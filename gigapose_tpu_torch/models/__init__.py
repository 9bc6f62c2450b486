"""nn.Module ports of the AE (DINOv2 ViT) and IST networks, and the weight bridge."""
