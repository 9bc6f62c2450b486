"""Tensor ops of the coarse path; ``fused_matching`` wraps the CUDA kernel."""
