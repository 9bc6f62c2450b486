"""Render-and-compare refinement: geometry ops, the refiner and scorer
ResNets, the device mesh pack, the refine loop and its runner."""
