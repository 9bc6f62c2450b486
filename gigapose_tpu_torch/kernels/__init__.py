"""Build and load the CUDA sources under ``gigapose_tpu_torch/csrc/``."""
