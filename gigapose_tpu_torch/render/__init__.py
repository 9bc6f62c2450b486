"""Mesh loading and rasterization: the host C++ rasterizer (``rasterizer``)
and the batched device rasterizer (``rasterize``, a CUDA kernel on the card)."""
