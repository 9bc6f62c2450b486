"""gigapose_tpu_torch — PyTorch / CUDA port of gigapose_tpu's coarse pose path.

The JAX package ``gigapose_tpu`` is the reference; this package mirrors its
sub-packages and module names so each counterpart sits at the same relative
path. It imports ``torch`` and never ``jax`` (nor ``gigapose_tpu``, whose
package ``__init__`` files pull jax in), so it runs on a machine that has only
PyTorch and the CUDA toolkit.

- ``lib3d``    : affine helpers, numpy icosphere template poses.
- ``ops``      : crop, gather, matching (plain reference), the fused matching
                 kernel's wrapper, RANSAC, 6D recovery.
- ``models``   : DINOv2 ViT, AE net, IST net as ``nn.Module``s, and the
                 flax -> torch weight bridge.
- ``pipeline`` : template onboarding, the coarse estimator, request prep.
- ``kernels``  : nvcc build + ctypes loading of the CUDA sources in ``csrc/``.
"""
