"""gigapose_tpu_torch — PyTorch / CUDA port of gigapose_tpu's coarse pose path,
its render-and-compare refinement and the training of its two nets and of
its refiner.

The JAX package ``gigapose_tpu`` is the reference; this package mirrors its
sub-packages and module names so each counterpart sits at the same relative
path. It imports ``torch`` and never ``jax`` (nor ``gigapose_tpu``, whose
package ``__init__`` files pull jax in), so it runs on a machine that has only
PyTorch and the CUDA toolkit.

- ``lib3d``    : affine helpers, projective geometry, numpy icosphere
                 template poses.
- ``ops``      : crop, gather, matching (plain reference), the fused matching
                 kernel's wrapper, RANSAC, 6D recovery.
- ``models``   : DINOv2 ViT, AE net, IST net as ``nn.Module``s, the
                 training losses, and the flax -> torch weight bridge.
- ``pipeline`` : template onboarding, the coarse estimator, request prep.
- ``render``   : mesh readers, the host C++ rasterizer, the batched device
                 rasterizer (a CUDA kernel on the card).
- ``refiner``  : render-and-compare geometry, the refiner and scorer nets,
                 the refine loop and its runner (``refine.py`` is its CLI),
                 refiner training (``scripts/train_refiner.py`` its CLI).
- ``dataloader``: BOP readers, the PNG codec, and the training data (the
                 PIL-free augmentations, keypoints, the host train loader).
- ``training`` : train state and step (optax's Adam / AdamW), validation,
                 checkpoints, the loop (``train.py`` is its CLI).
- ``kernels``  : nvcc / host-compiler build + ctypes loading of ``csrc/``.
"""
