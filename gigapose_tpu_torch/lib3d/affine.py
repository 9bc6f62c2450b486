"""2D affine helpers on torch tensors (port of gigapose_tpu/lib3d/affine.py).

Conventions as in the reference: 3x3 row-major homogeneous matrices acting on
column vectors [x, y, 1]^T; crop matrices are axis-aligned similarities
M = [[s, 0, tx], [0, s, ty], [0, 0, 1]]; leading axes broadcast.
"""

from __future__ import annotations

import torch


def homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., N, D) -> (..., N, D+1) by appending ones."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def affine2d(rotation: torch.Tensor, scale=None, translation=None) -> torch.Tensor:
    """(..., 3, 3) affine from a (..., 2, 2) rotation, an optional (...,)
    scale of the linear block and an optional (..., 2) translation."""
    batch_shape = rotation.shape[:-2]
    lin = rotation if scale is None else rotation * scale[..., None, None]
    if translation is None:
        translation = rotation.new_zeros(batch_shape + (2,))
    top = torch.cat([lin, translation[..., :, None]], dim=-1)  # (..., 2, 3)
    bottom = rotation.new_tensor([0.0, 0.0, 1.0]).expand(batch_shape + (1, 3))
    return torch.cat([top, bottom], dim=-2)


def rotation2d(cos_sin: torch.Tensor) -> torch.Tensor:
    """(..., 2) [cos, sin] -> (..., 2, 2) rotation matrix."""
    c, s = cos_sin[..., 0], cos_sin[..., 1]
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def apply_affine(M: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 3) homogeneous transforms to (..., N, 2) points, with
    the perspective divide; leading axes broadcast."""
    out = torch.einsum("...ij,...nj->...ni", M, homogeneous(points))
    return out[..., :2] / out[..., 2:3]


def inverse_crop_affine(M: torch.Tensor) -> torch.Tensor:
    """Inverse of an axis-aligned crop similarity. Assumes M[..., 0, 1] ==
    M[..., 1, 0] == 0 and equal diagonal scale."""
    scale = M[..., 0, 0]
    inv_scale = 1.0 / scale
    tx = -M[..., 0, 2] * inv_scale
    ty = -M[..., 1, 2] * inv_scale
    zeros = torch.zeros_like(scale)
    ones = torch.ones_like(scale)
    return torch.stack(
        [
            torch.stack([inv_scale, zeros, tx], dim=-1),
            torch.stack([zeros, inv_scale, ty], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )


def affine_scale(M: torch.Tensor) -> torch.Tensor:
    """Isotropic scale of an affine: norm of the first column of the 2x2 block."""
    return torch.linalg.vector_norm(M[..., :2, 0], dim=-1)


def normalize_affine(M: torch.Tensor) -> torch.Tensor:
    """Strip scale from the 2x2 linear block and zero the translation: the pure
    rotation embedded in a 3x3. Works on (..., 3, 3)."""
    lin = M[..., :2, :2] / affine_scale(M)[..., None, None]
    out = torch.zeros_like(M)
    out[..., :2, :2] = lin
    out[..., 2, 2] = 1.0
    return out
