"""The yardstick: published H100 peaks and the operations and bytes of each
layer's work, counted from shapes (never from the program's kernels), so a
later implementation reads against the same work.

Peaks (NVIDIA H100 SXM data sheet, dense, 700 W): 989e12 bf16 / fp16,
1,979e12 int8 / fp8, 495e12 TF32, 67e12 f32 outside the tensor cores;
3.35e12 bytes/s of HBM3. A kernel's least time is the larger of its
operations over the peak of their type and its bytes (each input read
once, each output written once) over the memory rate.
"""

from __future__ import annotations

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def least_seconds(ops: float, kind: str, nbytes: float) -> float:
    return max(ops / PEAK_OPS[kind], nbytes / PEAK_BYTES)


def vit_forward_ops(m: dict) -> float:
    """Operations of one ViT forward on one crop: the patch embedding, and
    per block the qkv, proj, fc1 and fc2 products and the two attention
    products (QK^T and AV), over 1 + P tokens."""
    C, H = m["embed_dim"], m["mlp_hidden"]
    P = (m["crop_size"] // m["patch_size"]) ** 2
    N = P + 1
    embed = 2.0 * P * 3 * m["patch_size"] ** 2 * C
    block = 2.0 * N * C * (3 * C + C + 2 * H) + 4.0 * N * N * C
    return embed + m["depth"] * block


def vit_weight_bytes(m: dict, bytes_per_weight: float) -> float:
    C, H = m["embed_dim"], m["mlp_hidden"]
    return m["depth"] * (4 * C * C + 2 * C * H) * bytes_per_weight


def _conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def ist_backbone_ops(m: dict) -> float:
    """Operations of one IST backbone forward on one crop: the 7 x 7 / 2
    stem, the four stages of two BasicBlocks (two 3 x 3 convolutions each,
    and a 1 x 1 downsample where the stride is 2) and the 1 x 1 out-conv."""
    s = _conv_out(m["ist_input_size"], 7, 2, 3)
    cin = m["ist_initial_dim"]
    ops = 2.0 * s * s * cin * 3 * 49
    for cout, stride in zip(m["ist_block_dims"], (1, 2, 2, 2)):
        so = _conv_out(s, 3, stride, 1)
        ops += 2.0 * so * so * cout * cin * 9 + 2.0 * so * so * cout * cout * 9
        if stride != 1:
            ops += 2.0 * so * so * cout * cin
        ops += 2.0 * 2 * so * so * cout * cout * 9  # the stage's second block
        s, cin = so, cout
    return ops + 2.0 * s * s * m["ist_descriptor"] * cin


def regression_ops(m: dict, correspondences: int) -> float:
    """The two regressor MLPs (2D -> 2D -> D -> 1 and -> 2) on each
    correspondence."""
    D = m["ist_descriptor"]
    per = 2.0 * (2 * D * 2 * D + 2 * D * D) * 2 + 2.0 * D * 3
    return per * correspondences


def matching_work(m: dict, B: int, objects: int) -> tuple:
    """(operations, bytes) of one matching launch over B detections: 2 V P^2
    C similarity products per detection in the store's type; the bytes of
    the labelled objects' views, the query, masks, labels and outputs."""
    V, C = m["templates"], m["embed_dim"]
    P = (m["crop_size"] // m["patch_size"]) ** 2
    esz = 2 if m["feature_dtype"] == "bf16" else 4
    nbytes = (objects * V * P * C + B * P * C) * esz + (objects * V * P + B * P + B) * 4 \
        + (B * V + 3 * B * V * P) * 4
    return 2.0 * B * V * P * P * C, nbytes


def serve_ops_per_detection(m: dict) -> float:
    """Useful operations of one detection's coarse pose: the AE and IST
    forwards, the regression of k x P correspondences and the matching
    against every view of its object."""
    P = (m["crop_size"] // m["patch_size"]) ** 2
    return vit_forward_ops(m) + ist_backbone_ops(m) + regression_ops(m, m["k"] * P) \
        + matching_work(m, 1, 1)[0]
