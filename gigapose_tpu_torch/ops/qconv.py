"""Int8 convolutions of the int8 IST serving path: wrappers of the CUDA
kernels in csrc/qconv.cu, and their plain PyTorch versions.

Counterpart of `_qconv` in gigapose_tpu/models/ist_int8.py, which is XLA
code (an int8 lax.conv_general_dilated with int32 accumulation). Scheme:
static per-output-channel weight scales with the BatchNorm affine folded in,
symmetric activation scales per image (dynamic) or one calibrated scale per
conv (static):

    scale = max(absmax over H, W, C / 127, 1e-12)        (act_scale)
    q = clip(round_half_even(x / scale), -127, 127)      (quantize_act)
    acc = conv(q, wq) in int32 -> y = acc * (sx * ws) + b [+ residual] [relu]
                                                         (qconv)
    [q' = clip(round_half_even(y / so), -127, 127)]      (qconv, out_scale=so)

The eps is 1e-12 and the scale is per image, not per row: these are not
ops/qmm.py's scales. Layouts: activations NHWC; the weight `wq` is
(O, KH*KW*I) int8, K-contiguous, K in the (kh, kw, i) order of an HWIO
kernel (square kernels); `ws` and `b` are (O,) f32; a scale `sx` is (B,)
per image or one element (static).

`qconv(..., out_scale=so)` (so one static scale, the next convolution's)
returns the int8 codes of the output instead of f32: exactly
`quantize_act(qconv(...), so)`, in one launch, a quarter of the output's
bytes. The int8 IST uses it for each block's conv1, whose output feeds only
conv2's quantization, when conv2 has a static scale.

The kernel takes channels in multiples of 16 (`CHANNELS`: one 16-byte copy
of its im2col gather is 16 channels of one tap). `qconv` pads an input of
other C (the int8 IST's stem: 3 channels -> 16) and its weight with zero
codes before the launch (`pad_weight`), which add nothing to an integer
sum. The N tile of the launch and the route of its im2col tiles follow
the shape (`n_tile`, `im2col_route`).

The plain `qconv` accumulates the integer codes exactly, as an f64
convolution (every product and partial sum is an integer below 2^53), then
rounds once to f32: the int32 -> f32 conversion of the kernel. The JAX
package's CPU backend ("ref") accumulates in f32 instead, which is exact
only while partial sums stay below 2^24 (ROADMAP C).

Dispatch is by device and nothing else: CUDA tensors launch the kernels (or
raise on what they do not take), CPU tensors take the plain versions. Each
wrapper's `.launches` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

_EPS = 1e-12
CHANNELS = 16  # the kernel's channel granularity


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division (PyTorch's CUDA kernels turn a division by
    a Python scalar into a product with its reciprocal)."""
    return t / torch.full((), 127.0, device=t.device)


def kernel_size(K: int, C: int) -> int:
    """The side of a square kernel whose (O, K) weight takes C channels."""
    taps = K // C
    ks = math.isqrt(taps)
    if K % C or ks * ks != taps:
        raise ValueError(f"a weight of width K={K} is no square kernel over C={C} channels")
    return ks


def out_size(size: int, ks: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - ks) // stride + 1


def padded_channels(C: int) -> int:
    """C rounded up to the kernel's multiple of CHANNELS."""
    return -(-C // CHANNELS) * CHANNELS


def pad_weight(wq: torch.Tensor, C: int) -> torch.Tensor:
    """(O, KH*KW*C) int8 -> (O, KH*KW*padded_channels(C)), zero codes in
    the added channels of every tap."""
    O, K = wq.shape
    Cp = padded_channels(C)
    if Cp == C:
        return wq
    return F.pad(wq.reshape(O, K // C, C), (0, Cp - C)).reshape(O, -1).contiguous()


def n_tile(M: int, O: int) -> int:
    """The N tile (output channels per CTA tile) of qconv's launch for an
    (M, O) output: 128 for O <= 128; 192 for O <= 192 or a multiple of 192
    but not of 256 (no wasted columns at the IST's 192); 256 for a multiple
    of 256 that still gives at least 96 tiles of 128 rows (three quarters of
    an H100's 132 SMs busy); 128 otherwise (the IST's out conv: 64 tiles at
    256 would leave half the card idle)."""
    if O <= 128:
        return 128
    if O <= 192 or (O % 192 == 0 and O % 256):
        return 192
    if O % 256 == 0 and -(-M // 128) * (O // 256) >= 96:
        return 256
    return 128


def im2col_route(C: int, OH: int, OW: int, stride: int) -> tuple:
    """How qconv's launch loads its im2col tiles: ("tma", window columns)
    or ("gather", 0).

    "tma" where C is a multiple of 128 (a k-block is one tap's 128
    channels), each 128-row tile is a window of one image (OW a multiple of
    128: 1 x 128; else OW a divisor of 128 with OH * OW a multiple of 128:
    128 / OW rows of OW) and a box spans at most 256 input columns and rows:
    TMA loads each k-block of the tile as one box of the input's 4-D tensor
    map. Any other shape (the IST's stem and its convolutions over 192
    channels among them): "gather", 16-byte cp.async copies row by row.
    The decision is made here alone: the C entry point takes it as given and
    checks only what its kernel and the TMA box need."""
    cols = 128 if OW >= 128 else OW
    tiles = OW % 128 == 0 if OW >= 128 else 128 % OW == 0 and OH * OW % 128 == 0
    if C % 128 == 0 and tiles and cols * stride <= 256 and 128 // cols * stride <= 256:
        return "tma", cols
    return "gather", 0


def _per_image(sx: torch.Tensor) -> torch.Tensor:
    return sx.reshape(-1, 1, 1, 1)


# ------------------------------------------------------------ plain versions


def act_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) f32 -> (B,) f32 per-image scales."""
    return torch.clamp(_div127(x.abs().amax(dim=(1, 2, 3))), min=_EPS)


def quantize_act_plain(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / _per_image(sx)), -127, 127).to(torch.int8)


def qconv_plain(xq, sx, wq, ws, b, stride: int, pad: int, residual=None, relu: bool = False):
    O, K = wq.shape
    C = xq.shape[-1]
    ks = kernel_size(K, C)
    x64 = xq.permute(0, 3, 1, 2).to(torch.float64)
    w64 = wq.reshape(O, ks, ks, C).permute(0, 3, 1, 2).to(torch.float64)
    # cuDNN is off on the card: its FFT and Winograd algorithms would round;
    # PyTorch's own f64 im2col + GEMM sums the integers exactly
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x64, w64, None, stride, pad)
    y = acc.to(torch.float32).permute(0, 2, 3, 1) * (_per_image(sx) * ws) + b
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.where(y > 0, y, 0.0)
    return y.contiguous()


# ------------------------------------------------------------ CUDA launches


@functools.cache
def _lib():
    """The built csrc/qconv.cu with its C signatures declared."""
    from gigapose_tpu_torch.kernels.build import load_library

    lib = load_library("qconv")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gp_qconv_act_scale.argtypes = [p, p, p, i, ll, p]
    lib.gp_qconv_quantize.argtypes = [p, p, i, p, i, ll, p]
    lib.gp_qconv_conv.argtypes = [p, p, i] + [p] * 6 + [i] * 13 + [p]
    for fn in (lib.gp_qconv_act_scale, lib.gp_qconv_quantize, lib.gp_qconv_conv):
        fn.restype = ctypes.c_int
    return lib


def _call(fn, *args, what: str) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"qconv {what} kernel launch failed: CUDA error {err}")


def _device(x: torch.Tensor, what: str) -> str:
    """'cuda' or 'cpu' for the dispatch; raises for other devices."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")
    if x.ndim != 4:
        raise ValueError(f"{what} takes an NHWC tensor, got shape {tuple(x.shape)}")
    return x.device.type


def _check(dev: torch.device, name: str, t: torch.Tensor, dtype: torch.dtype, shape=None) -> None:
    """Device, dtype, shape, contiguity and 16-byte alignment (the kernels
    read 16-byte vectors) of one kernel argument."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte aligned address")


def _check_scale(dev, sx: torch.Tensor, B: int) -> int:
    """The kernels' stride over sx: 1 per image (B,), 0 for one scale."""
    _check(dev, "sx", sx, torch.float32)
    if sx.numel() not in (1, B):
        raise ValueError(f"sx has {sx.numel()} elements: one per image ({B}) or one")
    return 0 if sx.numel() == 1 else 1


# ------------------------------------------------------------------ wrappers


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) f32 -> (B,) f32: max(absmax of each image / 127, 1e-12)."""
    if _device(x, "act_scale") == "cpu":
        return act_scale_plain(x)
    _check(x.device, "x", x, torch.float32)
    B = x.shape[0]
    scale = torch.empty((B,), dtype=torch.float32, device=x.device)
    scratch = torch.empty((B + 1,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _call(_lib().gp_qconv_act_scale, x.data_ptr(), scratch.data_ptr(), scale.data_ptr(),
              B, x[0].numel(), what="act_absmax")
    act_scale.launches += 1
    return scale


act_scale.launches = 0


def quantize_act(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) f32 -> int8 codes clip(round_half_even(x / sx), +-127),
    sx (B,) per image or one static scale."""
    if _device(x, "quantize_act") == "cpu":
        return quantize_act_plain(x, sx)
    _check(x.device, "x", x, torch.float32)
    B = x.shape[0]
    stride = _check_scale(x.device, sx, B)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        _call(_lib().gp_qconv_quantize, x.data_ptr(), sx.data_ptr(), stride, q.data_ptr(), B,
              x[0].numel(), what="quantize")
    quantize_act.launches += 1
    return q


quantize_act.launches = 0


def qconv(
    xq: torch.Tensor,  # (B, H, W, C) int8
    sx: torch.Tensor,  # (B,) or one element, f32
    wq: torch.Tensor,  # (O, KH*KW*C) int8
    ws: torch.Tensor,  # (O,) f32
    b: torch.Tensor,  # (O,) f32
    stride: int,
    pad: int,
    residual: Optional[torch.Tensor] = None,  # (B, OH, OW, O) f32
    relu: bool = False,
    out_scale: Optional[torch.Tensor] = None,  # one element, f32
) -> torch.Tensor:
    """int8 conv with int32 accumulation -> acc * (sx * ws) + b [+ residual]
    [relu], f32 (B, OH, OW, O); with `out_scale` its int8 codes
    clip(round_half_even(y / out_scale), +-127) instead."""
    if _device(xq, "qconv") == "cpu":
        y = qconv_plain(xq, sx, wq, ws, b, stride, pad, residual, relu)
        return y if out_scale is None else quantize_act_plain(y, out_scale)
    B, H, W, C = xq.shape
    O, K = wq.shape
    ks = kernel_size(K, C)
    OH, OW = out_size(H, ks, stride, pad), out_size(W, ks, stride, pad)
    if OH <= 0 or OW <= 0 or stride <= 0 or pad < 0:
        raise ValueError(f"no output for a {ks}x{ks} kernel, stride {stride}, pad {pad} "
                         f"over {H}x{W}")
    dev = xq.device
    _check(dev, "xq", xq, torch.int8)
    _check(dev, "wq", wq, torch.int8)
    _check(dev, "ws", ws, torch.float32, (O,))
    _check(dev, "b", b, torch.float32, (O,))
    if residual is not None:
        _check(dev, "residual", residual, torch.float32, (B, OH, OW, O))
    stride_sx = _check_scale(dev, sx, B)
    if out_scale is not None:
        _check(dev, "out_scale", out_scale, torch.float32)
        if out_scale.numel() != 1:
            raise ValueError(f"out_scale has {out_scale.numel()} elements: one static scale")
    if C % CHANNELS:  # zero codes in the added channels: the same sums
        xq = F.pad(xq, (0, padded_channels(C) - C))
        wq = pad_weight(wq, C)
        C = xq.shape[-1]
    out = torch.empty((B, OH, OW, O), dtype=torch.float32 if out_scale is None else torch.int8,
                      device=dev)
    with torch.cuda.device(dev):
        _call(_lib().gp_qconv_conv, xq.data_ptr(), sx.data_ptr(), stride_sx, wq.data_ptr(),
              ws.data_ptr(), b.data_ptr(), None if residual is None else residual.data_ptr(),
              out.data_ptr(), None if out_scale is None else out_scale.data_ptr(), B, H, W, C,
              OH, OW, O, ks, stride, pad, int(relu), n_tile(B * OH * OW, O),
              im2col_route(C, OH, OW, stride)[1], what="qconv")
    qconv.launches += 1
    return out


qconv.launches = 0
