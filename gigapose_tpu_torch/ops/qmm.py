"""W8A8 int8 matmul kernels of the int8 serving path: wrappers of the CUDA
kernels in csrc/qmm.cu, and their plain PyTorch versions.

Counterpart of gigapose_tpu/ops/qmm.py. Scheme: dynamic per-row (token)
activation scales, static per-column (output-channel) weight scales,
symmetric, int32 accumulation:

    [LN ->] absmax per row -> scale = max(absmax, 1e-20) / 127
    -> q = clip(round_half_even(x / scale), -127, 127) as int8
    -> acc = q . wq (int32) -> y = acc * xs * ws + b [-> res + ls * y]

- `qmm`:            one such matmul (the TPU's `_qmm_kernel`);
- `qmm_mlp`:        LN -> fc1 + b1 -> tanh-GELU -> fc2 + b2 -> x + ls * y;
- `qmm_attn_block`: LN -> qkv -> per-head bf16 attention with an f32 softmax
                    and a key bias -> proj -> x + ls * y.

On the TPU each is one kernel with the (T, 4C) hidden or the (Np, 3C) qkv in
VMEM. Neither fits in a Hopper block's shared memory, so on the card each is
a short chain of kernels from csrc/qmm.cu: a row prologue ([LN ->] quantize),
an int8 tensor-core GEMM with a fused epilogue, and the attention core.
`qmm_mlp` and `qmm_attn_block` end in a `qmm` call (the fc2 and proj matmuls
with their residual epilogue), which `qmm.launches` counts too.

Weights: `wq` is (K, N) int8 as in the JAX package, but stored K-contiguous
(`wq.t()` is contiguous), the layout the GEMM reads; `quantize_weight` and
models/vit_int8.prepare_int8_params produce it. Scales and biases are (1, N)
f32.

Dispatch is by device and nothing else: CUDA tensors launch the kernels (or
raise on what they do not take), CPU tensors take the plain versions. Each
wrapper's `.launches` counts its calls that launched kernels; the three
kernels' own launches are counted by `_quantize_rows.launches`,
`_gemm.launches` (a dict by epilogue mode) and `_attention.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

_LN_EPS = 1e-6
# csrc/qmm.cu: the attention core keeps K and V of one head of one batch
# element in shared memory, for the head width of ViT-S/B/L/g
MAX_TOKENS = 320
HEAD_DIM = 64
# the row prologue holds a row in registers: at most 256 threads x 8 vectors
# of 16 bytes, 8192 f32 values
MAX_WIDTH = 8192
_MODE_F32, _MODE_RES, _MODE_GELU, _MODE_BF16 = 0, 1, 2, 3
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division. PyTorch's CUDA kernels turn a division by
    a Python scalar into a product with its reciprocal, 1 ulp off at times;
    a 0-dim tensor on t's device keeps the IEEE division of JAX and the
    kernels."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> (wq int8 (K, N), stored K-contiguous; ws f32 (1, N)),
    symmetric per column."""
    w = w.to(torch.float32)
    ws = _div127(torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-20))
    wq = torch.clamp(torch.round(w / ws), -127, 127).to(torch.int8)
    return wq.t().contiguous().t(), ws


def _ln(x, gamma, beta):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * gamma + beta


def _gelu_tanh(x):
    """tanh-approximate GELU, in the JAX package's operation order (the int8
    path's numerics; the float ViT keeps the erf GELU)."""
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _quant_rows(x):
    """f32 (T, K) -> (int8 (T, K), f32 (T, 1) scales); round half to even."""
    scale = _div127(torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-20))
    xq = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return xq, scale


def _dot_i8(xq, wq):
    """The int8 dot as an f32 matmul of the integer values: exact while every
    partial sum stays below 2**24 (K <= 1024 with |q| <= 127)."""
    return torch.matmul(xq.to(torch.float32), wq.to(torch.float32))


# ------------------------------------------------------------ plain versions


def qmm_plain(x, wq, ws, bias, ln_gamma=None, ln_beta=None, residual=None, layerscale=None):
    x = x.to(torch.float32)
    if ln_gamma is not None:
        x = _ln(x, ln_gamma, ln_beta)
    xq, xs = _quant_rows(x)
    y = _dot_i8(xq, wq) * xs * ws + bias
    if residual is not None:
        y = residual.to(torch.float32) + y * layerscale
    return y


def qmm_mlp_plain(x, w1q, w1s, b1, w2q, w2s, b2, ln_gamma, ln_beta, layerscale):
    x = x.to(torch.float32)
    h = _gelu_tanh(qmm_plain(x, w1q, w1s, b1, ln_gamma, ln_beta))
    return qmm_plain(h, w2q, w2s, b2, residual=x, layerscale=layerscale)


def attention_plain(qkv, key_bias, batch, num_heads):
    """The attention of qmm_attn_block_ref on its bf16 qkv (batch * Np, 3C),
    laid out [token][3][head][hd]: f32 scores * hd^-1/2 + key_bias, f32
    softmax, p rounded to bf16, f32 context (batch * Np, C). The products
    and the softmax sum are accumulated in f64 and rounded once to f32: the
    bf16 products are exact there, so the result is the correctly rounded f32
    sum whatever the order or the number of (masked, zero) keys, and real
    tokens do not depend on padding."""
    T, C3 = qkv.shape
    Np, hd = T // batch, C3 // (3 * num_heads)
    qkv = qkv.to(torch.bfloat16).reshape(batch, Np, 3, num_heads, hd).to(torch.float64)
    q, k, v = qkv.unbind(dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * (hd ** -0.5)
    s = s + key_bias.to(torch.float32).reshape(1, 1, 1, Np)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)
    p = p.to(torch.bfloat16).to(torch.float64)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(torch.float32).reshape(T, C3 // 3)


def qmm_attn_block_plain(
    x, qkv_wq, qkv_ws, qkv_b, proj_wq, proj_ws, proj_b,
    ln_gamma, ln_beta, layerscale, key_bias, batch, num_heads,
):
    """The JAX package's qmm_attn_block_ref: bf16 q, k, v and p, f32 softmax
    (attention_plain)."""
    xr = x.to(torch.float32)
    qkv = qmm_plain(xr, qkv_wq, qkv_ws, qkv_b, ln_gamma, ln_beta).to(torch.bfloat16)
    ctx = attention_plain(qkv, key_bias, batch, num_heads)
    y = qmm_plain(ctx, proj_wq, proj_ws, proj_b)
    return xr + y * layerscale


# ------------------------------------------------------------ CUDA launches


@functools.cache
def _lib():
    """The built csrc/qmm.cu with its C signatures declared."""
    from gigapose_tpu_torch.kernels.build import load_library

    lib = load_library("qmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gp_qmm_quant_rows.argtypes = [p, i, p, p, p, p, i, i, p]
    lib.gp_qmm_gemm.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.gp_qmm_attention.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, p]
    for fn in (lib.gp_qmm_quant_rows, lib.gp_qmm_gemm, lib.gp_qmm_attention):
        fn.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _call(fn, *args, what: str) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"qmm {what} kernel launch failed: CUDA error {err}")


def _check(dev: torch.device, name: str, t: torch.Tensor, dtypes, shape) -> None:
    """Device, dtype, shape, layout and alignment of one kernel argument;
    weights (int8, 2-D) must be K-contiguous, everything else contiguous, and
    all of them 16-byte aligned: the kernels read rows as 16-byte vectors,
    and the int8 operands through TMA, which takes no other start."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {list(dtypes)}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype == torch.int8 and t.ndim == 2:
        if not t.t().is_contiguous():
            raise ValueError(f"{name} must be stored K-contiguous (wq.t() contiguous), "
                             "as quantize_weight returns it")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte aligned address, not a view "
                         "that starts inside a 16-byte block")


def _f32(*names_shapes):
    return [(n, t, (torch.float32,), s) for n, t, s in names_shapes]


def _quantize_rows(x, ln_gamma=None, ln_beta=None):
    T, K = x.shape
    xq = torch.empty((T, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((T,), dtype=torch.float32, device=x.device)
    _call(_lib().gp_qmm_quant_rows, x.data_ptr(), _X_DTYPES[x.dtype], _ptr(ln_gamma),
          _ptr(ln_beta), xq.data_ptr(), xs.data_ptr(), T, K, what="row quantization")
    _quantize_rows.launches += 1
    return xq, xs


_quantize_rows.launches = 0


def _gemm(xq, xs, wq, ws, bias, out, mode, residual=None, layerscale=None):
    T, K = xq.shape
    N = wq.shape[1]
    _call(_lib().gp_qmm_gemm, xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
          bias.data_ptr(), _ptr(residual), _ptr(layerscale), out.data_ptr(), T, N, K, mode,
          what="int8 GEMM")
    _gemm.launches[mode] += 1


_gemm.launches = {mode: 0 for mode in (_MODE_F32, _MODE_RES, _MODE_GELU, _MODE_BF16)}


def _attention(qkv, key_bias, batch, num_heads):
    """The attention core on a bf16 qkv (batch * Np, 3C) -> f32 ctx
    (batch * Np, C); arguments checked by qmm_attn_block."""
    T, C = qkv.shape[0], qkv.shape[1] // 3
    hd = C // num_heads
    ctx = torch.empty((T, C), dtype=torch.float32, device=qkv.device)
    _call(_lib().gp_qmm_attention, qkv.data_ptr(), key_bias.data_ptr(), ctx.data_ptr(),
          batch, T // batch, num_heads, hd, float(hd ** -0.5), what="attention")
    _attention.launches += 1
    return ctx


_attention.launches = 0


def _check_x(x: torch.Tensor, what: str) -> str:
    """'cuda' or 'cpu' for the dispatch; raises for other devices."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")
    if x.ndim != 2:
        raise ValueError(f"{what} takes x of shape (T, K), got {tuple(x.shape)}")
    return x.device.type


def _check_width(K: int) -> None:
    if K % 16:
        raise ValueError(f"the kernels read rows as 16-byte vectors: K={K} must be a "
                         "multiple of 16")
    if K > MAX_WIDTH:
        raise ValueError(f"the row prologue holds a row in registers: K={K} must be at "
                         f"most {MAX_WIDTH}")


# ------------------------------------------------------------------ wrappers


def qmm(
    x: torch.Tensor,  # (T, K) f32 or bf16
    wq: torch.Tensor,  # (K, N) int8, K-contiguous
    ws: torch.Tensor,  # (1, N) f32
    bias: torch.Tensor,  # (1, N) f32
    ln_gamma: Optional[torch.Tensor] = None,  # (1, K): fuse the LN prologue
    ln_beta: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,  # (T, N) f32: out = res + ls * y
    layerscale: Optional[torch.Tensor] = None,  # (1, N), with residual
) -> torch.Tensor:
    """[LN ->] quantize -> int8 dot -> * xs * ws + b [-> res + ls * y], f32 (T, N)."""
    if _check_x(x, "qmm") == "cpu":
        return qmm_plain(x, wq, ws, bias, ln_gamma, ln_beta, residual, layerscale)
    T, K = x.shape
    N = wq.shape[-1]
    specs = [("x", x, tuple(_X_DTYPES), (T, K)), ("wq", wq, (torch.int8,), (K, N))]
    specs += _f32(("ws", ws, (1, N)), ("bias", bias, (1, N)))
    if (ln_gamma is None) != (ln_beta is None) or (residual is None) != (layerscale is None):
        raise ValueError("ln_gamma / ln_beta and residual / layerscale come in pairs")
    if ln_gamma is not None:
        specs += _f32(("ln_gamma", ln_gamma, (1, K)), ("ln_beta", ln_beta, (1, K)))
    if residual is not None:
        specs += _f32(("residual", residual, (T, N)), ("layerscale", layerscale, (1, N)))
    for spec in specs:
        _check(x.device, *spec)
    _check_width(K)
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    if T == 0:
        return out
    with torch.cuda.device(x.device):
        xq, xs = _quantize_rows(x, ln_gamma, ln_beta)
        _gemm(xq, xs, wq, ws, bias, out, _MODE_F32 if residual is None else _MODE_RES,
              residual, layerscale)
    qmm.launches += 1
    return out


qmm.launches = 0


def qmm_mlp(
    x: torch.Tensor,  # (T, C) f32
    w1q: torch.Tensor, w1s: torch.Tensor, b1: torch.Tensor,  # (C, Hd) int8, (1, Hd), (1, Hd)
    w2q: torch.Tensor, w2s: torch.Tensor, b2: torch.Tensor,  # (Hd, C) int8, (1, C), (1, C)
    ln_gamma: torch.Tensor, ln_beta: torch.Tensor,  # (1, C)
    layerscale: torch.Tensor,  # (1, C)
) -> torch.Tensor:
    """The pre-norm MLP sub-block x + ls * fc2(gelu_tanh(fc1(LN(x)))), f32 (T, C)."""
    if _check_x(x, "qmm_mlp") == "cpu":
        return qmm_mlp_plain(x, w1q, w1s, b1, w2q, w2s, b2, ln_gamma, ln_beta, layerscale)
    T, C = x.shape
    Hd = w1q.shape[-1]
    specs = [("x", x, (torch.float32,), (T, C)), ("w1q", w1q, (torch.int8,), (C, Hd)),
             ("w2q", w2q, (torch.int8,), (Hd, C))]
    specs += _f32(("w1s", w1s, (1, Hd)), ("b1", b1, (1, Hd)), ("w2s", w2s, (1, C)),
                  ("b2", b2, (1, C)), ("ln_gamma", ln_gamma, (1, C)),
                  ("ln_beta", ln_beta, (1, C)), ("layerscale", layerscale, (1, C)))
    for spec in specs:
        _check(x.device, *spec)
    _check_width(C)
    _check_width(Hd)
    if T == 0:
        return torch.empty((0, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        xq, xs = _quantize_rows(x, ln_gamma, ln_beta)
        h = torch.empty((T, Hd), dtype=torch.float32, device=x.device)
        _gemm(xq, xs, w1q, w1s, b1, h, _MODE_GELU)
        out = qmm(h, w2q, w2s, b2, residual=x, layerscale=layerscale)
    qmm_mlp.launches += 1
    return out


qmm_mlp.launches = 0


def qmm_attn_block(
    x: torch.Tensor,  # (batch * Np, C) f32
    qkv_wq: torch.Tensor, qkv_ws: torch.Tensor, qkv_b: torch.Tensor,  # (C, 3C) int8, (1, 3C) x2
    proj_wq: torch.Tensor, proj_ws: torch.Tensor, proj_b: torch.Tensor,  # (C, C) int8, (1, C) x2
    ln_gamma: torch.Tensor, ln_beta: torch.Tensor,  # (1, C)
    layerscale: torch.Tensor,  # (1, C)
    key_bias: torch.Tensor,  # (1, Np) f32: 0 on real keys, -1e9 on padded ones
    batch: int = 1,
    num_heads: int = 16,
) -> torch.Tensor:
    """The pre-norm attention sub-block x + ls * proj(attention(qkv(LN(x)))),
    per batch element of Np tokens, f32 (T, C)."""
    if _check_x(x, "qmm_attn_block") == "cpu":
        return qmm_attn_block_plain(x, qkv_wq, qkv_ws, qkv_b, proj_wq, proj_ws, proj_b,
                                    ln_gamma, ln_beta, layerscale, key_bias, batch, num_heads)
    T, C = x.shape
    if batch <= 0 or T % batch or C % num_heads:
        raise ValueError(f"x of shape {(T, C)} does not split into batch={batch} "
                         f"x heads={num_heads}")
    Np, hd = T // batch, C // num_heads
    if hd != HEAD_DIM or not 0 < Np <= MAX_TOKENS:
        raise ValueError(f"the attention kernel takes head width {HEAD_DIM} and 1..{MAX_TOKENS} "
                         f"tokens per element; got hd={hd}, Np={Np}")
    specs = [("x", x, (torch.float32,), (T, C)),
             ("qkv_wq", qkv_wq, (torch.int8,), (C, 3 * C)),
             ("proj_wq", proj_wq, (torch.int8,), (C, C))]
    specs += _f32(("qkv_ws", qkv_ws, (1, 3 * C)), ("qkv_b", qkv_b, (1, 3 * C)),
                  ("proj_ws", proj_ws, (1, C)), ("proj_b", proj_b, (1, C)),
                  ("ln_gamma", ln_gamma, (1, C)), ("ln_beta", ln_beta, (1, C)),
                  ("layerscale", layerscale, (1, C)), ("key_bias", key_bias, (1, Np)))
    for spec in specs:
        _check(x.device, *spec)
    _check_width(C)
    with torch.cuda.device(x.device):
        xq, xs = _quantize_rows(x, ln_gamma, ln_beta)
        qkv = torch.empty((T, 3 * C), dtype=torch.bfloat16, device=x.device)
        _gemm(xq, xs, qkv_wq, qkv_ws, qkv_b, qkv, _MODE_BF16)
        ctx = _attention(qkv, key_bias, batch, num_heads)
        out = qmm(ctx, proj_wq, proj_ws, proj_b, residual=x, layerscale=layerscale)
    qmm_attn_block.launches += 1
    return out


qmm_attn_block.launches = 0
