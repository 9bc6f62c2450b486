"""The int8 serving kernels (csrc/qmm.cu) against their plain PyTorch
versions, on the GPU.

Marked `cuda`: each test skips where torch.cuda.is_available() is false (the
decision is taken in the fixture, never at import). Imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_qmm.py -q

Tolerances. Given the same int8 rows the kernels are exact: int32 sums, and
the epilogue rounds each product and sum as the plain version does. So qmm
without LayerNorm at K <= 1024 is bit-equal, the GEMM's f32 and residual
epilogues alone are bit-equal at every K (against the exact dot beyond
K = 1024, where the plain f32 sums round), and its GELU and bf16 epilogues
alone are within 2 ulps. The row prologue alone is equal without LayerNorm
and within one step with it. The attention core alone, on the same
bf16 qkv, differs only by the order of its f32 sums and the rare bf16
rounding of p that this flips: CORE limits. Elsewhere the two sides round
ulps apart before a quantization (LN means, tanh, the attention's f32 sums
in another order, the plain f32 sum of fc2's 4096 integer products), which
now and then flips one int8 by one step. A flip moves an output y[t, n] by
at most zmax[t] * ws[n] (the row's absmax over 127, times 127, times the
column scale), times |ls[n]| after a residual: for qmm the bound is 4
such steps for every output, and 0.25 of a step on average (flips are
sparse; a systematic fault, a wrong scale or row, costs half a step or more
on average). In the chained kernels (MLP, attention block) a flip before the
first matmul re-rounds the whole row downstream, and requantizing it flips
more. There the bound is relative to the branch out - x: max error / max
|branch|, mean error / mean |branch| and the per-token branch cosine, in
MLP and ATTN limits. These are the limits of chip_smoke.py: about twice
the readings at the ViT-L serving shapes on an H100, where flips are more
common than at most of these shapes (PERF.md, PR 2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gigapose_tpu_torch.models.vit import VIT_CONFIGS, ViT
from gigapose_tpu_torch.models import vit_int8 as v8
from gigapose_tpu_torch.ops import qmm as Q

pytestmark = pytest.mark.cuda

# (max |diff| / max |ref|, mean |diff| / mean |ref|, 1 - min per-token cosine)
CORE = (3e-3, 2e-6, 2.5e-6)
MLP = (6e-3, 1e-5, 5e-5)
ATTN = (2e-2, 3.5e-4, 3e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda", 0)


def _mk(dev, shape, seed, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dev)


def _weight(dev, K, N, seed):
    wq, ws = Q.quantize_weight(_mk(dev, (K, N), seed, 0.05))
    return wq, ws, _mk(dev, (1, N), seed + 1, 0.1)


def _assert_steps(got, want, zmax, ws, ls=None):
    """|got - want| <= 4 steps of zmax[t] * ws[n] * |ls[n]|, 0.25 on average."""
    step = zmax.reshape(-1, 1) * ws * (1.0 if ls is None else ls.abs())
    steps = (got - want).abs() / step
    assert bool(torch.isfinite(got).all())
    print(f"max {float(steps.max()):.3f} mean {float(steps.mean()):.5f} steps, "
          f"equal {float((got == want).float().mean()):.4f}")
    assert float(steps.max()) <= 4.0, float(steps.max())
    assert float(steps.mean()) <= 0.25, float(steps.mean())


def _assert_rel(got, want, limits, x=0.0):
    """|got - want| relative to r = want - x (the output, or the branch):
    max error / max |r| and mean error / mean |r| within limits[0] and
    limits[1]; 1 - the least per-token cosine of got - x and r (in f64)
    within limits[2]."""
    diff = (got - want).abs()
    bw, bg = (want - x).double(), (got - x).double()
    cos = (bg * bw).sum(-1) / (bg.norm(dim=-1) * bw.norm(dim=-1))
    rel_max = float(diff.max() / bw.abs().max())
    rel_mean = float(diff.mean() / bw.abs().mean())
    cos_gap = 1.0 - float(cos.min())
    print(f"rel max {rel_max:.4g} rel mean {rel_mean:.4g} cos gap {cos_gap:.4g}")
    assert bool(torch.isfinite(got).all())
    assert rel_max <= limits[0]
    assert rel_mean <= limits[1]
    assert cos_gap <= limits[2]


def _ulps(got, want, mantissa_bits):
    """max |got - want| in units in the last place of want."""
    _, e = torch.frexp(want.float())
    one = torch.ones_like(want.float())
    return float(((got.float() - want.float()).abs() / torch.ldexp(one, e - mantissa_bits)).max())


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("shape", [(300, 208, 200), (1, 64, 97), (514, 1024, 384)])
def test_qmm_matches_plain(dev, ln, res, shape):
    T, K, N = shape  # ragged T and N, K not a multiple of the 64-wide k-tile
    x = _mk(dev, (T, K), 1)
    wq, ws, b = _weight(dev, K, N, 2)
    g = _mk(dev, (1, K), 4).abs() + 0.5 if ln else None
    be = _mk(dev, (1, K), 5, 0.2) if ln else None
    r = _mk(dev, (T, N), 6) if res else None
    ls = _mk(dev, (1, N), 7, 0.3) if res else None
    before = Q.qmm.launches
    got = Q.qmm(x, wq, ws, b, g, be, r, ls)
    assert Q.qmm.launches == before + 1
    want = Q.qmm_plain(x, wq, ws, b, g, be, r, ls)
    torch.cuda.synchronize()
    if not ln:
        assert torch.equal(got, want)
    else:
        z = Q._ln(x, g, be).abs().amax(dim=-1)
        _assert_steps(got, want, z, ws, ls)


@pytest.mark.parametrize("mode", ["gelu", "bf16"])
@pytest.mark.parametrize("shape", [(300, 208, 200), (514, 1024, 4096)])
def test_gemm_epilogues_match_plain(dev, mode, shape):
    """The fc1 (GELU) and qkv (bf16) epilogues alone on the plain version's
    int8 rows: within 2 ulps (ragged T and N)."""
    T, K, N = shape
    xq, xs = Q._quant_rows(_mk(dev, (T, K), 3))
    wq, ws, b = _weight(dev, K, N, 4)
    dtype, bits = (torch.float32, 24) if mode == "gelu" else (torch.bfloat16, 8)
    out = torch.empty((T, N), dtype=dtype, device=dev)
    Q._gemm(xq, xs, wq, ws, b, out, Q._MODE_GELU if mode == "gelu" else Q._MODE_BF16)
    y = Q._dot_i8(xq, wq) * xs * ws + b
    want = Q._gelu_tanh(y) if mode == "gelu" else y.to(torch.bfloat16)
    torch.cuda.synchronize()
    ulps = _ulps(out, want, bits)
    print(f"{mode}: max {ulps} ulps, equal {float((out == want).float().mean()):.6f}")
    assert ulps <= 2.0


def _dot_exact(xq, wq):
    """The int8 dot at any K: integer products summed in f64, exact below
    2**53, rounded once to f32 as the kernel converts its int32 sums."""
    return torch.matmul(xq.double(), wq.double()).float()


@pytest.mark.parametrize("mode", ["f32", "res", "gelu", "bf16"])
@pytest.mark.parametrize("N", [97, 200, 1024, 3072])
@pytest.mark.parametrize("K", [16, 208, 1024, 4096])
@pytest.mark.parametrize("T", [1, 63, 300, 8224])
def test_gemm_matches_plain(dev, T, K, N, mode):
    """The GEMM alone, each epilogue mode, on the plain version's int8 rows,
    against Q._dot_i8(xq, wq) * xs * ws + b: T ragged against the 128-row
    tiles, N against the 128-column tiles and the 16-byte stores (97), K
    against the 128-deep k-blocks (16, 208). The plain f32 sums are exact at
    K <= 1024; at K = 4096 the reference takes the exact dot. f32 and
    residual bit-equal, GELU and bf16 within 2 ulps."""
    g = torch.Generator(device=dev).manual_seed(7 * T + 3 * K + N)
    xq, xs = Q._quant_rows(torch.randn((T, K), generator=g, device=dev))
    wq, ws = Q.quantize_weight(torch.randn((K, N), generator=g, device=dev) * 0.05)
    b = torch.randn((1, N), generator=g, device=dev) * 0.1
    res = torch.randn((T, N), generator=g, device=dev) if mode == "res" else None
    ls = torch.randn((1, N), generator=g, device=dev) * 0.3 if mode == "res" else None
    y = (Q._dot_i8(xq, wq) if K <= 1024 else _dot_exact(xq, wq)) * xs * ws + b
    code = dict(f32=Q._MODE_F32, res=Q._MODE_RES, gelu=Q._MODE_GELU, bf16=Q._MODE_BF16)[mode]
    out = torch.empty((T, N), dtype=torch.bfloat16 if mode == "bf16" else torch.float32,
                      device=dev)
    before = Q._gemm.launches[code]
    Q._gemm(xq, xs, wq, ws, b, out, code, res, ls)
    assert Q._gemm.launches[code] == before + 1
    torch.cuda.synchronize()
    if mode == "f32":
        assert torch.equal(out, y)
    elif mode == "res":
        assert torch.equal(out, res + y * ls)
    elif mode == "gelu":
        assert _ulps(out, Q._gelu_tanh(y), 24) <= 2.0
    else:
        assert _ulps(out, y.to(torch.bfloat16), 8) <= 2.0


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [16, 208, 1024, 4096])
def test_row_prologue_matches_plain(dev, K, dtype, ln):
    """The row prologue alone (one warp per row up to 256 vectors of 16
    bytes, one CTA per row above), T ragged against its 8 rows per CTA.
    Without LayerNorm the int8 rows and scales are equal (absmax takes no
    order); with it the mean's order may flip an int8 by one step, and the
    scales agree within 1e-6 relative."""
    T = 300
    x = _mk(dev, (T, K), 60 + K).to(dtype)
    g = _mk(dev, (1, K), 61).abs() + 0.5 if ln else None
    be = _mk(dev, (1, K), 62, 0.2) if ln else None
    before = Q._quantize_rows.launches
    xq, xs = Q._quantize_rows(x, g, be)
    assert Q._quantize_rows.launches == before + 1
    xf = x.float()
    pq, ps = Q._quant_rows(Q._ln(xf, g, be) if ln else xf)
    torch.cuda.synchronize()
    ps = ps.reshape(-1)
    if not ln:
        assert torch.equal(xq, pq) and torch.equal(xs, ps)
    else:
        assert int((xq.int() - pq.int()).abs().max()) <= 1
        assert float(((xs - ps).abs() / ps).max()) <= 1e-6


def test_qmm_bf16_input(dev):
    x = _mk(dev, (77, 128), 8).to(torch.bfloat16)
    wq, ws, b = _weight(dev, 128, 64, 9)
    assert torch.equal(Q.qmm(x, wq, ws, b), Q.qmm_plain(x, wq, ws, b))


@pytest.mark.parametrize("shape", [(257, 64, 256), (2 * 257 + 3, 1024, 4096)])
def test_qmm_mlp_matches_plain(dev, shape):
    T, C, Hd = shape
    x = _mk(dev, (T, C), 10)
    w1q, w1s, b1 = _weight(dev, C, Hd, 11)
    w2q, w2s, b2 = _weight(dev, Hd, C, 13)
    g, be, ls = _mk(dev, (1, C), 15).abs() + 0.5, _mk(dev, (1, C), 16, 0.2), _mk(dev, (1, C), 17, 0.3)
    args = (x, w1q, w1s, b1, w2q, w2s, b2, g, be, ls)
    before = (Q.qmm_mlp.launches, Q.qmm.launches)
    got = Q.qmm_mlp(*args)
    assert (Q.qmm_mlp.launches, Q.qmm.launches) == (before[0] + 1, before[1] + 1)
    want = Q.qmm_mlp_plain(*args)
    torch.cuda.synchronize()
    _assert_rel(got, want, MLP, x)


ATTN_SHAPES = [(3, 257, 128, 2, 0), (2, 264, 1024, 16, 7), (2, 50, 128, 2, 5),
               (1, 320, 64, 1, 0)]


def _attn_args(dev, B, Np, C, masked):
    x = _mk(dev, (B * Np, C), 20)
    qwq, qws, qb = _weight(dev, C, 3 * C, 21)
    pwq, pws, pb = _weight(dev, C, C, 23)
    g, be, ls = _mk(dev, (1, C), 25).abs() + 0.5, _mk(dev, (1, C), 26, 0.2), _mk(dev, (1, C), 27, 0.3)
    kb = torch.where(torch.arange(Np, device=dev) < Np - masked, 0.0, -1e9).reshape(1, Np)
    return (x, qwq, qws, qb, pwq, pws, pb, g, be, ls, kb)


@pytest.mark.parametrize("B,Np,C,H,masked", ATTN_SHAPES)
def test_attention_core_matches_plain(dev, B, Np, C, H, masked):
    """The attention core alone on the plain version's bf16 qkv."""
    x, qwq, qws, qb, _, _, _, g, be, _, kb = _attn_args(dev, B, Np, C, masked)
    qkv = Q.qmm_plain(x, qwq, qws, qb, g, be).to(torch.bfloat16)
    got = Q._attention(qkv, kb, B, H)
    want = Q.attention_plain(qkv, kb, B, H)
    torch.cuda.synchronize()
    _assert_rel(got, want, CORE)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("Np", [1, 17, 64, 65, 257, 320])
def test_attention_core_token_counts(dev, Np, masked):
    """The attention core at token counts on both sides of its 16-key and
    16-query blocks, with every third key masked or none."""
    B, C, H = 2, 128, 2
    keys = torch.arange(Np, device=dev)
    kb = torch.where((keys % 3 == 1) & masked, -1e9, 0.0).reshape(1, Np)
    x, qwq, qws, qb, _, _, _, g, be, _, _ = _attn_args(dev, B, Np, C, 0)
    qkv = Q.qmm_plain(x, qwq, qws, qb, g, be).to(torch.bfloat16)
    before = Q._attention.launches
    got = Q._attention(qkv, kb, B, H)
    assert Q._attention.launches == before + 1
    want = Q.attention_plain(qkv, kb, B, H)
    torch.cuda.synchronize()
    _assert_rel(got, want, CORE)


@pytest.mark.parametrize("B,Np,C,H,masked", ATTN_SHAPES)
def test_qmm_attn_block_matches_plain(dev, B, Np, C, H, masked):
    args = _attn_args(dev, B, Np, C, masked)
    before = Q.qmm_attn_block.launches
    got = Q.qmm_attn_block(*args, batch=B, num_heads=H)
    assert Q.qmm_attn_block.launches == before + 1
    want = Q.qmm_attn_block_plain(*args, batch=B, num_heads=H)
    torch.cuda.synchronize()
    _assert_rel(got, want, ATTN, args[0])


def test_padded_tokens_exact_on_the_card(dev):
    """A ViT block's attention on N = 257 tokens against the same tokens
    followed by 7 or 63 masked ones: the real rows are bit-equal (masked
    keys give exp = 0 exactly, and rows are independent)."""
    torch.manual_seed(0)
    vit = ViT(dataclasses.replace(VIT_CONFIGS["vit_tiny_test"], embed_dim=128))
    blk = v8.prepare_int8_params(vit.to(dev))["blocks"][0]
    B, N, C = 3, 257, 128
    x = _mk(dev, (B, N, C), 30)
    args = [blk[k] for k in ("qkv_wq", "qkv_ws", "qkv_b", "proj_wq", "proj_ws", "proj_b",
                             "n1g", "n1b")] + [torch.full_like(blk["ls1"], 0.3)]
    base = Q.qmm_attn_block(x.reshape(B * N, C), *args, torch.zeros((1, N), device=dev),
                            batch=B, num_heads=2).reshape(B, N, C)
    for pad in (7, 63):
        xp = torch.cat([x, _mk(dev, (B, pad, C), 31)], dim=1).reshape(B * (N + pad), C)
        kb = torch.where(torch.arange(N + pad, device=dev) < N, 0.0, -1e9).reshape(1, N + pad)
        got = Q.qmm_attn_block(xp, *args, kb, batch=B, num_heads=2).reshape(B, N + pad, C)
        assert torch.equal(got[:, :N], base), pad


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = _mk(dev, (8, 64), 40)
    wq, ws, b = _weight(dev, 64, 32, 41)
    bad = [
        (dict(x=x.to(torch.float16)), TypeError),
        (dict(wq=wq.to(torch.int32)), TypeError),
        (dict(ws=ws.cpu()), ValueError),  # device
        (dict(x=_mk(dev, (64, 8), 40).t()), ValueError),  # non-contiguous x
        (dict(wq=wq.contiguous()), ValueError),  # row-major weight
        (dict(bias=b.reshape(-1)), ValueError),  # shape
    ]
    for change, exc in bad:
        kw = dict(x=x, wq=wq, ws=ws, bias=b)
        kw.update(change)
        with pytest.raises(exc):
            Q.qmm(**kw)
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.qmm(_mk(dev, (8, 40), 42), *_weight(dev, 40, 32, 43))
    with pytest.raises(ValueError, match="at most"):  # the prologue's row in registers
        Q.qmm(_mk(dev, (2, Q.MAX_WIDTH + 16), 53), *_weight(dev, Q.MAX_WIDTH + 16, 16, 54))
    # views that start inside a 16-byte block: TMA and the 16-byte row loads
    # take none; an int8 weight one byte in, and x one float in
    wq_off = torch.empty(64 * 32 + 1, dtype=torch.int8, device=dev)[1:].view(32, 64).t()
    x_off = torch.empty(8 * 64 + 1, device=dev)[1:].view(8, 64)
    assert wq_off.t().is_contiguous() and x_off.is_contiguous()
    for kw in (dict(wq=wq_off.copy_(wq)), dict(x=x_off.copy_(x))):
        args = dict(x=x, wq=wq, ws=ws, bias=b)
        args.update(kw)
        with pytest.raises(ValueError, match="16-byte aligned"):
            Q.qmm(**args)
    with pytest.raises(ValueError, match="pairs"):
        Q.qmm(x, wq, ws, b, ln_gamma=_mk(dev, (1, 64), 44))
    C = 96  # hd = 48: the kernel takes hd = 64 only
    qwq, qws, qb = _weight(dev, C, 3 * C, 45)
    pwq, pws, pb = _weight(dev, C, C, 46)
    vec = _mk(dev, (1, C), 47)
    with pytest.raises(ValueError, match="head width"):
        Q.qmm_attn_block(_mk(dev, (10, C), 48), qwq, qws, qb, pwq, pws, pb, vec, vec, vec,
                         torch.zeros((1, 10), device=dev), batch=1, num_heads=2)
    x_long = _mk(dev, (321, 64), 49)
    qwq, qws, qb = _weight(dev, 64, 192, 50)
    pwq, pws, pb = _weight(dev, 64, 64, 51)
    vec = _mk(dev, (1, 64), 52)
    with pytest.raises(ValueError, match="tokens"):
        Q.qmm_attn_block(x_long, qwq, qws, qb, pwq, pws, pb, vec, vec, vec,
                         torch.zeros((1, 321), device=dev), batch=1, num_heads=1)
