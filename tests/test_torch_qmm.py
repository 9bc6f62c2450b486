"""Port int8 matmul ops (gigapose_tpu_torch/ops/qmm.py) == JAX ops/qmm.py.

The same numpy inputs go through the JAX Pallas kernels in interpret mode,
the JAX plain references (qmm_ref, qmm_mlp_ref, qmm_attn_block_ref) and the
port's wrappers on CPU tensors (which run the plain versions), with the same
int8 weights.

Tolerances:
- quantize_weight: wq and ws exact (IEEE division, round half to even);
- without LayerNorm: exact against qmm_ref (the row quantization is exact
  arithmetic, and the f32 sums of integer products below 2**24 are exact in
  any order); the interpreted kernel differs by 1 ulp (XLA's fused epilogue);
- with LayerNorm, the MLP and the attention block: atol 1e-5. The LN means,
  the softmax sums and the attention products are summed in another order,
  which moves values by ulps. One int8 that flips a step would move an
  output by xs * ws * |wq| ~ 1e-3 here, so the bound also asserts that no
  quantized value flips on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapose_tpu.ops import qmm as J
from gigapose_tpu_torch.ops import qmm as Q

ATOL = 1e-5


def _mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _wq(a):
    """A JAX (K, N) int8 weight -> the port's K-contiguous (K, N) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).T)).t()


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_quantize_weight_matches_jax():
    w = _mk((64, 96), 1, 0.05)
    jwq, jws = J.quantize_weight(jnp.asarray(w))
    wq, ws = Q.quantize_weight(torch.from_numpy(w))
    assert wq.dtype == torch.int8 and wq.shape == (64, 96) and ws.shape == (1, 96)
    assert wq.t().is_contiguous()  # the layout the GEMM reads
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    assert int(wq.abs().max()) == 127


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("res", [False, True])
def test_qmm_plain_matches_jax(ln, res):
    T, K, N = 48, 64, 96  # T is not a multiple of the JAX kernel's block
    x = _mk((T, K), 2)
    w = _mk((K, N), 3, 0.05)
    jwq, jws = J.quantize_weight(jnp.asarray(w))
    b = _mk((1, N), 4, 0.1)
    g = np.abs(_mk((1, K), 5)) + 0.5 if ln else None
    be = _mk((1, K), 6, 0.2) if ln else None
    r = _mk((T, N), 14) if res else None
    ls = _mk((1, N), 15, 0.1) if res else None
    jargs = (_j(x), jwq, jws, _j(b), _j(g), _j(be), _j(r), _j(ls))
    ref = np.asarray(J.qmm_ref(*jargs))
    interp = np.asarray(J.qmm(*jargs, block_t=32, interpret=True))
    before = Q.qmm.launches
    got = Q.qmm(_t(x), _wq(jwq), _t(jws), _t(b), _t(g), _t(be), _t(r), _t(ls))
    assert Q.qmm.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and got.shape == (T, N)
    if ln:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(got.numpy(), interp, rtol=0, atol=ATOL)


def test_qmm_mlp_plain_matches_jax():
    T, C, Hd = 40, 64, 256
    x = _mk((T, C), 7)
    w1q, w1s = J.quantize_weight(jnp.asarray(_mk((C, Hd), 8, 0.05)))
    w2q, w2s = J.quantize_weight(jnp.asarray(_mk((Hd, C), 10, 0.05)))
    b1, b2 = _mk((1, Hd), 9, 0.1), _mk((1, C), 11, 0.1)
    g, be = np.abs(_mk((1, C), 12)) + 0.5, _mk((1, C), 13, 0.2)
    ls = _mk((1, C), 16, 0.1)
    jargs = (_j(x), w1q, w1s, _j(b1), w2q, w2s, _j(b2), _j(g), _j(be), _j(ls))
    ref = np.asarray(J.qmm_mlp_ref(*jargs))
    interp = np.asarray(J.qmm_mlp(*jargs, block_t=32, interpret=True))
    got = Q.qmm_mlp(_t(x), _wq(w1q), _t(w1s), _t(b1), _wq(w2q), _t(w2s), _t(b2),
                    _t(g), _t(be), _t(ls)).numpy()
    for want in (ref, interp):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the MLP branch is visible: ls * y moves x by O(0.1)
    assert np.abs(got - x).max() > 0.05


def test_gelu_tanh_matches_jax():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(Q._gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(J._gelu_tanh(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_qmm_attn_block_plain_matches_jax():
    B, Np, C, H = 2, 24, 64, 2
    T = B * Np
    x = _mk((T, C), 20)
    qwq, qws = J.quantize_weight(jnp.asarray(_mk((C, 3 * C), 21, 0.05)))
    pwq, pws = J.quantize_weight(jnp.asarray(_mk((C, C), 23, 0.05)))
    qb, pb = _mk((1, 3 * C), 22, 0.1), _mk((1, C), 24, 0.1)
    g, be = np.abs(_mk((1, C), 25)) + 0.5, _mk((1, C), 26, 0.2)
    ls = _mk((1, C), 27, 0.1)
    # the last 4 tokens of each element are padding: masked keys
    kb = np.where(np.arange(Np) < Np - 4, 0.0, -1e9).astype(np.float32).reshape(1, Np)
    jargs = (_j(x), qwq, qws, _j(qb), pwq, pws, _j(pb), _j(g), _j(be), _j(ls), _j(kb))
    ref = np.asarray(J.qmm_attn_block_ref(*jargs, batch=B, num_heads=H))
    interp = np.asarray(J.qmm_attn_block(*jargs, batch=B, num_heads=H, interpret=True))
    targs = (_t(x), _wq(qwq), _t(qws), _t(qb), _wq(pwq), _t(pws), _t(pb), _t(g), _t(be),
             _t(ls), _t(kb))
    got = Q.qmm_attn_block(*targs, batch=B, num_heads=H).numpy()
    for want in (ref, interp):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # masked keys never reach a real row: changing the padded tokens' values
    # leaves the real rows unchanged
    x2 = x.copy().reshape(B, Np, C)
    x2[:, Np - 4:] = _mk((B, 4, C), 28, 10.0)
    got2 = Q.qmm_attn_block(_t(x2.reshape(T, C)), *targs[1:], batch=B, num_heads=H).numpy()
    real = (np.arange(T) % Np) < Np - 4
    np.testing.assert_array_equal(got2[real], got[real])


def test_wrappers_refuse_other_devices_and_shapes():
    x = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        Q.qmm(x, x, x, x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        Q.qmm_mlp(x, *([x] * 9))
    with pytest.raises(ValueError, match=r"\(T, K\)"):
        Q.qmm(torch.zeros(16), *([torch.zeros(1)] * 3))
