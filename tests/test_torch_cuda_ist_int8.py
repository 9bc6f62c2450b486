"""The int8 convolution kernels (csrc/qconv.cu) against their plain PyTorch
versions (ops/qconv.py), on the GPU.

Marked `cuda`: each test skips where torch.cuda.is_available() is false (the
decision is taken in the fixture, never at import). Imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ist_int8.py -q

Tolerance: none. The absmax is a maximum and the scale one IEEE division;
the quantizer divides, rounds half to even and clips as the plain version
does; the convolution sums integers exactly (int32 on the card, f64 in the
plain version) and rounds the int32 -> f32 conversion, the scale product,
the product, the bias and the residual sums each on its own. So every
output is bit-equal, on odd shapes: H and W not multiples of a tile, the
stem's K = 147, channels that take the byte-gather path (C not a multiple
of 64) and the 16-byte path, O not a multiple of the 128-wide tile, B = 1,
and a static scale small enough to clip.
"""

import copy

import numpy as np
import pytest
import torch

from gigapose_tpu_torch.models import ist_int8 as T8
from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
from gigapose_tpu_torch.ops import qconv as QC

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda", 0)


def _x(dev, shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape) * rng.uniform(0.3, 4.0, (shape[0], 1, 1, 1))
    return torch.as_tensor(a.astype(np.float32), device=dev)


def _equal(got, want, what):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert torch.equal(got, want), f"{what}: {int((got != want).sum())} values differ"


@pytest.mark.parametrize("shape", [(1, 37, 29, 3), (3, 13, 11, 3), (2, 17, 9, 64),
                                   (5, 8, 8, 24), (32, 16, 16, 512)])
def test_act_scale_and_quantize_bit_equal(dev, shape):
    x = _x(dev, shape, sum(shape))
    before = QC.act_scale.launches, QC.quantize_act.launches
    s = QC.act_scale(x)
    _equal(s, QC.act_scale_plain(x), "act_scale")
    _equal(QC.quantize_act(x, s), QC.quantize_act_plain(x, s), "quantize, per image")
    # a static scale small enough that a part of the values clips at +-127
    sa = torch.tensor(float(x.abs().max()) * 0.4 / 127.0, dtype=torch.float32, device=dev)
    q = QC.quantize_act(x, sa)
    _equal(q, QC.quantize_act_plain(x, sa), "quantize, static")
    assert int((q.abs() == 127).sum()) > 0
    assert (QC.act_scale.launches, QC.quantize_act.launches) == (before[0] + 1, before[1] + 2)


# (B, H, W, C, O, kernel, stride, pad, residual, relu)
CONVS = [
    (1, 37, 29, 3, 40, 7, 2, 3, False, True),  # the stem: K = 147, byte gather
    (2, 19, 17, 64, 96, 3, 1, 1, True, True),  # 16-byte path, O < 128
    (3, 19, 17, 64, 200, 3, 2, 1, False, True),  # O across two column tiles
    (2, 15, 13, 128, 192, 1, 2, 0, False, False),  # a 1x1 down conv
    (1, 9, 7, 24, 20, 3, 1, 1, True, True),  # byte gather, C = 24
    (2, 5, 6, 512, 256, 1, 1, 0, False, False),  # the out conv's width
    (4, 16, 16, 256, 512, 3, 2, 1, False, True),  # layer4's stride-2 conv, K = 2304
]


@pytest.mark.parametrize("B,H,W,C,O,ks,stride,pad,residual,relu", CONVS)
@pytest.mark.parametrize("static", [False, True])
def test_qconv_bit_equal(dev, B, H, W, C, O, ks, stride, pad, residual, relu, static):
    rng = np.random.default_rng(B * H * W + C + O)
    x = _x(dev, (B, H, W, C), C + O)
    sx = (torch.tensor(float(x.abs().max()) * 0.5 / 127.0, dtype=torch.float32, device=dev)
          if static else QC.act_scale(x))
    xq = QC.quantize_act(x, sx)
    wq = torch.as_tensor(rng.integers(-127, 128, (O, ks * ks * C)).astype(np.int8), device=dev)
    ws = torch.as_tensor(rng.uniform(1e-3, 2e-2, O).astype(np.float32), device=dev)
    b = torch.as_tensor(rng.normal(size=O).astype(np.float32), device=dev)
    OH, OW = QC.out_size(H, ks, stride, pad), QC.out_size(W, ks, stride, pad)
    res = torch.as_tensor(rng.normal(size=(B, OH, OW, O)).astype(np.float32), device=dev) \
        if residual else None
    before = QC.qconv.launches
    got = QC.qconv(xq, sx, wq, ws, b, stride, pad, res, relu)
    assert QC.qconv.launches == before + 1
    want = QC.qconv_plain(xq, sx, wq, ws, b, stride, pad, res, relu)
    _equal(got, want, "qconv")
    assert float(got.abs().max()) > 0


def test_qconv_refuses_what_it_does_not_take(dev):
    xq = torch.zeros((1, 8, 8, 64), dtype=torch.int8, device=dev)
    wq = torch.zeros((16, 9 * 64), dtype=torch.int8, device=dev)
    f = lambda n: torch.ones(n, device=dev)
    with pytest.raises(ValueError, match="square kernel"):
        QC.qconv(xq, f(1), wq[:, :-64], f(16), f(16), 1, 1)
    with pytest.raises(TypeError):
        QC.qconv(xq.float(), f(1), wq, f(16), f(16), 1, 1)
    with pytest.raises(ValueError, match="one per image"):
        QC.qconv(xq, f(3), wq, f(16), f(16), 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        QC.qconv(xq, f(1), wq.t().contiguous().t(), f(16), f(16), 1, 1)


def test_tiny_int8_ist_on_the_card_equals_the_cpu(dev):
    """The tiny int8 IST (dynamic, then static scales) on the card against
    the same module on the CPU, where every wrapper runs its plain version:
    each step rounds alike, so the features are equal."""
    torch.manual_seed(0)
    net = ISTNet(ISTBackbone(initial_dim=16, block_dims=(16, 16, 24, 32), descriptor_size=32),
                 Regressor(64, hidden_dim=32)).eval()
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 2.0)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 3, 224, 224)).astype(np.float32))
    q_cpu = T8.ISTNetInt8.from_ist_net(net).eval()
    q_dev = T8.ISTNetInt8.from_ist_net(copy.deepcopy(net).to(dev)).eval()
    with torch.no_grad():
        _equal(q_dev.features(x.to(dev)).cpu(), q_cpu.features(x), "dynamic features")
        q_cpu.calibrate(x[:2], margin=1.1)
        q_dev.calibrate(x[:2].to(dev), margin=1.1)
        _equal(q_dev.features(x.to(dev)).cpu(), q_cpu.features(x), "static features")
