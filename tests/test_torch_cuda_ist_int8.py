"""The int8 convolution kernels (csrc/qconv.cu) against their plain PyTorch
versions (ops/qconv.py), on the GPU.

Marked `cuda`: each test skips where torch.cuda.is_available() is false (the
decision is taken in the fixture, never at import). Imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ist_int8.py -q

Tolerance: none. The absmax is a maximum and the scale one IEEE division;
the quantizer divides, rounds half to even and clips as the plain version
does; the convolution sums integers exactly (int32 on the card, f64 in the
plain version) and rounds the int32 -> f32 conversion, the scale product,
the product, the bias and the residual sums each on its own, and its int8
output (out_scale) quantizes that as the quantizer does. So every output
is bit-equal, on odd shapes: H and W not multiples of a tile, M not a
multiple of the 128-row tile (tiles across images), both routes of the
im2col tile (16-byte gathers; TMA windows where C is a multiple of 128),
the stem's C = 3 and
C = 24 (padded to 16 and 32 channels of zero codes), O not a multiple of
the N tile and not of 4 (element stores), each N tile (128, 192, 256, as
ops/qconv.n_tile picks them), C = 192 (k-blocks across two taps), stride 2
with padding, B = 1, and a static scale small enough to clip.
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


def _conv_args(dev, B, H, W, C, O, ks, stride, pad, residual, static, seed):
    """x, its scale and codes, and a random weight, ws, bias and residual."""
    rng = np.random.default_rng(seed)
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
    return xq, sx, wq, ws, b, res


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


def _around(v: torch.Tensor, steps: int = 4) -> torch.Tensor:
    """v and its neighbours up to `steps` floats away on either side."""
    out, up, down = [v], v, v
    for _ in range(steps):
        up, down = torch.nextafter(up, up + 1), torch.nextafter(down, down - 1)
        out += [up, down]
    return torch.cat(out)


@pytest.mark.parametrize("scale", [0.37, 1.0, 3.1e-3, 1e-12])
def test_quantize_near_midpoints_bit_equal(dev, scale):
    """Values at, and a few floats around, (k + 1/2) * s and k * s for every
    code k, zeros of both signs, values that clip and non-finite ones: the
    quantizer's product with 1 / s decides only away from the midpoints,
    and gives the IEEE quotient's codes everywhere."""
    s = torch.tensor(scale, dtype=torch.float32)
    k = torch.arange(-130, 131, dtype=torch.float32)
    x = torch.cat([_around(torch.cat([(k + 0.5) * s, k * s])),
                   torch.tensor([0.0, -0.0, 1e30, -1e30, np.inf, -np.inf])])
    x = torch.nn.functional.pad(x, (0, -x.numel() % 64)).reshape(1, 1, -1, 64).to(dev)
    _equal(QC.quantize_act(x, s.to(dev)), QC.quantize_act_plain(x, s.to(dev)),
           "quantize near midpoints")


@pytest.mark.parametrize("so", [2.0, 2.0 * (1 + 2.0 ** -21), 2.0 * (1 - 2.0 ** -21), 0.37])
def test_qconv_int8_output_near_midpoints_bit_equal(dev, so):
    """qconv's int8 epilogue rounds with the quantizer's function: a 1x1
    identity conv (sx = ws = 1, b = 0) outputs every code -127..127 exactly,
    and an output scale of 2 puts half of them on midpoints (ties to even),
    2 (1 +- 2^-21) a hair beside them."""
    codes = torch.arange(-127, 128, dtype=torch.int8).repeat(2)[:448].reshape(1, 7, 1, 64)
    codes = codes.to(dev)
    eye = torch.eye(64, dtype=torch.int8, device=dev)
    one = torch.ones((), device=dev)
    so = torch.tensor(so, dtype=torch.float32, device=dev)
    got = QC.qconv(codes, one, eye, torch.ones(64, device=dev), torch.zeros(64, device=dev), 1, 0,
                   out_scale=so)
    y = QC.qconv_plain(codes, one, eye, torch.ones(64, device=dev), torch.zeros(64, device=dev),
                       1, 0)
    assert torch.equal(y.flatten()[:255], torch.arange(-127, 128, dtype=torch.float32, device=dev))
    _equal(got, QC.quantize_act_plain(y, so), "qconv int8 output near midpoints")


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
    xq, sx, wq, ws, b, res = _conv_args(dev, B, H, W, C, O, ks, stride, pad, residual, static,
                                        B * H * W + C + O)
    before = QC.qconv.launches
    got = QC.qconv(xq, sx, wq, ws, b, stride, pad, res, relu)
    assert QC.qconv.launches == before + 1
    want = QC.qconv_plain(xq, sx, wq, ws, b, stride, pad, res, relu)
    _equal(got, want, "qconv")
    assert float(got.abs().max()) > 0


# (B, H, W, C, O, kernel, stride, pad, residual, relu, the N tile n_tile picks)
TILES = [
    (2, 33, 31, 128, 128, 3, 1, 1, True, True, 128),  # M = 2046: tiles across images
    (2, 40, 36, 192, 192, 3, 1, 1, True, True, 192),  # C = 192: k-blocks across taps
    (1, 20, 20, 96, 384, 1, 1, 0, False, False, 192),  # two 192-wide tiles
    (3, 66, 62, 64, 256, 3, 1, 1, False, True, 256),  # M = 12276: 96 tiles; K = 4.5 k-blocks
    (2, 128, 96, 64, 512, 3, 2, 1, True, True, 256),  # stride 2, pad 1: 48 x 2 tiles
    (2, 9, 11, 32, 30, 3, 1, 1, True, True, 128),  # O = 30: element stores
]


@pytest.mark.parametrize("B,H,W,C,O,ks,stride,pad,residual,relu,tile", TILES)
def test_qconv_n_tiles_bit_equal(dev, B, H, W, C, O, ks, stride, pad, residual, relu, tile):
    xq, sx, wq, ws, b, res = _conv_args(dev, B, H, W, C, O, ks, stride, pad, residual, False,
                                        H * W + C + O)
    OH, OW = QC.out_size(H, ks, stride, pad), QC.out_size(W, ks, stride, pad)
    assert QC.n_tile(B * OH * OW, O) == tile
    got = QC.qconv(xq, sx, wq, ws, b, stride, pad, res, relu)
    _equal(got, QC.qconv_plain(xq, sx, wq, ws, b, stride, pad, res, relu), f"qconv, N tile {tile}")


# (B, H, W, C, O, kernel, stride, pad, residual, relu, int8 output, route, window columns)
WINDOWS = [
    (2, 32, 32, 128, 128, 3, 1, 1, True, True, False, "tma", 32),  # 4 x 32 windows
    (1, 8, 256, 256, 192, 3, 1, 1, False, True, True, "tma", 128),  # 1 x 128 of 256 columns
    (2, 64, 64, 128, 192, 3, 2, 1, False, True, False, "tma", 32),  # stride 2
    (1, 16, 16, 512, 256, 1, 1, 0, False, False, True, "tma", 16),  # the out conv's 8 x 16
    (1, 16, 8, 256, 128, 3, 1, 1, True, True, False, "tma", 8),  # its pair lies past the image
    (2, 32, 32, 256, 512, 3, 2, 1, True, True, True, "tma", 16),  # stride 2, two N tiles
    # window tiles over C not a multiple of 128: the gather
    (2, 16, 64, 192, 192, 3, 1, 1, True, True, True, "gather", 0),  # C = 192: 2 x 64 windows
    (2, 64, 64, 192, 256, 3, 2, 1, False, True, False, "gather", 0),  # C = 192, stride 2
    (1, 64, 256, 3, 128, 7, 2, 3, False, True, True, "gather", 0),  # the stem: 16 channels
    (2, 32, 32, 64, 96, 1, 1, 0, False, False, False, "gather", 0),  # K = 64: half a k-block
    (1, 16, 8, 48, 40, 3, 1, 1, True, True, False, "gather", 0),  # its pair past the image
]


@pytest.mark.parametrize("B,H,W,C,O,ks,stride,pad,residual,relu,q8,route,cols", WINDOWS)
def test_qconv_window_routes_bit_equal(dev, B, H, W, C, O, ks, stride, pad, residual, relu, q8,
                                       route, cols):
    """Tiles that are windows of one image: where C is a multiple of 128 the
    im2col tile comes by TMA from the input's 4-D tensor map (zeros in the
    padding and past the last image), else by the gather; bit-equal, also
    with int8 output."""
    xq, sx, wq, ws, b, res = _conv_args(dev, B, H, W, C, O, ks, stride, pad, residual, True,
                                        2 * H * W + C + O)
    OH, OW = QC.out_size(H, ks, stride, pad), QC.out_size(W, ks, stride, pad)
    assert QC.im2col_route(QC.padded_channels(C), OH, OW, stride) == (route, cols)
    want = QC.qconv_plain(xq, sx, wq, ws, b, stride, pad, res, relu)
    so = torch.tensor(float(want.abs().max()) * 0.6 / 127.0, dtype=torch.float32, device=dev) \
        if q8 else None
    got = QC.qconv(xq, sx, wq, ws, b, stride, pad, res, relu, out_scale=so)
    _equal(got, want if so is None else QC.quantize_act_plain(want, so), f"qconv, {route}")


def test_qconv_gather_route_on_the_odd_shapes():
    """The odd shapes of CONVS and TILES take the 16-byte gather (tiles
    across images, windows that do not tile), so both routes are held to
    the plain version."""
    for B, H, W, C, O, ks, stride, pad, *_ in CONVS + [t[:10] for t in TILES]:
        OH, OW = QC.out_size(H, ks, stride, pad), QC.out_size(W, ks, stride, pad)
        assert QC.im2col_route(QC.padded_channels(C), OH, OW, stride) == ("gather", 0)


# (B, H, W, C, O, kernel, stride, pad, residual, relu): the IST's conv1 and others
OUT_SCALE = [
    (2, 33, 31, 128, 128, 3, 1, 1, False, True),
    (2, 40, 36, 192, 192, 3, 2, 1, False, True),
    (3, 64, 64, 64, 256, 3, 1, 1, False, False),
    (2, 17, 15, 128, 512, 3, 1, 1, True, False),
    (1, 37, 29, 3, 40, 7, 2, 3, False, True),  # the stem's C, padded
    (2, 9, 11, 32, 30, 3, 1, 1, True, True),  # element stores
]


@pytest.mark.parametrize("B,H,W,C,O,ks,stride,pad,residual,relu", OUT_SCALE)
def test_qconv_int8_output_bit_equal(dev, B, H, W, C, O, ks, stride, pad, residual, relu):
    """qconv(..., out_scale=so) == quantize_act_plain(qconv_plain(...), so),
    with a scale small enough that a part of the codes clips."""
    xq, sx, wq, ws, b, res = _conv_args(dev, B, H, W, C, O, ks, stride, pad, residual, True,
                                        3 * H * W + C + O)
    y = QC.qconv_plain(xq, sx, wq, ws, b, stride, pad, res, relu)
    so = torch.tensor(float(y.abs().max()) * 0.6 / 127.0, dtype=torch.float32, device=dev)
    before = QC.qconv.launches, QC.quantize_act.launches
    got = QC.qconv(xq, sx, wq, ws, b, stride, pad, res, relu, out_scale=so)
    assert (QC.qconv.launches, QC.quantize_act.launches) == (before[0] + 1, before[1])
    _equal(got, QC.quantize_act_plain(y, so), "qconv, int8 output")
    assert int((got.abs() == 127).sum()) > 0 and int((got != 0).sum()) > 0
    if not relu:
        assert int((got < 0).sum()) > 0


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
    with pytest.raises(ValueError, match="one static scale"):
        QC.qconv(xq, f(1), wq, f(16), f(16), 1, 1, out_scale=f(2))


def test_tiny_int8_ist_on_the_card_equals_the_cpu(dev):
    """The tiny int8 IST (dynamic, then static scales, whose blocks' conv1
    write int8) on the card against the same module on the CPU, where every
    wrapper runs its plain version: each step rounds alike, so the features
    are equal."""
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
