"""Int8 (W8A8) serving forward of the IST ResNet backbone (port of
gigapose_tpu/models/ist_int8.py).

Weights are quantized once from the float backbone, per output channel,
with the inference BatchNorm affine folded into the dequantization scale
and bias (`prepare_int8_ist_params`). Activations are quantized before
every convolution, with a per-image scale (dynamic) or with one scale per
convolution calibrated on serving images (static, `attach_static_act_scales`;
`ISTNetInt8.calibrate`, which template onboarding calls). Every convolution
runs through ops/qconv.py: `act_scale` (dynamic only), `quantize_act` and
`qconv`, whose epilogue fuses the dequantization, the folded BatchNorm, the
block's residual and its ReLU. The default backbone has 21 convolutions:
the stem, 2 or 3 per BasicBlock (the stride-2 blocks' 1x1 down
convolution), and the 1x1 out convolution. With per-image scales a forward
makes 21 launches of each kernel. With static scales it makes no
`act_scale`, and each block's conv1 quantizes its own output with conv2's
scale in its epilogue (`qconv(..., out_scale=)`: the same codes as
`quantize_act` of the f32 output), so 21 `qconv` and 13 `quantize_act` on
the default backbone's 8 blocks.

Parameter tree: the JAX package's, key for key ({"conv1", "layers": [per
block {"conv1", "conv2", ["down"]}], "out"}, each {"wq", "ws", "b", ["sa"]}),
except that `wq` is (O, KH*KW*I) int8, K-contiguous, where JAX keeps an HWIO
kernel (models/convert.ist_int8_params_flax_to_torch carries the JAX tree
across). Strides are not stored: they follow from a block's position, as
in JAX.

Inference only: a module in training mode raises. `num_attn_heads > 0` (the
SpatialTransformer stages) raises NotImplementedError, as in JAX.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from gigapose_tpu_torch.models.ist_net import (
    ISTBackbone,
    ISTNet,
    align_corners_points,
    resize_bilinear_align_corners,
)
from gigapose_tpu_torch.models.vit_int8 import _Buffers
from gigapose_tpu_torch.ops import qconv as QC

STAGE_STRIDES = (1, 2, 2, 2)
_EPS = 1e-12


def _quantize_conv_weight(w: torch.Tensor):
    """OIHW float -> (int8 (O, KH*KW*I) in (kh, kw, i) order, f32 (O,)
    scales), symmetric per output channel, on the CPU."""
    k = w.detach().to(torch.device("cpu"), torch.float32).permute(0, 2, 3, 1)
    s = torch.clamp(QC._div127(k.abs().amax(dim=(1, 2, 3))), min=_EPS)
    q = torch.clamp(torch.round(k / s[:, None, None, None]), -127, 127).to(torch.int8)
    return q.reshape(q.shape[0], -1).contiguous(), s


def _fold_bn(bn: nn.BatchNorm2d):
    """Inference BatchNorm -> per-channel (s, b): y = s * x + b."""
    cpu = lambda t: t.detach().to(torch.device("cpu"), torch.float32)
    # the correctly rounded f32 square root, as numpy's (an f64 root rounded
    # once is; torch's f32 CPU root is at times 1 ulp off)
    root = torch.sqrt((cpu(bn.running_var) + bn.eps).double()).float()
    s = cpu(bn.weight) / root
    return s, cpu(bn.bias) - cpu(bn.running_mean) * s


def prepare_int8_ist_params(backbone: nn.Module) -> dict:
    """Port ISTBackbone (or ISTNet) -> int8 serving tree of its backbone, on
    the backbone's device (the regressor MLPs stay float)."""
    bb: ISTBackbone = getattr(backbone, "backbone", backbone)
    if bb.num_attn_heads:
        raise NotImplementedError("int8 IST serving supports the shipped attention-free config")
    dev = bb.conv1.weight.device

    def conv_bn(conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d]) -> dict:
        wq, ws = _quantize_conv_weight(conv.weight)
        if bn is None:
            b = torch.zeros_like(ws)
        else:
            s, b = _fold_bn(bn)
            ws = ws * s  # the BN scale folded into the dequantization scale
        return {"wq": wq.to(dev), "ws": ws.to(dev), "b": b.to(dev)}

    out = {"conv1": conv_bn(bb.conv1, bb.bn1), "layers": []}
    for i in range(1, 5):
        for blk in getattr(bb, f"layer{i}"):
            layer = {"conv1": conv_bn(blk.conv1, blk.bn1), "conv2": conv_bn(blk.conv2, blk.bn2)}
            if blk.downsample is not None:
                layer["down"] = conv_bn(blk.downsample[0], blk.downsample[1])
            out["layers"].append(layer)
    out["out"] = conv_bn(bb.layer4_outconv, None)
    return out


def _quant(x: torch.Tensor, layer: dict, collect: Optional[list]):
    """Quantize a conv's f32 NHWC input: its static scale "sa" if the layer
    has one, else the per-image scale. `collect` (calibration) gets the
    input's absmax."""
    if collect is not None:
        collect.append(x.abs().amax())
    sx = layer.get("sa")
    if sx is None:
        sx = QC.act_scale(x)
    return QC.quantize_act(x, sx), sx


def _conv(q, layer: dict, stride: int, pad: int, residual=None, relu: bool = False,
          out_scale=None):
    xq, sx = q
    return QC.qconv(xq, sx, layer["wq"], layer["ws"], layer["b"], stride, pad, residual, relu,
                    out_scale)


def ist_features_int8(qp: dict, images: torch.Tensor, input_size: int = 256,
                      _collect: Optional[list] = None) -> torch.Tensor:
    """(B, 3, H, W) -> (B, P, C) stride-16 descriptors, the ISTBackbone
    contract. Quantization happens in JAX's call order (conv1; per block
    conv1, conv2, down; out); the down convolution runs before conv2, whose
    epilogue adds it as the residual. Where conv2 has a static scale (and
    no calibration collects absmaxes), conv1's epilogue quantizes for it."""
    # at JAX's sample points: a quantizer turns an ulp of difference into a step
    x = resize_bilinear_align_corners(images.to(torch.float32), (input_size, input_size),
                                      align_corners_points)
    x = x.permute(0, 2, 3, 1).contiguous()  # NHWC
    x = _conv(_quant(x, qp["conv1"], _collect), qp["conv1"], 2, 3, relu=True)
    for idx, blk in enumerate(qp["layers"]):
        # only the first block of a stage strides
        stride = STAGE_STRIDES[idx // 2] if idx % 2 == 0 else 1
        q1 = _quant(x, blk["conv1"], _collect)
        so = blk["conv2"].get("sa") if _collect is None else None
        if so is not None:  # conv2's static scale: its int8 input from conv1's epilogue
            yq = (_conv(q1, blk["conv1"], stride, 1, relu=True, out_scale=so), so)
        else:
            yq = _quant(_conv(q1, blk["conv1"], stride, 1, relu=True), blk["conv2"], _collect)
        if "down" in blk:
            x = _conv(_quant(x, blk["down"], _collect), blk["down"], stride, 0)
        x = _conv(yq, blk["conv2"], 1, 1, residual=x, relu=True)
    x = _conv(_quant(x, qp["out"], _collect), qp["out"], 1, 0)
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C)


def ist_act_absmax(qp: dict, images: torch.Tensor, input_size: int = 256) -> List[float]:
    """Calibration pass: each conv's input absmax over `images`, in the
    order attach_static_act_scales consumes, from the quantized forward
    itself (so deep layers see the serving distribution)."""
    collected: list = []
    ist_features_int8(qp, images, input_size, _collect=collected)
    return [float(a) for a in collected]


def _num_convs(qp: dict) -> int:
    return 2 + sum(len(blk) for blk in qp["layers"])


def attach_static_act_scales(qp: dict, absmaxes: List[float], margin: float = 1.0) -> dict:
    """The tree with static activation scales "sa" = max(absmax * margin /
    127, 1e-12) (computed in Python floats, rounded once to f32) in forward
    order (conv1; per block conv1, conv2, down; out). margin > 1 leaves
    headroom above the calibration absmax before the int8 clip bites. A list
    of another length than the tree's convolutions raises ValueError."""
    absmaxes = list(absmaxes)
    if len(absmaxes) != _num_convs(qp):
        raise ValueError(f"{len(absmaxes)} calibration absmaxes for the tree's "
                         f"{_num_convs(qp)} convolutions")
    it = iter(absmaxes)

    def nxt(layer: dict) -> dict:
        sa = max(float(next(it)) * margin / 127.0, _EPS)
        return {**layer, "sa": torch.tensor(sa, dtype=torch.float32, device=layer["wq"].device)}

    out = {"conv1": nxt(qp["conv1"]), "layers": []}
    for blk in qp["layers"]:
        b = {"conv1": nxt(blk["conv1"]), "conv2": nxt(blk["conv2"])}
        if "down" in blk:
            b["down"] = nxt(blk["down"])
        out["layers"].append(b)
    out["out"] = nxt(qp["out"])
    return out


class ISTNetInt8(nn.Module):
    """Drop-in for ISTNet with the backbone on the int8 serving path, its
    tree as buffers; `regress` delegates to the wrapped float net, which
    stays a submodule (so the module's parameters name its device).

        q = ISTNetInt8.from_ist_net(ist_net, static_scales=True)
        q.calibrate(template_crops, margin=1.1)  # static scales only
        feats = q.features(crops)  # (B, P, C), as ist_net.features(crops)
    """

    def __init__(self, float_net: ISTNet, qparams: dict, static_scales: bool = False):
        super().__init__()
        self.float_net = float_net
        self.input_size = float_net.backbone.input_size
        # static_scales asks for calibrated static activation scales; the
        # calibration needs serving images, so template onboarding runs it
        # (CoarseRunner._maybe_calibrate_ist) while static_pending
        self.static_scales = static_scales
        self._set_params(qparams)

    def _set_params(self, qp: dict) -> None:
        self.q_conv1 = _Buffers(qp["conv1"])
        self.q_layers = nn.ModuleList(
            nn.ModuleDict({k: _Buffers(v) for k, v in blk.items()}) for blk in qp["layers"])
        self.q_out = _Buffers(qp["out"])

    @classmethod
    def from_ist_net(cls, ist_net: ISTNet, static_scales: bool = False) -> "ISTNetInt8":
        return cls(ist_net, prepare_int8_ist_params(ist_net.backbone), static_scales)

    @property
    def params(self) -> dict:
        return {"conv1": self.q_conv1.tree(),
                "layers": [{k: m.tree() for k, m in blk.items()} for blk in self.q_layers],
                "out": self.q_out.tree()}

    @property
    def static_pending(self) -> bool:
        return self.static_scales and not hasattr(self.q_conv1, "sa")

    def _inference_only(self) -> None:
        if self.training:
            raise NotImplementedError("int8 IST serving is inference-only")

    @torch.no_grad()
    def calibrate(self, images: torch.Tensor, margin: float = 1.0) -> "ISTNetInt8":
        """Switch to static activation scales calibrated on `images` (the
        first template crops at onboarding: the serving distribution)."""
        self._inference_only()
        qp = self.params
        absmaxes = ist_act_absmax(qp, images, self.input_size)
        self._set_params(attach_static_act_scales(qp, absmaxes, margin))
        return self

    def features(self, images: torch.Tensor) -> torch.Tensor:
        self._inference_only()
        return ist_features_int8(self.params, images, self.input_size)

    def regress(self, src_feat, tar_feat, src_pts, tar_pts):
        self._inference_only()
        return self.float_net.regress(src_feat, tar_feat, src_pts, tar_pts)

    def forward(self, src_img, tar_img, src_pts, tar_pts):
        return self.regress(self.features(src_img), self.features(tar_img), src_pts, tar_pts)
