"""Weight bridge: flax parameter trees (as numpy arrays) -> the port's state dicts.

The inverse of the torch -> flax maps in gigapose_tpu/models/convert.py: Dense
kernels (in, out) become Linear weights (out, in); Conv kernels HWIO become
OIHW; LayerNorm / BatchNorm `scale` becomes `weight`, BatchNorm running
`mean` / `var` become `running_mean` / `running_var`. The port's module names
are the original PyTorch ones, so one JAX random init drives both packages and
torch -> flax -> torch is the identity (tests/test_torch_models.py).

Inputs are nested dicts of array-likes (numpy, or anything np.asarray takes);
nothing here imports jax. `gigapose_ckpt_to_torch` reads the reference's
lightning checkpoints directly.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _linear(p: Mapping, prefix: str, out: Dict) -> None:
    out[prefix + "weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[prefix + "bias"] = _t(p["bias"])


def _conv(p: Mapping, prefix: str, out: Dict) -> None:
    out[prefix + "weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
    if "bias" in p:
        out[prefix + "bias"] = _t(p["bias"])


def _ln(p: Mapping, prefix: str, out: Dict) -> None:
    out[prefix + "weight"] = _t(p["scale"])
    out[prefix + "bias"] = _t(p["bias"])


def _bn(p: Mapping, stats: Mapping, prefix: str, out: Dict) -> None:
    _ln(p, prefix, out)
    out[prefix + "running_mean"] = _t(stats["mean"])
    out[prefix + "running_var"] = _t(stats["var"])
    out[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def vit_flax_to_torch(p: Mapping) -> Dict[str, torch.Tensor]:
    """models.vit.ViT params (the `vit` subtree) -> ViT state dict."""
    out: Dict[str, torch.Tensor] = {
        "cls_token": _t(p["cls_token"]),
        "pos_embed": _t(p["pos_embed"]),
    }
    if "register_tokens" in p:
        out["register_tokens"] = _t(p["register_tokens"])
    _conv(p["patch_embed"], "patch_embed.proj.", out)
    _ln(p["norm"], "norm.", out)
    depth = sum(1 for k in p if k.startswith("block"))
    for i in range(depth):
        blk, b = p[f"block{i}"], f"blocks.{i}."
        _ln(blk["norm1"], b + "norm1.", out)
        _linear(blk["attn"]["qkv"], b + "attn.qkv.", out)
        _linear(blk["attn"]["proj"], b + "attn.proj.", out)
        out[b + "ls1.gamma"] = _t(blk["ls1"]["gamma"])
        _ln(blk["norm2"], b + "norm2.", out)
        for name, layer in blk["mlp"].items():  # fc1/fc2 or w12/w3
            _linear(layer, f"{b}mlp.{name}.", out)
        out[b + "ls2.gamma"] = _t(blk["ls2"]["gamma"])
    return out


def ae_flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """AENet variables {"params": {"vit": ...}} -> AENet state dict."""
    return {"vit." + k: v for k, v in vit_flax_to_torch(variables["params"]["vit"]).items()}


def ist_backbone_flax_to_torch(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """ISTBackbone params + batch_stats -> ISTBackbone state dict."""
    out: Dict[str, torch.Tensor] = {}
    _conv(params["conv1"], "conv1.", out)
    _bn(params["bn1"], stats["bn1"], "bn1.", out)
    for li in range(1, 5):
        for bi in range(2):
            bp, bs, pre = params[f"layer{li}_{bi}"], stats[f"layer{li}_{bi}"], f"layer{li}.{bi}."
            _conv(bp["conv1"], pre + "conv1.", out)
            _bn(bp["bn1"], bs["bn1"], pre + "bn1.", out)
            _conv(bp["conv2"], pre + "conv2.", out)
            _bn(bp["bn2"], bs["bn2"], pre + "bn2.", out)
            if "down_conv" in bp:
                _conv(bp["down_conv"], pre + "downsample.0.", out)
                _bn(bp["down_bn"], bs["down_bn"], pre + "downsample.1.", out)
    for name in ("attention1", "attention2"):
        if name in params:
            out.update(spatial_transformer_flax_to_torch(params[name], name + "."))
    _conv(params["out_conv"], "layer4_outconv.", out)
    return out


def spatial_transformer_flax_to_torch(p: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """models.ist_net.SpatialTransformer params -> the port's module, whose
    names are the reference's (the inverse of the JAX package's
    spatial_transformer_to_flax): block{d} -> transformer_blocks.{d},
    to_out -> to_out.0, ff_proj -> ff.net.0.proj, ff_out -> ff.net.2."""
    out: Dict[str, torch.Tensor] = {}
    _ln(p["norm"], prefix + "norm.", out)
    _conv(p["proj_in"], prefix + "proj_in.", out)
    _conv(p["proj_out"], prefix + "proj_out.", out)
    depth = sum(1 for k in p if k.startswith("block"))
    for d in range(depth):
        blk, b = p[f"block{d}"], f"{prefix}transformer_blocks.{d}."
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _linear(blk[attn][proj], f"{b}{attn}.{proj}.", out)
            _linear(blk[attn]["to_out"], f"{b}{attn}.to_out.0.", out)
        for n in ("norm1", "norm2", "norm3"):
            _ln(blk[n], f"{b}{n}.", out)
        _linear(blk["ff_proj"], b + "ff.net.0.proj.", out)
        _linear(blk["ff_out"], b + "ff.net.2.", out)
    return out


def regressor_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Regressor params -> Regressor state dict (Sequential indices 0/2/4)."""
    out: Dict[str, torch.Tensor] = {}
    for head, name in (("scale_predictor", "scale"), ("inplane_predictor", "inplane")):
        for j, fc in zip((0, 2, 4), ("fc1", "fc2", "fc3")):
            _linear(params[f"{name}_{fc}"], f"{head}.{j}.", out)
    return out


def ist_flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """ISTNet variables {"params": {backbone, regressor}, "batch_stats":
    {backbone}} -> ISTNet state dict."""
    p, s = variables["params"], variables["batch_stats"]
    out = {"backbone." + k: v for k, v in
           ist_backbone_flax_to_torch(p["backbone"], s["backbone"]).items()}
    out.update({"regressor." + k: v for k, v in regressor_flax_to_torch(p["regressor"]).items()})
    return out


def train_state_flax_to_torch(ae_params: Mapping, ist_params: Mapping,
                              ist_batch_stats: Mapping):
    """The nets of a JAX TrainState (gigapose_tpu/training/state.py:
    ae_params, ist_params, ist_batch_stats, as numpy trees) -> (AENet state
    dict, ISTNet state dict with its BatchNorm statistics)."""
    return (ae_flax_to_torch({"params": ae_params}),
            ist_flax_to_torch({"params": ist_params, "batch_stats": ist_batch_stats}))


def params_flax_to_torch(net: str, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A tree shaped like one net's flax params (the params, their
    gradients or an Adam moment; net "ae" or "ist") -> the port's
    parameters by name, in the port's layouts (BatchNorm statistics left
    out)."""
    if net == "ae":
        return ae_flax_to_torch({"params": tree})
    stats = {"backbone": _stats_like(tree["backbone"])}
    sd = ist_flax_to_torch({"params": tree, "batch_stats": stats})
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def _stats_like(params: Mapping) -> Dict:
    """Placeholder BatchNorm statistics for every norm layer of a params tree."""
    out = {}
    for name, sub in params.items():
        if isinstance(sub, Mapping):
            if "scale" in sub and "kernel" not in sub:
                out[name] = {"mean": sub["scale"], "var": sub["scale"]}
            else:
                out[name] = _stats_like(sub)
    return out


def int8_params_flax_to_torch(qp: Mapping) -> Dict:
    """The JAX package's int8 serving tree (models/vit_int8.prepare_int8_params,
    as numpy arrays) -> the port's tree (models/vit_int8): same keys and
    values, each `*_wq` (K, N) int8 stored K-contiguous for the GEMM."""

    def conv(key, a):
        a = np.asarray(a)
        if key.endswith("_wq"):
            return torch.from_numpy(np.ascontiguousarray(a.T, dtype=np.int8)).t()
        return _t(a)

    out: Dict = {k: conv(k, v) for k, v in qp.items() if k != "blocks"}
    out["blocks"] = [{k: conv(k, v) for k, v in b.items()} for b in qp["blocks"]]
    return out


def ist_int8_params_flax_to_torch(qp: Mapping) -> Dict:
    """The JAX package's int8 IST serving tree (models/ist_int8.
    prepare_int8_ist_params, and attach_static_act_scales' "sa", as numpy
    arrays) -> the port's tree (models/ist_int8): the same keys and values,
    each HWIO `wq` as an (O, KH*KW*I) int8 weight, K-contiguous."""

    def conv(layer: Mapping) -> Dict:
        out = {}
        for k, a in layer.items():
            a = np.asarray(a)
            if k == "wq":
                O = a.shape[-1]
                out[k] = torch.from_numpy(np.ascontiguousarray(
                    a.transpose(3, 0, 1, 2).reshape(O, -1), dtype=np.int8))
            else:
                out[k] = _t(a)
        return out

    return {"conv1": conv(qp["conv1"]),
            "layers": [{k: conv(v) for k, v in blk.items()} for blk in qp["layers"]],
            "out": conv(qp["out"])}


# reference lightning checkpoint prefix -> (net, prefix of the port's module)
CKPT_PREFIXES = (
    ("ae_net.dinov2_model.", "ae", "vit."),
    ("ist_net.backbone.", "ist", "backbone."),
    ("ist_net.regressor.", "ist", "regressor."),
)
# keys of the reference layout that inference does not use: DINOv2's iBOT
# mask token (training only)
CKPT_UNUSED = ("ae_net.dinov2_model.mask_token",)


def gigapose_ckpt_to_torch(path: str):
    """Load a reference lightning `.ckpt` ({"state_dict": ...} or a bare
    state dict with ae_net.dinov2_model.* / ist_net.backbone.* /
    ist_net.regressor.* keys) -> (AENet state dict, ISTNet state dict). The
    port's module names are the reference's, so keys map by prefix; a key
    under no prefix raises ValueError, and `load_state_dict(strict=True)` on
    the port's modules raises on a missing or unknown one. Unpickles the
    file: load only checkpoints you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out: Dict[str, Dict[str, torch.Tensor]] = {"ae": {}, "ist": {}}
    unknown = []
    for key, value in sd.items():
        if key in CKPT_UNUSED:
            continue
        for prefix, net, to in CKPT_PREFIXES:
            if key.startswith(prefix):
                out[net][to + key[len(prefix):]] = value
                break
        else:
            unknown.append(key)
    if unknown:
        raise ValueError(f"checkpoint keys outside the coarse nets: {unknown}")
    return out["ae"], out["ist"]


def _flax_tree_to_torch(variables: Mapping, rename=lambda name: name) -> Dict[str, torch.Tensor]:
    """A flax tree of convolutions, dense layers and BatchNorms
    {"params", "batch_stats"} -> a state dict: each module's path joined
    by dots, every name through `rename`; conv kernels HWIO -> OIHW, dense
    kernels (in, out) -> (out, in), BatchNorm scale / bias / mean / var."""
    out: Dict[str, torch.Tensor] = {}
    stats = variables.get("batch_stats", {})

    def walk(p: Mapping, s: Mapping, prefix: str) -> None:
        if "kernel" in p:
            (_conv if np.ndim(p["kernel"]) == 4 else _linear)(p, prefix, out)
        elif "scale" in p:
            _bn(p, s, prefix, out)
        else:
            for name, sub in p.items():
                walk(sub, s.get(name, {}), f"{prefix}{rename(name)}.")

    walk(variables["params"], stats, "")
    return out


def refiner_flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """RefinerNet or CoarseScorerNet variables {"params", "batch_stats"}
    (gigapose_tpu/refiner/network.py) -> the port's state dict
    (refiner/network.py, whose module names are the flax ones). Load it
    with load_state_dict(strict=True)."""
    return _flax_tree_to_torch(variables)


_MEGAPOSE_NAMES = {"down_conv": "downsample.0", "down_bn": "downsample.1"}


def megapose_flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Variables {"params", "batch_stats"} of the JAX package's
    MegaposePoseHeadNet, MegaposeWideResNet or VanillaResNet34
    (gigapose_tpu/refiner/megapose_net.py) -> the state dict of the port's
    twin (refiner/megapose_net.py), whose keys are the reference torch
    modules' own: block `layer3_0` becomes `layer3.0`, torchvision's
    `down_conv` / `down_bn` become `downsample.0` / `.1`. The inverse of
    the JAX converters megapose_pose_model_to_flax,
    megapose_backbone_to_flax and vanilla_resnet34_to_flax. Load it with
    load_state_dict(strict=True)."""
    def rename(name: str) -> str:
        block = re.fullmatch(r"layer(\d+)_(\d+)", name)
        return f"layer{block[1]}.{block[2]}" if block else _MEGAPOSE_NAMES.get(name, name)

    return _flax_tree_to_torch(variables, rename)
