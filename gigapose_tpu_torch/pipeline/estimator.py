"""End-to-end coarse pose estimation (port of gigapose_tpu/pipeline/estimator.py).

features -> template retrieval -> per-correspondence scale / in-plane
regression -> one-correspondence RANSAC -> closed-form 6D recovery, on
fixed-shape padded batches:

    crops  (B, 3, 224, 224) CLIP-normalized detection crops
    masks  (B, P)           patch-level modal masks
    labels (B,)             0-based object index into the TemplateStore
    Ks     (B, 3, 3)        query intrinsics
    Ms     (B, 3, 3)        query crop affines
    valid  (B,)             padding mask

Precision: f32 matmuls and convolutions are full f32 (TF32 off, set by
`set_f32_matmul_precision`, which `GigaPoseEstimator.create` calls), so an
f32 run matches the JAX reference. Serving uses compute_dtype "bfloat16"
(bf16 matmuls; f32 LayerNorm, softmax, BatchNorm and residual) and a bf16
store (feature_dtype), as gigapose_tpu/configs/model/large.yaml does.
`GigaPoseEstimator.quantize_serving()` swaps the AE for the int8 (W8A8)
serving path (models/vit_int8.AENetInt8); call it before onboarding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
from torch import nn

from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.ist_net import ISTNet, default_ist_net
from gigapose_tpu_torch.models.vit_int8 import AENetInt8
from gigapose_tpu_torch.ops.fused_matching import fused_match_templates
from gigapose_tpu_torch.ops.matching import match_templates
from gigapose_tpu_torch.ops.pose_recovery import recover_poses
from gigapose_tpu_torch.ops.ransac import ransac_affine
from gigapose_tpu_torch.pipeline.templates import TemplateStore
from gigapose_tpu_torch.utils.device import resolve_device


def set_f32_matmul_precision() -> None:
    """Full-f32 matmuls and cuDNN convolutions (no TF32), for parity with the
    JAX reference. Process-wide PyTorch flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class DetectionBatch:
    crops: torch.Tensor  # (B, 3, 224, 224)
    masks: torch.Tensor  # (B, P)
    labels: torch.Tensor  # (B,) int32
    Ks: torch.Tensor  # (B, 3, 3)
    Ms: torch.Tensor  # (B, 3, 3)
    valid: torch.Tensor  # (B,) bool


@dataclasses.dataclass
class CoarsePrediction:
    poses: torch.Tensor  # (B, k, 4, 4) sorted by score desc
    scores: torch.Tensor  # (B, k) RANSAC inlier score / P
    view_ids: torch.Tensor  # (B, k) retrieved template view ids
    M: torch.Tensor  # (B, k, 3, 3) RANSAC affines
    failed: torch.Tensor  # (B, k) bool
    sim_scores: torch.Tensor  # (B, k) template similarity scores
    ransac_valid: torch.Tensor  # (B, k, P) inlier masks
    src_pts: torch.Tensor  # (B, k, P, 2)
    tar_pts: torch.Tensor  # (B, k, P, 2)


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    k: int = 5
    sim_threshold: float = 0.5
    patch_threshold: int = 3
    pixel_threshold: float = 14.0
    patch_size: int = 14
    num_patches: int = 16
    sort_by_inliers: bool = True
    # name kept from the JAX config: True routes retrieval through the fused
    # matching kernel (ops/fused_matching: the CUDA kernel for CUDA tensors,
    # its plain version for CPU tensors) instead of match_templates on a
    # per-batch gather of the store
    use_pallas_matching: bool = False


def coarse_forward(
    ae_net: Union[AENet, AENetInt8],
    ist_net: ISTNet,
    store: TemplateStore,
    batch: DetectionBatch,
    cfg: EstimatorConfig = EstimatorConfig(),
) -> CoarsePrediction:
    """The full coarse pipeline on one padded batch."""
    P = cfg.num_patches**2
    labels = batch.labels.to(torch.int32)
    tar_ae = ae_net(batch.crops)  # (B, P, C)
    tar_ist = ist_net.features(batch.crops)
    if tar_ae.shape[1] != P or tar_ist.shape[1] != P:
        raise ValueError(
            f"feature grids must match the {cfg.num_patches}x{cfg.num_patches} patch "
            f"convention; got AE P={tar_ae.shape[1]}, IST P={tar_ist.shape[1]} "
            "(the IST backbone's stride is 16: input_size must be 16*num_patches)"
        )

    if cfg.use_pallas_matching:
        match = fused_match_templates(
            tar_ae.to(store.ae_features.dtype).contiguous(), store.ae_features,
            batch.masks.to(torch.float32).contiguous(), store.masks, labels.contiguous(),
            k=cfg.k, sim_threshold=cfg.sim_threshold,
            patch_threshold=cfg.patch_threshold, num_patches=cfg.num_patches,
        )
    else:
        lab = labels.to(torch.int64)
        src_ae = store.ae_features[lab]  # (B, V, P, C)
        match = match_templates(
            tar_ae.to(src_ae.dtype), src_ae, batch.masks, store.masks[lab],
            k=cfg.k, sim_threshold=cfg.sim_threshold,
            patch_threshold=cfg.patch_threshold, num_patches=cfg.num_patches,
        )

    # gather only the k retrieved views' IST features (B, k, P, C2)
    V = store.ist_features.shape[1]
    flat_ist = store.ist_features.reshape((-1,) + store.ist_features.shape[2:])
    src_ist = flat_ist[labels.to(torch.int64)[:, None] * V + match.ids.to(torch.int64)]
    return finish_coarse(ist_net, tar_ist, match, src_ist, store, batch, cfg)


def finish_coarse(
    ist_net: ISTNet,
    tar_ist: torch.Tensor,
    match,
    src_ist: torch.Tensor,
    store: TemplateStore,
    batch: DetectionBatch,
    cfg: EstimatorConfig,
) -> CoarsePrediction:
    """IST regression on the k retrieved views' correspondences, RANSAC,
    hypothesis sorting and closed-form 6D recovery."""
    P = cfg.num_patches**2
    labels = batch.labels.to(torch.int64)
    B, k = match.ids.shape
    flat = lambda a: a.reshape((B * k,) + a.shape[2:])
    tar_k = tar_ist.to(src_ist.dtype)[:, None].expand((B, k) + tar_ist.shape[1:])
    ist = ist_net.regress(flat(src_ist), flat(tar_k), flat(match.src_pts), flat(match.tar_pts))
    unflat = lambda a: a.reshape((B, k) + a.shape[1:])

    rr = ransac_affine(
        match.src_pts, match.tar_pts, match.score_pts,
        unflat(ist.scale), unflat(ist.cossin), match.valid & unflat(ist.valid),
        pixel_threshold=cfg.pixel_threshold, patch_size=cfg.patch_size,
    )
    scores = rr.inlier_scores.sum(dim=-1) / P  # (B, k)

    view_ids, Ms_r, failed, sim_scores = match.ids, rr.M, rr.failed, match.scores
    inliers, src_pts, tar_pts = rr.inliers, match.src_pts, match.tar_pts
    if cfg.sort_by_inliers:
        # stable: equal scores keep retrieval order, as jnp.argsort(-scores)
        order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
        take = lambda a: torch.gather(
            a, 1, order.reshape(order.shape + (1,) * (a.ndim - 2)).expand(a.shape)
        )
        scores, view_ids, failed, sim_scores = (take(a) for a in (scores, view_ids, failed, sim_scores))
        Ms_r, inliers, src_pts, tar_pts = (take(a) for a in (Ms_r, inliers, src_pts, tar_pts))

    poses = recover_poses(
        batch.Ms, batch.Ks, view_ids, Ms_r,
        store.K[labels], store.Ms[labels], store.poses[labels],
    )
    valid = batch.valid.to(torch.bool)
    return CoarsePrediction(
        poses=poses,
        scores=scores * valid[:, None],
        view_ids=view_ids,
        M=Ms_r,
        failed=failed | ~valid[:, None],
        sim_scores=sim_scores,
        ransac_valid=inliers,
        src_pts=src_pts,
        tar_pts=tar_pts,
    )


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights following flax's default initializers: Linear and
    Conv weights truncated-normal with std 1/sqrt(fan_in) (lecun_normal),
    biases 0, CLS / position / register tokens truncated-normal 0.02. Norm
    layers and LayerScale keep their constructor values (scale 1, bias 0,
    running mean 0 / var 1; gamma 1e-5), which are flax's too."""
    # std of a standard normal truncated to [-2, 2]; lecun_normal divides it out
    trunc_std = 0.87962566103423978
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("cls_token", "pos_embed", "register_tokens"):
            nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)
        elif leaf == "weight" and p.ndim >= 2:
            std = 1.0 / math.sqrt(p[0].numel()) / trunc_std
            nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=generator)
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)) and m.bias is not None:
            nn.init.zeros_(m.bias)
    return module


@dataclasses.dataclass
class GigaPoseEstimator:
    """The two nets on one device plus the coarse entry points."""

    ae_net: Union[AENet, AENetInt8]
    ist_net: ISTNet
    config: EstimatorConfig = EstimatorConfig()

    @classmethod
    def create(
        cls,
        model_name: str = "dinov2_vits14",
        seed: int = 0,
        config: EstimatorConfig = EstimatorConfig(),
        ist_descriptor_size: int = 256,
        compute_dtype: Optional[str] = None,
        device: Optional[Union[torch.device, str]] = None,
    ) -> "GigaPoseEstimator":
        """Both nets with seeded random weights, in eval mode on `device`:
        the card (cuda:0) unless the caller names another device, such as
        "cpu". With no card and no device given it raises; it never moves
        to the CPU on its own."""
        device = resolve_device(device, "GigaPoseEstimator.create")
        set_f32_matmul_precision()
        gen = torch.Generator().manual_seed(seed)
        ae_net = init_random_(AENet(model_name, compute_dtype=compute_dtype), gen)
        ist_net = init_random_(
            default_ist_net(ist_descriptor_size, compute_dtype=compute_dtype), gen
        )
        return cls(ae_net.to(device).eval(), ist_net.to(device).eval(), config)

    def quantize_serving(self, ist: Union[bool, str] = False) -> "GigaPoseEstimator":
        """Swap the AE backbone for the W8A8 int8 serving path
        (models/vit_int8.AENetInt8: the ops/qmm.py kernels on CUDA tensors,
        their plain versions on CPU tensors), quantized from the current
        weights on their device. `ae_apply`, and so onboarding, then use it.

        Inference only. Call after loading weights and before onboarding:
        queries and the template store must share one feature extractor."""
        if ist:
            raise NotImplementedError(
                "int8 IST serving (models/ist_int8, ist=True / 'static') is not "
                "ported: ROADMAP A11"
            )
        if not isinstance(self.ae_net, AENetInt8):
            self.ae_net = AENetInt8.from_ae_net(self.ae_net).eval()
        return self

    @property
    def device(self) -> torch.device:
        """The device both nets run on (that of the IST net's weights)."""
        return next(self.ist_net.parameters()).device

    @torch.inference_mode()
    def __call__(self, store: TemplateStore, batch: DetectionBatch) -> CoarsePrediction:
        return coarse_forward(self.ae_net, self.ist_net, store, batch, self.config)

    @torch.inference_mode()
    def ae_apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.ae_net(x)

    @torch.inference_mode()
    def ist_apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.ist_net.features(x)
