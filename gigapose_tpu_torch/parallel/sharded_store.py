"""View-sharded template store (port of gigapose_tpu/parallel/sharded_store.py).

The replicated store puts every object's (V, P, C) AE and IST features on
one card: a ViT-L object costs about 106 MB (85 AE + 21 IST in bf16), so a
large object set outgrows a card. Here the template VIEW axis is split over
an explicit list of devices, so each device holds and matches V/S views;
the pose-recovery arrays (Ms, poses, K: a few KB an object) stay whole, at
the real V, on the nets' device.

1. each shard matches the query against its own views with the stock
   matcher: `ops.fused_matching.fused_match_templates` (the bf16 kernel on a
   bf16 store; on an f32 store the split kernel, once per shard, then the
   f32 kernel) or `ops.matching.match_templates`, as the estimator's config
   says; its top-k view ids are made global by adding shard * V/S;
2. the S * k candidates come to the nets' device, concatenated in shard
   order;
3. the global top-k is merged exactly as one top-k over the whole score row
   orders it (score descending, ties to the lowest view id): each shard's
   list is already (score desc, id asc) and the concatenation is
   id-ascending among equal scores, so a stable sort on the score keeps the
   lowest id first. A view outside its shard's top k is beaten by k views of
   its own shard, so nothing is lost;
4. the k winning views' IST features are copied from the shards that own
   them.

V is zero-padded to a multiple of S with all-masked views (mask 0:
similarity 0, score 0), which lose to every scoring view; an object with
fewer than k scoring views gets garbage hypotheses either way, as in the
reference. Each shard must hold at least k views.

The JAX package runs this in one process over its local devices; so does
the port, over the devices it is given (on one card, [cuda:0] * S).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from gigapose_tpu_torch.ops.fused_matching import fused_match_templates
from gigapose_tpu_torch.ops.matching import MatchResult, match_templates, top_k_stable
from gigapose_tpu_torch.pipeline.estimator import (
    CoarsePrediction,
    DetectionBatch,
    EstimatorConfig,
    finish_coarse,
)
from gigapose_tpu_torch.pipeline.templates import TemplateStore


@dataclasses.dataclass
class StoreShard:
    """One device's views: (O, V/S, P, C) features and (O, V/S, P) masks."""

    ae_features: torch.Tensor
    ist_features: torch.Tensor
    masks: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.ae_features.device


@dataclasses.dataclass
class ShardedStore:
    """A TemplateStore with its views split over devices: `shards[s]` holds
    padded views s * V/S .. (s + 1) * V/S - 1; Ms, poses and K keep the real
    V on the nets' device."""

    shards: List[StoreShard]
    Ms: torch.Tensor  # (O, V, 3, 3)
    poses: torch.Tensor  # (O, V, 4, 4)
    K: torch.Tensor  # (O, 3, 3)

    @property
    def views_per_shard(self) -> int:
        return self.shards[0].ae_features.shape[1]

    @property
    def num_views(self) -> int:
        """The padded V."""
        return self.views_per_shard * len(self.shards)


def shard_template_store(store: TemplateStore, devices: Sequence, home=None) -> ShardedStore:
    """Split `store`'s views over `devices` (one shard each, contiguous on
    its device), V zero-padded to a multiple of len(devices); Ms, poses and
    K go to `home` (default: the store's own device) at the real V. A store
    on the host is copied shard by shard, so the whole store never sits on
    one card."""
    devices = [torch.device(d) for d in devices]
    S = len(devices)
    if S < 1:
        raise ValueError("shard_template_store needs at least one device")
    V = store.ae_features.shape[1]
    Vloc = -(-V // S)

    def part(a: torch.Tensor, s: int, dev: torch.device) -> torch.Tensor:
        lo, hi = s * Vloc, min((s + 1) * Vloc, V)
        x = a[:, lo:hi]
        if hi - lo < Vloc:  # the last shards hold the padding views
            x = torch.cat([x, x.new_zeros((x.shape[0], Vloc - (hi - lo)) + x.shape[2:])], 1)
        return x.to(dev).contiguous()

    shards = [StoreShard(ae_features=part(store.ae_features, s, d),
                         ist_features=part(store.ist_features, s, d),
                         masks=part(store.masks, s, d)) for s, d in enumerate(devices)]
    home = store.K.device if home is None else torch.device(home)
    return ShardedStore(shards=shards, Ms=store.Ms.to(home), poses=store.poses.to(home),
                        K=store.K.to(home))


def sharded_match_and_gather(
    tar_ae: torch.Tensor,  # (B, P, C)
    tar_masks: torch.Tensor,  # (B, P)
    labels: torch.Tensor,  # (B,) 0-based
    store: ShardedStore,
    cfg: EstimatorConfig,
) -> Tuple[MatchResult, torch.Tensor]:
    """Steps 1-2 of the coarse pipeline over a view-sharded store -> (the
    merged MatchResult with global view ids, the (B, k, P, C2) IST features
    of the winning views), on tar_ae's device."""
    Vloc, k = store.views_per_shard, cfg.k
    if Vloc < k:
        raise ValueError(f"{Vloc} views per shard < k={k}: the exact merge needs each shard "
                         "to offer k candidates; use fewer shards")
    out = tar_ae.device
    lab = labels.to(torch.int32)
    cands = []
    for s, shard in enumerate(store.shards):
        dev = shard.device
        t = tar_ae.to(dev, shard.ae_features.dtype).contiguous()
        m = tar_masks.to(dev, torch.float32).contiguous()
        ls = lab.to(dev).contiguous()
        kw = dict(k=k, sim_threshold=cfg.sim_threshold, patch_threshold=cfg.patch_threshold,
                  num_patches=cfg.num_patches)
        if cfg.use_pallas_matching:
            match = fused_match_templates(t, shard.ae_features, m, shard.masks, ls, **kw)
        else:
            l64 = ls.to(torch.int64)
            match = match_templates(t, shard.ae_features[l64], m, shard.masks[l64], **kw)
        match = dataclasses.replace(match, ids=match.ids + s * Vloc)
        cands.append(MatchResult(*(getattr(match, f.name).to(out)
                                   for f in dataclasses.fields(MatchResult))))
    cat = lambda name: torch.cat([getattr(c, name) for c in cands], dim=1)  # (B, S*k, ...)
    c_scores = cat("scores")
    _, perm = top_k_stable(c_scores, k)  # stable: ties keep the lower global id first
    take = lambda a: torch.gather(a, 1, perm.reshape(perm.shape + (1,) * (a.ndim - 2))
                                  .expand(perm.shape + a.shape[2:]))
    merged = MatchResult(ids=take(cat("ids")), scores=take(c_scores),
                         score_pts=take(cat("score_pts")), src_pts=take(cat("src_pts")),
                         tar_pts=take(cat("tar_pts")), valid=take(cat("valid")))

    # the winning views' IST features, each copied from the shard that owns it
    src_ist = None
    for s, shard in enumerate(store.shards):
        local = merged.ids.to(shard.device, torch.int64) - s * Vloc  # (B, k)
        owned = (local >= 0) & (local < Vloc)
        rows = shard.ist_features[lab.to(shard.device, torch.int64)[:, None],
                                  local.clamp(0, Vloc - 1)].to(out)
        owned = owned.to(out)[..., None, None]
        src_ist = torch.where(owned, rows, torch.zeros_like(rows) if src_ist is None else src_ist)
    return merged, src_ist


def coarse_forward_sharded(
    ae_net,
    ist_net,
    store: ShardedStore,
    batch: DetectionBatch,
    cfg: EstimatorConfig = EstimatorConfig(),
) -> CoarsePrediction:
    """The coarse pipeline on a view-sharded store: the nets on the batch's
    device, `sharded_match_and_gather`, then estimator.finish_coarse. The
    same ids, correspondences and poses as estimator.coarse_forward on the
    whole store."""
    tar_ae = ae_net(batch.crops)
    tar_ist = ist_net.features(batch.crops)
    match, src_ist = sharded_match_and_gather(tar_ae, batch.masks, batch.labels, store, cfg)
    return finish_coarse(ist_net, tar_ist, match, src_ist, store, batch, cfg)
