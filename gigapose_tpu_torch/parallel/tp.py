"""Megatron tensor parallelism of the ViT over process groups (port of
gigapose_tpu/parallel/tp.py).

The JAX package leaves the work to GSPMD: Megatron PartitionSpecs by module
name, one heads-on-"mp" annotation of the attention's qkv, and XLA inserts
the psums. The port runs one process per card (parallel/mesh.py), so here
the same split is explicit, over torch.distributed groups:

- `make_dp_mp_groups(dp, mp)` puts the world's first dp * mp ranks on a
  (dp, mp) grid with "mp" the fast axis (rank = dp_rank * mp + mp_rank, as
  make_dp_mp_mesh reshapes its devices) and builds both axes' groups;
- `shard_vit_tp(state_dict, mp_rank, mp, num_heads)` slices a whole ViT /
  AENet state dict by the name rules of JAX's `_spec_for`. Column split
  (this rank's output rows, and their bias): attn.qkv, mlp.fc1, mlp.w12.
  Row split (this rank's input columns; the bias stays whole and is added
  once, after the sum): attn.proj, mlp.fc2, mlp.w3. Everything else is
  replicated. Two contiguous splits would be wrong: qkv's rows are laid out
  (3, H, hd), so a rank takes its heads of q, of k and of v; w12's rows are
  x1 | x2 (SwiGLU chunks them), so a rank takes its rows of both halves.
  Where mp does not divide the heads, JAX's constrain_heads leaves them
  unsharded: here too the attention (qkv and proj) stays whole on every
  rank and only the MLP is split. A hidden width that mp does not divide
  raises ValueError;
- models/vit.py's Attention, Mlp and SwiGLU built with `tp` hold their
  local shard and run `row_parallel` for their row-split product: the
  partial product, an all-reduce over the mp group (no autograd: the TP
  forward is inference only, and raises with gradients on), then the bias.
  With compute_dtype "bfloat16" the partial products are summed in f32 and
  cast to bf16 once, after the sum (on the card torch.mm with out_dtype
  f32: bf16 operands, f32 sums, nothing rounded before the all-reduce; on
  the CPU the same bf16 products in an f32 matmul). GSPMD's all-reduce of
  a bf16 dot sums the ranks' bf16-rounded partials instead (ROADMAP §C);
- the dp axis splits the batch over the dp group (models/ae_net.AENet),
  and parallel/multihost.all_gather_rows gives every rank the whole
  batch's features; a batch that dp does not divide is not split (JAX's
  constrain_heads shards the batch only where dp divides it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from gigapose_tpu_torch.parallel import multihost

# (parent module, linear) -> how its torch weight (out, in) is split
_COL = {("attn", "qkv"), ("mlp", "fc1"), ("mlp", "w12")}
_ROW = {("attn", "proj"), ("mlp", "fc2"), ("mlp", "w3")}


@dataclasses.dataclass(frozen=True)
class TPGroups:
    """This rank's place on the (dp, mp) grid and both axes' groups."""

    dp: int
    mp: int
    dp_rank: int
    mp_rank: int
    dp_group: Optional[object] = None  # ranks with this mp_rank: the batch axis
    mp_group: Optional[object] = None  # ranks with this dp_rank: the model axis

    def all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Sum over the mp group, in place, outside autograd."""
        if self.mp > 1:
            dist.all_reduce(y, group=self.mp_group)
        return y

    def split_rows(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """This dp rank's rows of the batch, or None where dp does not
        divide it (every rank then runs the whole batch)."""
        if self.dp == 1 or x.shape[0] % self.dp:
            return None
        n = x.shape[0] // self.dp
        return x[self.dp_rank * n:(self.dp_rank + 1) * n]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        return multihost.all_gather_rows(x, group=self.dp_group)


def make_dp_mp_groups(dp: int, mp: int) -> Optional[TPGroups]:
    """The (dp, mp) grid over the first dp * mp ranks of the initialized
    world (JAX's make_dp_mp_mesh takes the first dp * mp devices): every
    rank calls this, and every group is made on every rank in the same
    order, as torch.distributed.new_group requires; a rank outside the grid
    gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_dp_mp_groups needs torch.distributed initialized "
                           "(parallel/multihost.maybe_initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp < 1 or mp < 1 or dp * mp > world:
        raise ValueError(f"dp={dp} x mp={mp} ranks wanted, the world has {world}")
    mp_groups = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(dp)]
    dp_groups = [dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
    if rank >= dp * mp:
        return None
    d, m = divmod(rank, mp)
    return TPGroups(dp=dp, mp=mp, dp_rank=d, mp_rank=m, dp_group=dp_groups[m],
                    mp_group=mp_groups[d])


def heads_split(num_heads: int, mp: int) -> bool:
    """Whether the attention is split over mp (JAX: the heads divide by mp)."""
    return mp > 1 and num_heads % mp == 0


def local_width(width: int, mp: int, what: str) -> int:
    if width % mp:
        raise ValueError(f"tensor parallelism: mp={mp} does not divide the {what} width {width}")
    return width // mp


def shard_vit_tp(state_dict: Dict[str, torch.Tensor], mp_rank: int, mp: int,
                 num_heads: int) -> Dict[str, torch.Tensor]:
    """mp_rank's shard of a whole ViT or AENet state dict (see the head)."""
    if not 0 <= mp_rank < mp:
        raise ValueError(f"mp_rank {mp_rank} outside [0, {mp})")
    attn = heads_split(num_heads, mp)
    out = {}
    for key, v in state_dict.items():
        parts = key.split(".")
        site = tuple(parts[-3:-1]) if len(parts) >= 3 else ()
        if mp == 1 or (site[:1] == ("attn",) and not attn) or site not in _COL | _ROW:
            out[key] = v
        elif site in _COL:
            # rows (out, ...) grouped as (3, C) for qkv, (2, hidden) for w12
            groups = {"qkv": 3, "w12": 2}.get(site[1], 1)
            rows = v.reshape(groups, -1, *v.shape[1:])
            n = local_width(rows.shape[1], mp, ".".join(parts[:-1]))
            out[key] = rows[:, mp_rank * n:(mp_rank + 1) * n].reshape(-1, *v.shape[1:]).clone()
        elif parts[-1] == "weight":  # row split: this rank's input columns
            n = local_width(v.shape[1], mp, ".".join(parts[:-1]))
            out[key] = v[:, mp_rank * n:(mp_rank + 1) * n].clone()
        else:  # a row-split layer's bias: whole, added once after the sum
            out[key] = v
    return out


def row_parallel(layer: torch.nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype],
                 tp: TPGroups) -> torch.Tensor:
    """layer(x) for a Linear whose input columns are split over tp's mp
    group: this rank's partial product, summed over the group (in f32 for a
    bf16 dtype, cast once after the sum), then the whole bias."""
    if torch.is_grad_enabled():
        raise RuntimeError("the tensor-parallel forward is inference only: run it under "
                           "torch.no_grad() or torch.inference_mode()")
    x2 = x.reshape(-1, x.shape[-1])
    if dtype is None:
        y = x2 @ layer.weight.t()
    else:
        xd, wd = x2.to(dtype), layer.weight.to(dtype)
        y = (torch.mm(xd, wd.t(), out_dtype=torch.float32) if xd.is_cuda
             else xd.float() @ wd.float().t())
    y = tp.all_reduce(y.contiguous())
    if dtype is not None:
        y = y.to(dtype)
    return (y + layer.bias.to(y.dtype)).reshape(*x.shape[:-1], layer.out_features)
