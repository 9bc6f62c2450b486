"""Writes the orbax fixtures of the port's checkpoint reader
(tests/data/orbax/) with the JAX package's own save functions, and their
manifest.json.

    python tests/torch_orbax_fixtures.py

Run where the JAX package runs (jax, flax, optax, orbax). The values are
seeded, so a new run writes the same arrays (orbax's file names, uuids and
times differ). Files, about 1.9 MB:

- train/step_00000000/: gigapose_tpu.training.checkpoint.save_checkpoint of
  a JAX TrainState of the coarse CLI's GIGAPOSE_TINY nets (vit_tiny_test;
  the IST at initial_dim 16, blocks (16, 16, 24, 32), 32-wide descriptors,
  the regressor's hidden width 32), every weight and BatchNorm statistic
  drawn from a seed (tests/torch_train_fixtures._fill), the optimizer state
  as make_optimizer(OptimConfig()).init makes it (step 0, zero moments: a
  state after steps would not fit the size). JAX's `last` pointer is left
  out: it holds the absolute path of the machine that wrote it;
- train_refiner/refiner/: gigapose_tpu.scripts.train_refiner.
  save_refiner_checkpoint of refine.py's GIGAPOSE_TINY nets (RefinerNet and
  CoarseScorerNet at width 8, 64 x 64), seeded as
  tests/test_torch_refiner.jax_vars seeds them.

manifest.json gives, per checkpoint, every array of orbax's own restore
by its dotted key path: shape, dtype and the sha256 of its C-order bytes,
so that a machine without orbax (chip_smoke.py's phase 20a) can check the
port's reader against orbax's result, and tests/test_torch_orbax.py checks
that this script still writes the same arrays.
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
import shutil
import sys
import types

import numpy as np

HERE = osp.join(osp.dirname(osp.abspath(__file__)), "data", "orbax")
TRAIN = "train/step_00000000"
REFINER = "train_refiner/refiner"
CLI_TINY_IST = dict(initial_dim=16, block_dims=(16, 16, 24, 32), descriptor_size=32,
                    input_size=256)


def coarse_valued(a) -> np.ndarray:
    """f32 values rounded to 4 significant bits (3 stored mantissa bits, the
    low 20 bits 0): seeded weights that zstd packs into about a byte each,
    so that the fixtures stay small."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFFF + ((bits >> 20) & 1)) & 0xFFF00000
    return bits.astype(np.uint32).view(np.float32)


def train_state():
    """The JAX TrainState of the coarse CLI's tiny nets (see the head)."""
    import jax
    import jax.numpy as jnp

    from gigapose_tpu.models.ae_net import AENet
    from gigapose_tpu.models.ist_net import ISTBackbone, ISTNet, Regressor
    from gigapose_tpu.training import state as JS
    from tests.torch_train_fixtures import _fill

    ae = AENet(model_name="vit_tiny_test")
    ist = ISTNet(backbone=ISTBackbone(**CLI_TINY_IST), regressor=Regressor(hidden_dim=32))
    img, pts = jnp.zeros((1, 3, 224, 224), jnp.float32), jnp.zeros((1, 4, 2), jnp.float32)
    shapes = {"ae": jax.eval_shape(ae.init, jax.random.PRNGKey(0), img),
              "ist": jax.eval_shape(ist.init, jax.random.PRNGKey(0), img, img, pts, pts)}
    rng = np.random.default_rng(18)
    values = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(coarse_valued(_fill(p, x, rng))), shapes)
    params = {"ae": values["ae"]["params"], "ist": values["ist"]["params"]}
    tx = JS.make_optimizer(JS.OptimConfig())
    return JS.TrainState(step=jnp.zeros((), jnp.int32), ae_params=params["ae"],
                         ist_params=params["ist"],
                         ist_batch_stats=values["ist"]["batch_stats"], opt_state=tx.init(params))


def write(out_dir: str = HERE) -> None:
    """Both checkpoints under out_dir (replacing what is there)."""
    import jax

    from gigapose_tpu.refiner.network import CoarseScorerNet, RefinerNet
    from gigapose_tpu.scripts.train_refiner import save_refiner_checkpoint
    from gigapose_tpu.training.checkpoint import save_checkpoint
    from tests.test_torch_refiner import jax_vars

    for sub in ("train", "train_refiner"):
        shutil.rmtree(osp.join(out_dir, sub), ignore_errors=True)
    ckpt_dir = osp.join(out_dir, "train")
    os.makedirs(ckpt_dir)
    save_checkpoint(ckpt_dir, train_state(), 0)
    os.remove(osp.join(ckpt_dir, "last"))
    refiner = types.SimpleNamespace(
        refiner_vars=jax.tree_util.tree_map(coarse_valued, jax_vars(RefinerNet(width=8), 1)),
        scorer_vars=jax.tree_util.tree_map(coarse_valued, jax_vars(CoarseScorerNet(width=8), 4)))
    save_refiner_checkpoint(osp.join(out_dir, "train_refiner"), refiner)


def flatten(tree, prefix=()):
    """(dotted key path, leaf) of a restored tree's arrays (None and empty
    containers left out)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, prefix + (str(i),))
    elif tree is not None:
        yield ".".join(prefix), tree


def array_record(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": a.dtype.str,
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def manifest_of(out_dir: str = HERE) -> dict:
    """{checkpoint: {key path: array_record}} of orbax's own restore."""
    import orbax.checkpoint as ocp

    out = {}
    for name in (TRAIN, REFINER):
        with ocp.PyTreeCheckpointer() as ckptr:
            tree = ckptr.restore(osp.join(out_dir, name))
        out[name] = {k: array_record(np.asarray(v)) for k, v in sorted(flatten(tree))}
    return out


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    write(HERE)
    manifest = manifest_of(HERE)
    with open(osp.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=0, sort_keys=True)
        f.write("\n")
    sizes = sum(osp.getsize(osp.join(d, f)) for d, _, fs in os.walk(HERE) for f in fs)
    print(f"wrote {HERE}: {sum(map(len, manifest.values()))} arrays, {sizes} bytes")


if __name__ == "__main__":
    sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
    main()
