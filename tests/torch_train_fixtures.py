"""Shared set-up of the training parity tests (tests/test_torch_train*.py):
train.py's tiny nets on both sides, one JAX TrainState made from numpy on
jax.eval_shape's tree (flax's own init is slow on the CPU and not what is
tested), the same state in the port through the weight bridge, and seeded
random batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapose_tpu.models.ae_net import AENet as JAENet
from gigapose_tpu.models.ist_net import ISTBackbone as JISTBackbone
from gigapose_tpu.models.ist_net import ISTNet as JISTNet
from gigapose_tpu.models.ist_net import Regressor as JRegressor
from gigapose_tpu.training import state as JS
from gigapose_tpu_torch.models import convert
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.ist_net import ISTBackbone, ISTNet, Regressor
from gigapose_tpu_torch.training import state as TS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny nets gain little from more threads, and the suite runs
    several test files at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IST_KW = dict(initial_dim=8, block_dims=(8, 8, 12, 16), descriptor_size=16, input_size=256)


def jax_nets():
    """train.py's GIGAPOSE_TINY nets."""
    return (JAENet(model_name="vit_tiny_test"),
            JISTNet(backbone=JISTBackbone(**IST_KW), regressor=JRegressor(hidden_dim=16)))


def port_nets():
    return AENet("vit_tiny_test"), ISTNet(ISTBackbone(**IST_KW), Regressor(32, hidden_dim=16))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fill(path, leaf, rng):
    """A value for one flax leaf: kernels N(0, 1 / fan_in), LayerScale 0.1
    (its 1e-5 init would hide the blocks), norm scales near 1, biases and
    tokens small."""
    key = jax.tree_util.keystr(path)
    shape = leaf.shape
    if key.endswith("['kernel']"):
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(scale=1.0 / np.sqrt(fan_in), size=shape)
    if key.endswith("['gamma']"):
        return np.full(shape, 0.1)
    if key.endswith("['scale']"):
        return rng.uniform(0.8, 1.2, shape)
    if key.endswith("['var']"):
        return rng.uniform(0.5, 2.0, shape)
    return rng.normal(scale=0.02, size=shape)


def jax_train_state(cfg, seed: int = 0, image_size: int = 224):
    """(JAX TrainState, its optax transformation) for the tiny nets with
    seeded numpy values: gigapose_tpu.training.state.create_train_state
    without flax's initializers."""
    jae, jist = jax_nets()
    dummy = jnp.zeros((1, 3, image_size, image_size), jnp.float32)
    pts = jnp.zeros((1, 4, 2), jnp.float32)
    shapes = {"ae": jax.eval_shape(jae.init, jax.random.PRNGKey(0), dummy),
              "ist": jax.eval_shape(jist.init, jax.random.PRNGKey(0), dummy, dummy, pts, pts)}
    rng = np.random.default_rng(seed)
    values = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(_fill(p, x, rng).astype(np.float32)), shapes)
    params = {"ae": values["ae"]["params"], "ist": values["ist"]["params"]}
    tx = JS.make_optimizer(cfg)
    state = JS.TrainState(step=jnp.zeros((), jnp.int32), ae_params=params["ae"],
                          ist_params=params["ist"],
                          ist_batch_stats=values["ist"]["batch_stats"], opt_state=tx.init(params))
    return state, tx


def port_state_dicts(jstate):
    """(AE, IST) state dicts of the port for a JAX TrainState."""
    return convert.train_state_flax_to_torch(to_numpy(jstate.ae_params),
                                             to_numpy(jstate.ist_params),
                                             to_numpy(jstate.ist_batch_stats))


def port_train_state(jstate, cfg: "TS.OptimConfig"):
    ae, ist = port_nets()
    ae_sd, ist_sd = port_state_dicts(jstate)
    ae.load_state_dict(ae_sd, strict=True)
    ist.load_state_dict(ist_sd, strict=True)
    return TS.TrainState(ae, ist, cfg)


def random_batch(seed: int, B: int = 2, P: int = 256, invalid: float = 0.3) -> dict:
    """numpy TrainBatch fields: N(0, 1) crops, random patch pairs with a
    share of -1 rows, scales in [0.5, 2], angles in [0, 2 pi)."""
    r = np.random.default_rng(seed)
    src = r.integers(0, 16, (B, P, 2)).astype(np.float32)
    tar = r.integers(0, 16, (B, P, 2)).astype(np.float32)
    off = r.uniform(size=(B, P)) < invalid
    src[off] = -1.0
    tar[off] = -1.0
    return dict(src_img=r.normal(size=(B, 3, 224, 224)).astype(np.float32),
                tar_img=r.normal(size=(B, 3, 224, 224)).astype(np.float32),
                src_pts=src, tar_pts=tar,
                rel_scale=r.uniform(0.5, 2.0, B).astype(np.float32),
                rel_inplane=r.uniform(0, 2 * np.pi, B).astype(np.float32),
                src_mask=(r.uniform(size=(B, P)) < 0.8).astype(np.float32),
                tar_mask=(r.uniform(size=(B, P)) < 0.8).astype(np.float32))


def jax_batch(b: dict):
    return JS.TrainBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def port_batch(b: dict):
    return TS.TrainBatch(**{k: torch.as_tensor(v) for k, v in b.items()})
