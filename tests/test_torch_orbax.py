"""The port's orbax reader (utils/zstd.py, utils/ocdbt.py, utils/orbax.py)
against orbax itself, and the JAX trainers' checkpoints through the port's
checkpoint modules (training/checkpoint.py, refiner/checkpoint.py).

- every array that read_tree gives equals orbax's own restore bit for bit
  (dtype, shape and bytes; bfloat16 leaves by their bits): the JAX
  trainer's TrainState after a step (with and without the global-norm clip,
  one net frozen), the refiner trainer's {"refiner_vars", "scorer_vars"},
  every dtype the reader takes, an array of several chunks, OCDBT trees of
  several levels, and zarr chunks never written (their fill value);
- the decoder equals the `zstandard` package on random and repetitive
  frames; a corrupt or truncated frame, node or value and a missing
  libzstd raise;
- a JAX TrainState resumed by the port (train.py's restore_checkpoint) is
  the JAX state bit for bit, and one port step from it equals one JAX step
  after JAX's restore_checkpoint within tests/test_torch_train_step.py's
  tolerances: the losses to rtol 5e-4, the AE's parameters to 1e-6, the
  IST's within 2 x the summed lr (at most 2 % of the entries beyond a
  tenth of it), the BatchNorm statistics to 1e-4, the moments as there;
- the committed fixtures (tests/data/orbax, tests/torch_orbax_fixtures.py)
  read as their manifest says, and the script still writes that manifest.
"""

import json
import os
import os.path as osp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from gigapose_tpu.refiner.network import CoarseScorerNet as JScorer
from gigapose_tpu.refiner.network import RefinerNet as JRefiner
from gigapose_tpu.scripts.train_refiner import save_refiner_checkpoint as jax_save_refiner
from gigapose_tpu.training import checkpoint as JC
from gigapose_tpu.training import state as JS
from gigapose_tpu_torch.models import convert
from gigapose_tpu_torch.training import checkpoint as CK
from gigapose_tpu_torch.training import state as TS
from gigapose_tpu_torch.utils import ocdbt, orbax, zstd
from tests import torch_orbax_fixtures as FIX
from tests.test_torch_refiner import jax_vars
from tests.test_torch_train_step import _close
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (a fixture)
from tests.torch_train_fixtures import (
    jax_batch, jax_nets, jax_train_state, port_batch, port_nets, port_state_dicts, random_batch,
    to_numpy,
)

WARM = 2


def _restore(path):
    with ocp.PyTreeCheckpointer() as ckptr:
        return ckptr.restore(path)


def _assert_reads_as_orbax(path) -> int:
    """read_tree(path) == orbax's restore, leaf for leaf, bit for bit."""
    want = dict(FIX.flatten(_restore(path)))
    got = dict(FIX.flatten(orbax.read_tree(path)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, k
            assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16)), k
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
            assert g.tobytes() == np.ascontiguousarray(w).tobytes(), k
    return len(want)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX TrainState one step in (nonzero moments), saved by the JAX
    trainer's save_checkpoint: (checkpoint dir, step dir, state, jitted step)."""
    cfg = JS.OptimConfig(warm_up_steps=WARM)
    jstate, tx = jax_train_state(cfg, seed=11)
    jae, jist = jax_nets()
    step = jax.jit(lambda s, b: JS.train_step(jae, jist, tx, cfg, s, b))
    jstate, _ = step(jstate, jax_batch(random_batch(100)))
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    path = JC.save_checkpoint(ckpt_dir, jstate, 1)
    return ckpt_dir, path, jstate, step


@pytest.mark.parametrize("kind", ["random", "repetitive", "two_frames", "with_size"])
def test_zstd_matches_zstandard(kind):
    r = np.random.default_rng(3)
    data = {"random": r.bytes(200_000), "repetitive": bytes(r.integers(0, 4, 300_000, np.uint8)),
            "two_frames": r.bytes(1000), "with_size": b"orbax" * 50_000}[kind]
    c = zstandard.ZstdCompressor(level=1, write_content_size=kind == "with_size")
    frame = c.compress(data)
    if kind == "two_frames":
        frame += c.compress(data[::-1])
        data += data[::-1]
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame, expected_size=len(data)) == data
    for bad in (frame[:-5], frame[:len(frame) // 3], b"\x00" + frame, b""):
        with pytest.raises(ValueError, match="zstd"):
            zstd.decompress(bad)
    with pytest.raises(ValueError, match="expected"):
        zstd.decompress(frame, expected_size=len(data) + 1)


def test_missing_libzstd_raises(monkeypatch):
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-missing.so.9")
    zstd.library.cache_clear()
    try:
        with pytest.raises(OSError, match="libzstd-missing"):
            zstd.decompress(b"x")
    finally:
        monkeypatch.undo()
        zstd.library.cache_clear()


def test_train_state_reads_as_orbax_restores(jax_ckpt):
    ckpt_dir, path, jstate, _ = jax_ckpt
    assert _assert_reads_as_orbax(path) > 300
    tree = orbax.read_tree(path)
    assert tree["opt_state"]["inner_states"]["frozen"]["inner_state"] is None
    assert int(tree["step"]) == 1 and tree["step"].dtype == np.int32


@pytest.mark.parametrize("cfg", [dict(grad_clip=1.0), dict(nets_to_train="ae")],
                         ids=["clipped", "ae_only"])
def test_optimizer_layouts_read_and_restore(tmp_path, cfg):
    """The clip chain's (empty, groups) layout and a frozen IST read as
    orbax restores them; the port restores each into a run with the same
    optimizer, and refuses a run with another."""
    jstate, _ = jax_train_state(JS.OptimConfig(**cfg), seed=5)
    path = JC.save_checkpoint(str(tmp_path), jstate, 0)
    _assert_reads_as_orbax(path)
    sd = CK.load_checkpoint(path)
    assert sd["clips_global_norm"] == ("grad_clip" in cfg)
    assert sorted(sd["optimizer"]) == (["ae"] if "nets_to_train" in cfg else ["ae", "ist"])
    state = TS.TrainState(*port_nets(), TS.OptimConfig(**cfg))
    CK.restore_checkpoint(path, state)
    other = {"grad_clip": 0.0} if "grad_clip" in cfg else {"nets_to_train": "all"}
    with pytest.raises(ValueError, match="clip|trains"):
        CK.restore_checkpoint(path, TS.TrainState(*port_nets(), TS.OptimConfig(**other)))


def test_refiner_checkpoint_reads_as_orbax_restores(tmp_path):
    refiner = type("R", (), dict(refiner_vars=jax_vars(JRefiner(width=8), 1),
                                 scorer_vars=jax_vars(JScorer(width=8), 4)))
    path = jax_save_refiner(str(tmp_path), refiner)
    assert _assert_reads_as_orbax(path) > 100
    tree = orbax.read_tree(path)
    for name in ("refiner_vars", "scorer_vars"):
        want = convert.refiner_flax_to_torch(to_numpy(getattr(refiner, name)))
        got = convert.refiner_flax_to_torch(tree[name])
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_every_dtype_reads_bit_for_bit(tmp_path):
    r = np.random.default_rng(0)
    tree = {"f4": r.normal(size=(3, 5)).astype(np.float32),
            "f8": r.normal(size=(7,)),
            "i4": r.integers(-2**31, 2**31 - 1, (4, 2), dtype=np.int32),
            "i8": r.integers(-2**62, 2**62, (3,), dtype=np.int64),
            "u4": r.integers(0, 2**32 - 1, (2, 2, 2), dtype=np.uint32),
            "bool": r.uniform(size=(9,)) < 0.5,
            "bf16": jnp.asarray(r.normal(size=(6, 3)), jnp.bfloat16),
            "bf16_scalar": jnp.asarray(-3.5, jnp.bfloat16),
            "nested": [{"x": np.arange(5, dtype=np.int32)}, None],
            "scalar": 7}
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "ck"), tree)
    assert _assert_reads_as_orbax(str(tmp_path / "ck")) == 10
    got = orbax.read_tree(str(tmp_path / "ck"))
    assert got["nested"]["1"] is None and got["bool"].dtype == np.bool_


def test_multi_chunk_array_reads_as_orbax_restores(tmp_path):
    """A jax.Array sharded over the 8 CPU devices is written as 8 chunks."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    x = np.random.default_rng(1).normal(size=(20, 6)).astype(np.float32)
    tree = {"x": jax.device_put(x, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("a", "b"))), "y": np.ones(3, np.float32)}
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(str(tmp_path / "ck"), tree)
    store = ocdbt.OcdbtStore(str(tmp_path / "ck"))
    assert json.loads(store.get("x/.zarray"))["chunks"] == [5, 3]
    assert sorted(k for k in store.keys() if k.startswith("x/") and k != "x/.zarray") == \
        [f"x/{i}.{j}" for i in range(4) for j in range(2)]
    assert _assert_reads_as_orbax(str(tmp_path / "ck")) == 2
    assert np.array_equal(orbax.read_tree(str(tmp_path / "ck"))["x"], x)


@pytest.mark.parametrize("fill", [None, 1.5, "NaN"])
def test_unwritten_chunks_hold_the_fill_value(tmp_path, fill):
    """A zarr array in an OCDBT store of which only some chunks were
    written (edge chunks included), with several B-tree levels: the reader
    gives tensorstore's own read."""
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/",
                        "config": {"max_decoded_node_bytes": 256}, "path": "arr/"},
            "metadata": {"dtype": "<f4", "shape": [7, 10], "chunks": [3, 4], "fill_value": fill,
                         "compressor": {"id": "zstd", "level": 1}},
            "create": True}
    arr = ts.open(spec).result()
    r = np.random.default_rng(2)
    arr[0:3, 4:8] = r.normal(size=(3, 4)).astype(np.float32)
    arr[6:7, 8:10] = r.normal(size=(1, 2)).astype(np.float32)
    want = arr.read().result()
    store = ocdbt.OcdbtStore(str(tmp_path))
    assert sum(k.startswith("arr/") for k in store.keys()) == 3  # .zarray + 2 chunks
    got = orbax.read_array(store, "arr")
    np.testing.assert_array_equal(got, want)
    assert got.tobytes() == np.asarray(want).tobytes()


def test_ocdbt_tree_of_several_levels_reads_as_tensorstore(tmp_path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 8}}).result()
    values = {f"k{i:03d}/{'x' * (i % 5)}": bytes([i]) * (i % 13) for i in range(80)}
    with ts.Transaction() as txn:
        for k, v in values.items():
            kv.with_transaction(txn)[k] = v
    store = ocdbt.OcdbtStore(str(tmp_path))
    assert sorted(store.keys()) == sorted(values)
    assert all(store.get(k) == v for k, v in values.items())
    assert sum(isinstance(v, tuple) for v in store.entries.values()) > 10  # references


def test_malformed_checkpoints_raise(jax_ckpt, tmp_path):
    """A flipped byte in the manifest or in the root B-tree node (their
    CRC-32C), a cut manifest, a wrong magic, a data file cut short, arrays
    outside an OCDBT store: each raises ValueError naming the checkpoint,
    never a partial value. (A byte
    flipped inside a zarr chunk's zstd data may decode: the chunks carry no
    checksum, for orbax as for this reader.)"""
    _, path, _, _ = jax_ckpt
    root_node = osp.join("d", os.listdir(osp.join(path, "d"))[0])
    data_files = [osp.relpath(osp.join(d, f), path) for d, _, fs in os.walk(path) for f in fs
                  if osp.basename(d) == "d"]
    biggest = max(data_files, key=lambda f: osp.getsize(osp.join(path, f)))
    edits = {"flip_manifest": ("manifest.ocdbt", lambda b: b[:40] + bytes([b[40] ^ 4]) + b[41:]),
             "cut_manifest": ("manifest.ocdbt", lambda b: b[:-7]),
             "magic": ("manifest.ocdbt", lambda b: bytes([b[0] ^ 1]) + b[1:]),
             "flip_node": (root_node, lambda b: b[:-9] + bytes([b[-9] ^ 0x40]) + b[-8:]),
             "cut_data": (biggest, lambda b: b[:len(b) // 2]),
             "no_ocdbt": ("_METADATA", lambda b: b.replace(b'"use_ocdbt": true',
                                                          b'"use_ocdbt": false'))}
    for how, (rel, edit) in edits.items():
        ck = shutil.copytree(path, str(tmp_path / how))
        with open(osp.join(ck, rel), "rb") as f:
            data = f.read()
        with open(osp.join(ck, rel), "wb") as f:
            f.write(edit(data))
        with pytest.raises(ValueError) as info:
            orbax.read_tree(ck)
        assert ck in str(info.value), (how, str(info.value))
    with pytest.raises(ValueError, match="not an orbax checkpoint"):
        orbax.read_tree(str(tmp_path))


def test_resume_from_jax_then_step_matches_jax(jax_ckpt):
    """train.py's resume path on a JAX checkpoint directory: the `last`
    pointer (JAX's absolute path, and the same directory moved), the state
    bit for bit, then one step of each package."""
    ckpt_dir, path, jstate1, step = jax_ckpt
    assert CK.latest_checkpoint(ckpt_dir) == path
    cfg_t = TS.OptimConfig(warm_up_steps=WARM)
    state = TS.TrainState(*port_nets(), cfg_t)  # another init, overwritten
    CK.restore_checkpoint(CK.latest_checkpoint(ckpt_dir), state)
    ae_sd, ist_sd = port_state_dicts(jstate1)
    assert state.step == 1
    for net, want in (("ae", ae_sd), ("ist", ist_sd)):
        got = state.nets[net].state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), net
        adam = jstate1.opt_state.inner_states[net].inner_state[0]
        assert state.opt_state[net]["count"] == int(adam.count) == 1
        for m in ("mu", "nu"):
            w = convert.params_flax_to_torch(net, to_numpy(getattr(adam, m)[net]))
            assert all(torch.equal(state.opt_state[net][m][k], w[k]) for k in w), (net, m)

    jrestored = JC.restore_checkpoint(path, jstate1)
    b = random_batch(101)
    jstate2, jm = step(jrestored, jax_batch(b))
    tm = TS.train_step(state, port_batch(b))
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=5e-4, err_msg=k)
    lr_sum = {"ae": 1e-5 * 1.5, "ist": 1e-4 * 1.5}
    ae_sd, ist_sd = port_state_dicts(jstate2)
    for net, want_sd in (("ae", ae_sd), ("ist", ist_sd)):
        got_sd, far, moved = state.nets[net].state_dict(), 0, 0
        for k, want in want_sd.items():
            got, w = got_sd[k].numpy(), want.numpy()
            if k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got, w, atol=1e-4, rtol=0, err_msg=k)
            elif net == "ae":
                np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, err_msg=k)
            else:
                d = np.abs(got - w)
                assert d.max() <= 2 * lr_sum[net], k
                far, moved = far + int((d > 0.1 * lr_sum[net]).sum()), moved + d.size
        assert far <= 0.02 * max(moved, 1), (net, far, moved)
        adam = jstate2.opt_state.inner_states[net].inner_state[0]
        assert state.opt_state[net]["count"] == int(adam.count) == 2
        for m in ("mu", "nu"):
            want = convert.params_flax_to_torch(net, to_numpy(getattr(adam, m)[net]))
            for k, v in state.opt_state[net][m].items():
                _close(v.numpy(), want[k].numpy(), net, k, after_steps=True)

    moved_dir = shutil.copytree(ckpt_dir, ckpt_dir + "_moved")
    try:
        shutil.move(path, path + "_gone")  # JAX's absolute path no longer exists
        found = CK.latest_checkpoint(moved_dir)
        assert found == osp.join(moved_dir, osp.basename(path))
        ae, ist, served = CK.serving_weights(moved_dir)
        assert served == found and all(torch.equal(ae[k], v) for k, v in
                                       port_state_dicts(jstate1)[0].items())
    finally:
        shutil.move(path + "_gone", path)


def test_train_py_resumes_a_jax_run(jax_ckpt, tmp_path, monkeypatch):
    """train.py resume=true on a run whose checkpoints/ holds the JAX
    trainer's (its tiny nets, GIGAPOSE_TINY): it restores step 1, steps
    once and writes the port's step_00000002.pt with the counts carried on."""
    from gigapose_tpu_torch import train as train_cli
    from tests import synthetic_bop

    jstate1 = jax_ckpt[2]
    root = synthetic_bop.build(str(tmp_path))
    ckpts = osp.join(root, "results", "large_resume", "checkpoints")
    JC.save_checkpoint(ckpts, jstate1, 1)
    monkeypatch.setenv("GIGAPOSE_TINY", "1")
    state = train_cli.main([f"machine.root_dir={root}", "train_dataset_name=tudl",
                            "machine.batch_size=2", "max_steps=2", "checkpoint_every=2",
                            "log_every=1", "run_id=resume", "resume=true", "device=cpu"])
    assert state.step == 2
    assert CK.latest_checkpoint(ckpts) == osp.join(ckpts, "step_00000002.pt")
    sd = CK.load_checkpoint(osp.join(ckpts, "step_00000002.pt"))
    assert sd["step"] == 2 and [sd["optimizer"][n]["count"] for n in ("ae", "ist")] == [2, 2]


def test_committed_fixtures_read_as_their_manifest():
    """What chip_smoke.py's phase 20a checks on the card: every array of
    tests/data/orbax as the manifest (orbax's restore) gives it."""
    manifest = json.load(open(osp.join(FIX.HERE, "manifest.json")))
    for name, arrays in manifest.items():
        got = dict(FIX.flatten(orbax.read_tree(osp.join(FIX.HERE, name))))
        assert sorted(got) == sorted(arrays), name
        for k, rec in arrays.items():
            assert FIX.array_record(got[k]) == rec, (name, k)
    ae, ist, _ = CK.serving_weights(osp.join(FIX.HERE, FIX.TRAIN))
    assert len(ae) > 30 and len(ist) > 30


def test_fixture_script_still_writes_the_manifest(tmp_path):
    FIX.write(str(tmp_path))
    assert FIX.manifest_of(str(tmp_path)) == json.load(
        open(osp.join(FIX.HERE, "manifest.json")))
