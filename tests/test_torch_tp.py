"""Tensor parallelism (parallel/tp.py, models/vit.py's `tp`) and
object-parallel onboarding (pipeline/templates.onboard_templates_sharded)
of the port against the JAX package, CPU.

- TP: one launch of 4 gloo processes (parallel/multihost's launch
  contract) runs every case: (dp, mp) = (1, 2), (2, 2) and (1, 4) on
  vit_tiny_test (2 heads: at mp = 4 the heads stay whole and only the MLP
  is split, as JAX's constrain_heads leaves them) and (2, 2) on
  vit_tiny_swiglu_test (the w12 / w3 split), in f32; and (1, 2) on
  vit_tiny_test in bf16, whose every patch's cosine to JAX's bf16 forward
  must pass 0.999 (tests/test_torch_models.py's bf16 agreement). Each rank in the grid loads
  shard_vit_tp's slice of the whole state dict (JAX's params through the
  weight bridge) and its AENet(tp=...) features of a batch of 8 at 224 x
  224 equal JAX's single-device AENet.apply within tests/test_tp.py's
  2e-5 (atol and rtol); each rank's shard shapes are the whole ones
  divided as test_params_actually_sharded checks them (qkv and fc1 / w12
  rows, proj and fc2 / w3 columns split; norms whole), and the shard is
  the right slice: rank r's q, k and v rows are heads r * H / mp.., its
  w12 rows are both halves' block r;
- a hidden width that mp does not divide raises ValueError, and the TP
  forward with gradients on raises;
- onboarding on 8 CPU "devices" ([cpu] * 8) against JAX's
  onboard_templates_sharded on its 8 virtual devices with
  tests/test_onboard_sharded.py's inputs (3 objects padded to 8; the AE as
  one callable per device, the IST as one for all): features and Ms
  within 1e-5, masks and poses equal; and bit for bit the port's own
  sequential onboard_templates.
"""

import os
import os.path as osp
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapose_tpu.models.ae_net import AENet as JAENet
from gigapose_tpu.parallel.mesh import make_mesh
from gigapose_tpu.pipeline.templates import onboard_templates_sharded as jax_onboard_sharded
from gigapose_tpu_torch.models import convert
from gigapose_tpu_torch.models.ae_net import AENet
from gigapose_tpu_torch.models.vit import VIT_CONFIGS, Mlp
from gigapose_tpu_torch.parallel.tp import TPGroups, row_parallel, shard_vit_tp
from gigapose_tpu_torch.pipeline.templates import onboard_templates, onboard_templates_sharded

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CASES = [(1, 2, "vit_tiny_test", None), (2, 2, "vit_tiny_test", None),
         (1, 4, "vit_tiny_test", None), (2, 2, "vit_tiny_swiglu_test", None),
         (1, 2, "vit_tiny_test", "bfloat16")]
TOL = 2e-5
BF16_COS = 0.999  # tests/test_torch_models.py's bf16 agreement, per patch

TP_SCRIPT = textwrap.dedent("""
    import json, os
    import numpy as np
    import torch
    from gigapose_tpu_torch.models.ae_net import AENet
    from gigapose_tpu_torch.models.vit import VIT_CONFIGS
    from gigapose_tpu_torch.parallel import multihost
    from gigapose_tpu_torch.parallel.tp import make_dp_mp_groups, shard_vit_tp
    rank, world = multihost.maybe_initialize()
    torch.set_num_threads(1)
    out = os.environ["OUT"]
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    x = torch.as_tensor(inputs["x"])
    for i, (dp, mp, model, dtype) in enumerate(inputs["cases"]):
        tp = make_dp_mp_groups(dp, mp)
        if tp is None:
            continue
        ae = AENet(model, compute_dtype=dtype, tp=tp)
        local = shard_vit_tp(inputs["sd"][model], tp.mp_rank, mp, VIT_CONFIGS[model].num_heads)
        ae.load_state_dict(local, strict=True)
        with torch.inference_mode():
            feats = ae(x)
        torch.save(dict(feats=feats, shapes={k: tuple(v.shape) for k, v in local.items()},
                        local=local, dp_rank=tp.dp_rank, mp_rank=tp.mp_rank),
                   os.path.join(out, f"case{i}_rank{rank}.pt"))
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(script: str, out: str, n_proc: int, timeout: int = 300) -> None:
    """`script` in n_proc gloo processes joined through the
    GIGAPOSE_COORDINATOR contract, each one's output in a file."""
    port, procs = _free_port(), []
    for pid in range(n_proc):
        env = dict(os.environ, GIGAPOSE_COORDINATOR=f"127.0.0.1:{port}",
                   GIGAPOSE_NUM_PROCESSES=str(n_proc), GIGAPOSE_PROCESS_ID=str(pid),
                   GIGAPOSE_DIST_BACKEND="gloo", OUT=out, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        log = open(osp.join(out, f"proc_{pid}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, "-c", script], env=env, cwd=REPO,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for pid, (p, _) in enumerate(procs):
        assert p.returncode == 0, open(osp.join(out, f"proc_{pid}.log")).read()[-4000:]


def _jax_ae(model, x, dtype=None):
    ae = JAENet(model_name=model, compute_dtype=dtype)
    params = ae.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    # LayerScale at 0.1 (its 1e-5 init would hide the blocks)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if jax.tree_util.keystr(p).endswith("['gamma']")
        else v, params)
    return params, np.asarray(jax.jit(ae.apply)(params, jnp.asarray(x)))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every case in one launch of 4 processes -> (outputs per case and
    rank, JAX's features per model, the whole state dicts)."""
    out = str(tmp_path_factory.mktemp("tp"))
    x = np.random.default_rng(0).normal(size=(8, 3, 224, 224)).astype(np.float32)
    sd, ref = {}, {}
    for _, _, model, dtype in CASES:
        params, ref[model, dtype] = _jax_ae(model, x, dtype)
        sd[model] = convert.ae_flax_to_torch(jax.tree_util.tree_map(np.asarray, params))
    torch.save(dict(x=x, sd=sd, cases=CASES), osp.join(out, "inputs.pt"))
    _run(TP_SCRIPT, out, 4)
    runs = {i: {int(f.split("rank")[1][:-3]): torch.load(osp.join(out, f), weights_only=False)
                for f in os.listdir(out) if f.startswith(f"case{i}_")}
            for i in range(len(CASES))}
    return runs, ref, sd


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"dp{dp}-mp{mp}-{m}" + ("-bf16" if d else "")
                              for dp, mp, m, d in CASES])
def test_tp_forward_matches_jax_single_device(tp_runs, case):
    """f32: within 2e-5 of JAX's features; bf16 (the row-split sums in f32,
    one rounding after them): every patch's cosine to JAX's bf16 forward
    above BF16_COS."""
    runs, ref, sd = tp_runs
    dp, mp, model, dtype = CASES[case]
    assert sorted(runs[case]) == list(range(dp * mp))
    cfg = VIT_CONFIGS[model]
    C, H = cfg.embed_dim, cfg.num_heads
    attn_split = H % mp == 0
    for rank, r in runs[case].items():
        assert (r["dp_rank"], r["mp_rank"]) == divmod(rank, mp)
        got, want = r["feats"].numpy(), ref[model, dtype]
        if dtype is None:
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=f"rank {rank}")
        else:
            assert got.dtype == np.float32 and (got * want).sum(-1).min() > BF16_COS, rank
        whole, shapes, m = sd[model], r["shapes"], r["mp_rank"]
        blk = "vit.blocks.0."
        mlp_in, mlp_out = ("fc1", "fc2") if cfg.ffn_layer == "mlp" else ("w12", "w3")
        a = mp if attn_split else 1
        assert shapes[blk + "attn.qkv.weight"] == (3 * C // a, C)
        assert shapes[blk + "attn.proj.weight"] == (C, C // a)
        assert shapes[blk + "attn.proj.bias"] == (C,)
        hid = whole[blk + f"mlp.{mlp_in}.weight"].shape[0]
        assert shapes[blk + f"mlp.{mlp_in}.weight"] == (hid // mp, C)
        assert shapes[blk + f"mlp.{mlp_out}.weight"] == (C, hid // (2 if mlp_in == "w12" else 1)
                                                          // mp)
        assert shapes[blk + "norm1.weight"] == (C,) and shapes["vit.pos_embed"] == (1, 257, C)
        local = r["local"]
        if attn_split:  # heads m * H / mp .. of q, k and v
            q_k_v = whole[blk + "attn.qkv.weight"].reshape(3, H, C // H, C)
            want = q_k_v[:, m * H // mp:(m + 1) * H // mp].reshape(-1, C)
            assert torch.equal(local[blk + "attn.qkv.weight"], want)
        if mlp_in == "w12":  # block m of both halves
            halves = whole[blk + "mlp.w12.weight"].reshape(2, hid // 2, C)
            n = hid // 2 // mp
            assert torch.equal(local[blk + "mlp.w12.weight"],
                               halves[:, m * n:(m + 1) * n].reshape(-1, C))


def test_tp_refusals():
    grid = TPGroups(dp=1, mp=3, dp_rank=0, mp_rank=0)
    with pytest.raises(ValueError, match="mp=3 does not divide the MLP hidden width 256"):
        Mlp(64, 256, tp=grid)
    sd = AENet("vit_tiny_test").state_dict()
    with pytest.raises(ValueError, match="mp=3 does not divide"):
        shard_vit_tp(sd, 0, 3, num_heads=2)
    layer = torch.nn.Linear(4, 2)
    with pytest.raises(RuntimeError, match="inference only"):
        row_parallel(layer, torch.zeros(1, 4), None, TPGroups(dp=1, mp=1, dp_rank=0, mp_rank=0))


def test_onboard_sharded_matches_jax_and_the_sequential_store():
    ae = JAENet(model_name="vit_tiny_test")
    params = ae.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 56, 56)))
    apply = jax.jit(lambda x: ae.apply(params, x))
    O, V, H = 3, 6, 64
    rng = np.random.default_rng(0)
    rgbas = rng.uniform(size=(O, V, 4, H, H)).astype(np.float32)
    rgbas[:, :, 3] = (rgbas[:, :, 3] > 0.3).astype(np.float32)
    rgbas[:, :, 3, H // 2, H // 2] = 1.0
    poses = np.tile(np.eye(4, dtype=np.float32), (O, V, 1, 1))
    kw = dict(target_size=56, num_patches=4, chunk=4)
    want = jax_onboard_sharded(apply, apply, rgbas, poses, make_mesh(8), **kw)

    net = AENet("vit_tiny_test")
    net.load_state_dict(convert.ae_flax_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    net.eval()
    got = onboard_templates_sharded([net] * 8, net, rgbas, poses, ["cpu"] * 8, **kw)
    seq = onboard_templates(net, net, list(rgbas), list(poses), torch.device("cpu"), **kw)
    for f in ("ae_features", "ist_features", "masks", "Ms", "poses", "K"):
        assert torch.equal(getattr(got, f), getattr(seq, f)), f
    assert got.ae_features.shape == tuple(want.ae_features.shape)
    for f in ("ae_features", "ist_features", "Ms"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    for f in ("masks", "poses"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
