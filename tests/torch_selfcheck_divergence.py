"""How fast two selfcheck_e2e trainings part on the CPU: the port against the
JAX package from the same init, and the JAX package against itself with its
init perturbed by 1e-6 relative. Not a test: a measurement behind PERF.md's
acceptance findings, run by hand (about 2 min for `steps`, 6 min per `train`
run with two threads):

    python tests/torch_selfcheck_divergence.py steps [n=60] [root=<dir>]
    python tests/torch_selfcheck_divergence.py train init=jax|port [n=600] [root=<dir>]
    python tests/torch_selfcheck_divergence.py stores seed=1 [n=600] [root=<dir>]

`steps` trains both packages on the pasted-texture fixture with the
selfcheck_e2e recipe (grad clip 1.0, InfoNCE temperature 0.5 -> 0.1 over
50 steps, the same loader seed) and prints, per step, the largest relative
gap of any metric: port against JAX from JAX's init (flax's, PRNGKey
2023, through the weight bridge), and JAX against JAX perturbed. `train`
runs the port's selfcheck_e2e on the CPU from JAX's init or from its own
and prints its JSON line. `stores` trains the port's nets on the CPU (the
selfcheck_e2e recipe at `seed`) and estimates the test image with them four
ways, a bf16 or an f32 store each through the fused matcher's plain
version and through match_templates (the JAX script's f32 store and
matcher), printing each pose's error and score.
"""

import os.path as osp
import shutil
import sys
import tempfile

import jax
import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from gigapose_tpu.dataloader.scene import DirSceneSource as JDirSceneSource  # noqa: E402
from gigapose_tpu.dataloader.train_set import TrainLoader as JTrainLoader  # noqa: E402
from gigapose_tpu.models.ae_net import AENet as JAENet  # noqa: E402
from gigapose_tpu.models.ist_net import ISTBackbone as JISTBackbone  # noqa: E402
from gigapose_tpu.models.ist_net import ISTNet as JISTNet  # noqa: E402
from gigapose_tpu.models.ist_net import Regressor as JRegressor  # noqa: E402
from gigapose_tpu.training import loop as JL  # noqa: E402
from gigapose_tpu.training import state as JS  # noqa: E402
from gigapose_tpu_torch.dataloader.scene import DirSceneSource  # noqa: E402
from gigapose_tpu_torch.dataloader.train_set import TrainLoader  # noqa: E402
from gigapose_tpu_torch.models import convert  # noqa: E402
from gigapose_tpu_torch.scripts import selfcheck_e2e, synthetic_bop  # noqa: E402
from gigapose_tpu_torch.training.loop import FitConfig, fit  # noqa: E402
from gigapose_tpu_torch.training.state import OptimConfig  # noqa: E402

RECIPE = dict(ae_lr=3e-4, ist_lr=1e-3, warm_up_steps=10, grad_clip=1.0, tau_start=0.5,
              tau_warmup_steps=50)


def jax_nets():
    return (JAENet(model_name="vit_tiny_test"),
            JISTNet(backbone=JISTBackbone(initial_dim=16, block_dims=(16, 16, 24, 32),
                                          descriptor_size=32, input_size=256),
                    regressor=JRegressor(hidden_dim=32)))


def jax_init(eps: float = 0.0):
    """The JAX trainer's init (create_train_state at PRNGKey 2023), each
    parameter times (1 + eps N(0, 1)) when eps > 0."""
    jae, jist = jax_nets()
    state, tx = JS.create_train_state(jae, jist, jax.random.PRNGKey(selfcheck_e2e.INIT_SEED),
                                      JS.OptimConfig(**RECIPE))
    if eps:
        rng = np.random.default_rng(1)
        pert = lambda x: jax.numpy.asarray(
            np.asarray(x) * (1 + eps * rng.standard_normal(x.shape).astype(np.float32)))
        state = state._replace(ae_params=jax.tree_util.tree_map(pert, state.ae_params),
                               ist_params=jax.tree_util.tree_map(pert, state.ist_params))
    return state, tx


def port_nets_from(state):
    npy = lambda t: jax.tree_util.tree_map(np.asarray, t)
    ae_sd, ist_sd = convert.train_state_flax_to_torch(npy(state.ae_params), npy(state.ist_params),
                                                      npy(state.ist_batch_stats))
    ae, ist = selfcheck_e2e.tiny_nets()
    ae.load_state_dict(ae_sd, strict=True)
    ist.load_state_dict(ist_sd, strict=True)
    return ae, ist


def jax_metrics(root: str, n: int, state, tx) -> dict:
    split, tdir = _split(root)
    JL.create_train_state = lambda *args, **kw: (state, tx)
    out = {}
    jae, jist = jax_nets()
    JL.fit(jae, jist, JTrainLoader(scene_source=JDirSceneSource(split), template_dir=tdir,
                                   batch_size=3, rgb_augmentation=False, seed=0),
           optim_cfg=JS.OptimConfig(**RECIPE),
           fit_cfg=JL.FitConfig(max_steps=n, log_every=1, checkpoint_every=10**9),
           metrics_hook=lambda step, m: out.setdefault(step, m))
    return out


def _split(root: str):
    return (osp.join(root, "datasets", "tudl", "train_pbr"),
            osp.join(root, "datasets", "templates", "tudl"))


def gaps(a: dict, b: dict) -> list:
    """Per step: (the largest relative gap of any metric, that metric)."""
    out = []
    for step in sorted(a):
        rel = {k: abs(a[step][k] - b[step][k]) / max(abs(a[step][k]), 1e-6) for k in a[step]}
        worst = max(rel, key=rel.get)
        out.append((step, rel[worst], worst))
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    mode, kv = argv[0], dict(a.split("=", 1) for a in argv[1:])
    root = kv.get("root") or osp.join(tempfile.gettempdir(), f"gp_divergence_{mode}")
    torch.set_num_threads(2)
    if mode == "steps":
        n = int(kv.get("n", 60))
        shutil.rmtree(root, ignore_errors=True)
        synthetic_bop.build(root)
        state, tx = jax_init()
        ae, ist = port_nets_from(state)  # before JAX's fit donates the state's buffers
        split, tdir = _split(root)
        port = {}
        fit(ae, ist, TrainLoader(scene_source=DirSceneSource(split), template_dir=tdir,
                                 batch_size=3, rgb_augmentation=False, seed=0),
            "cpu", OptimConfig(**RECIPE), FitConfig(max_steps=n, log_every=1,
                                                    checkpoint_every=10**9),
            metrics_hook=lambda step, m: port.setdefault(step, m))
        jax_a = jax_metrics(root, n, state, tx)
        jax_b = jax_metrics(root, n, *jax_init(eps=1e-6))
        print("step  port-vs-JAX (same init)  JAX-vs-JAX (init x (1 + 1e-6 N))")
        for (s, g1, k1), (_, g2, k2) in zip(gaps(jax_a, port), gaps(jax_a, jax_b)):
            print(f"{s:4d}  {g1:.2e} {k1:10s}  {g2:.2e} {k2}")
    elif mode == "train":
        if kv.get("init", "port") == "jax":
            nets = port_nets_from(jax_init()[0])
            selfcheck_e2e.tiny_nets = lambda ae_model="vit_tiny_test": nets
        selfcheck_e2e.main([f"root={root}", f"steps={kv.get('n', 600)}", "device=cpu"])
    elif mode == "stores":
        from gigapose_tpu_torch.dataloader import bop_io
        from gigapose_tpu_torch.dataloader.test_set import InferenceDataset
        from gigapose_tpu_torch.pipeline.estimator import EstimatorConfig, GigaPoseEstimator
        from gigapose_tpu_torch.pipeline.runner import CoarseRunner

        shutil.rmtree(root, ignore_errors=True)
        state = selfcheck_e2e.train({"steps": kv.get("n", "600"), "seed": kv.get("seed", "0")},
                                    torch.device("cpu"), root)
        K = selfcheck_e2e.FIXTURE_K
        gt = np.array([(440 - K[0, 2]) * 400 / K[0, 0], (160 - K[1, 2]) * 400 / K[1, 1], 400])
        for name, dtype, fused in (("bf16_fused", torch.bfloat16, True),
                                   ("bf16_match_templates", torch.bfloat16, False),
                                   ("f32_fused", None, True), ("f32_match_templates", None, False)):
            est = GigaPoseEstimator(state.ae_net.eval(), state.ist_net.eval(),
                                    EstimatorConfig(use_pallas_matching=fused))
            runner = CoarseRunner.onboard(est, template_dir=_split(root)[1],
                                          save_dir=osp.join(root, "results", name),
                                          dataset_name="tudl", num_templates=8,
                                          feature_dtype=dtype)
            paths = runner.run(InferenceDataset(root_dir=osp.join(root, "datasets"),
                                                dataset_name="tudl"), model_name="sc")
            top1 = bop_io.load_bop_csv(paths[0])[0]
            rot = np.degrees(np.arccos(np.clip((np.trace(top1["R"]) - 1) / 2, -1, 1)))
            print(f"{name:22s} t_err_mm {np.linalg.norm(top1['t'].ravel() - gt):.2f} "
                  f"rot_err_deg {rot:.2f} score {top1['score']:.4f}")
    else:
        raise ValueError(f"mode {mode}: expected steps, train or stores")


if __name__ == "__main__":
    main()
