"""Where csrc/fused_matching.cu's f32 kernel (match_f32_kernel) spends its
time, and what its sums' start does to its accuracy: the kernel against
copies of itself, at the serving shape (B = 32 detections, 2 objects x 162
views, P = 256, C = 1024, a planted world). Needs a CUDA device.

    python -m gigapose_tpu_torch.scripts.match_f32_variants

Each variant is the source with one edit, built like the package's library
(kernels/build.py's flags) into build/gigapose_tpu_torch/variants/ and
called through ops/fused_matching.py's checks and launch:

    base     the kernel as it is
    start0   each strip's sums start at 0, not at kAccStart (-0.5)
    no_lo    one product a k-step, hi . hi: no correction products
    no_mma   no wgmma (the compiler drops the A fragments' reads and split
             with them): the TMA loads, the barriers and the epilogue

The cuts are the statements after the marker comments `// [cut <variants>]`
in the source. Prints one line per variant with its device ms (CUDA
events, the median of 3 runs of 5 launches after a warm-up) and, where the
variant computes the function, the largest gap of sim_avg and score_t2s
from the plain version's f64 product and how many idx_t2s / valid entries
differ from it; then, as a yardstick of the card's TF32 rate, one batched
TF32 matmul of the pre-gathered views (cuBLAS, allow_tf32: one product, not
f32-grade), and the card's name and power limit. The cut variants compute
wrong outputs: only their times mean anything.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gigapose_tpu_torch.kernels import build as KB
from gigapose_tpu_torch.ops import fused_matching as FM

MARK = re.compile(r"^\s*// \[cut ([a-z_0-9, ]+)\]")
CUTS = ("no_lo", "no_mma")
START = "constexpr float kAccStart = -0.5f;"
MATCH = dict(sim_threshold=0.5, patch_threshold=3, num_patches=16)
SHAPE = dict(B=32, O=2, V=162, npat=16, C=1024)


def variants(src: str) -> dict:
    """The base source, start0, and each cut: every statement (one line)
    after a marker naming the variant removed."""
    if src.count(START) != 1:
        raise RuntimeError(f"csrc/fused_matching.cu: no single line {START!r}")
    out = {"base": src, "start0": src.replace(START, "constexpr float kAccStart = 0.f;")}
    lines = src.splitlines(keepends=True)
    for name in CUTS:
        marks = [i for i, line in enumerate(lines)
                 if (m := MARK.match(line)) and name in m.group(1).replace(" ", "").split(",")]
        if not marks:
            raise RuntimeError(f"{name}: no marker in csrc/fused_matching.cu")
        out[name] = "".join(line for i, line in enumerate(lines) if i - 1 not in marks)
    return out


def build_variant(name: str, src: str):
    out = KB.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"fused_matching_{name}.cu"
    path.write_text(src)
    lib = out / f"fused_matching_{name}.so"
    cmd = [KB.find_nvcc(), *KB.NVCC_FLAGS, f"-I{KB.CSRC_DIR}", "-o", str(lib), str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    return FM.declare(ctypes.CDLL(str(lib)))[0]


def planted_world(seed, B, O, V, npat, C):
    """Random unit features; view (labels[b], b % V) copies half of query
    b's patches up to noise (chip_smoke.py's planted_world)."""
    rng = np.random.default_rng(seed)
    P = npat * npat
    tar = rng.standard_normal((B, P, C), dtype=np.float32)
    store = rng.standard_normal((O, V, P, C), dtype=np.float32)
    labels = rng.integers(0, O, size=B).astype(np.int32)
    for b in range(B):
        take = rng.integers(0, P, size=P // 2)
        store[labels[b], b % V, take] = tar[b, take] + 0.05 * rng.standard_normal(
            (len(take), C), dtype=np.float32)
    tar /= np.linalg.norm(tar, axis=-1, keepdims=True)
    store /= np.linalg.norm(store, axis=-1, keepdims=True)
    tmask = (rng.uniform(size=(B, P)) > 0.2).astype(np.float32)
    smask = (rng.uniform(size=(O, V, P)) > 0.2).astype(np.float32)
    return tar, store, tmask, smask, labels


def device_ms(fn) -> float:
    fn()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 5)
    return float(np.median(times))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("match_f32_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    srcs = variants((KB.CSRC_DIR / "fused_matching.cu").read_text())
    with ThreadPoolExecutor(len(srcs)) as pool:
        entries = dict(zip(srcs, pool.map(build_variant, srcs, srcs.values())))
    args = tuple(torch.as_tensor(a).to(dev) for a in planted_world(0, **SHAPE))
    with torch.inference_mode():
        ref = FM.match_scores_plain(*args, products="f64", **MATCH)
    for name, entry in entries.items():
        run = lambda: FM._launch(*args, **MATCH, match_entry=entry)
        out = run()
        torch.cuda.synchronize()
        fields = dict(ms=f"{device_ms(run):.4f}")
        if name in ("base", "start0"):
            fields.update(
                gap_f64=f"{max(float((out[i].double() - ref[i]).abs().max()) for i in (0, 2)):.3e}",
                idx_differ=int((out[1] != ref[1]).sum()), valid_differ=int((out[3] != ref[3]).sum()))
        print(f"[match_f32_variant] variant={name} "
              + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)
    B, P, C = args[0].shape
    src = args[1][args[4].long()].reshape(B, -1, C)
    tar_t = args[0].transpose(1, 2)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_ms = device_ms(lambda: torch.bmm(src, tar_t))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[match_f32_yardstick] tf32_bmm_ms={tf32_ms:.4f} "
          f"tf32_tflops={2.0 * B * src.shape[1] * P * C / tf32_ms / 1e9:.1f}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
