"""Where csrc/qconv.cu's convolution spends its time: the kernel against
copies of itself with one part cut out, at the int8 IST's heaviest shapes
(B = 32), on both routes of the im2col tile. Needs a CUDA device.

    python -m gigapose_tpu_torch.scripts.qconv_variants

Each variant is the source with one statement cut, built like the
package's library (kernels/build.py's flags) into
build/gigapose_tpu_torch/variants/ and called through its C entry point
with random codes. The statements are the ones after the marker comments
`// [cut <variants>]` in csrc/qconv.cu, so that an edit of the statement
itself leaves the variants in step:

    base       the kernel as it is
    no_epi     no output stores (the epilogue still computes)
    no_mma     no wgmma (the accumulators stay 0)
    no_gather  the gather issues no copies (stale tiles; its loop still runs)
    zfill      the gather's copies read nothing and write zeros
    no_vote    the int8 output's codes from the product with the
               reciprocal alone: no warp vote, no division near midpoints

Routes: "tma" (the TMA window, where the shape allows it) and "gather"
(forced on every shape: the C entry takes a window of 0 columns). Prints
one line per (shape, route, output) with the device ms of each variant
(CUDA-graph replays, median of 5), then the card's name and power limit.
The cut variants compute wrong outputs: only their times mean anything.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gigapose_tpu_torch.kernels import build as KB
from gigapose_tpu_torch.ops import qconv as QC

# a marker comment line of csrc/qconv.cu, naming the variants that cut the
# statement after it
MARK = re.compile(r"^\s*// \[cut ([a-z_, ]+)\]")
CUTS = ("no_epi", "no_mma", "no_gather", "no_vote")
# (name, input side, C, O, kernel, stride, pad, residual, relu): chip_smoke.py's IST_CONVS
SHAPES = [("l1_conv1", 128, 128, 128, 3, 1, 1, False, True),
          ("l1_conv2", 128, 128, 128, 3, 1, 1, True, True),
          ("l2_conv1", 64, 192, 192, 3, 1, 1, False, True),
          ("l3_conv2", 32, 256, 256, 3, 1, 1, True, True),
          ("l4_conv1", 16, 512, 512, 3, 1, 1, False, True)]
B = 32


def variants(src: str) -> dict:
    """The base source and each variant: the statement after its marker
    (through the first line ending in ';', or where it opens a block with
    '{', through the line that closes it) removed, or for zfill run with
    its `ok` false (no bytes read, 16 zeros written)."""
    lines = src.splitlines(keepends=True)
    out = {"base": src}
    for name in (*CUTS, "zfill"):
        marks = [i for i, line in enumerate(lines)
                 if (m := MARK.match(line)) and name in m.group(1).replace(" ", "").split(",")]
        if len(marks) != 1:
            raise RuntimeError(f"{name}: {len(marks)} markers in csrc/qconv.cu, not one")
        start = end = marks[0] + 1
        if lines[start].rstrip().endswith("{"):
            depth = 0
            while True:
                depth += lines[end].count("{") - lines[end].count("}")
                if depth == 0:
                    break
                end += 1
        else:
            while not lines[end].rstrip().endswith(";"):
                end += 1
        stmt = "".join(lines[start:end + 1])
        cut = "" if name in CUTS else "{ const bool ok = false;\n" + stmt + "}\n"
        out[name] = "".join(lines[:start]) + cut + "".join(lines[end + 1:])
    return out


def build_variant(item):
    name, text = item
    out = KB.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"qconv_{name}.cu", out / f"qconv_{name}.so"
    cu.write_text(text)
    cmd = [KB.find_nvcc(), *KB.NVCC_FLAGS, *KB.EXTRA_NVCC_FLAGS["qconv"], "-I",
           str(KB.CSRC_DIR), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gp_qconv_conv.argtypes = [p, p, i] + [p] * 6 + [i] * 13 + [p]
    lib.gp_qconv_conv.restype = ctypes.c_int
    return name, lib


def graph_ms(fn, reps: int = 5, iters: int = 10) -> float:
    """Device ms of one fn(): `iters` calls in a CUDA graph, the median of
    `reps` replays after a warm-up."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("qconv_variants: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    src = (KB.CSRC_DIR / "qconv.cu").read_text()
    with ThreadPoolExecutor(len(CUTS) + 2) as pool:
        libs = dict(pool.map(build_variant, variants(src).items()))
    rng = np.random.default_rng(0)
    for name, S, C, O, ks, st, pad, res, relu in SHAPES:
        xq = torch.as_tensor(rng.integers(-127, 128, (B, S, S, C)).astype(np.int8), device=dev)
        wq = torch.as_tensor(rng.integers(-127, 128, (O, ks * ks * C)).astype(np.int8), device=dev)
        sx, ws, b = (torch.full((B,), 1e-2, device=dev), torch.full((O,), 1e-3, device=dev),
                     torch.zeros(O, device=dev))
        OH = QC.out_size(S, ks, st, pad)
        r = torch.randn((B, OH, OH, O), device=dev) if res else None
        route, cols = QC.im2col_route(C, OH, OH, st)
        for route, cols in {route: cols, "gather": 0}.items():
            for q8 in (False, True):
                out = torch.empty((B, OH, OH, O), dtype=torch.int8 if q8 else torch.float32,
                                  device=dev)
                so = torch.tensor(0.5, device=dev) if q8 else None
                row = {}
                for vname, lib in libs.items():
                    def call(lib=lib):
                        err = lib.gp_qconv_conv(
                            xq.data_ptr(), sx.data_ptr(), 1, wq.data_ptr(), ws.data_ptr(),
                            b.data_ptr(), None if r is None else r.data_ptr(), out.data_ptr(),
                            None if so is None else so.data_ptr(), B, S, S, C, OH, OH, O, ks, st,
                            pad, int(relu), QC.n_tile(B * OH * OH, O), cols,
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{vname}: CUDA error {err}")
                    row[vname] = graph_ms(call)
                print(f"[qconv_variant] shape={name} route={route} out={'int8' if q8 else 'f32'} "
                      + " ".join(f"{k}_ms={v:.4f}" for k, v in row.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
