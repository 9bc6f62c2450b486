"""nvcc build of the port's CUDA sources into shared libraries, loaded with ctypes.

Each source ``csrc/<name>.cu`` exposes a plain C entry point, so it compiles
in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/gigapose_tpu_torch/<name>-<hash>.so csrc/<name>.cu

The output lands in ``build/gigapose_tpu_torch/`` at the repository root
(git-ignored), named by a hash of the source and of the shared headers
``csrc/*.cuh``, and is built at first use in a process: nothing is compiled
at import. ``-Xptxas -v`` makes ptxas report
registers, shared memory and spills; the report is kept next to the library
as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "gigapose_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this exact source exists;
    returns the library's path."""
    src = CSRC_DIR / f"{name}.cu"
    # the headers every source may include: an edited header must not load a stale library
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(
        f"$ {' '.join(cmd)}\n# {time.perf_counter() - t0:.2f} s, rc {proc.returncode}\n"
        + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src} (log: {log}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    return ctypes.CDLL(str(build(name)))
