"""Build of the port's native sources into shared libraries, loaded with ctypes.

Each CUDA source ``csrc/<name>.cu`` exposes a plain C entry point, so it
compiles in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v [EXTRA_NVCC_FLAGS[name]] \
         -o build/gigapose_tpu_torch/<name>-<hash>.so csrc/<name>.cu

A host source ``csrc/<name>.cpp`` (the host rasterizer) is built with the
host compiler (``$CXX``, else ``g++``) and native/Makefile's flags
``-O3 -fPIC -shared -std=c++17``, so that it computes what the JAX
package's build of the same source computes. It is linked with a private
copy of the C++ runtime (``-static-libstdc++ -static-libgcc
-Wl,--exclude-libs,ALL``: only its C entry points are exported): a process
that already holds another libstdc++, as torch's does, would otherwise bind
the library's runtime calls to that one, which breaks a library built by a
compiler of another version.

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
# per-source additions: the rasterizer and the int8 convolution's epilogue
# round every product and sum on their own, as their plain PyTorch versions
# do (no contraction into FMA)
EXTRA_NVCC_FLAGS = {"rasterizer": ["-fmad=false"], "qconv": ["-fmad=false"]}
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
CXX_LINK_FLAGS = ["-static-libstdc++", "-static-libgcc", "-Wl,--exclude-libs,ALL"]


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


def _command(name: str):
    """(source, library name, compiler command without its output, bytes
    the library's file name hashes besides the source)."""
    if name.endswith(".cpp"):
        src = CSRC_DIR / name
        cxx = os.environ.get("CXX") or "g++"
        cmd = [cxx, *CXX_FLAGS, *CXX_LINK_FLAGS, str(src)]
        return src, f"{src.stem}_host", cmd, " ".join(cmd[:-1]).encode()
    src = CSRC_DIR / f"{name}.cu"
    flags = NVCC_FLAGS + EXTRA_NVCC_FLAGS.get(name, [])
    # the headers every source may include: an edited header must not load a stale library
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    return src, name, [find_nvcc(), *flags, str(src)], headers + " ".join(flags).encode()


def build(name: str) -> Path:
    """Compile csrc/<name>.cu with nvcc, or csrc/<name> when it names a
    `.cpp` with the host compiler, unless the library for this exact source
    exists; returns the library's path. A failed build raises."""
    src, lib, cmd, salt = _command(name)
    digest = hashlib.sha256(src.read_bytes() + salt).hexdigest()[:16]
    out = BUILD_DIR / f"{lib}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = cmd[:-1] + ["-o", str(tmp), cmd[-1]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(
        f"$ {' '.join(cmd)}\n# {time.perf_counter() - t0:.2f} s, rc {proc.returncode}\n"
        + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed for {src} (log: {log}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu (or csrc/<name>.cpp) once per process."""
    return ctypes.CDLL(str(build(name)))
