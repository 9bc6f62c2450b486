"""ctypes binding of the port's host rasterizer (csrc/rasterizer.cpp, the
C++ software rasterizer of gigapose_tpu/render/rasterizer.py).

The library is built with the host compiler at first use
(kernels/build.py), never at import. Each call of `grast_render2` runs in
C with the GIL released, so threads render in parallel (MeshStore's pool).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

_F32P = ctypes.POINTER(ctypes.c_float)


@functools.cache
def _library() -> ctypes.CDLL:
    from gigapose_tpu_torch.kernels.build import load_library

    lib = load_library("rasterizer.cpp")
    lib.grast_load_mesh.restype = ctypes.c_void_p
    lib.grast_load_mesh.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.grast_free_mesh.restype = None
    lib.grast_free_mesh.argtypes = [ctypes.c_void_p]
    lib.grast_mesh_diameter.restype = ctypes.c_double
    lib.grast_mesh_diameter.argtypes = [ctypes.c_void_p]
    lib.grast_mesh_center.restype = None
    lib.grast_mesh_center.argtypes = [ctypes.c_void_p, _F32P]
    lib.grast_num_vertices.restype = ctypes.c_int
    lib.grast_num_vertices.argtypes = [ctypes.c_void_p]
    lib.grast_render2.restype = ctypes.c_int
    lib.grast_render2.argtypes = [ctypes.c_void_p, _F32P, _F32P, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_uint8), _F32P, _F32P]
    return lib


class Rasterizer:
    """One loaded mesh; renders views with any K, pose and size."""

    def __init__(self, mesh_path: str):
        self._lib = _library()
        status = ctypes.c_int(0)
        self._handle = self._lib.grast_load_mesh(mesh_path.encode(), ctypes.byref(status))
        if status.value != 0 or not self._handle:
            raise IOError(f"Failed to load mesh: {mesh_path}")
        self.mesh_path = mesh_path

    @property
    def diameter(self) -> float:
        return float(self._lib.grast_mesh_diameter(self._handle))

    @property
    def center(self) -> np.ndarray:
        out = (ctypes.c_float * 3)()
        self._lib.grast_mesh_center(self._handle, out)
        return np.asarray(out, np.float32)

    @property
    def num_vertices(self) -> int:
        return int(self._lib.grast_num_vertices(self._handle))

    def render(self, K: np.ndarray, pose: np.ndarray, width: int = 640,
               height: int = 480) -> Tuple[np.ndarray, np.ndarray]:
        """K (3,3), pose (4,4) object -> camera in mesh units -> (rgba (H,W,4)
        uint8, depth (H,W) float32, camera units, 0 on background)."""
        rgba, depth, _ = self.render_full(K, pose, width, height, normals=False)
        return rgba, depth

    def render_full(self, K: np.ndarray, pose: np.ndarray, width: int = 640,
                    height: int = 480, normals: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """render() plus, with `normals`, the unit camera-space face normal per
        pixel (H,W,3) float32, 0 on background. A pose that is not finite
        renders nothing."""
        K32 = np.ascontiguousarray(K, np.float32)
        T32 = np.ascontiguousarray(pose, np.float32)
        nrm = np.zeros((height, width, 3), np.float32) if normals else None
        rgba = np.zeros((height, width, 4), np.uint8)
        depth = np.zeros((height, width), np.float32)
        if not np.isfinite(T32).all():
            return rgba, depth, nrm
        rc = self._lib.grast_render2(
            self._handle, K32.ctypes.data_as(_F32P), T32.ctypes.data_as(_F32P), width, height,
            rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), depth.ctypes.data_as(_F32P),
            nrm.ctypes.data_as(_F32P) if nrm is not None else None,
        )
        if rc != 0:
            raise RuntimeError(f"render failed rc={rc}")
        return rgba, depth, nrm

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.grast_free_mesh(self._handle)
            self._handle = None
