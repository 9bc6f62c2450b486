"""Mesh readers (numpy only): a copy of gigapose_tpu/render/jax_renderer.py's
`load_mesh` (PLY ascii and binary little-endian, OBJ; polygon faces
fan-triangulated as the native loader does) and of
gigapose_tpu/refiner/refiner.py's `_load_vertices` (vertices only, f64)."""

from __future__ import annotations

import numpy as np


def load_mesh(path: str):
    """(verts (V,3) f32, faces (F,3) i32, colors (V,3) u8 or None)."""
    if path.endswith(".obj"):
        return _load_obj(path)
    return _load_ply(path)


def _load_obj(path: str):
    vs, cols, faces = [], [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(x) for x in t[1:4]])
                if len(t) >= 7:  # some OBJs carry vertex colors after xyz
                    cols.append([float(x) * 255.0 for x in t[4:7]])
            elif t[0] == "f":
                idx = [int(w.split("/")[0]) - 1 for w in t[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    verts = np.asarray(vs, np.float32)
    colors = (
        np.clip(np.asarray(cols), 0, 255).astype(np.uint8)
        if len(cols) == len(vs) and cols
        else None
    )
    return verts, np.asarray(faces, np.int32), colors


def _load_ply(path: str):
    with open(path, "rb") as f:
        fmt, elements = _parse_ply_header(f)
        verts = faces = colors = None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    verts, colors = _ply_vertices_ascii(rows, props)
                elif name == "face":
                    faces = _ply_faces_ascii(rows)
            else:
                if name == "vertex":
                    verts, colors = _ply_vertices_binary(f, count, props)
                elif name == "face":
                    faces = _ply_faces_binary(f, count, props)
                else:
                    _skip_ply_element_binary(f, count, props)
    if verts is None or faces is None:
        raise IOError(f"PLY without vertex/face data: {path}")
    return verts, faces, colors


_PLY_NP = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
}


def _parse_ply_header(f):
    if f.readline().strip() != b"ply":
        raise IOError("not a PLY file")
    fmt = "ascii"
    elements = []  # (name, count, props) with props = [(kind, ...)]
    while True:
        t = f.readline().decode("ascii", "ignore").split()
        if not t or t[0] == "comment":
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append(("list", t[2], t[3], t[4]))
            else:
                elements[-1][2].append(("scalar", t[1], t[2]))
        elif t[0] == "end_header":
            return fmt, elements


def _ply_vertices_ascii(rows, props):
    names = [p[2] for p in props if p[0] == "scalar"]
    data = {n: np.asarray([float(r[i]) for r in rows]) for i, n in enumerate(names)}
    return _assemble_vertices(data, names)


def _ply_vertices_binary(f, count, props):
    dtype = np.dtype([(p[2], _PLY_NP[p[1]]) for p in props])
    data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
    names = list(dtype.names)
    return _assemble_vertices({n: data[n] for n in names}, names)


def _assemble_vertices(data, names):
    verts = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)
    cmap = {"red": "r", "green": "g", "blue": "b"}
    have = {cmap.get(n, n) for n in names}
    if {"r", "g", "b"} <= have:
        def ch(c):
            for n in (c, {"r": "red", "g": "green", "b": "blue"}[c]):
                if n in data:
                    return data[n]
        colors = np.stack([ch("r"), ch("g"), ch("b")], axis=1)
        return verts, np.clip(colors, 0, 255).astype(np.uint8)
    return verts, None


def _ply_faces_ascii(rows):
    faces = []
    for r in rows:
        n = int(r[0])
        idx = [int(v) for v in r[1: 1 + n]]
        for k in range(1, n - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(faces, np.int32)


def _ply_faces_binary(f, count, props):
    cnt_t = np.dtype(_PLY_NP[props[0][1]])
    idx_t = np.dtype(_PLY_NP[props[0][2]])
    faces = []
    for _ in range(count):
        n = int(np.frombuffer(f.read(cnt_t.itemsize), cnt_t)[0])
        idx = np.frombuffer(f.read(idx_t.itemsize * n), idx_t)
        for k in range(1, n - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(faces, np.int32)


def _skip_ply_element_binary(f, count, props):
    for _ in range(count):
        for p in props:
            if p[0] == "list":
                n = int(np.frombuffer(f.read(np.dtype(_PLY_NP[p[1]]).itemsize),
                                      _PLY_NP[p[1]])[0])
                f.read(np.dtype(_PLY_NP[p[2]]).itemsize * n)
            else:
                f.read(np.dtype(_PLY_NP[p[1]]).itemsize)


_PLY_SIZES_F64 = {"float": "<f4", "float32": "<f4", "double": "<f8",
                  "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
                  "short": "<i2", "ushort": "<u2", "int": "<i4",
                  "uint": "<u4", "int32": "<i4", "uint32": "<u4"}


def load_vertices(path: str) -> np.ndarray:
    """(V, 3) f64 vertices of a PLY (ascii or binary) or OBJ, as the refiner's
    MeshStore samples its crop points from them."""
    if path.endswith(".obj"):
        vs = []
        with open(path) as f:
            for line in f:
                if line.startswith("v "):
                    vs.append([float(x) for x in line.split()[1:4]])
        return np.asarray(vs, np.float64)
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts, props, fmt, in_vertex = 0, [], "ascii", False
        for line in header:
            t = line.split()
            if not t:
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                in_vertex = t[1] == "vertex"
                if in_vertex:
                    n_verts = int(t[2])
            elif t[0] == "property" and in_vertex and t[1] != "list":
                props.append((t[1], t[2]))
        if fmt == "ascii":
            vs = []
            for _ in range(n_verts):
                vals = f.readline().split()
                rec = {name: float(v) for (_, name), v in zip(props, vals)}
                vs.append([rec["x"], rec["y"], rec["z"]])
            return np.asarray(vs, np.float64)
        dtype = np.dtype([(name, _PLY_SIZES_F64.get(t, "<f4")) for t, name in props])
        data = np.frombuffer(f.read(dtype.itemsize * n_verts), dtype=dtype, count=n_verts)
        return np.stack([data["x"].astype(np.float64), data["y"].astype(np.float64),
                         data["z"].astype(np.float64)], axis=1)


def diameter(verts: np.ndarray, cap: int = 2000) -> float:
    """The largest distance between two of at most `cap` vertices, evenly
    spaced in file order, in verts' dtype (JaxRenderer.diameter on f32
    verts, the scorer's `_diameter` on f64 ones)."""
    v = verts
    if len(v) > cap:
        v = v[np.linspace(0, len(v) - 1, cap).astype(int)]
    d2 = ((v[:, None, :] - v[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.max()))
