"""Orbax checkpoints of the JAX package, read without orbax, tensorstore or
zarr: the tree that `orbax.checkpoint.PyTreeCheckpointer().save` wrote.

A checkpoint directory holds `_METADATA` (JSON: every leaf's key path with
its key types and value type, and whether the arrays live in an OCDBT store,
"use_ocdbt", and in zarr v2 or v3, "use_zarr3") and the arrays. Each array
is a zarr v2 array stored under its key path joined by dots: the JSON
`<name>/.zarray` (shape, chunks, dtype, compressor, fill_value, order,
dimension_separator) and one value per chunk, `<name>/<i>.<j>...`
(`<name>/0` for a 0-d array), each a compressed copy of the chunk's raw
C-order bytes, edge chunks at the full chunk shape, all in one OCDBT store
(utils/ocdbt.py).

`read_tree(path)` -> the checkpoint's tree as nested dicts with orbax's
key names (a sequence index becomes its decimal string, as orbax's own
metadata names it), each array a numpy array of its dtype (`<f4`, `<f8`,
`<i4`, `<i8`, `<u4`, `|b1` and the other little-endian numeric ones) or,
for `bfloat16`, a torch.bfloat16 tensor with the same bits; a leaf that
orbax skips (None, an empty optax state) is None. A chunk that was never
written holds the array's fill_value (zeros for a null fill_value, as
tensorstore reads it). zarr v3, a store without OCDBT, another compressor
than zstd or none, a filter, Fortran order or an unknown value type raise
ValueError, and so does
any malformed store or chunk. (The chunks carry no checksum: a byte flipped
inside one may decode to other values, for orbax as for this reader; the
OCDBT manifest and nodes have their CRC.)
"""

from __future__ import annotations

import itertools
import json
import math
import os.path as osp
from typing import Any, Dict, Tuple

import numpy as np
import torch

from gigapose_tpu_torch.utils import zstd
from gigapose_tpu_torch.utils.ocdbt import OcdbtStore

ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
SKIPPED_TYPES = ("None",)
_FILL = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}


def is_checkpoint(path: str) -> bool:
    """An orbax PyTree checkpoint directory (its _METADATA is there)."""
    return osp.isdir(path) and osp.isfile(osp.join(path, "_METADATA"))


def _dtype(name: str, what: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")  # read as bits, handed out as torch.bfloat16
    dt = np.dtype(name)
    if name[:1] not in "<|" or dt.kind not in "biuf":
        raise ValueError(f"{what}: dtype {name!r} is not read (little-endian numbers, bool "
                         "and bfloat16 are)")
    return dt


def read_array(store, name: str):
    """One zarr v2 array `name` of `store` -> numpy (torch.bfloat16 for bf16)."""
    what = f"{store.root}:{name}"
    meta = json.loads(store.get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{what}: order {meta.get('order')} / filters {meta.get('filters')} "
                         "are not read (C order, no filters)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{what}: compressor {comp.get('id')!r} is not read (zstd or none)")
    dt = _dtype(meta["dtype"], what)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{what}: chunks {chunks} for shape {shape}")
    fill = meta.get("fill_value")
    fill = 0 if fill is None else _FILL.get(fill, fill)
    if meta["dtype"] == "bfloat16" and fill != 0:
        raise ValueError(f"{what}: a nonzero bfloat16 fill_value is not read")
    out = np.full(shape, fill, dt)
    sep = meta.get("dimension_separator", ".")
    chunk_bytes = math.prod(chunks) * dt.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue  # never written: the fill value
        raw = store.get(key)
        if comp is not None:
            raw = zstd.decompress(raw, expected_size=chunk_bytes, what=f"{what}/{key}")
        elif len(raw) != chunk_bytes:
            raise ValueError(f"{what}/{key}: {len(raw)} bytes, a chunk holds {chunk_bytes}")
        block = np.frombuffer(raw, dt).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)
    return out


def _store(path: str, meta: Dict) -> OcdbtStore:
    if meta.get("use_zarr3") or not meta.get("use_ocdbt"):
        raise ValueError(f"{path}: use_zarr3={meta.get('use_zarr3')}, "
                         f"use_ocdbt={meta.get('use_ocdbt')}; only zarr v2 arrays in an OCDBT "
                         "store (orbax's default) are read")
    return OcdbtStore(path)


def read_tree(path: str) -> Dict[str, Any]:
    """The orbax checkpoint at `path` -> its tree (see the module's head)."""
    mpath = osp.join(path, "_METADATA")
    if not osp.isfile(mpath):
        raise ValueError(f"{path} is not an orbax checkpoint (no _METADATA)")
    with open(mpath) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise ValueError(f"{mpath}: no tree_metadata")
    store = _store(path, meta)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys: Tuple[str, ...] = tuple(str(k["key"]) for k in entry["key_metadata"])
        vtype = entry["value_metadata"]["value_type"]
        if vtype in SKIPPED_TYPES:
            value = None
        elif vtype in ARRAY_TYPES:
            value = read_array(store, ".".join(keys))
        else:
            raise ValueError(f"{mpath}: leaf {keys} of type {vtype!r} is not read "
                             f"(arrays: {', '.join(ARRAY_TYPES)})")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise ValueError(f"{mpath}: {keys} runs through a leaf")
        if keys[-1] in node:
            raise ValueError(f"{mpath}: leaf {keys} twice")
        node[keys[-1]] = value
    return tree
