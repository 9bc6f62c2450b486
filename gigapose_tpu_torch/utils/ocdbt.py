"""Read-only reader of an OCDBT key-value store (the tensorstore format that
orbax writes its arrays into, "use_ocdbt": true).

Layout, as tensorstore 0.1.x writes it (its `ocdbt.dump` shows the same
fields):

- `<root>/manifest.ocdbt`: a 14-byte header (magic 0c db 3a 2a, the file's
  length as u64 LE, the format version varint 0, the compression varint:
  0 none, 1 zstd), the body, and a CRC-32C of everything before it (u32
  LE). The body: the config (uuid[16], manifest kind, max inline value
  bytes, max decoded node bytes, version-tree arity log2 u8, compression
  method, for zstd an int32 LE level), a data file table, the newest
  versions (count, then per version: generation, root height u8, the root
  node's data file id / offset / length, its key count / tree bytes /
  indirect value bytes, commit time u64 LE) and the version-tree nodes of
  older versions (not read: the newest version is always inline).
- B-tree nodes (magic 0c db 20 de, the same header and CRC) are byte ranges
  of the data files under `d/` (or `ocdbt.process_N/d/`): the height u8, a
  data file table, the entry count, the keys prefix-compressed against the
  previous key (prefix lengths of entries 1.., suffix lengths, in an
  interior node the subtree common prefix lengths, the suffix bytes), then
  for a leaf (height 0) the value lengths, the value kinds (0 inline, 1 a
  reference), the references' data file ids and offsets and the inline
  values; for an interior node the children's data file ids, offsets,
  lengths, key counts, tree bytes and indirect value bytes. A child's keys
  omit the common prefix that its entry names.
- A data file table: the count, the path prefix each path shares with the
  one before (entries 1..), the suffix lengths, the base path lengths, the
  suffix bytes; paths are relative to the store's root.

`OcdbtStore(root)` reads the manifest, walks the newest version's whole
tree and keeps every key with its value's place; `get(key)` returns the
value's bytes. Every magic, length, CRC, count and key order is checked: a
mismatch raises ValueError naming the file. A value is returned whole or
not at all.
"""

from __future__ import annotations

import os.path as osp
import struct
from typing import Dict, Iterator, List, Tuple, Union

from gigapose_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # data file offset / length of an empty tree


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as tensorstore checks its files."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """A cursor over one decoded body; any overrun raises ValueError."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg: str):
        raise ValueError(f"{self.what}: {msg} (at byte {self.pos})")

    def raw(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail(f"truncated: {n} bytes wanted, {len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.raw(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} trailing bytes")


def decode_file(data: bytes, magic: int, what: str) -> bytes:
    """Header, length and CRC of one manifest or node -> its decoded body."""
    if len(data) < 18:
        raise ValueError(f"{what}: {len(data)} bytes, too short for an OCDBT header")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:08x}, expected {magic:08x}")
    r = _Reader(data, what)
    r.raw(4)
    length = r.u64()
    if length != len(data):
        raise ValueError(f"{what}: header says {length} bytes, the file holds {len(data)}")
    if r.varint() != 0:
        raise ValueError(f"{what}: unknown OCDBT format version")
    compression = r.varint()
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C mismatch")
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, what=what)
    raise ValueError(f"{what}: unknown compression {compression}")


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the base path is part of the path
    paths: List[str] = []
    for i in range(n):
        if i and prefix[i] > len(paths[-1]):
            r.fail("data file path prefix longer than the previous path")
        p = (paths[-1][:prefix[i]] if i else "") + r.raw(suffix[i]).decode()
        if p and (osp.isabs(p) or ".." in p.split("/")):
            r.fail(f"data file path {p!r} leaves the store")
        paths.append(p)
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """-> (the keys, an interior node's subtree common prefix lengths)."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys: List[bytes] = []
    for i in range(n):
        if i and prefix[i] > len(keys[-1]):
            r.fail("key prefix longer than the previous key")
        k = (keys[-1][:prefix[i]] if i else b"") + r.raw(suffix[i])
        if i and k <= keys[-1]:
            r.fail("keys out of order")
        keys.append(k)
    return keys, common


Ref = Tuple[str, int, int]  # (data file path, offset, length)


class OcdbtStore:
    """The newest version of the OCDBT store at `root`: {key: value place}."""

    def __init__(self, root: str):
        self.root = osp.abspath(root)
        self.entries: Dict[bytes, Union[bytes, Ref]] = {}
        path = osp.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _Reader(decode_file(f.read(), MANIFEST_MAGIC, path), path)
        r.raw(16)  # uuid
        if r.varint() != 0:
            r.fail("only single-file manifests are read (manifest_kind 0)")
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.u8()  # version tree arity log2
        if r.varint() == 1:
            r.raw(4)  # zstd level, int32 LE
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            r.fail("no version")
        gens, heights = r.varints(n), list(r.raw(n))
        ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        r.varints(n)  # tree bytes
        r.varints(n)  # indirect value bytes
        r.raw(8 * n)  # commit times
        new = max(range(n), key=gens.__getitem__)
        if offs[new] == _MISSING:  # an empty tree
            if num_keys[new]:
                r.fail("an empty root with keys")
            return
        if ids[new] >= len(files):
            r.fail(f"data file id {ids[new]} of {len(files)}")
        self._walk((files[ids[new]], offs[new], lens[new]), b"", heights[new])
        if len(self.entries) != num_keys[new]:
            raise ValueError(f"{path}: {len(self.entries)} keys in the tree, the manifest "
                             f"says {num_keys[new]}")

    def _read(self, ref: Ref) -> bytes:
        """The bytes of one (file, offset, length), whole."""
        name, off, n = ref
        path = osp.join(self.root, name)
        with open(path, "rb") as f:
            f.seek(off)
            data = f.read(n)
        if len(data) != n:
            raise ValueError(f"{path}: {n} bytes wanted at offset {off}, the file ends "
                             f"after {len(data)}")
        return data

    def _walk(self, ref: Ref, prefix: bytes, height: int) -> int:
        what = f"{osp.join(self.root, ref[0])}@{ref[1]}+{ref[2]}"
        r = _Reader(decode_file(self._read(ref), NODE_MAGIC, what), what)
        if r.u8() != height:
            r.fail(f"node height differs from its parent's {height} - 1")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)

        def refs(ids, offs, lens):
            for i in ids:
                if i >= len(files):
                    r.fail(f"data file id {i} of {len(files)}")
            return [(files[i], o, m) for i, o, m in zip(ids, offs, lens)]

        if height == 0:
            lens, kinds = r.varints(n), r.varints(n)
            if any(k not in (0, 1) for k in kinds):
                r.fail(f"value kinds {sorted(set(kinds))}")
            ind = [i for i in range(n) if kinds[i] == 1]
            out = refs(r.varints(len(ind)), r.varints(len(ind)), [lens[i] for i in ind])
            places = dict(zip(ind, out))
            for i, k in enumerate(keys):
                self.entries[prefix + k] = places[i] if i in places else r.raw(lens[i])
            r.end()
            return n
        kids = refs(r.varints(n), r.varints(n), r.varints(n))
        counts = r.varints(n)
        r.varints(n)  # tree bytes
        r.varints(n)  # indirect value bytes
        r.end()
        for k, c, kid, want in zip(keys, common, kids, counts):
            if c > len(k):
                r.fail("subtree prefix longer than its key")
            got = self._walk(kid, prefix + k[:c], height - 1)
            if got != want:
                r.fail(f"subtree of {got} keys, its entry says {want}")
        return sum(counts)

    def keys(self) -> Iterator[str]:
        return (k.decode() for k in self.entries)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self.entries

    def get(self, key: str) -> bytes:
        """The value of `key` (KeyError if it is absent)."""
        v = self.entries[key.encode()]
        return v if isinstance(v, bytes) else self._read(v)
