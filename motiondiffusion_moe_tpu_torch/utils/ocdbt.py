"""A read-only OCDBT key-value store: the part of tensorstore's OCDBT driver
that orbax's checkpoints need, without tensorstore.

orbax (``use_ocdbt: true``, its default) writes every array of a step into
one OCDBT database under ``<step>/default/``: a ``manifest.ocdbt``, B+tree
nodes and values in data files under ``d/``, and, one per writing process,
a database of its own under ``ocdbt.process_<i>/`` that the top-level tree
points into. :class:`OcdbtReader` opens such a directory and gives its keys
and values.

The format (tensorstore's ``kvstore/ocdbt/format``), as read here:

- Every manifest and B+tree node is framed: a big-endian magic
  (``0x0cdb3a2a`` a manifest, ``0x0cdb20de`` a node), the framed length
  (uint64 LE), the format version (varint, 0), the compression (varint: 0
  none, 1 zstd), the body, and a CRC-32C (LE) of everything before it.
- A manifest holds the database config (uuid, manifest kind, the inline
  value and node size limits, the version tree arity, the compression),
  a data file table, and the newest versions of the version tree inline:
  for each, its generation and the reference to its root node (height,
  data file, offset, length, key and byte counts, commit time). The
  newest generation is the one read.
- A data file table is the number of files, then their paths: each is
  front-coded against the previous one (prefix length, suffix length) and
  split into a base path and a relative path. A node's table is relative
  to the base path of the file that holds the node, which is how the
  top-level tree reaches the per-process ones.
- A node is its height, its data file table and its entries, keys
  front-coded. A leaf entry's value is inline (in the node) or a reference
  (data file, offset; its length is the value's). An interior entry is a
  child reference whose subtree shares the first
  ``subtree_common_prefix_length`` bytes of its key, which its own keys
  leave out.

Values are read through ``mmap`` of their data files, one map per file;
several threads may read at once.
"""

from __future__ import annotations

import mmap
import os
import struct
import threading
from typing import Dict, List, Tuple, Union

import numpy as np

from motiondiffusion_moe_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = 4 + 8  # magic + length, before the two varints
_MISSING = 2 ** 64 - 1


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Sequential reads of varints, fixed-width ints and byte runs."""

    def __init__(self, buf, what: str):
        self.buf, self.pos, self.what = memoryview(buf), 0, what

    def varint(self) -> int:
        out, shift = 0, 0
        buf, pos = self.buf, self.pos
        while True:
            if pos >= len(buf):
                raise ValueError(f"{self.what}: truncated")
            b = buf[pos]
            pos += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                self.pos = pos
                return out

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))


def _front_coded(cur: _Cursor, n: int, with_subtree: bool = False):
    """``n`` front-coded byte strings (and, for interior nodes, each one's
    subtree common prefix length)."""
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    subtree = cur.varints(n) if with_subtree else None
    out, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{cur.what}: bad key prefix length")
        prev = prev[:p] + bytes(cur.take(s))
        out.append(prev)
    return out, subtree


def _data_file_table(cur: _Cursor, base: str) -> Tuple[List[str],
                                                       List[str]]:
    """The data files of a manifest or node: each one's path relative to
    the database directory, and its base path. ``base`` is the base path of
    the file that holds the table."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    paths, bases, prev = [], [], b""
    for p, s, b in zip(prefix, suffix, base_len):
        prev = prev[:p] + bytes(cur.take(s))
        paths.append(base + prev.decode() if prev else "")
        bases.append(base + prev[:b].decode())
    return paths, bases


class OcdbtReader:
    """The newest version of the OCDBT database at ``path`` (a directory
    holding ``manifest.ocdbt``): :meth:`keys` in order, :meth:`read` of
    one value. The whole tree is walked once, at open."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._maps: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._values: Dict[bytes, Tuple] = {}
        manifest = os.path.join(self.path, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            raise FileNotFoundError(f"no OCDBT manifest {manifest}")
        with open(manifest, "rb") as f:
            raw = f.read()
        body = self._decode(raw, MANIFEST_MAGIC, manifest)
        cur = _Cursor(body, manifest)
        cur.take(16)                      # uuid
        kind = cur.varint()
        if kind != 0:
            raise ValueError(f"{manifest}: manifest kind {kind} (numbered "
                             "manifests) is not supported; orbax writes "
                             "kind 0")
        cur.varint()                      # max_inline_value_bytes
        cur.varint()                      # max_decoded_node_bytes
        cur.u8()                          # version_tree_arity_log2
        method = cur.varint()
        if method == 1:
            cur.u32()                     # zstd level
        elif method != 0:
            raise ValueError(f"{manifest}: unknown compression method "
                             f"{method}")
        files, bases = _data_file_table(cur, "")
        n = cur.varint()
        if n == 0:
            return
        generation = cur.varints(n)
        height = cur.u8s(n)
        file_id = cur.varints(n)
        offset = cur.varints(n)
        length = cur.varints(n)
        num_keys = cur.varints(n)
        cur.varints(n)                    # num_tree_bytes
        cur.varints(n)                    # num_indirect_value_bytes
        cur.u64s(n)                       # commit_time
        v = max(range(n), key=generation.__getitem__)
        if num_keys[v] == 0 or offset[v] == _MISSING:
            return
        self._walk(files[file_id[v]], bases[file_id[v]], offset[v],
                   length[v], height[v], b"")

    # -- framing ----------------------------------------------------------

    @staticmethod
    def _decode(raw, magic: int, what: str) -> bytes:
        raw = memoryview(raw)
        if len(raw) < _HEADER + 2 + 4:
            raise ValueError(f"{what}: truncated ({len(raw)} bytes)")
        got = struct.unpack(">I", raw[:4])[0]
        if got != magic:
            raise ValueError(f"{what}: bad magic {got:#010x}, expected "
                             f"{magic:#010x}")
        length = struct.unpack("<Q", raw[4:12])[0]
        if length != len(raw):
            raise ValueError(f"{what}: length field {length} != "
                             f"{len(raw)} bytes")
        want = struct.unpack("<I", raw[-4:])[0]
        if crc32c(raw[:-4]) != want:
            raise ValueError(f"{what}: CRC-32C mismatch (corrupt file)")
        cur = _Cursor(raw[:-4], what)
        cur.pos = _HEADER
        version = cur.varint()
        if version != 0:
            raise ValueError(f"{what}: unknown format version {version}")
        method = cur.varint()
        body = raw[cur.pos:-4]
        if method == 0:
            return bytes(body)
        if method == 1:
            return bytes(zstd.decompress(body, what=what))
        raise ValueError(f"{what}: unknown compression method {method}")

    def _file(self, rel: str) -> np.ndarray:
        with self._lock:
            return self._map(rel)

    def _map(self, rel: str) -> np.ndarray:
        arr = self._maps.get(rel)
        if arr is None:
            path = os.path.join(self.path, rel)
            with open(path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                arr = (np.frombuffer(mmap.mmap(f.fileno(), 0,
                                               access=mmap.ACCESS_READ),
                                     np.uint8)
                       if size else np.zeros(0, np.uint8))
            self._maps[rel] = arr
        return arr

    def _region(self, rel: str, offset: int, length: int) -> np.ndarray:
        arr = self._file(rel)
        if offset + length > arr.size:
            raise ValueError(f"{os.path.join(self.path, rel)}: "
                             f"[{offset}, {offset + length}) lies past its "
                             f"end ({arr.size} bytes)")
        return arr[offset:offset + length]

    # -- the B+tree -------------------------------------------------------

    def _walk(self, rel: str, base: str, offset: int, length: int,
              height: int, prefix: bytes) -> None:
        what = f"{os.path.join(self.path, rel)}@{offset}"
        body = self._decode(self._region(rel, offset, length), NODE_MAGIC,
                            what)
        cur = _Cursor(body, what)
        got = cur.u8()
        if got != height:
            raise ValueError(f"{what}: node height {got}, expected {height}")
        files, bases = _data_file_table(cur, base)
        n = cur.varint()
        keys, subtree = _front_coded(cur, n, with_subtree=height > 0)
        if height == 0:
            lengths = cur.varints(n)
            kinds = cur.u8s(n)
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            if any(k > 1 for k in kinds):
                raise ValueError(f"{what}: unknown value kind")
            ids = cur.varints(len(indirect))
            offs = cur.varints(len(indirect))
            refs = dict(zip(indirect, zip(ids, offs)))
            for i, key in enumerate(keys):
                if i in refs:
                    fid, off = refs[i]
                    self._values[prefix + key] = (files[fid], off,
                                                  lengths[i])
                else:
                    self._values[prefix + key] = (cur.take(lengths[i]),)
            return
        ids = cur.varints(n)
        offs = cur.varints(n)
        lens = cur.varints(n)
        cur.varints(n)                    # num_keys
        cur.varints(n)                    # num_tree_bytes
        cur.varints(n)                    # num_indirect_value_bytes
        for key, common, fid, off, ln in zip(keys, subtree, ids, offs, lens):
            self._walk(files[fid], bases[fid], off, ln, height - 1,
                       prefix + key[:common])

    # -- the public view ----------------------------------------------------

    def keys(self) -> List[str]:
        """Every key, in byte order."""
        return [k.decode() for k in sorted(self._values)]

    def view(self, key: Union[str, bytes]):
        """The value of ``key`` without a copy: a ``memoryview`` of the
        node (an inline value) or a read-only uint8 array over the data
        file's map. ``KeyError`` when the key is absent."""
        ref = self._values[_bytes(key)]
        if len(ref) == 1:
            return ref[0]
        return self._region(*ref)

    def read(self, key: Union[str, bytes]) -> bytes:
        """The value of ``key`` as ``bytes``."""
        v = self.view(key)
        return v.tobytes()

    def close(self) -> None:
        """Drop the file maps (each closes when no view of it is left)."""
        self._maps.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _bytes(key: Union[str, bytes]) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)
