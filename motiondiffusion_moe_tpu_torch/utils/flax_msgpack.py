"""flax's msgpack format, read and written without flax or ``msgpack``.

The port's copy of the part of ``flax.serialization`` that the JAX package's
export uses (``tools/export.py``: ``msgpack_serialize`` of a state dict,
``msgpack_restore`` of the file): a tree of dicts with str keys, lists,
arrays, numpy scalars, ints, floats, bools, None, str and bytes, encoded as
flax encodes it, so that for the same tree both writers give the same bytes
and each reader reads the other's file.

- An array is msgpack ext type 1 holding the msgpack of ``(shape, dtype
  name, C-order bytes)``; a numpy scalar is ext type 3 holding the same for
  its 0-d array.
- An array of more than :data:`MAX_CHUNK_SIZE` bytes that is a dict value
  (or the whole tree) is written as flax's chunked form,
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": flat piece, ...}}``, and joined again on reading.
- ``bfloat16``, which numpy cannot hold without ``ml_dtypes``: a bf16 leaf
  is read as a ``torch.bfloat16`` tensor from its raw 16-bit words, and a
  ``torch.bfloat16`` tensor (or a numpy array whose dtype is named
  ``bfloat16``) is written as those words under that name. Every other
  array is read as a numpy array.

Arrays are read with ``np.frombuffer`` over views of the input buffer, with
no per-element Python work: the numpy leaves share the caller's buffer (pass
a ``bytearray`` for writable ones); the bf16 leaves are copied where that
buffer is read-only.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

# flax's chunk size (``flax.serialization.MAX_CHUNK_SIZE``), read at call time
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED_KEY = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def is_bf16(x) -> bool:
    """A bf16 leaf: a ``torch.bfloat16`` tensor, or a numpy array whose
    dtype is named ``bfloat16`` (``ml_dtypes``', which JAX hands out)."""
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.bfloat16
    return isinstance(x, (np.ndarray, np.generic)) and \
        x.dtype.name == "bfloat16"


def bf16_words(x) -> np.ndarray:
    """The raw 16-bit words of a bf16 leaf, as uint16, in C order."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().view(torch.int16).numpy() \
            .view(np.uint16)
    return np.asarray(x, order="C").view(np.uint16)


def bf16_tensor(words: np.ndarray) -> torch.Tensor:
    """A ``torch.bfloat16`` tensor from raw 16-bit words (uint16)."""
    if not words.flags.writeable:
        words = words.copy()
    return torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _header(out: List, size: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes`` lists the codes for the 8-bit form or None, then 16, 32)."""
    if fix is not None and size <= fix_max:
        out.append(bytes([fix | size]))
    elif codes[0] is not None and size <= 0xFF:
        out.append(bytes([codes[0], size]))
    elif size <= 0xFFFF:
        out.append(bytes([codes[1]]) + struct.pack(">H", size))
    elif size <= 0xFFFFFFFF:
        out.append(bytes([codes[2]]) + struct.pack(">I", size))
    else:
        raise ValueError(f"msgpack: object of size {size} too large")


def _pack_int(out: List, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(bytes([x]))
    elif -32 <= x < 0:
        out.append(struct.pack(">b", x))
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= top:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"msgpack: int {x} too large")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if x >= low:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"msgpack: int {x} too small")


def _pack_str(out: List, s: str) -> None:
    b = s.encode("utf-8")
    _header(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out.append(b)


def _pack_bin(out: List, b) -> None:
    _header(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
    out.append(b)


def _array_parts(x):
    """(shape, dtype name, C-order data as a byte view) of an array leaf."""
    if is_bf16(x):
        words = bf16_words(x)
        return tuple(words.shape), "bfloat16", memoryview(words).cast("B")
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    x = np.asarray(x, order="C")  # keeps a 0-d array 0-d
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "supported")
    return x.shape, x.dtype.name, memoryview(x.reshape(-1).view(np.uint8))


def _pack_array(out: List, x, code: int) -> None:
    shape, name, data = _array_parts(x)
    head: List = []
    _header(head, 3, 0x90, 15, (None, 0xDC, 0xDD))
    _header(head, len(shape), 0x90, 15, (None, 0xDC, 0xDD))
    for d in shape:
        _pack_int(head, int(d))
    _pack_str(head, name)
    _header(head, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    prefix = b"".join(head)
    size = len(prefix) + len(data)
    if size in _FIXEXT:
        out.append(bytes([_FIXEXT[size], code]))
    else:
        _header(out, size, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(bytes([code]))
    out.append(prefix)
    out.append(data)


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize


def _pack_map(out: List, items) -> None:
    """A map of (key, value) pairs in the given order; a value that is an
    array above MAX_CHUNK_SIZE bytes goes in flax's chunked form."""
    _header(out, len(items), 0x80, 15, (None, 0xDE, 0xDF))
    for k, v in items:
        _pack(out, k)
        _pack_value(out, v)


def _pack_value(out: List, x) -> None:
    flat = x.reshape(-1) if _is_array(x) else None
    if flat is not None and flat.shape[0] * _itemsize(x) > MAX_CHUNK_SIZE:
        # flax's _chunk, built after its sorted copy: in this order
        size = max(1, int(MAX_CHUNK_SIZE / _itemsize(x)))
        n = flat.shape[0]
        shape = [(str(i), int(d)) for i, d in enumerate(x.shape)]
        chunks = [(str(j), flat[i:i + size])
                  for j, i in enumerate(range(0, n, size))]
        _header(out, 3, 0x80, 15, (None, 0xDE, 0xDF))
        _pack(out, CHUNKED_KEY)
        _pack(out, True)
        _pack(out, "shape")
        _pack_map(out, shape)
        _pack(out, "chunks")
        _pack_map(out, chunks)
    else:
        _pack(out, x)


def _pack(out: List, x: Any) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(out, x)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        _pack_str(out, x)
    elif t is bytes:
        _pack_bin(out, x)
    elif t is dict:
        _pack_map(out, [(k, x[k]) for k in sorted(x)])
    elif t is list:
        _header(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif _is_array(x):
        _pack_array(out, x, _EXT_NDARRAY)
    elif isinstance(x, np.generic):
        _pack_array(out, np.asarray(x), _EXT_NPSCALAR)
    else:
        raise TypeError(f"msgpack: can not serialize {t.__name__!r} object")


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for
    ``tree``: each dict's keys in sorted order, as flax's copy of the tree
    (``jax.tree_util.tree_map``) orders them. The tree is not modified."""
    out: List = []
    _pack_value(out, tree)
    return b"".join(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.read_map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(">" + "BHI"[c - 0xC4])))
        if c in (0xC7, 0xC8, 0xC9):
            n = self.unpack(">" + "BHI"[c - 0xC7])
            return self.read_ext(self.unpack(">b"), n)
        if c == 0xCA:
            return self.unpack(">f")
        if c == 0xCB:
            return self.unpack(">d")
        if 0xCC <= c <= 0xCF:
            return self.unpack(">" + "BHIQ"[c - 0xCC])
        if 0xD0 <= c <= 0xD3:
            return self.unpack(">" + "bhiq"[c - 0xD0])
        if 0xD4 <= c <= 0xD8:
            n = 1 << (c - 0xD4)
            return self.read_ext(self.unpack(">b"), n)
        if c in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack(">" + "BHI"[c - 0xD9])), "utf-8")
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">" + "HI"[c - 0xDC]))]
        if c in (0xDE, 0xDF):
            return self.read_map(self.unpack(">" + "HI"[c - 0xDE]))
        raise ValueError(f"msgpack: unknown type byte 0x{c:02x}")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read_ext(self, code: int, n: int):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        sub = _Reader(self.take(n))
        c = sub.take(1)[0]
        if c != 0x93:
            raise ValueError("msgpack: an array ext must hold 3 items")
        shape = tuple(sub.read())
        name = sub.read()
        name = name.decode() if isinstance(name, bytes) else name
        c = sub.take(1)[0]
        if c not in (0xC4, 0xC5, 0xC6):
            raise ValueError("msgpack: an array ext must end in its bytes")
        data = sub.take(sub.unpack(">" + "BHI"[c - 0xC4]))
        if name == "bfloat16":
            arr = bf16_tensor(np.frombuffer(data, dtype=np.uint16)).reshape(
                shape)
        else:
            arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(x):
    """flax's ``_unchunk_array_leaves_in_place``: the chunked form joined
    back where it is a dict value or the whole tree."""
    if isinstance(x, dict):
        if CHUNKED_KEY in x:
            return _unchunk(x)
        for k, v in x.items():
            if isinstance(v, dict):
                x[k] = _unchunk_tree(v)
    return x


def msgpack_restore(data) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` reads from ``data``
    (bytes-like), with bf16 leaves as ``torch.bfloat16`` tensors."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes "
                         "after the end of the tree")
    return _unchunk_tree(tree)
