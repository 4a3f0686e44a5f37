"""zstd decompression through ``ctypes`` on the system's ``libzstd.so.1``.

What reading a JAX run's orbax checkpoint needs (``utils/ocdbt.py``,
``utils/orbax_format.py``): tensorstore compresses the OCDBT manifests and
B+tree nodes and zarr the array chunks with zstd, and the chunks' frames do
not record their content size. So :func:`decompress` takes the size the
caller knows (a zarr chunk's shape times its item size) and decodes into a
buffer of exactly that size, with ``ZSTD_decompress``; without one it reads
the frame header's size, or streams (``ZSTD_decompressStream``) when the
frame has none.

The library is found with ``ctypes.util.find_library("zstd")``, then at the
usual multiarch paths. Nothing else decodes zstd here: without the library
:func:`library` raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional, Union

import numpy as np

_PATHS = ("/usr/lib/x86_64-linux-gnu/libzstd.so.1",
          "/lib/x86_64-linux-gnu/libzstd.so.1",
          "/usr/lib/aarch64-linux-gnu/libzstd.so.1",
          "/usr/lib64/libzstd.so.1", "/usr/lib/libzstd.so.1",
          "/usr/local/lib/libzstd.so.1")
_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_CONTENTSIZE_ERROR = 2 ** 64 - 2

_lib: Optional[ctypes.CDLL] = None
_path: Optional[str] = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _candidates():
    found = ctypes.util.find_library("zstd")
    if found:
        yield found
    yield "libzstd.so.1"
    yield from (p for p in _PATHS if os.path.exists(p))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    sz, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    lib.ZSTD_decompress.restype = sz
    lib.ZSTD_decompress.argtypes = [vp, sz, vp, sz]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [sz]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [sz]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [vp, sz]
    lib.ZSTD_createDCtx.restype = vp
    lib.ZSTD_freeDCtx.restype = sz
    lib.ZSTD_freeDCtx.argtypes = [vp]
    lib.ZSTD_DStreamOutSize.restype = sz
    lib.ZSTD_decompressStream.restype = sz
    lib.ZSTD_decompressStream.argtypes = [
        vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]
    return lib


def library() -> ctypes.CDLL:
    """The bound ``libzstd``, loaded once. Raises ``RuntimeError`` when the
    system has none."""
    global _lib, _path
    if _lib is not None:
        return _lib
    tried = []
    for name in _candidates():
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            tried.append(f"{name}: {e}")
            continue
        _lib, _path = _bind(lib), name
        return _lib
    raise RuntimeError(
        "reading an orbax (OCDBT / zarr) checkpoint needs the zstd library "
        "libzstd.so.1, and none was found (" + "; ".join(tried) + "). "
        "Install it (Debian / Ubuntu: libzstd1), or export the run with the "
        "JAX package's tools/export.py on a machine that has JAX and serve "
        "that export with the port's tools/serve.py --export_dir.")


def library_path() -> str:
    """The name the library was loaded under."""
    library()
    return _path


def version() -> str:
    """``ZSTD_versionNumber`` as ``major.minor.release``."""
    v = library().ZSTD_versionNumber()
    return f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {what}: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


Buffer = Union[bytes, bytearray, memoryview]


def _pointer(buf) -> tuple:
    """(address, byte length, keep-alive) of any buffer, read-only ones
    (``bytes``, an ``mmap`` slice) included, with no copy."""
    arr = np.frombuffer(buf, np.uint8)
    return (arr.ctypes.data if arr.size else None), arr.size, arr


def decompress_into(src: Buffer, dst: Buffer, what: str = "frame") -> int:
    """Decode the zstd frame(s) in ``src`` into the writable buffer ``dst``,
    which must be exactly the decoded size; returns that size."""
    lib = library()
    s_addr, s_len, _src = _pointer(src)
    d_addr, d_len, d_arr = _pointer(dst)
    if d_len and not d_arr.flags.writeable:
        raise ValueError(f"zstd: {what}: the output buffer is read-only")
    n = _check(lib, lib.ZSTD_decompress(d_addr, d_len, s_addr, s_len), what)
    if n != d_len:
        raise ValueError(f"zstd: {what}: decoded {n} bytes, expected "
                         f"{d_len}")
    return n


def decompress(src: Buffer, size: Optional[int] = None,
               what: str = "frame") -> bytearray:
    """The decoded bytes of ``src`` as a new ``bytearray``: ``size`` bytes
    when given (an error unless the frames hold exactly that many), else
    the size the frame header records, else as many as the stream gives."""
    lib = library()
    if size is None:
        s_addr, s_len, _src = _pointer(src)
        fcs = lib.ZSTD_getFrameContentSize(s_addr, s_len)
        if fcs == _CONTENTSIZE_ERROR:
            raise ValueError(f"zstd: {what}: not a zstd frame")
        if fcs == _CONTENTSIZE_UNKNOWN:
            return _stream(lib, s_addr, s_len, what)
        size = int(fcs)
    out = bytearray(size)
    decompress_into(src, out, what)
    return out


def _stream(lib, s_addr: int, s_len: int, what: str) -> bytearray:
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("zstd: ZSTD_createDCtx failed")
    try:
        step = int(lib.ZSTD_DStreamOutSize())
        out = bytearray()
        chunk = (ctypes.c_char * step)()
        inb = _InBuffer(s_addr, s_len, 0)
        while True:
            outb = _OutBuffer(ctypes.addressof(chunk), step, 0)
            ret = _check(lib, lib.ZSTD_decompressStream(
                dctx, ctypes.byref(outb), ctypes.byref(inb)), what)
            out += chunk.raw[:outb.pos]
            if ret == 0 and inb.pos == inb.size:
                return out
            if inb.pos == inb.size and outb.pos < step:
                raise ValueError(f"zstd: {what}: truncated frame")
    finally:
        lib.ZSTD_freeDCtx(dctx)
