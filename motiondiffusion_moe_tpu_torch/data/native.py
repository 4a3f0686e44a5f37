"""ctypes bindings for the native (C++) motion data plane.

The same C API and Python surface as ``motiondiffusion_moe_tpu/data/
native.py``, over the same source, ``native/motionio.cc`` (reused, not
copied): .npy decode, random crop / zero-pad and feat_bias z-normalisation
in GIL-free C++ threads, written straight into the numpy batch buffer.

The library is compiled on first use with ``g++`` and the flags of
``native/Makefile`` into the git-ignored ``motiondiffusion_moe_tpu_torch/
build/``, under a name that carries a hash of the source and the flags, and
renamed into place atomically, so that concurrent processes never load a
half-written file; ``native/`` itself is never written. A build or load
that fails raises with the compiler's message: the port does not fall back
to the Python path on its own (``use_native_io=False`` / ``--no_native_io``
is the way to ask for it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "motionio.cc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
CXX = os.environ.get("CXX", "g++")
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall"]
LD_FLAGS = ["-shared", "-lpthread"]

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmotionio_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless an up-to-date one exists; return its
    path. Raises RuntimeError with the compiler's output on failure."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, *LD_FLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native motionio: cannot run {CXX!r}: "
                           f"{e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native motionio: {' '.join(cmd)} failed "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.motionio_create.restype = vp
    lib.motionio_destroy.argtypes = [vp]
    lib.motionio_add_file.restype = i64
    lib.motionio_add_file.argtypes = [vp, ctypes.c_char_p]
    lib.motionio_add_array.restype = i64
    lib.motionio_add_array.argtypes = [vp, f32p, i64, i64]
    lib.motionio_num_items.restype = i64
    lib.motionio_num_items.argtypes = [vp]
    lib.motionio_item_rows.restype = i64
    lib.motionio_item_rows.argtypes = [vp, i64]
    lib.motionio_assemble_batch.restype = ctypes.c_int
    lib.motionio_assemble_batch.argtypes = [
        vp, ctypes.POINTER(i64), i64, i64, i64, f32p, f32p, ctypes.c_uint64,
        f32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built on first call; raises on failure."""
    global _lib, _build_error
    with _LOCK:
        if _lib is None:
            try:
                _lib = _bind(ctypes.CDLL(build()))
            except (RuntimeError, OSError) as e:
                _build_error = str(e)
                raise RuntimeError(
                    f"native motionio unavailable: {e}") from e
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here (the reason otherwise in
    :func:`build_error`)."""
    try:
        load()
        return True
    except RuntimeError:
        return False


def build_error() -> Optional[str]:
    return _build_error


class NativeMotionStore:
    """In-memory motion store with C++ batch assembly."""

    def __init__(self):
        self._lib = load()
        self._h = ctypes.c_void_p(self._lib.motionio_create())

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.motionio_destroy(self._h)
            self._h = None

    def add_file(self, path: str) -> int:
        idx = self._lib.motionio_add_file(self._h, path.encode("utf-8"))
        if idx < 0:
            raise IOError(f"failed to load npy: {path}")
        return int(idx)

    def add_array(self, motion: np.ndarray) -> int:
        motion = np.ascontiguousarray(motion, dtype=np.float32)
        if motion.ndim != 2:
            raise ValueError(f"motion must be [T, D], got {motion.shape}")
        return int(self._lib.motionio_add_array(
            self._h, motion.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            motion.shape[0], motion.shape[1]))

    def __len__(self) -> int:
        return int(self._lib.motionio_num_items(self._h))

    def item_length(self, idx: int) -> int:
        return int(self._lib.motionio_item_rows(self._h, idx))

    def assemble_batch(self, indices: Sequence[int], max_len: int,
                       mean: np.ndarray, std: np.ndarray, seed: int = 0,
                       num_threads: int = 4
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(motions [B, max_len, D] normalised f32, lengths [B] i32)."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        mean = np.ascontiguousarray(mean, dtype=np.float32)
        std = np.ascontiguousarray(std, dtype=np.float32)
        B, D = len(idx), mean.shape[0]
        out = np.empty((B, max_len, D), np.float32)
        lengths = np.empty((B,), np.int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        rc = self._lib.motionio_assemble_batch(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            B, max_len, D, mean.ctypes.data_as(f32p),
            std.ctypes.data_as(f32p), ctypes.c_uint64(seed),
            out.ctypes.data_as(f32p),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_threads)
        if rc == -2:
            raise ValueError(
                f"assemble_batch: an item's feature dim differs from the "
                f"normalizer's ({D}) — mixed-dim store or wrong mean/std")
        if rc != 0:
            raise ValueError("assemble_batch failed (bad index?)")
        return out, lengths
