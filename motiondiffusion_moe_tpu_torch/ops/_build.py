"""Build and load the hand-written CUDA kernels.

The sources under ``motiondiffusion_moe_tpu_torch/csrc/`` are compiled on
first use with ``nvcc`` for Hopper (``sm_90a``) into ONE shared library with
a plain C interface, loaded through ``ctypes``. Building this way takes
seconds; ``torch.utils.cpp_extension`` would compile PyTorch's headers and
take minutes. The library lands in ``motiondiffusion_moe_tpu_torch/build/``
(git-ignored) under a name carrying a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.

Nothing here runs at import: the CPU-only test environment imports every
module but has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import List, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# what the last build in this process reported: seconds and ptxas lines
build_info: dict = {}


def sources() -> List[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the kernels are compiled on first use)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmdm_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless an up-to-date one exists; return its
    path. Raises with the compiler's output when nvcc fails."""
    path = library_path()
    if os.path.isfile(path):
        build_info.update(seconds=0.0, cached=True, ptxas=[])
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           *[s for s in sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    # atomic install: concurrent builds each write their own temp file
    os.replace(tmp, path)
    log = (proc.stdout + proc.stderr).splitlines()
    build_info.update(seconds=seconds, cached=False,
                      ptxas=[l for l in log if "ptxas info" in l])
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mdm_favor_qkv.argtypes = [vp, vp, vp, vp, vp, vp,  # tensors
                                  i, i, i, i, i, i,        # B T H D M bf16
                                  f, f, vp]                # eps pre stream
    lib.mdm_favor_qkv.restype = i
    lib.mdm_performer_epilogue.argtypes = [vp] * 8 + [i, i, i, i, vp]
    lib.mdm_performer_epilogue.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(build()))
        return _LIB
