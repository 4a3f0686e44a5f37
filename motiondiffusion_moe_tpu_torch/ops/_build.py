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

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]
NVCC_FLAGS = COMPILE_FLAGS + LINK_FLAGS  # what the library's hash covers

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# what the last build in this process reported: seconds and ptxas lines
# (each kernel's "Compiling entry function", its stack and spill bytes, its
# registers)
build_info: dict = {}


def resource_usage(fragment: str) -> List[str]:
    """What ptxas reported for the kernels whose mangled names contain
    ``fragment``, one line per kernel: "<name>: <registers line>; <stack and
    spill line>". Empty when the library came from the cache."""
    out, name, spill = [], None, ""
    for line in build_info.get("ptxas", []):
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name is not None and fragment in name:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return out


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
    path. Raises with the compiler's output when nvcc fails.

    Each ``.cu`` source is compiled to an object file by its own ``nvcc``,
    all started together, and the objects are linked into the shared
    library: the build takes as long as the slowest source."""
    path = library_path()
    if os.path.isfile(path):
        build_info.update(seconds=0.0, cached=True, ptxas=[])
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in (s for s in sources() if s.endswith(".cu")):
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log += out.splitlines()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        # atomic install: concurrent builds each write their own work dir
        os.replace(tmp, path)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas=[l for l in log if "ptxas info" in l
                             or "spill" in l])
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mdm_favor_qkv.argtypes = ([vp] * 9        # tensors, scratch, logits
                                  + [i] * 7      # B T H D M bf16 mxu_bf16
                                  + [f, f, i, vp])  # eps pre cluster stream
    lib.mdm_favor_qkv.restype = i
    ll = ctypes.c_longlong
    lib.mdm_performer_epilogue.argtypes = ([vp] * 3        # y scale shift
                                           + [ll, ll]      # their strides
                                           + [vp] * 5      # LN vectors, out
                                           + [i] * 5       # B T D bf16 C
                                           + [vp])         # stream
    lib.mdm_performer_epilogue.restype = i
    lib.mdm_performer_epilogue_blocks_per_sm.argtypes = [
        i, i, ctypes.POINTER(i)]                          # D bf16 out
    lib.mdm_performer_epilogue_blocks_per_sm.restype = i
    lib.mdm_favor_qkv_bwd.argtypes = ([vp] * 13     # tensors, scratch,
                                      + [i] * 7      # logits; B T H D M bf16
                                                     # mxu_bf16
                                      + [f, f, i, vp])  # eps pre cluster s
    lib.mdm_favor_qkv_bwd.restype = i
    lib.mdm_favor_qkv_bwd_scratch_floats.argtypes = [i] * 7
    lib.mdm_favor_qkv_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.mdm_performer_epilogue_bwd.argtypes = ([vp] * 16    # tensors, scratch
                                               + [i] * 4    # B T D bf16
                                               + [vp])      # stream
    lib.mdm_performer_epilogue_bwd.restype = i
    lib.mdm_performer_epilogue_bwd_scratch_floats.argtypes = [i] * 3
    lib.mdm_performer_epilogue_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.mdm_performer_epilogue_bwd_cluster.argtypes = ([i] * 4  # B T D bf16
                                                       + [ctypes.POINTER(i)])
    lib.mdm_performer_epilogue_bwd_cluster.restype = i
    lib.mdm_moe_dense_fused.argtypes = ([vp] * 7     # tensors
                                        + [i] * 5    # S D E hid bf16
                                        + [vp])      # stream
    lib.mdm_moe_dense_fused.restype = i
    for fn in (lib.mdm_xattn_fastlayout, lib.mdm_xattn_fastlayout_bf16):
        fn.argtypes = ([vp] * 4      # q k v out
                       + [i] * 5     # B T N H D
                       + [f, vp])    # scale stream
        fn.restype = i
    lib.mdm_xattn_fastlayout_smem_bytes.argtypes = [i] * 2  # N D (f32)
    lib.mdm_xattn_fastlayout_smem_bytes.restype = ctypes.c_longlong
    lib.mdm_adaln_dense.argtypes = ([vp] * 8         # tensors
                                    + [i] * 5        # rows T D Dout bf16
                                    + [vp])          # stream
    lib.mdm_adaln_dense.restype = i
    lib.mdm_favor_attention.argtypes = ([vp] * 7     # q k v proj mask out sc
                                        + [i] * 5    # B H T D M
                                        + [f, i, vp])  # eps cluster stream
    lib.mdm_favor_attention.restype = i
    lib.mdm_favor_qkv_moments.argtypes = ([vp] * 6   # qkv LN proj mask kv
                                          + [i] * 7  # B T H D M bf16 mxu
                                          + [f, i, vp])  # pre cluster s
    lib.mdm_favor_qkv_moments.restype = i
    lib.mdm_favor_qkv_apply.argtypes = ([vp] * 8     # qkv kv LN proj mask
                                        #            out scratch
                                        + [i] * 7    # B T H D M bf16 mxu
                                        + [f, f, i, vp])  # eps pre C s
    lib.mdm_favor_qkv_apply.restype = i
    lib.mdm_favor_attention_moments.argtypes = ([vp] * 5  # k v proj mask kv
                                                + [i] * 6  # B H T D M C
                                                + [vp])    # stream
    lib.mdm_favor_attention_moments.restype = i
    lib.mdm_favor_attention_apply.argtypes = ([vp] * 7  # q k kv proj mask
                                              #           out scratch
                                              + [i] * 5  # B H T D M
                                              + [f, i, vp])  # eps C stream
    lib.mdm_favor_attention_apply.restype = i
    lib.mdm_favor_qkv_bwd_split_scratch_floats.argtypes = [i] * 7
    lib.mdm_favor_qkv_bwd_split_scratch_floats.restype = ctypes.c_longlong
    lib.mdm_favor_qkv_bwd_kv.argtypes = ([vp] * 7    # qkv LN proj mask kv
                                         #             scratch
                                         + [i] * 7   # B T H D M bf16 mxu
                                         + [f, i, i, vp])  # pre dp C s
    lib.mdm_favor_qkv_bwd_kv.restype = i
    lib.mdm_favor_qkv_bwd_q.argtypes = ([vp] * 10    # qkv LN proj mask g
                                        #              kv dqkv g_kv scratch
                                        + [i] * 7    # B T H D M bf16 mxu
                                        + [f, f, i, i, vp])  # eps pre dp C s
    lib.mdm_favor_qkv_bwd_q.restype = i
    lib.mdm_favor_qkv_bwd_k.argtypes = ([vp] * 11    # qkv LN proj mask g_kv
                                        #              dqkv d_ln d_proj sc
                                        + [i] * 7    # B T H D M bf16 mxu
                                        + [f, f, i, vp])  # eps pre C s
    lib.mdm_favor_qkv_bwd_k.restype = i
    lib.mdm_favor_attention_full.argtypes = ([vp] * 9    # tensors, scratch
                                             + [i] * 6   # B T H D M bf16
                                             + [f, f, i, vp])  # eps pre C s
    lib.mdm_favor_attention_full.restype = i
    lib.mdm_flash_cross_attention.argtypes = ([vp] * 4      # q k v out
                                              + [i] * 5     # BH T N D bn
                                              + [f, vp])    # scale stream
    lib.mdm_flash_cross_attention.restype = i
    lib.mdm_flash_cross_attention_smem_bytes.argtypes = [i] * 2  # bn D (f32)
    lib.mdm_flash_cross_attention_smem_bytes.restype = ctypes.c_longlong
    lib.mdm_flash_cross_attention_bf16.argtypes = ([vp] * 4     # q k v out
                                                   + [i] * 4    # BH T N D
                                                   + [f, vp])   # scale s
    lib.mdm_flash_cross_attention_bf16.restype = i
    lib.mdm_activation.argtypes = [vp, vp, vp,              # x bias y
                                   ctypes.c_longlong, i, i,  # n C op
                                   vp]                       # stream
    lib.mdm_activation.restype = i
    lib.mdm_activation_grad.argtypes = [vp, vp, vp, vp,         # x bias g dx
                                        ctypes.c_longlong, i, i,  # n C op
                                        vp]                       # stream
    lib.mdm_activation_grad.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(build()))
        return _LIB
