"""Time variants of kernels 7 (``csrc/adaln_dense.cu``, bf16) and 4
(``csrc/performer_epilogue_bwd.cu``, bf16) at the flagship shapes, each
built from a copy of the source with one change, to see where a kernel's
time goes.

    python3 scripts/kernel_variants.py [--only k7|k4]

Each variant is the checkout's source with the text substitutions listed
in ``VARIANTS`` (a phase left out, a knob set otherwise), compiled by its
own ``nvcc`` into its own library (all started together) and called
through its C entry on the same inputs: kernel 7 at B = 32, T = 196,
D = Dout = 512, kernel 4 at B = 32, T = 196, D = 512. Per variant it
prints the largest difference from the plain version (a variant that
leaves out a phase is wrong on purpose), the time per call over 100
back-to-back calls (CUDA events) and the device time per call and per
launch (``torch.profiler``, with ``chip_smoke.py``'s helpers), then the
device times once more in reverse order. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K7, K4 = "adaln_dense.cu", "performer_epilogue_bwd.cu"
_K7_PROLOGUE = "lr0 < r_end; lr0 += kAbPair) {"
_K7_MMA = "    warp_mma<kAbPanelK>(acc,"
_K7_STREAM = "    if (p < P::kPanels) {\n      cp_async_tile<kAbPanelK"
_K7_SILU = "x[q][j][e] = __fdividef(m, 1.f + __expf(-m));"
_K4_SIG = "const float sig = __fdividef(1.f, 1.f + __expf(-h4));"
_K4_FIT = "if (fits[c] >= batch) {"
# (kernel, name): (source, [(text, replacement), ...])
VARIANTS = {
    ("k7", "as built"): (K7, []),
    ("k7", "no prologue"): (K7, [(_K7_PROLOGUE, _K7_PROLOGUE.replace(
        "r_end;", "r_end && false;"))]),
    ("k7", "no products"): (K7, [(_K7_MMA, "    if (n0 < 0)" + _K7_MMA[3:])]),
    ("k7", "no w stream"): (K7, [(_K7_STREAM, _K7_STREAM.replace(
        "p < P::kPanels", "n0 < 0"))]),
    ("k7", "the stream alone"): (K7, [
        (_K7_PROLOGUE, _K7_PROLOGUE.replace("r_end;", "r_end && false;")),
        (_K7_MMA, "    if (n0 < 0)" + _K7_MMA[3:])]),
    ("k7", "IEEE expf and divide in the SiLU"): (K7, [(_K7_SILU, (
        "x[q][j][e] = m * (1.f / (1.f + expf(-m)));"))]),
    ("k7", "one row per prologue step"): (K7, [(
        "constexpr int kAbPair = 2;", "constexpr int kAbPair = 1;")]),
    ("k7", "7 ring slots"): (K7, [(
        "static constexpr int kStages = 4;",
        "static constexpr int kStages = D <= 512 ? 7 : 4;")]),
    ("k4", "as built"): (K4, []),
    ("k4", "IEEE expf and divide in the sigmoid"): (K4, [(_K4_SIG, (
        "const float sig = 1.f / (1.f + expf(-h4));"))]),
    ("k4", "2 blocks per batch row"): (K4, [(_K4_FIT, "if (c == 2) {")]),
    ("k4", "4 blocks per batch row"): (K4, [(_K4_FIT, "if (c == 4) {")]),
    ("k4", "8 blocks per batch row"): (K4, [(_K4_FIT, "if (c == 8) {")]),
}


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(work, csrc, nvcc, flags, key, src, subs):
    """Start nvcc on the patched copy; returns (library path, process)."""
    text = open(os.path.join(csrc, src)).read()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{key}: {old!r} is not in {src}")
        text = text.replace(old, new)
    d = os.path.join(work, f"{key[0]}_{len(os.listdir(work))}")
    os.makedirs(d)
    shutil.copy(os.path.join(csrc, "common.cuh"), d)
    with open(os.path.join(d, src), "w") as f:
        f.write(text)
    lib = os.path.join(d, "lib.so")
    cmd = [nvcc, *flags, "-shared", "-o", lib, os.path.join(d, src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("k7", "k4"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from motiondiffusion_moe_tpu_torch.ops import _build
    from motiondiffusion_moe_tpu_torch.ops import adaln as AD
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    cs = load("mdm_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    wanted = {k: v for k, v in VARIANTS.items()
              if args.only in (None, k[0])}
    with tempfile.TemporaryDirectory() as work:
        started = {key: build(work, _build.CSRC_DIR, _build.find_nvcc(),
                              _build.COMPILE_FLAGS, key, src, subs)
                   for key, (src, subs) in wanted.items()}
        libs = {}
        for key, (path, proc) in started.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"{key}: nvcc failed\n{out}")
            lib = ctypes.CDLL(path)
            vp, i = ctypes.c_void_p, ctypes.c_int
            if key[0] == "k7":
                lib.mdm_adaln_dense.argtypes = [vp] * 8 + [i] * 5 + [vp]
                lib.mdm_adaln_dense.restype = i
            else:
                lib.mdm_performer_epilogue_bwd.argtypes = ([vp] * 16
                                                           + [i] * 4 + [vp])
                lib.mdm_performer_epilogue_bwd.restype = i
                lib.mdm_performer_epilogue_bwd_cluster.argtypes = (
                    [i] * 4 + [ctypes.POINTER(i)])
                lib.mdm_performer_epilogue_bwd_cluster.restype = i
            libs[key] = lib

        dev = torch.device("cuda", 0)
        print(cs.card_line())
        rng = np.random.default_rng(0)

        def t(*shape, s=1.0, off=0.0, dt=torch.bfloat16):
            return torch.from_numpy((off + s * rng.standard_normal(shape))
                                    .astype(np.float32)).to(dev, dt)

        B, T, D = 32, 196, 512
        f32 = torch.float32
        stream = torch.cuda.current_stream().cuda_stream
        ada = [t(B, T, D), t(B, D, s=0.3), t(B, D, s=0.3),
               t(D, s=0.1, off=1.0, dt=f32), t(D, s=0.1, dt=f32),
               t(D, D, s=D ** -0.5), t(D, s=0.1)]
        ref7 = AD.adaln_dense_plain(*ada)
        out7 = torch.empty_like(ref7)
        epi = [t(B, T, D), t(B, D, s=0.3), t(B, D, s=0.3),
               t(D, s=0.1, off=1.0, dt=f32), t(D, s=0.1, dt=f32),
               t(D, s=0.1, off=1.0, dt=f32), t(D, s=0.1, dt=f32),
               t(B, T, D)]
        ref4 = P.performer_epilogue_bwd_plain(*epi)
        outs4 = [torch.empty_like(r) for r in ref4]
        scratch = torch.empty(B * 4 * D, dtype=f32, device=dev)

        def call(key):
            lib = libs[key]
            if key[0] == "k7":
                rc = lib.mdm_adaln_dense(
                    *[a.data_ptr() for a in ada], out7.data_ptr(), B * T, T,
                    D, D, 1, stream)
            else:
                rc = lib.mdm_performer_epilogue_bwd(
                    *[a.data_ptr() for a in epi],
                    *[o.data_ptr() for o in outs4], scratch.data_ptr(), B,
                    T, D, 1, stream)
            if rc != 0:
                raise RuntimeError(f"{key}: CUDA error {rc}")

        for key in libs:
            fn = (lambda key=key: call(key))  # noqa: E731
            fn()
            torch.cuda.synchronize()
            if key[0] == "k7":
                err = (out7.float() - ref7.float()).abs().max().item()
                extra = ""
            else:
                err = max((o.float() - r.float()).abs().max().item()
                          for o, r in zip(outs4, ref4))
                c = ctypes.c_int(0)
                libs[key].mdm_performer_epilogue_bwd_cluster(
                    B, T, D, 1, ctypes.byref(c))
                extra = f", {c.value} blocks per batch row by the query"
            print(f"{key[0]} {key[1]}: max_abs_err {err:.3e} against the "
                  f"plain version{extra}; {cs.time_ms(fn, 100):.4f} ms per "
                  f"call (CUDA events); device time "
                  f"{cs.device_ms(fn, 50)}, by launch "
                  f"{cs.device_ms_by_kernel(fn, 50)} (torch.profiler)",
                  flush=True)
        for key in reversed(list(libs)):
            print(f"{key[0]} {key[1]} (again): device time "
                  f"{cs.device_ms(lambda key=key: call(key), 50)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
