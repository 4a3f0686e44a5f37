"""Time variants of kernels 7 (``csrc/adaln_dense.cu``, bf16), 4
(``csrc/performer_epilogue_bwd.cu``, bf16) and 2
(``csrc/performer_epilogue.cu``, bf16) at the flagship shapes, each built
from a copy of the source with one change, to see where a kernel's time
goes.

    python3 scripts/kernel_variants.py [--only k7|k4|k2]

Each variant is the checkout's source with the text substitutions listed
in ``VARIANTS`` (a phase left out, a knob set otherwise), compiled by its
own ``nvcc`` into its own library (all started together) and called
through its C entry on the same inputs: kernel 7 at B = 32, T = 196,
D = Dout = 512, kernels 4 and 2 at B = 32, T = 196, D = 512 (kernel 2 fed
scale and shift as the chunk views of one [B, 2D] tensor, at the blocks
per batch row its wrapper takes, then the build as it is and the
variants with the factors in shared memory at 1-16 blocks per batch
row). Per variant it prints the largest difference from the
plain version (a variant that leaves out a phase is wrong on purpose), the
time per call over 100 back-to-back calls (CUDA events) and the device
time per call and per launch (``torch.profiler``, with ``chip_smoke.py``'s
helpers), then the device times once more in reverse order. Beside kernel
2 it times PyTorch's copy of y into a tensor of its shape: the same bytes
moved, a yardstick of the rate the card reaches at this size. Needs a
CUDA device and nvcc.
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
K7, K4, K2 = ("adaln_dense.cu", "performer_epilogue_bwd.cu",
              "performer_epilogue.cu")
_K7_PROLOGUE = "lr0 < r_end; lr0 += kAbPair) {"
_K7_MMA = "    warp_mma<kAbPanelK>(acc,"
_K7_STREAM = "    if (p < P::kPanels) {\n      cp_async_tile<kAbPanelK"
_K7_SILU = "x[q][j][e] = __fdividef(m, 1.f + __expf(-m));"
_K4_SIG = "const float sig = __fdividef(1.f, 1.f + __expf(-h4));"
_K4_FIT = "if (fits[c] >= batch) {"
_K2_SILU = "o[4 * q + k] = __fdividef(h4, 1.f + __expf(-h4));"
_K2_PREFETCH = "constexpr bool kPrefetch = sizeof(T) * V <= 64;"
_K2_FOLD = "constexpr bool kFoldStyle = true;"
_K2_REGS = "constexpr bool kParamRegs = true;"
_K2_BLOCKS = "kParamRegs ? (V <= 16 ? 2 : 1) : 3)"
_K2_L2 = "? sqrt_d * fminf(rsqrtf(q1), 1e12f)"
# kernel 2's blocks per batch row in the sweep of these of its variants
K2_CHUNKS = (1, 2, 3, 4, 6, 8, 12, 16)
K2_SWEPT = ("as built", "the factors in shared memory",
            "the factors in shared memory, 4 blocks an SM")
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
    ("k2", "as built"): (K2, []),
    ("k2", "IEEE expf and divide in the SiLU"): (K2, [(_K2_SILU, (
        "o[4 * q + k] = h4 / (1.f + expf(-h4));"))]),
    ("k2", "the SiLU by ftz approximations (ex2, rcp)"): (K2, [(_K2_SILU, (
        "{ float e_, r_; asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(e_) "
        ": \"f\"(h4 * -1.4426950408889634f)); asm(\"rcp.approx.ftz.f32 "
        "%0, %1;\" : \"=f\"(r_) : \"f\"(1.f + e_)); "
        "o[4 * q + k] = h4 * r_; }"))]),
    ("k2", "no SiLU"): (K2, [(_K2_SILU, "o[4 * q + k] = h4;")]),
    ("k2", "no prefetch"): (K2, [(_K2_PREFETCH, (
        "constexpr bool kPrefetch = false;"))]),
    ("k2", "the style LayerNorm unfolded"): (K2, [(_K2_FOLD, (
        "constexpr bool kFoldStyle = false;"))]),
    ("k2", "the L2 step by IEEE sqrt and divide"): (K2, [(_K2_L2, (
        "? sqrt_d / fmaxf(sqrtf(q1), 1e-12f)"))]),
    ("k2", "the factors in shared memory"): (K2, [(_K2_REGS, (
        "constexpr bool kParamRegs = false;"))]),
    ("k2", "the factors in shared memory, 4 blocks an SM"): (K2, [
        (_K2_REGS, "constexpr bool kParamRegs = false;"),
        (_K2_BLOCKS, "kParamRegs ? (V <= 16 ? 2 : 1) : 4)")]),
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
    ap.add_argument("--only", choices=("k7", "k4", "k2"))
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
            elif key[0] == "k2":
                ll = ctypes.c_longlong
                lib.mdm_performer_epilogue.argtypes = (
                    [vp] * 3 + [ll, ll] + [vp] * 5 + [i] * 5 + [vp])
                lib.mdm_performer_epilogue.restype = i
                lib.mdm_performer_epilogue_blocks_per_sm.argtypes = [
                    i, i, ctypes.POINTER(i)]
                lib.mdm_performer_epilogue_blocks_per_sm.restype = i
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
        y2 = t(B, T, D)
        sc2, sh2 = t(B, 2 * D, s=0.3).chunk(2, dim=-1)
        vecs2 = [t(D, s=0.1, off=1.0, dt=f32), t(D, s=0.1, dt=f32),
                 t(D, s=0.1, off=1.0, dt=f32), t(D, s=0.1, dt=f32)]
        ref2 = P.performer_epilogue_plain(y2, sc2, sh2, *vecs2)
        out2 = torch.empty_like(ref2)
        chunks = P.epilogue_chunks(B, T, P.epilogue_slots(
            0, D, torch.bfloat16))

        def call(key, c=chunks):
            lib = libs[key]
            if key[0] == "k7":
                rc = lib.mdm_adaln_dense(
                    *[a.data_ptr() for a in ada], out7.data_ptr(), B * T, T,
                    D, D, 1, stream)
            elif key[0] == "k2":
                rc = lib.mdm_performer_epilogue(
                    y2.data_ptr(), sc2.data_ptr(), sh2.data_ptr(),
                    sc2.stride(0), sh2.stride(0),
                    *[v.data_ptr() for v in vecs2], out2.data_ptr(), B, T,
                    D, 1, c, stream)
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
            elif key[0] == "k2":
                err = (out2.float() - ref2.float()).abs().max().item()
                n = ctypes.c_int(0)
                libs[key].mdm_performer_epilogue_blocks_per_sm(
                    D, 1, ctypes.byref(n))
                extra = (f", {chunks} blocks per batch row, {n.value} "
                         f"blocks an SM at once")
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
        for key in [k for k in libs if k[0] == "k2" and k[1] in K2_SWEPT]:
            for c in K2_CHUNKS:
                fn = (lambda key=key, c=c: call(key, c))  # noqa: E731
                print(f"k2 {key[1]} at {c} blocks per batch row: "
                      f"{cs.time_ms(fn, 100):.4f} ms per call (CUDA "
                      f"events); device time {cs.device_ms(fn, 50)} "
                      f"(torch.profiler)", flush=True)
        if any(k[0] == "k2" for k in libs):
            copy = torch.empty_like(y2)
            fn = (lambda: copy.copy_(y2))  # noqa: E731
            print(f"y copied by PyTorch (the same bytes as kernel 2 moves): "
                  f"{cs.time_ms(fn, 100):.4f} ms per call (CUDA events); "
                  f"device time {cs.device_ms(fn, 50)} (torch.profiler)",
                  flush=True)
        for key in reversed(list(libs)):
            print(f"{key[0]} {key[1]} (again): device time "
                  f"{cs.device_ms(lambda key=key: call(key), 50)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
