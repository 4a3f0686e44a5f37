"""For one checkout of the PyTorch port: the SHA-256 of the fused MoE
kernel's outputs (kernel 5, ``csrc/moe_dense_fused.cu``) at the shapes of
``chip_smoke.py`` phase E1 and of the epilogue backward's outputs (kernel
4, ``csrc/performer_epilogue_bwd.cu``) at the flagship shape, and the
times of kernels 2, 4, 5 and 7 at the flagship shapes.

    python3 scripts/kernel_bench.py --root DIR [--label NAME] [--times]

``DIR`` is the root of a checkout whose ``motiondiffusion_moe_tpu_torch``
is imported (not necessarily this one's). Run it for each of two checkouts
on one card, one process each, in turns (a, b, b, a; unpack the other with
``git archive`` into a directory that ``.gitignore`` lists): equal digests
show that a change left kernel 5's and kernel 4's bits as they were, and
the times compare
the two checkouts' kernels on the same inputs. The inputs are drawn with
numpy from fixed seeds, the same for every checkout. Needs a CUDA device;
the checkout builds its kernels on first use.

With ``--times``: per kernel, the time per call (CUDA events over
back-to-back calls) and the device time per call (``torch.profiler``, with
the helpers of this checkout's ``chip_smoke.py``) of
``performer_epilogue`` (bf16, B = 32, T = 196, D = 512, contiguous scale
and shift, which every checkout takes; with grad, and under inference
mode entered once around the timed calls, as the sampling path calls it), ``performer_epilogue_bwd`` (bf16,
B = 32, T = 196, D = 512),
``moe_dense_fused`` (bf16, S = 6272, D = 512, E = 4, hid = 256) and
``adaln_dense`` (bf16, B = 32, T = 196, D = Dout = 512).

With ``--forward``: the CUDA kernels and device time of one bf16 forward
(B = 32, T = 196) of ``chip_smoke.py`` phase F3's flagship, every style
block fused (kernel 7) and every Performer unfused, from
``chip_smoke.kernels_per_call``.

Prints one line per result and as its last line one JSON object of them.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np

# chip_smoke.py phase E1's shapes: (label, S, D, E, hid)
SHAPES = (("flagship", 6272, 512, 4, 256), ("S=600", 600, 512, 4, 256),
          ("E=3", 1000, 384, 3, 128), ("moe_big", 6272, 768, 16, 1024))


def inputs(S, D, E, hid, seed):
    """x, top-2 routing weights and the experts' weights at E1's scales."""
    rng = np.random.default_rng(seed)
    p = np.exp(rng.standard_normal((S, E)))
    p /= p.sum(-1, keepdims=True)
    idx = np.argsort(-p, -1, kind="stable")[:, :2]
    combine = np.zeros((S, E), np.float32)
    np.put_along_axis(combine, idx, np.take_along_axis(p, idx, -1), -1)
    return (rng.standard_normal((S, D)), combine,
            rng.standard_normal((E, D, hid)) * D ** -0.5,
            0.1 * rng.standard_normal((E, hid)),
            rng.standard_normal((E, hid, D)) * hid ** -0.5,
            0.1 * rng.standard_normal((E, D)))


def smoke():
    """This checkout's chip_smoke.py, loaded by its path for its timers."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("mdm_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def times(dev) -> dict:
    """{kernel: (ms per call, device time)} at the flagship shapes."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import adaln as AD
    from motiondiffusion_moe_tpu_torch.ops import moe as MOE
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    cs = smoke()
    rng = np.random.default_rng(7)

    def t(*shape, s=1.0, off=0.0, dtype=torch.bfloat16):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev, dtype)

    B, T, D = 32, 196, 512
    f32 = torch.float32
    epi = (t(B, T, D), t(B, D, s=0.3), t(B, D, s=0.3),
           t(D, s=0.1, off=1.0, dtype=f32), t(D, s=0.1, dtype=f32),
           t(D, s=0.1, off=1.0, dtype=f32), t(D, s=0.1, dtype=f32),
           t(B, T, D))
    moe = [torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)
           for a in inputs(B * T, D, 4, 256, seed=100)]
    ada = (t(B, T, D), t(B, D, s=0.3), t(B, D, s=0.3),
           t(D, s=0.1, off=1.0, dtype=f32), t(D, s=0.1, dtype=f32),
           t(D, D, s=D ** -0.5), t(D, s=0.1))
    calls = {"performer_epilogue": lambda: P.performer_epilogue(*epi[:7]),
             "performer_epilogue_bwd": lambda: P.performer_epilogue_bwd(*epi),
             "moe_dense_fused": lambda: MOE.moe_dense_fused(*moe),
             "adaln_dense": lambda: AD.adaln_dense(*ada)}
    out = {name: (cs.time_ms(fn), cs.device_ms(fn))
           for name, fn in calls.items()}
    fn = calls["performer_epilogue"]
    with torch.inference_mode():  # entered once, as a sampling forward does
        out["performer_epilogue (inference mode)"] = (cs.time_ms(fn),
                                                      cs.device_ms(fn))
    return out


def forward_time(dev) -> str:
    """The kernels and device time of one bf16 forward of phase F3's
    module forms (every style block fused, every Performer unfused)."""
    import dataclasses

    import torch
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    cs = smoke()
    cfg = ExperimentConfig.moe_small()
    m = MotionTransformer(dataclasses.replace(cfg.model, dtype="bfloat16"))
    m.load_state_dict(cs.build_flagship(cfg).state_dict())
    m.to(dev).eval()
    cs._unfused_forms(m)
    args, ids = cs.denoiser_inputs(cfg, dev)

    def forward():
        with torch.inference_mode():
            m(*args, text_ids=ids)
        torch.cuda.synchronize()

    forward()
    return cs.kernels_per_call(forward)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="root of the checkout whose port is imported")
    ap.add_argument("--label", default="",
                    help="a name for this checkout in the output")
    ap.add_argument("--times", action="store_true",
                    help="also time kernels 2, 4, 5 and 7")
    ap.add_argument("--forward", action="store_true",
                    help="also time phase F3's bf16 forward")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    from motiondiffusion_moe_tpu_torch.ops import moe as MOE

    dev = torch.device("cuda", 0)
    label = args.label or args.root
    digests = {}
    for i, (shape, S, D, E, hid) in enumerate(SHAPES):
        base = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                for a in inputs(S, D, E, hid, seed=100 + i)]
        for dtype in (torch.bfloat16, torch.float32):
            out = MOE.moe_dense_fused(*[a.to(dtype) for a in base])
            torch.cuda.synchronize()
            raw = out.contiguous().cpu().view(torch.uint8).numpy()
            key = f"{shape} {str(dtype)[6:]}"
            digests[key] = hashlib.sha256(raw.tobytes()).hexdigest()
            print(f"[{label}] moe_dense_fused {key}: SHA-256 {digests[key]}")
    # kernel 4 at the flagship shape, bf16 and f32: its seven outputs
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    rng = np.random.default_rng(200)
    B, T, D = 32, 196, 512
    base = [rng.standard_normal((B, T, D)), 0.3 * rng.standard_normal((B, D)),
            0.3 * rng.standard_normal((B, D)),
            1 + 0.1 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
            1 + 0.1 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
            rng.standard_normal((B, T, D))]
    base = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in base]
    for dtype in (torch.bfloat16, torch.float32):
        k4_args = [a if i in (3, 4, 5, 6) else a.to(dtype)
                   for i, a in enumerate(base)]
        outs = P.performer_epilogue_bwd(*k4_args)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for o in outs:
            h.update(o.contiguous().cpu().view(torch.uint8).numpy().tobytes())
        key = f"performer_epilogue_bwd flagship {str(dtype)[6:]}"
        digests[key] = h.hexdigest()
        print(f"[{label}] {key}: SHA-256 {digests[key]}")
    result = {"label": label, "device": torch.cuda.get_device_name(0),
              "digests": digests}
    if args.times:
        result["times"] = times(dev)
        for name, (ms, dev_ms) in result["times"].items():
            print(f"[{label}] {name}: {ms:.4f} ms per call (CUDA events), "
                  f"device time {dev_ms} (torch.profiler)")
    if args.forward:
        result["forward"] = forward_time(dev)
        print(f"[{label}] one bf16 forward, every style block fused and "
              f"every Performer unfused: {result['forward']} "
              f"(torch.profiler)")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
