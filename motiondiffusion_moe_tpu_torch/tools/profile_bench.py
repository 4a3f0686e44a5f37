"""Trace the flagship's sampler or train step with ``torch.profiler`` and
print the device time by kernel family (top kernels + family roll-up).

Port of ``motiondiffusion_moe_tpu/tools/profile_bench.py``, the JAX CLI's
flags plus ``--device``; ``--scan > 1`` (the JAX package's
``steps_per_call``) is not ported and raises. The weights are
``utils/bench_init.py``'s (fan-in-scaled normals, made on the device).
``--mode sample`` runs DDIM with ``--steps`` steps through
``GenerationPipeline`` (one warm call, then one traced call); ``--mode
train`` one warm and one traced optimizer step at B = ``--batch`` (zero
motion, t = 0, as the JAX tool feeds it). The trace is a Chrome trace in
``--log_dir`` (:func:`utils.profiling.trace`); :func:`analyze` reads its
CUDA kernel events (``cat == "kernel"``; XProf's ``XLA Ops`` thread in the
JAX tool) and prints the families of ``scripts/forward_breakdown.py``: the
hand-written kernels by name, cuBLAS GEMM, elementwise, reduction, copy,
LayerNorm, softmax, convolution, top-k, gathers, the optimizer's
multi-tensor kernels and other, each with its ms and share of the traced
device time.
:func:`report_cost` counts the FLOPs of the warm call's ATen operators
(``torch.utils.flop_counter.FlopCounterMode``; the hand-written kernels'
operations are not ATen operators and are not in it) and prints the time
they would take at the H100 SXM spec sheet's dense bf16 rate. XLA's bytes
accessed have no PyTorch counterpart: none are printed.

Usage::

    python -m motiondiffusion_moe_tpu_torch.tools.profile_bench \\
        [--batch 32] [--steps 50] [--top 30] [--mode sample|train] \\
        [--log_dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
from collections import defaultdict
from typing import Dict, Optional

# H100 SXM spec sheet, dense bf16 (not a measurement)
PEAK_BF16_FLOPS = 989e12

# (family, pattern on the lower-cased kernel name), the first match wins:
# scripts/forward_breakdown.py's families, the hand-written kernels by name
FAMILIES = (
    ("favor_qkv_bwd (3)", r"favor_qkv_bwd|sum_partials"),
    ("favor_qkv (1; 8, 10)", r"favor_kernel"),
    ("performer_epilogue_bwd (4)", r"epilogue_bwd"),
    ("performer_epilogue (2)", r"performer_epilogue"),
    ("moe_dense_fused (5)", r"moe_bf16_kernel|moe_f32_kernel"),
    ("cross-attention (6, 9; bf16)", r"cross_attention_mma"),
    ("xattn_fastlayout (6; f32)", r"xattn_fastlayout"),
    ("flash_cross_attention (9; f32)", r"flash_xattn"),
    ("adaln_dense (7)", r"adaln_(bf16|f32)_kernel"),
    ("activations (csrc/activations.cu)", r"activation_kernel"),
    ("softmax", r"softmax"),
    ("cuBLAS GEMM", r"gemm|nvjet|cutlass|xmma|cublas|sm90_"),
    ("convolution", r"conv|cudnn|implicit_"),
    ("layer_norm", r"layer_norm|gammabeta"),
    ("top-k / sort", r"topk|sort|radix"),
    ("optimizer (multi_tensor_apply)", r"multi_tensor_apply"),
    ("copy", r"copy"),
    ("elementwise", r"elementwise"),
    ("reduction", r"reduce"),
    ("index / gather / scatter", r"index|gather|scatter"),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, pattern in FAMILIES:
        if re.search(pattern, low):
            return fam
    return "other"


def _flagship(device):
    import torch

    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.utils.bench_init import (
        random_benchmark_params)

    cfg = ExperimentConfig.moe_small()
    with torch.device(device):
        model = MotionTransformer(cfg.model)
    return cfg, random_benchmark_params(model)


def report_cost(fn, scan: int = 1) -> Optional[float]:
    """Run ``fn`` once under ``FlopCounterMode``; print its ATen FLOPs and
    their time at the spec sheet's bf16 rate; returns the FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    flops = float(counter.get_total_flops())
    print(f"cost (per call, scan={scan}): ATen flops={flops / 1e9:.1f}G "
          f"(floor {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at 989 TFLOP/s, "
          "dense bf16, H100 SXM spec sheet; the hand-written kernels' "
          "operations are not counted; no bytes figure)",
          file=sys.stderr, flush=True)
    return flops


def capture(batch: int, steps: int, mode: str, log_dir: str,
            scan: int = 0, device="cuda"):
    """Build the flagship, warm the path once (counting its FLOPs), then
    trace one call into ``log_dir``; returns the profiler."""
    import torch

    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)
    from motiondiffusion_moe_tpu_torch.utils.profiling import trace

    if scan > 1:
        raise NotImplementedError(
            f"--scan {scan}: the K-step scanned program (steps_per_call) is "
            "not ported; trace one step")
    device = torch.device(device)
    cfg, model = _flagship(device)
    B, T, D = batch, cfg.model.max_frames, cfg.model.input_feats

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if mode == "sample":
        from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

        pipe = GenerationPipeline(cfg, model, sampler="ddim",
                                  num_inference_steps=steps, micro_batch=B,
                                  device=device)
        del model
        captions = ["a person walks forward and turns around"] * B
        lens = [T] * B

        def call(seed):
            pipe.generate(captions, lens,
                          generator=torch.Generator(device).manual_seed(seed))
            sync()
    else:
        from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
            make_schedule)
        from motiondiffusion_moe_tpu_torch.training.train_state import (
            TrainStep, create_train_state)

        sched = make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                              num_timesteps=cfg.diffusion.num_timesteps,
                              device=device)
        state = create_train_state(model, cfg)
        step = TrainStep(sched, cfg)
        data = {
            "motion": torch.zeros((B, T, D), device=device),
            "length": torch.full((B,), T, device=device),
            "text_ids": torch.as_tensor(hash_tokenize(
                ["a person walks"] * B, cfg.model.text_max_tokens),
                device=device),
            "t": torch.zeros((B,), dtype=torch.long, device=device),
            "t_weight": torch.ones((B,), device=device),
        }

        def call(seed):
            m = step(state, data, torch.Generator(device).manual_seed(seed))
            float(m["loss_total"])

    print("warming up...", file=sys.stderr, flush=True)
    report_cost(lambda: call(0), max(scan, 1))
    print("tracing...", file=sys.stderr, flush=True)
    with trace(log_dir) as prof:
        call(1)
    print("trace done", file=sys.stderr, flush=True)
    return prof


def analyze(log_dir: str, top: int, category: str = "kernel"
            ) -> Optional[Dict[str, object]]:
    """Read the newest Chrome trace in ``log_dir`` and print its events of
    ``category`` (CUDA kernels by default; ``"cpu_op"`` for the operators
    of a CPU trace, each counted by its self time) by family and the
    ``top`` names by total time. Returns {"total_ms", "families": {name:
    [count, ms]}, "top": [(name, count, ms)]}, or None without events."""
    traces = glob.glob(os.path.join(log_dir, "**", "*.json"), recursive=True)
    if not traces:
        print("no trace captured", file=sys.stderr)
        return None
    with open(max(traces, key=os.path.getmtime)) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == category]
    if not ops:
        print(f"no {category} events in the trace", file=sys.stderr)
        return None
    dur = _self_times(ops) if category != "kernel" else [
        float(e["dur"]) for e in ops]

    fam = defaultdict(lambda: [0, 0.0])
    agg = defaultdict(lambda: [0, 0.0])
    total = 0.0
    for e, d in zip(ops, dur):
        for table, key in ((fam, family(e["name"])), (agg, e["name"])):
            table[key][0] += 1
            table[key][1] += d / 1e3
        total += d / 1e3

    what = "device" if category == "kernel" else f"{category} self"
    print(f"\n== kernel-family rollup ({what} total {total:.3f} ms) ==")
    for k in sorted(fam, key=lambda k: -fam[k][1]):
        n, ms = fam[k]
        print(f"  {k:38s} {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%"
              f"  x{n}")
    ranked = sorted(agg, key=lambda k: -agg[k][1])[:top]
    print(f"\n== top {top} by total time ==")
    for k in ranked:
        n, ms = agg[k]
        print(f"  {ms:8.3f} ms  x{n:5d}  {k[:70]}")
    return {"total_ms": total,
            "families": {k: list(v) for k, v in fam.items()},
            "top": [(k, agg[k][0], agg[k][1]) for k in ranked]}


def _self_times(ops):
    """Each event's duration less that of the events nested in it on the
    same thread (CPU operators nest: aten::linear holds aten::addmm)."""
    order = sorted(range(len(ops)), key=lambda i: (
        ops[i].get("pid"), ops[i].get("tid"), float(ops[i]["ts"]),
        -float(ops[i]["dur"])))
    self_t = [float(e["dur"]) for e in ops]
    stack = []
    for i in order:
        e = ops[i]
        ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        key = (e.get("pid"), e.get("tid"))
        while stack and (stack[-1][1] != key or stack[-1][2] <= ts):
            stack.pop()
        if stack:
            self_t[stack[-1][0]] -= float(e["dur"])
        stack.append((i, key, end))
    return self_t


def device_total_ms(prof) -> float:
    """The profiler's own device total: the self device time of its CUDA
    events (``key_averages``)."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def main(argv=None) -> dict:
    """Runs the CLI; returns {"trace_dir", "analysis",
    "profiler_device_ms"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--mode", default="sample", choices=["sample", "train"])
    ap.add_argument("--scan", type=int, default=0,
                    help="not ported: > 1 raises (the JAX tool's K-step "
                         "scanned program)")
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu)")
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="torch_trace_")
    prof = capture(args.batch, args.steps, args.mode, log_dir,
                   scan=args.scan, device=device)
    category = "kernel" if device.type == "cuda" else "cpu_op"
    analysis = analyze(log_dir, args.top, category)
    device_ms = device_total_ms(prof) if device.type == "cuda" else None
    if device_ms is not None:
        print(f"profiler device total (key_averages): {device_ms:.3f} ms",
              file=sys.stderr)
    print(f"\ntrace dir: {log_dir}", file=sys.stderr)
    return {"trace_dir": log_dir, "analysis": analysis,
            "profiler_device_ms": device_ms}


if __name__ == "__main__":
    main()
