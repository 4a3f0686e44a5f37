"""Time the flagship sampling path of one checkout of the PyTorch port:
dpm20 s/motion, and one denoiser forward's device time by kernel family,
with the two sampling switches (``use_fast_xattn``, ``MOE_FUSED_KERNEL=1``)
off and on.

    python3 scripts/forward_breakdown.py --root DIR --label NAME [--out FILE]

``DIR`` is the root of a checkout whose ``motiondiffusion_moe_tpu_torch``
is imported (not necessarily this one's), so that two commits can be
compared on one card: unpack the other with ``git archive`` into a
directory that ``.gitignore`` lists and run this script for each in turns
(a, b, b, a), one process each. The denoiser is ``chip_smoke.py``'s
flagship (``ExperimentConfig.moe_small()``, seeded weights, zero-init
leaves perturbed) in bf16 compute with bf16 weights, fed
``chip_smoke.denoiser_inputs`` (B = 32, T = 196), so both checkouts run
the same weights on the same inputs.

Per switch setting it prints the CUDA kernels of one forward by family
(count and device ms, ``torch.profiler``, a discarded warm-up cycle first),
the 25 kernels that take the most device time, and the host's wall time of
one synchronised forward (median of 5); then dpm20 ``generate`` of 16
prompts x 196 frames, in turns (off, on, on, off), s/motion. With
``--train-steps N`` it then runs ``tools/train.py main()`` of the checkout
for N optimizer steps at the flagship defaults (synthetic dataset, B = 32,
bf16 compute, dropout 0.1) and reports the host's ms per synchronised step
(``chip_smoke.run_train_cli``; the first step, which warms up, left out).
The last line is one JSON object with these numbers; ``--out`` also writes
it to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import re
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (family, pattern on the lower-cased kernel name), the first match wins
FAMILIES = (
    ("activation kernels (csrc/activations.cu)", r"activation_kernel"),
    ("cross-attention kernels (6, 9)", r"cross_attention|xattn|flash_cross"),
    ("favor kernels (1, 8, 10)", r"favor"),
    # before the epilogue: PyTorch's softmax kernels carry "Epilogue" in
    # their template arguments
    ("softmax", r"softmax"),
    ("performer epilogue (2)", r"epilogue"),
    ("fused MoE (5)", r"moe_dense"),
    ("adaln (7)", r"adaln"),
    ("GEMM", r"gemm|nvjet|cutlass|xmma|cublas|sm90_"),
    ("convolution", r"conv|cudnn|implicit_"),
    ("layer_norm", r"layer_norm"),
    ("top-k / sort", r"topk|sort|radix"),
    ("dtype copies", r"copy"),
    ("elementwise add", r"elementwise.*(add|sub)"),
    ("elementwise mul / div", r"elementwise.*(mul|div)"),
    ("elementwise (other)", r"elementwise"),
    ("reductions", r"reduce"),
    ("index / gather / scatter", r"index|gather|scatter"),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, pattern in FAMILIES:
        if re.search(pattern, low):
            return fam
    return "other"


def load_chip_smoke():
    """This checkout's chip_smoke.py, for its flagship and inputs; its
    functions import the port lazily, so they take ``--root``'s."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_forward(fn, torch):
    """{family: [count, device ms]} and the top kernels of one call of
    ``fn``, or None when no whole session was recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count]
        if events:
            break
    else:
        return None
    fams = {}
    for e in events:
        f = fams.setdefault(family(e.key), [0, 0.0])
        f[0] += e.count
        f[1] += e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:25]
    return fams, [(e.key[:110], e.count, e.self_device_time_total / 1e3)
                  for e in top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose motiondiffusion_moe_tpu_torch runs")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--train-steps", type=int, default=0,
                    help="also time this many optimizer steps (even)")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import motiondiffusion_moe_tpu_torch as port
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != root:
        raise SystemExit(f"imported the port from {port.__file__}, not {root}")
    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("forward_breakdown: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ExperimentConfig.moe_small()
    model = MotionTransformer(dataclasses.replace(
        cfg.model, dtype="bfloat16", use_fast_xattn=True))
    model.load_state_dict(cs.build_flagship(cfg).state_dict())
    model.to(dev).eval()
    cfg_run = dataclasses.replace(cfg, model=model.config)
    pipe = GenerationPipeline(cfg_run, model, sampler="dpm",
                              num_inference_steps=20, micro_batch=16,
                              param_dtype="bfloat16", device=dev)
    T = cfg.model.max_frames
    pipe.generate(["warm up"], [T])
    inputs, ids = cs.denoiser_inputs(cfg, dev)
    sync = torch.cuda.synchronize

    model = pipe.model  # the pipeline's own bf16 copy

    def forward():
        with torch.inference_mode():
            model(*inputs, text_ids=ids)

    result = {"label": args.label, "root": root, "card": cs.card_line(),
              "forward": {}, "s_per_motion": {}}
    for on in (False, True):
        cs.set_fused_paths(model, on)
        forward()
        walls = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            forward()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        entry = {"host_wall_ms": statistics.median(walls)}
        prof = profile_forward(forward, torch)
        if prof is None:
            entry["families"] = "not measured"
        else:
            fams, top = prof
            entry["families"] = {k: [n, round(ms, 4)] for k, (n, ms) in
                                 sorted(fams.items(), key=lambda kv: -kv[1][1])}
            entry["kernels"] = sum(n for n, _ in fams.values())
            entry["device_ms"] = round(sum(ms for _, ms in fams.values()), 4)
            entry["top"] = [[k, n, round(ms, 4)] for k, n, ms in top]
        key = "on" if on else "off"
        result["forward"][key] = entry
        print(f"[{args.label}] one forward, switches {key} (B=32, bf16): "
              f"host wall {entry['host_wall_ms']:.3f} ms; "
              + (f"{entry['kernels']} kernels, {entry['device_ms']:.3f} ms "
                 f"of device time" if prof else "device time not measured"))
        if prof:
            for fam, (n, ms) in entry["families"].items():
                print(f"[{args.label}]   {fam}: {n} kernels, {ms:.4f} ms")
            for k, n, ms in entry["top"]:
                print(f"[{args.label}]     {ms:9.4f} ms {n:5d}x {k}")

    prompts = [f"a person performs action number {i}" for i in range(16)]
    gen = {False: [], True: []}
    for on in (False, True, True, False):
        cs.set_fused_paths(model, on)
        sync()
        t0 = time.perf_counter()
        out = pipe.generate(prompts, [T] * len(prompts),
                            generator=torch.Generator(dev).manual_seed(7))
        sync()
        gen[on].append(time.perf_counter() - t0)
        if not all(np.isfinite(o).all() for o in out):
            raise SystemExit("non-finite motions")
    for on, key in ((False, "off"), (True, "on")):
        result["s_per_motion"][key] = [s / len(prompts) for s in gen[on]]
    print(f"[{args.label}] dpm20 generate {len(prompts)} prompts x {T} "
          f"frames, in turns (off, on, on, off): s/motion off "
          f"{result['s_per_motion']['off']}, on "
          f"{result['s_per_motion']['on']} ({result['card']})")
    if args.train_steps:
        import tempfile

        del pipe, model
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as ckdir:
            _, _, times = cs.run_train_cli([
                "--dataset", "synthetic", "--synthetic_size",
                str(16 * args.train_steps), "--batch_size", "32",
                "--device", "cuda", "--log_every", "1", "--num_epochs", "1",
                "--checkpoint_dir", ckdir])
        result["train_ms_per_step"] = times[1:]
        print(f"[{args.label}] train step (B=32, bf16, dropout 0.1), ms per "
              f"synchronised step after the first: {times[1:]} (median "
              f"{statistics.median(times[1:]):.1f}) ({result['card']})")
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
