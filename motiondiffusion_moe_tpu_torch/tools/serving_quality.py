"""Serving-defaults quality measurement on trained weights.

Port of ``motiondiffusion_moe_tpu/tools/serving_quality.py``, the JAX CLI's
flags plus ``--device``. It measures the two serving-surface claims:

- few-step solver quality: strided DDIM-50 (the headline sampler) and
  DPM-Solver++(2M) at 20 and 10 steps, each against the full-schedule
  deterministic DDIM trajectory (the probability-flow reference all
  few-step solvers approximate);
- bf16-resident serving weights: the trajectory drift of
  ``param_dtype="bfloat16"`` (the ``tools/export.py --dtype bfloat16``
  cast) against the same solver with the f32 weights.

Usage (after a training run of either package's ``tools/train.py``)::

    python -m motiondiffusion_moe_tpu_torch.tools.serving_quality \\
        --run_dir RUN [--use_ema] [--batch 8] \\
        [--evaluator_ckpt path/to/finest.tar] [--skip_bf16] [--device cpu]

Each variant is one micro-batch of ``--batch`` synthetic captions at ``T =
max_motion_length``, from the same seeded initial noise. The run is read on
the host (``tools/export.py::load_run``), and its weights are placed on the
device once per dtype: one ``GenerationPipeline`` per dtype, its other
solvers sharing its model (``GenerationPipeline.with_sampler``). The JAX
tool restores on the host and hands the host params to a pipeline without
a mesh, which never places them. Every statistic (trajectory RMSE / rms,
the relative distance of the evaluator's motion embeddings, the bf16
drift) is computed on the device; each variant's sync is one (checksum,
non-finite count) pair, and the table comes to the host in one read.
"""

from __future__ import annotations

import argparse
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", required=True)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--evaluator_ckpt", default="",
                   help="released finest.tar weights; seeded-init evaluator "
                        "(relative distances only) when absent")
    p.add_argument("--skip_bf16", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on (default: the card)")
    return p


def main(argv=None) -> dict:
    """Runs the CLI; returns {"step", "stats": {variant: (traj, emb)},
    "drifts": {solver: drift}, "seconds": {variant: s}}."""
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from motiondiffusion_moe_tpu_torch.data.dataset import (
        SyntheticText2MotionDataset)
    from motiondiffusion_moe_tpu_torch.eval.evaluator_models import (
        EvaluatorModelWrapper)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.export import load_run

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    cfg, params, step0, _ = load_run(args.run_dir, use_ema=args.use_ema)
    print(f"[serving-quality] restored step {step0} (ema={args.use_ema}) "
          "on host", flush=True)

    B = args.batch
    T = cfg.data.max_motion_length
    ds = SyntheticText2MotionDataset(cfg.data, size=B, seed=7)
    captions = [ds[i][0] for i in range(B)]
    lengths = torch.full((B,), T, dtype=torch.long)

    if args.evaluator_ckpt:
        wrapper = EvaluatorModelWrapper.from_torch_checkpoint(
            args.evaluator_ckpt, dim_pose=cfg.data.dim_pose,
            unit_length=cfg.data.unit_length, device=device)
        ev_kind = "finest.tar"
    else:
        wrapper = EvaluatorModelWrapper(dim_pose=cfg.data.dim_pose,
                                        unit_length=cfg.data.unit_length,
                                        device=device)
        ev_kind = "seeded init (relative distances only)"

    # one pipeline per dtype: its weights are placed on the device once,
    # and every solver of that dtype shares them
    placed = {}

    def pipeline(sampler, steps, dtype):
        key = dtype or "f32"
        if key not in placed:
            placed[key] = GenerationPipeline(
                cfg, params=params, sampler=sampler,
                num_inference_steps=steps, micro_batch=B, param_dtype=dtype,
                device=device)
            return placed[key]
        return placed[key].with_sampler(sampler, steps)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    seconds = {}

    def sample(sampler, steps, dtype=None, seed=123):
        """One micro-batch sampled on the device; returns the device
        tensor."""
        pipe = pipeline(sampler, steps, dtype)
        ids_c = torch.as_tensor(pipe.tokenize(captions))
        ids_u = torch.as_tensor(pipe.tokenize([""] * B))
        name = (f"{sampler}{steps or cfg.diffusion.num_timesteps}"
                f"{' bf16' if dtype else ''}")
        sync()
        t0 = time.perf_counter()
        m = pipe.sample(ids_c, ids_u, lengths,
                        generator=torch.Generator(device).manual_seed(seed))
        chk, nonfinite = torch.stack([
            (m * 1e-3).sum(), (~torch.isfinite(m)).sum().float()]).tolist()
        seconds[name] = time.perf_counter() - t0
        assert int(nonfinite) == 0, f"{name}: {int(nonfinite)} non-finite"
        print(f"[serving-quality] {name}: sampled in {seconds[name]:.1f}s "
              f"(checksum {chk:.3f})", flush=True)
        return m

    @torch.inference_mode()
    def embed(m):
        # the fused eval path's math: zero frames at/after each length, then
        # the evaluator's motion encoder
        lt = lengths.to(device)
        keep = torch.arange(m.shape[1], device=device)[None, :, None] < \
            lt[:, None, None]
        return wrapper.motion_embeddings(torch.where(keep, m, 0.0), lengths)

    def rel_rms(x, y, ref):
        scale = ref.pow(2).mean().sqrt()
        return (x - y).pow(2).mean().sqrt() / scale.clamp(min=1e-8)

    def pair_stats(x, ref, ex, eref):
        enorm = eref.norm(dim=-1).mean()
        emb = (ex - eref).norm(dim=-1).mean() / enorm.clamp(min=1e-8)
        return rel_rms(x, ref, ref), emb

    # the probability-flow reference: full-schedule deterministic DDIM, f32
    ref = sample("ddim", None)
    variants = [("ddim50", "ddim", 50, None),
                ("dpm20", "dpm", 20, None),
                ("dpm10", "dpm", 10, None)]
    if not args.skip_bf16:
        variants += [("ddim50-bf16", "ddim", 50, "bfloat16"),
                     ("dpm20-bf16", "dpm", 20, "bfloat16")]
    outs = {name: sample(s, st, dt) for name, s, st, dt in variants}

    emb_ref = embed(ref)
    stats = {name: pair_stats(x, ref, embed(x), emb_ref)
             for name, x in outs.items()}
    drifts = {}
    if not args.skip_bf16:
        for a, b in (("ddim50", "ddim50-bf16"), ("dpm20", "dpm20-bf16")):
            drifts[a] = rel_rms(outs[b], outs[a], ref)
    # one host read for the whole table
    print("[serving-quality] fetching the stats table (one read)...",
          flush=True)
    flat = torch.stack([v for pair in stats.values() for v in pair]
                       + list(drifts.values())).tolist()
    stats = {name: (flat[2 * i], flat[2 * i + 1])
             for i, name in enumerate(stats)}
    drifts = dict(zip(drifts, flat[2 * len(stats):]))

    print(f"\n[serving-quality] checkpoint step {step0}, "
          f"B={B}, T={T}, evaluator: {ev_kind}")
    print(f"{'variant':<14} {'traj RMSE/rms':>14} {'emb dist (rel)':>15}")
    for name, (traj, emb) in stats.items():
        print(f"{name:<14} {traj:>14.4f} {emb:>15.4f}")
    # bf16 drift isolated from solver error: bf16 vs the SAME solver in f32
    for a, d in drifts.items():
        print(f"bf16 drift {a}: {d:.5f} "
              "(traj RMSE/rms vs same-solver f32)")
    assert all(np.isfinite(flat)), "non-finite statistic"
    return {"step": step0, "stats": stats, "drifts": drifts,
            "seconds": seconds}


if __name__ == "__main__":
    main()
