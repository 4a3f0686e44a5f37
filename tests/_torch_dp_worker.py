"""One rank of the port's data-parallel tests (``test_torch_parallel.py``).

    python -m tests._torch_dp_worker SPEC.json RANK

Joins a gloo process group of ``spec["world"]`` processes at
``spec["init"]`` (a ``file://`` URL), then runs, in order:

- ``cases``: for each, the model from ``spec["state_dict"]`` trained
  ``steps`` optimizer steps on this rank's rows of ``spec["batch"]``
  (``motion_r`` ... ``noise_r``, indexed [step, row]) with the case's
  ``zero1`` and ``grad_accum_steps``; ``control`` takes each rank's own
  denominators (the naive mean of the ranks' means). Rank 0 writes
  ``<out>/<name>.pt``: the metrics per step, the gradients averaged over
  the ranks before the first update, the parameters after the first update
  and after the last, the optimizer's and the EMA's whole state, and each
  rank's resident elements of the moments and the EMA (with the size of
  its optimizer's flat buffers, alignment gaps included). A case with
  ``save`` writes its state in both checkpoint formats and restores it into
  a fresh state, reporting the round trip.
- ``units``: the loss-aware sampler's gather, the rank's host RNG, and the
  errors of a mismatched ``num_data_partitions`` and an indivisible
  microbatch (``<out>/units_<rank>.pt``).

It imports the port and torch, nothing of JAX.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _batch(arrays, rank: int, step: int):
    b = {k: torch.from_numpy(np.array(arrays[f"{k}_{rank}"][step]))
         for k in ("motion", "length", "text_ids", "t", "t_weight")}
    for k in ("length", "text_ids", "t"):
        b[k] = b[k].long()
    return b, torch.from_numpy(np.array(arrays[f"noise_{rank}"][step]))


def run_case(spec, case, dp, arrays):
    from motiondiffusion_moe_tpu_torch.config import (
        ExperimentConfig, ParallelConfig)
    from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
        make_schedule)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        TrainStep, create_train_state)

    cfg = ExperimentConfig.from_dict(spec["cfg"])
    cfg = dataclasses.replace(
        cfg, parallel=ParallelConfig(zero1=case["zero1"]),
        train=dataclasses.replace(cfg.train,
                                  grad_accum_steps=case["accum"]))
    model = MotionTransformer(cfg.model)
    model.load_state_dict(torch.load(spec["state_dict"], weights_only=True))
    state = create_train_state(model, cfg, dp=dp)
    sched = make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                          num_timesteps=cfg.diffusion.num_timesteps)
    step = TrainStep(sched, cfg, dp=dp)
    if case.get("control"):
        step.dp = None  # each rank's own denominators and expert counts
    out = {"metrics": [], "grads": None, "params1": None}
    names = [n for n, _ in model.named_parameters()]
    for s in range(spec["steps"]):
        batch, noise = _batch(arrays, dp.rank, s)
        metrics = step.backward(state, batch, None, noise=noise)
        if s == 0:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in model.parameters()]
            flat = dp.sum_(torch.cat([g.reshape(-1) for g in grads]))
            flat /= dp.world
            out["grads"] = {n: v.view_as(g) for n, v, g in zip(
                names, flat.split([g.numel() for g in grads]), grads)}
        metrics = step.apply_update(state, metrics)
        out["metrics"].append({k: float(v) for k, v in metrics.items()
                               if v.dim() == 0})
        if s == 0:
            out["params1"] = {k: v.clone()
                              for k, v in model.state_dict().items()}
    opt = state.optimizer
    out["resident"] = all_gather_objects(
        {"mu": sum(m.numel() for m in opt.mu),
         "nu": sum(v.numel() for v in opt.nu),
         "ema": sum(e.numel() for e in state.ema.params),
         "trainable": sum(p.numel() for p in opt.params),
         "all": sum(p.numel() for p in model.parameters()),
         "padded": sum(part.size for f in opt.flats
                       for _, part in f.groups),
         "tensors": len(opt.params)})
    out["params"] = model.state_dict()
    out["opt"] = opt.state_dict()
    out["ema"] = state.ema.state_dict()["params"]
    if case.get("save"):
        out["saved"] = save_and_restore(spec, cfg, state, dp)
    if dp.rank == 0:
        torch.save(out, os.path.join(spec["out"], f"{case['name']}.pt"))


def save_and_restore(spec, cfg, state, dp):
    """Save ``state`` in both formats (a generator per rank), then restore
    each into a fresh state over the same ranks: {fmt: what held}."""
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        create_train_state)

    gen = torch.Generator().manual_seed(100 + dp.rank)
    held = {}
    for fmt in ("torch", "orbax"):
        ckpt = CheckpointManager(os.path.join(spec["out"], f"ckpt_{fmt}"),
                                 fmt=fmt, cfg=cfg)
        ckpt.save(state.step, state, 0, gen)
        fresh = create_train_state(MotionTransformer(cfg.model), cfg, dp=dp)
        _, epoch, rng = ckpt.restore_with_rng(fresh)
        payload = ckpt.read()
        opt, ema = fresh.optimizer, fresh.ema
        shards = (all(_same(a, b) for a, b in zip(
            opt.mu, opt.layout.local(payload["opt_state"]["mu"])))
            and all(_same(a, b) for a, b in zip(
                opt.nu, opt.layout.local(payload["opt_state"]["nu"])))
            and all(_same(a, b) for a, b in zip(
                ema.params,
                ema.shards.local(payload["ema_params"]["params"]))))
        whole = opt.state_dict()  # the whole on rank 0 alone
        ema_whole = ema.state_dict()["params"]
        same = (all(_same(a, b) for a, b in zip(
            fresh.model.state_dict().values(),
            state.model.state_dict().values()))
            and fresh.step == state.step and epoch == 0)
        if dp.rank == 0:
            same = same and (all(_same(a, b) for a, b in zip(
                whole["mu"], payload["opt_state"]["mu"]))
                and all(_same(a, b) for a, b in zip(
                    whole["nu"], payload["opt_state"]["nu"]))
                and all(_same(a, b) for a, b in zip(
                    ema_whole, payload["ema_params"]["params"])))
        else:
            same = same and whole["mu"] is whole["nu"] is ema_whole is None
        rngs = isinstance(rng, list) and len(rng) == dp.world and torch.equal(
            rng[dp.rank], gen.get_state())
        held[fmt] = all_gather_objects(
            {"shards": bool(shards), "state": bool(same),
             "rng": bool(rngs)})
    return held


def run_units(spec, dp):
    from motiondiffusion_moe_tpu_torch.config import (
        ExperimentConfig, ParallelConfig)
    from motiondiffusion_moe_tpu_torch.diffusion.samplers import (
        LossSecondMomentResampler)
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    out = {}
    sampler = LossSecondMomentResampler(50, history_per_term=2)
    rng = np.random.default_rng(7 + dp.rank)
    ts = rng.integers(0, 50, 6)
    losses = rng.random(6)
    sampler.update_with_local_losses(ts, losses)
    out["sampler"] = {"ts": ts, "losses": losses,
                      "history": sampler._loss_history.copy(),
                      "counts": sampler._loss_counts.copy()}
    cfg = ExperimentConfig.from_dict(spec["cfg"])
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=5))
    trainer = Trainer(cfg, device="cpu")
    B = 4
    motions = np.zeros((B, cfg.data.max_motion_length, cfg.data.dim_pose),
                       np.float32)
    out["t"] = trainer._make_batch(["a"] * B, motions, [8] * B)["t"].numpy()
    errors = {}
    for name, kw in (
            ("data_partitions", dict(parallel=ParallelConfig(
                num_data_partitions=3))),
            ("microbatch", dict(train=dataclasses.replace(
                cfg.train, batch_size=6, grad_accum_steps=2)))):
        try:
            Trainer(dataclasses.replace(cfg, **kw), device="cpu")
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = (type(e).__name__, str(e))
    out["errors"] = errors
    torch.save(out, os.path.join(spec["out"], f"units_{dp.rank}.pt"))


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    from motiondiffusion_moe_tpu_torch.parallel.data_parallel import (
        DataGroup)
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        initialize_distributed)

    initialize_distributed(spec["init"], spec["world"], rank,
                           backend="gloo", device="cpu", timeout_s=120)
    dp = DataGroup()
    arrays = np.load(spec["batch"])
    for case in spec["cases"]:
        run_case(spec, case, dp, arrays)
    run_units(spec, dp)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
