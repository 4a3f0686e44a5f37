"""One rank of the port's tensor-parallel tests
(``test_torch_tensor_parallel.py``).

    python -m tests._torch_tp_worker SPEC.json RANK

Joins a gloo process group of ``spec["world"]`` processes at
``spec["init"]`` (a ``file://`` URL), then runs ``spec["cases"]`` in
order, each on its own ``parallel.ExpertMesh`` (``ep`` x ``tp`` of the
world):

- ``step``: one train step of the tiny model from ``spec["state_dict"]`` on
  this rank's row-holder's rows of ``spec["batch"]``; the gradient caught
  where the optimizer clips it (reduced, before the clip) and gathered to
  the global layout. ``control`` "no_column_sum" takes the model group's
  sum out of the column inputs' backward, "world_reduce" reduces the
  model-cut leaves over the world instead of the ranks that share ``m``;
  ``save`` saves the state in both formats and restores it at the same
  mesh; a case's own ``cfg`` and ``state_dict`` (the dense-FFN model)
  take the place of the spec's;
- ``ffn``: a ``DenseFFN`` at dropout 0.2 in training mode, split over the
  model axis, against the whole module on the same rows and generator;
- ``units``: the errors and switches of the trainer under a model axis.

Rank 0 writes ``<out>/<name>.pt`` with what the case gathered. It imports
the port and torch, nothing of JAX.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from tests._torch_ep_worker import _held_as_sliced, _model, _same, _t


def _rows(arrays, q, holders):
    """Row-holder q's rows of the global batch and of its noise."""
    n = arrays["motion"].shape[0] // holders
    b = {k: _t(arrays[k][q * n:(q + 1) * n]) for k in
         ("motion", "length", "text_ids", "t", "t_weight")}
    for k in ("length", "text_ids", "t"):
        b[k] = b[k].long()
    return b, _t(arrays["noise"][q * n:(q + 1) * n])


def _config(spec, case, mesh):
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig.from_dict(case.get("cfg", spec["cfg"]))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, moe_compute=case["compute"],
            moe_capacity_factor=case["cf"]),
        parallel=dataclasses.replace(
            cfg.parallel, num_expert_partitions=mesh.ep,
            num_model_partitions=mesh.tp, zero1=case["zero1"]))


def run_step(spec, case, mesh, arrays):
    from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
        make_schedule)
    from motiondiffusion_moe_tpu_torch.parallel import moe_parallel as MP
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        gather_whole, leaf_cuts, model_dim, whole_state_dict)
    from motiondiffusion_moe_tpu_torch.training import train_state as TS

    cfg = _config(spec, case, mesh)
    control = case.get("control")
    sd = torch.load(case.get("state_dict", spec["state_dict"]),
                    weights_only=True)
    model = _model(cfg, mesh, sd)
    sharing_m = mesh.blocks[(False, True)]
    if control == "world_reduce":
        mesh.blocks[(False, True)] = mesh
    try:
        state = TS.create_train_state(model, cfg, dp=mesh)
    finally:
        mesh.blocks[(False, True)] = sharing_m
    opt = state.optimizer
    sched = make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                          num_timesteps=cfg.diffusion.num_timesteps)
    step = TS.TrainStep(sched, cfg, dp=mesh)
    batch, noise = _rows(arrays, mesh.q, mesh.holders)
    column = MP._ColumnInput.backward
    if control == "no_column_sum":
        MP._ColumnInput.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        metrics = step.backward(state, batch, None, noise=noise)
    finally:
        MP._ColumnInput.backward = column
    caught = {}
    clip = TS.clip_by_norm_

    def catch(grads, norm, max_norm):  # the reduced gradient, pre-clip
        whole = (opt.layout.gather(grads) if opt.zero1 else
                 gather_whole(grads, opt.cuts, opt.mesh))
        caught["grads"] = whole and [g.clone() for g in whole]
        return clip(grads, norm, max_norm)

    TS.clip_by_norm_ = catch
    try:
        metrics = step.apply_update(state, metrics)
    finally:
        TS.clip_by_norm_ = clip
    cuts = leaf_cuts(model)
    named = list(model.named_parameters())
    shapes = {n: tuple(v.shape) for n, v in sd.items()}
    held = {"split": {n: p.numel() for n, p in named
                      if model_dim(n, shapes[n], mesh.tp) is not None},
            "cut_dims": {n: c.dim for n, c in cuts.items()
                         if c.dim is not None},
            "mu": sum(m.numel() for m in opt.mu),
            "ema": sum(e.numel() for e in state.ema.params)}
    tnames = [n for n, p in named if p.requires_grad]
    out = {"metrics": {k: float(v) for k, v in metrics.items()
                       if v.dim() == 0},
           "params": whole_state_dict(model),
           "opt": opt.state_dict(), "ema": state.ema.state_dict()["params"],
           "held": all_gather_objects(held)}
    if caught["grads"] is not None:  # the frozen leaves' gradient is zero
        out["grads"] = {n: torch.zeros_like(v) for n, v in sd.items()}
        out["grads"].update(zip(tnames, caught["grads"]))
    if case.get("save"):
        out["saved"] = save_and_restore(spec, case, cfg, state, mesh, sd)
    if mesh.rank == 0:
        torch.save(out, os.path.join(spec["out"], f"{case['name']}.pt"))


def save_and_restore(spec, case, cfg, state, mesh, sd):
    """Save in both formats, restore into a fresh state at this mesh:
    {fmt: [per rank, whether its part of the save and its row-holder's
    generator state came back bit for bit]}."""
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        create_train_state)

    gen = torch.Generator().manual_seed(100 + mesh.q)
    held = {}
    for fmt in ("torch", "orbax"):
        ckpt = CheckpointManager(
            os.path.join(spec["out"], f"ckpt_{case['name']}_{fmt}"),
            fmt=fmt, cfg=cfg)
        ckpt.save(state.step, state, 0, gen)
        fresh = create_train_state(_model(cfg, mesh, sd), cfg, dp=mesh)
        _, epoch, rng = ckpt.restore_with_rng(fresh)
        ok = (_held_as_sliced(fresh, ckpt.read(), mesh)
              and all(_same(a, b) for a, b in zip(
                  fresh.model.state_dict().values(),
                  state.model.state_dict().values()))
              and all(_same(a, b) for a, b in zip(fresh.optimizer.mu,
                                                  state.optimizer.mu))
              and fresh.step == state.step and epoch == 0
              and len(rng) == mesh.holders
              and torch.equal(rng[mesh.q], gen.get_state()))
        held[fmt] = all_gather_objects(bool(ok))
    return held


def run_ffn(spec, case, mesh):
    """The split DenseFFN against the whole one on the same rows and
    generator: the output and every gradient on every rank (the rank's
    block of the cut ones)."""
    from motiondiffusion_moe_tpu_torch.models.layers import TrainContext
    from motiondiffusion_moe_tpu_torch.models.moe import DenseFFN
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        attach_mesh, leaf_cuts, shard_params)

    D, H = 64, 32
    rng = np.random.default_rng(7)
    x, emb, cot = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((4, 6, D), (4, D), (4, 6, D)))

    def run(split, train=True):
        ffn = DenseFFN(D, H, 2, D, dropout=0.2)
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():  # every leaf nonzero, the output's too
            for p in ffn.parameters():
                p.normal_(0.0, 0.2, generator=g)
        attach_mesh(ffn, mesh if split else None)
        if split:
            shard_params(ffn)
        ffn.train(train)
        xi = x.clone().requires_grad_()
        y = ffn(xi, emb, ctx=TrainContext(torch.Generator().manual_seed(5)))
        (y * cot).sum().backward()
        grads = {n: p.grad for n, p in ffn.named_parameters()}
        return y.detach(), xi.grad, grads, ffn

    y0, dx0, g0, _ = run(False)
    y_eval = run(False, train=False)[0]
    y, dx, g, ffn = run(True)
    cuts = leaf_cuts(ffn)

    def err(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    worst = {"y": err(y, y0), "dx": err(dx, dx0)}
    for n, v in g.items():
        worst[n] = err(v, mesh.take(g0[n], cuts[n]))
    got = {"worst": worst, "split": sorted(n for n, c in cuts.items()
                                           if c.dim is not None),
           "dropout_moves": err(y0, y_eval)}
    got = all_gather_objects(got)
    if mesh.rank == 0:
        torch.save(got, os.path.join(spec["out"], f"{case['name']}.pt"))


def run_units(spec, case, mesh):
    """Each check's error message (or None), and the trainer's switches."""
    from motiondiffusion_moe_tpu_torch.config import (
        ExperimentConfig, ParallelConfig)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    cfg = ExperimentConfig.from_dict(spec["cfg"])
    tp = ParallelConfig(num_model_partitions=2)
    errors = {}
    for name, c, model in (
            ("tp_divides", dataclasses.replace(cfg, parallel=ParallelConfig(
                num_model_partitions=3)), None),
            ("ep_tp_divide", dataclasses.replace(
                cfg, parallel=dataclasses.replace(
                    tp, num_expert_partitions=4)), None),
            ("data_partitions", dataclasses.replace(
                cfg, parallel=dataclasses.replace(
                    tp, num_data_partitions=4)), None),
            ("microbatch", dataclasses.replace(
                cfg, parallel=tp, train=dataclasses.replace(
                    cfg.train, batch_size=3)), None),
            ("seq", dataclasses.replace(cfg, parallel=dataclasses.replace(
                tp, num_seq_partitions=3)), None),
            ("pipe", dataclasses.replace(cfg, parallel=dataclasses.replace(
                tp, num_pipeline_stages=2)), None),
            ("caller_dense_fused", dataclasses.replace(cfg, parallel=tp),
             MotionTransformer(cfg.model))):
        try:
            Trainer(c, model=model, device="cpu")
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = (type(e).__name__, str(e))
    trainer = Trainer(dataclasses.replace(cfg, parallel=tp), device="cpu")
    errors["dense_fused_became"] = trainer.cfg.model.moe_compute
    errors["row_holder"] = all_gather_objects(
        (trainer.q, trainer.holders, trainer.dp.m))
    if mesh.rank == 0:
        torch.save(errors, os.path.join(spec["out"], "units.pt"))


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import ExpertMesh

    initialize_distributed(spec["init"], spec["world"], rank,
                           backend="gloo", device="cpu", timeout_s=120)
    meshes = {}
    arrays = np.load(spec["batch"])
    for case in spec["cases"]:
        key = (case.get("ep", 1), case.get("tp", 2))
        if key not in meshes:
            meshes[key] = ExpertMesh(*key)
        mesh = meshes[key]
        kind = case["kind"]
        if kind == "step":
            run_step(spec, case, mesh, arrays)
        elif kind == "ffn":
            run_ffn(spec, case, mesh)
        else:
            run_units(spec, case, mesh)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
