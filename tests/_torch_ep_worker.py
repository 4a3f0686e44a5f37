"""One rank of the port's expert-parallel tests
(``test_torch_moe_parallel.py``).

    python -m tests._torch_ep_worker SPEC.json RANK

Joins a gloo process group of ``spec["world"]`` processes at
``spec["init"]`` (a ``file://`` URL), then runs ``spec["cases"]`` in
order, each on its own ``parallel.ExpertMesh`` (``ep`` of the world):

- ``layer``: ``parallel/moe_parallel.py::make_ep_moe_layer`` on this rank's
  token chunk of ``layer.npz`` (f32), a backward of ``sum(y * cot)``;
- ``bf16``: a bf16 ``SwitchMoELayer(compute="dispatch")`` under the mesh,
  routed by JAX's top-2 (``top2`` of ``layer.npz``), its own routing
  counted;
- ``step``: one train step of the tiny model from ``spec["state_dict"]``
  on this rank's rows of ``spec["batch"]``; ``control`` "dp_divide" divides
  the expert gradients by dp instead of W, "local_capacity" runs
  ``dispatch`` with each rank's own capacity; ``save`` saves the state in
  both formats and restores it at the same mesh; ``resume`` restores the
  one-process save ``spec["resume"]``;
- ``units``: the errors of the mesh's checks.

Rank 0 writes ``<out>/<name>.pt`` with what the case gathered (outputs and
gradients whole, in the global layout). It imports the port and torch,
nothing of JAX.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a))


def _whole_grads(model, mesh, denom_experts):
    """The gradients of the global batch in the global layout, on rank 0:
    the replicated ones averaged over the world, the expert shards summed
    over the data group, divided by ``denom_experts`` and gathered."""
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        gather_whole, leaf_cuts)

    named = list(model.named_parameters())
    cuts = leaf_cuts(model)
    flags = [cuts[n] for n, _ in named]
    grads = []
    for (_, p), x in zip(named, flags):
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
        if x.expert:
            mesh.data.sum_(g).div_(denom_experts)
        else:
            mesh.sum_(g).div_(mesh.world)
        grads.append(g)
    whole = gather_whole(grads, flags, mesh)
    return None if whole is None else dict(zip([n for n, _ in named], whole))


def run_layer(spec, case, mesh, arrays):
    from motiondiffusion_moe_tpu_torch.parallel.mesh import Cut
    from motiondiffusion_moe_tpu_torch.parallel.moe_parallel import (
        make_ep_moe_layer)

    r, W = mesh.rank, mesh.world
    x_all = _t(arrays["x"])
    n = x_all.shape[0] // W
    x = x_all[r * n:(r + 1) * n].clone().requires_grad_()
    params = {k: _t(arrays[k]).requires_grad_()
              for k in ("gate_w", "gate_b", "w1", "b1", "w2", "b2")}
    E = params["w1"].shape[0]
    layer = make_ep_moe_layer(mesh, E, 2, case["cf"])
    y = layer(x, params)
    (y * _t(arrays["cot"])[r * n:(r + 1) * n]).sum().backward()
    keep = mesh.expert_slice(E)
    out = {"y": mesh.all_gather(y.detach()), "dx": mesh.all_gather(x.grad)}
    for k in ("gate_w", "gate_b"):
        out["d" + k] = mesh.sum_(params[k].grad.clone())
    experts = []
    for k in ("w1", "b1", "w2", "b2"):
        g = params[k].grad
        # the experts this rank does not hold get no gradient here
        out[f"unheld_{k}"] = float(torch.cat([g[:keep.start],
                                              g[keep.stop:]]).abs().sum())
        experts.append(mesh.data.sum_(g[keep].clone()))
    whole = mesh.gather_blocks(experts, [Cut(expert=True)] * 4)
    if r == 0:
        out.update(zip(("dw1", "db1", "dw2", "db2"), whole))
        torch.save(out, os.path.join(spec["out"], f"{case['name']}.pt"))


def run_bf16(spec, case, mesh, arrays):
    from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        attach_mesh, shard_params)

    r, W = mesh.rank, mesh.world
    sd = torch.load(spec["layer_sd"], weights_only=True)
    E, D, hid = sd["w1"].shape
    layer = SwitchMoELayer(D, hid, E, 2, torch.bfloat16, "dispatch",
                           case["cf"])
    layer.load_state_dict(sd)
    attach_mesh(layer, mesh)
    shard_params(layer)
    x_all = _t(arrays["x"])
    n = x_all.shape[0] // W
    x = x_all[r * n:(r + 1) * n].to(torch.bfloat16)
    own_vals, own_idx = layer.ep_routing(x)
    forced = _t(arrays["top2"])[r * n:(r + 1) * n].long()
    probs = torch.softmax(layer._router_logits(x).to(torch.bfloat16).float(),
                          dim=-1)
    layer.ep_routing = lambda _: (probs.gather(1, forced), forced)
    with torch.no_grad():
        y = layer(x).float()
    flips = int((own_idx.sort(-1).values != forced.sort(-1).values)
                .any(-1).sum())
    out = {"y": mesh.all_gather(y),
           "flips": int(mesh.total(torch.tensor(flips))),
           "held": layer.w1.shape[0]}
    if r == 0:
        torch.save(out, os.path.join(spec["out"], f"{case['name']}.pt"))


def _rows(arrays, r, W):
    B = arrays["motion"].shape[0]
    n = B // W
    b = {k: _t(arrays[k][r * n:(r + 1) * n]) for k in
         ("motion", "length", "text_ids", "t", "t_weight")}
    for k in ("length", "text_ids", "t"):
        b[k] = b[k].long()
    return b, _t(arrays["noise"][r * n:(r + 1) * n])


def _counting_drops():
    """Count the (token, choice) pairs the expert-parallel and the global
    dispatch drop: ({"pairs", "dropped"}, restore)."""
    from motiondiffusion_moe_tpu_torch.parallel import moe_parallel as MP

    seen = {"pairs": 0, "dropped": 0}
    slots, keep_fn = MP.capacity_slots, MP.global_keep

    def count(keep):
        seen["pairs"] += keep.numel()
        seen["dropped"] += int((~keep).sum())

    def slots_(*a):
        slot, keep = slots(*a)
        count(keep)
        return slot, keep

    def keep_(*a):
        keep = keep_fn(*a)
        count(keep)
        return keep

    MP.capacity_slots, MP.global_keep = slots_, keep_

    def restore():
        MP.capacity_slots, MP.global_keep = slots, keep_fn

    return seen, restore


def _model(cfg, mesh, sd, local_capacity=False):
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        attach_mesh, shard_params)

    model = MotionTransformer(cfg.model)
    model.load_state_dict(sd)
    attach_mesh(model, None if local_capacity else mesh)
    shard_params(model)
    return model


def run_step(spec, case, mesh, arrays):
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
        make_schedule)
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        is_expert_param, whole_state_dict)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        TrainStep, create_train_state)

    cfg = ExperimentConfig.from_dict(spec["cfg"])
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, moe_compute=case["compute"],
            moe_capacity_factor=case["cf"]),
        parallel=dataclasses.replace(
            cfg.parallel, num_expert_partitions=mesh.ep,
            zero1=case["zero1"]))
    control = case.get("control")
    sd = torch.load(spec["state_dict"], weights_only=True)
    model = _model(cfg, mesh, sd, control == "local_capacity")
    state = create_train_state(model, cfg, dp=mesh)
    denom = mesh.dp if control == "dp_divide" else mesh.world
    if mesh.ep > 1:
        state.optimizer.flats[1].denom = denom
    sched = make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                          num_timesteps=cfg.diffusion.num_timesteps)
    step = TrainStep(sched, cfg, dp=mesh)
    batch, noise = _rows(arrays, mesh.rank, mesh.world)
    seen, restore = _counting_drops()
    metrics = step.backward(state, batch, None, noise=noise)
    restore()
    grads = _whole_grads(model, mesh, denom)
    metrics = step.apply_update(state, metrics)
    opt, ema = state.optimizer, state.ema
    held = {"experts": sum(p.numel() for n, p in model.named_parameters()
                           if is_expert_param(n)),
            "mu": sum(m.numel() for m in opt.mu),
            "ema": sum(e.numel() for e in ema.params)}
    out = {"metrics": {k: float(v) for k, v in metrics.items()
                       if v.dim() == 0},
           "grads": grads, "params": whole_state_dict(model),
           "opt": opt.state_dict(), "ema": ema.state_dict()["params"],
           "held": all_gather_objects(held),
           "drops": all_gather_objects(seen)}
    if case.get("save"):
        out["saved"] = save_and_restore(spec, cfg, state, mesh, sd)
    if case.get("resume"):
        out["resumed"] = resume(spec, cfg, mesh, sd)
    if mesh.rank == 0:
        torch.save(out, os.path.join(spec["out"], f"{case['name']}.pt"))


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _held_as_sliced(state, payload, mesh) -> bool:
    """The rank's parameters, moments and EMA equal its part of the whole
    ``payload``, bit for bit."""
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        local_leaves, local_state_dict)

    opt, ema = state.optimizer, state.ema

    def part(whole, flags, shards):
        mine = local_leaves(whole, flags, mesh)
        return mine if shards is None else shards.local(mine)

    want = local_state_dict(state.model, payload["params"])
    ok = all(_same(v, want[k]) for k, v in state.model.state_dict().items())
    shards = opt.layout if opt.zero1 else None
    for mine, whole, flags, sh in (
            (opt.mu, payload["opt_state"]["mu"], opt.cuts, shards),
            (opt.nu, payload["opt_state"]["nu"], opt.cuts, shards),
            (ema.params, payload["ema_params"]["params"], ema.cuts,
             ema.shards)):
        ok = ok and all(_same(a, b) for a, b in
                        zip(mine, part(whole, flags, sh)))
    return ok


def save_and_restore(spec, cfg, state, mesh, sd):
    """Save in both formats, restore into a fresh state at this mesh:
    {fmt: [per rank, whether its part of the save came back bit for
    bit]}."""
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        create_train_state)

    gen = torch.Generator().manual_seed(100 + mesh.rank)
    held = {}
    for fmt in ("torch", "orbax"):
        ckpt = CheckpointManager(os.path.join(spec["out"], f"ckpt_{fmt}"),
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
              and torch.equal(rng[mesh.rank], gen.get_state()))
        held[fmt] = all_gather_objects(bool(ok))
    return held


def resume(spec, cfg, mesh, sd):
    """Restore the one-process save ``spec["resume"]`` at this mesh:
    [per rank, whether it holds its part of it bit for bit]."""
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        create_train_state)

    ckpt = CheckpointManager(spec["resume"], cfg=cfg)
    state = create_train_state(_model(cfg, mesh, sd), cfg, dp=mesh)
    ckpt.restore_with_rng(state)
    return all_gather_objects(bool(_held_as_sliced(state, ckpt.read(),
                                                   mesh)
                                   and state.step == 1))


def run_units(spec, mesh):
    from motiondiffusion_moe_tpu_torch.config import (
        ExperimentConfig, ParallelConfig)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    cfg = ExperimentConfig.from_dict(spec["cfg"])
    ep = ParallelConfig(num_expert_partitions=mesh.world)
    errors = {}
    for name, c, model in (
            ("experts", dataclasses.replace(
                cfg, parallel=ep, model=dataclasses.replace(
                    cfg.model, num_experts=3)), None),
            ("data_partitions", dataclasses.replace(
                cfg, parallel=dataclasses.replace(
                    ep, num_data_partitions=2)), None),
            ("caller_dense_fused", dataclasses.replace(cfg, parallel=ep),
             MotionTransformer(cfg.model)),
            ("tensor", dataclasses.replace(cfg, parallel=dataclasses.replace(
                ep, num_model_partitions=2)), None)):
        try:
            Trainer(c, model=model, device="cpu")
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = (type(e).__name__, str(e))
    trainer = Trainer(dataclasses.replace(cfg, parallel=ep), device="cpu")
    errors["dense_fused_became"] = trainer.cfg.model.moe_compute
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
    arrays = {k: np.load(spec[k]) for k in ("layer", "batch") if k in spec}
    for case in spec["cases"]:
        ep = case.get("ep", 1)
        if ep not in meshes:
            meshes[ep] = ExpertMesh(ep)
        mesh = meshes[ep]
        kind = case["kind"]
        if kind == "units":
            run_units(spec, mesh)
        elif kind == "step":
            run_step(spec, case, mesh, arrays["batch"])
        else:
            {"layer": run_layer, "bf16": run_bf16}[kind](
                spec, case, mesh, arrays["layer"])
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
