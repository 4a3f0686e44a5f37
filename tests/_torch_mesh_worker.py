"""One rank of the port's sampling-over-ranks tests
(``test_torch_sharded_sampling.py``).

    python -m tests._torch_mesh_worker SPEC.json RANK

Joins a gloo process group of ``spec["world"]`` processes at
``spec["init"]`` (a ``file://`` URL), then runs ``spec["cases"]`` in
order, each on its own ``parallel.mesh.generation_mesh(*layout)`` over
the whole world (``(dp, ep, tp)``, or ``(dp, ep, tp, sp)`` with a seq
axis; ``test_torch_seq_parallel.py`` runs the seq cases):

- ``sample``: ``GenerationPipeline(mesh=...).sample`` of one micro-batch
  (``inputs.npz``: token ids, lengths, the injected noise) from the global
  state dict ``spec["weights"][case["weights"]]``, with the case's
  ``model`` fields over the base config; ``control`` "bias_every_rank"
  adds the row-parallel biases on every model rank;
- ``generate``: ``GenerationPipeline.generate`` of ``spec["prompts"]``
  from a generator seeded with ``spec["seed"]``;
- ``units``: the errors of the mesh's checks;
- ``forward``: one denoiser forward of the inputs ``<prefix>_x``, ``_t``,
  ``_length``, ``_ids`` (``case["prefix"]``) under no grad, each rank on
  its rows and frames, gathered over the seq and data groups; with
  ``control`` "grad" the same forward under grad (its error);
- ``seq_units``: the seq axis's errors, and each rank's mesh indices.

Training over the seq axis (``test_torch_seq_training.py``), each case on
the training mesh of ``parallel.mesh.make_mesh`` of ``spec["train_cfg"]``
with the case's ``model`` / ``train`` fields and ``layout`` ``(dp, ep, tp,
sp)``:

- ``train_step``: one ``TrainStep`` update of the weights
  ``spec["weights"][case["weights"]]`` on the row-holder's rows of the batch
  ``<prefix>_*`` (``case["prefix"]``) with its injected noise; the
  metrics, the whole parameters and Adam's first moment, each rank's
  ``per_sample_mse``, its calls of kernels 1 and 3, whole and split, and
  the pairs its expert-parallel ``dispatch`` dropped; with ``save``, a save
  at this mesh (every rank's generator state gathered beside it);
- ``train_fit``: ``Trainer.fit`` of the seeded init on the batches of
  ``spec["fit"]`` (the whole parameters, each rank's sampler state);
- ``train_resume``: a restore of the save at ``case["path"]`` at this mesh,
  held to the save bit for bit;
- ``train_units``: the training mesh's errors.

The pipe axis (``test_torch_pipeline_parallel.py``), each case on its own
``(data, pipe)`` mesh (``layout`` ``(dp, ep, tp, sp, pp)`` for the
training and generation kinds above):

- ``pipe_gpipe``: ``parallel.pipeline_parallel.gpipe`` of a toy stage
  (``tanh(h @ w_l)`` for each of the stage's layers of ``<prefix>_w``, or
  with ``context`` the ring plus the microbatch's context) on ``<prefix>_x``
  in ``case["M"]`` microbatches; the output, the loss's gradient of each
  stage's layers, and the aux;
- ``pipe_forward``: one denoiser forward of ``<prefix>_*`` under no grad
  on the data rank's rows, gathered over the data group, with each rank's
  held parameters;
- ``pipe_fit``: ``Trainer.fit`` at the case's mesh recording, after each
  step, the loss and a digest of every replicated leaf, and each forward's
  coins and dropout seeds (``pipeline_parallel.ring_draws``);
- ``pipe_memory``: the rank's held bytes (parameters, gradients, Adam's
  moments, the EMA) beside ``pp_stage_memory_report`` of the whole model.

Every rank reports the elements it holds (its expert tensors, its split
FFN columns, all of them); rank 0 writes ``<out>/<name>.pt``. It imports
the port and torch, nothing of JAX.
"""

import dataclasses
import json
import sys

import numpy as np
import torch


def _pipeline(spec, case, mesh):
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    cfg = ExperimentConfig.from_dict(spec["cfg"])
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **case.get("model", {})))
    weights = torch.load(spec["weights"][case.get("weights", "moe")],
                         weights_only=True)
    return GenerationPipeline(
        cfg, params=weights, sampler=case.get("sampler", "ddim"),
        num_inference_steps=case.get("steps", spec["steps"]),
        micro_batch=spec["micro_batch"], device="cpu", mesh=mesh)


def _elements(pipe):
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        is_expert_param, model_dim)

    out = {"all": 0, "experts": 0, "split": 0}
    for name, p in pipe.model.named_parameters():
        out["all"] += p.numel()
        if is_expert_param(name):
            out["experts"] += p.numel()
        elif model_dim(name, pipe._global_shapes[name], 2) is not None:
            out["split"] += p.numel()
    return out


def run_sample(spec, case, mesh, arrays):
    from motiondiffusion_moe_tpu_torch.parallel import moe_parallel as MP

    pipe = _pipeline(spec, case, mesh)
    once = MP.adds_bias
    if case.get("control") == "bias_every_rank":
        MP.adds_bias = lambda mesh: True
    try:
        out = pipe.sample(torch.from_numpy(arrays["ids_c"]),
                          torch.from_numpy(arrays["ids_u"]),
                          torch.from_numpy(arrays["lengths"]),
                          noise=torch.from_numpy(arrays["noise"]))
    finally:
        MP.adds_bias = once
    return {"out": out, "computes": sorted({
        m.compute for m in pipe.model.modules() if hasattr(m, "model_split")
    })}, pipe


def run_generate(spec, case, mesh):
    pipe = _pipeline(spec, case, mesh)
    texts, lengths = spec["prompts"]
    out = pipe.generate(texts, lengths,
                        torch.Generator().manual_seed(spec["seed"]))
    return {"out": [torch.from_numpy(o) for o in out]}, pipe


def run_units(spec, case, W):
    """Each check's error message, or 'no error'."""
    from motiondiffusion_moe_tpu_torch.parallel.mesh import generation_mesh

    def message(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return f"{type(e).__name__}: {e}"
        return "no error"

    got = {"world": message(lambda: generation_mesh(W, 2, 1)),
           "world_dp": message(lambda: generation_mesh(1, 1, 1))}
    mesh = generation_mesh(W, 1, 1)
    got["micro_batch"] = message(lambda: _pipeline(
        dict(spec, micro_batch=W + 1), case, mesh))
    if spec["cfg"]["model"]["num_experts"] % W:
        mesh = generation_mesh(1, W, 1)
        got["experts"] = message(lambda: _pipeline(spec, case, mesh))
    return got


def run_forward(spec, case, mesh, arrays):
    pipe = _pipeline(spec, case, mesh)
    x, t, length, ids = (torch.from_numpy(arrays[f"{case['prefix']}_{k}"])
                         for k in ("x", "t", "length", "ids"))
    B, T = x.shape[:2]
    rows, frames = mesh.rows(B), mesh.frames(T)
    sizes = [b - a for a, b in (mesh.frames(T, s) for s in range(mesh.sp))]
    args = (x[rows, frames[0]:frames[1]], t[rows], length[rows])
    kw = dict(text_ids=ids[rows], frames=frames)
    res = {}
    if case.get("control") == "grad":
        try:
            pipe.model(*args, **kw)
            res["grad"] = "no error"
        except NotImplementedError as e:
            res["grad"] = str(e)
        return res, pipe
    with torch.no_grad():
        out = mesh.gather_frames(pipe.model(*args, **kw), sizes)
        if mesh.dp > 1:
            out = mesh.data.all_gather(out)
    res.update(out=out, computes=sorted({
        m.compute for m in pipe.model.modules() if hasattr(m, "model_split")
    }))
    return res, pipe


def run_seq_units(spec, case, W):
    """The seq axis's errors (or 'no error'), and (d, s, e, m) of this
    rank on the mesh of ``case["layout"]``."""
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        ExpertMesh, generation_mesh)

    def message(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return f"{type(e).__name__}: {e}"
        return "no error"

    got = {"training_layout": message(lambda: ExpertMesh(1, 1, sp=2)),
           "world": message(lambda: generation_mesh(1, 1, 1, 3))}
    mesh = generation_mesh(*case["layout"])
    got["index"] = (mesh.d, mesh.s, mesh.e, mesh.m)
    got["short"] = message(lambda: _pipeline(spec, dict(
        case, model={"max_frames": 2 * mesh.sp - 1}), mesh))
    return got


def _train_config(spec, case):
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig.from_dict(spec["train_cfg"])
    dp, ep, tp, sp, pp = (tuple(case["layout"]) + (1,))[:5]
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, **case.get("model", {})),
        train=dataclasses.replace(cfg.train, **case.get("train", {})),
        data=dataclasses.replace(cfg.data, **case.get("data", {})),
        diffusion=dataclasses.replace(cfg.diffusion,
                                      **case.get("diffusion", {})),
        parallel=dataclasses.replace(
            cfg.parallel, num_data_partitions=dp, num_expert_partitions=ep,
            num_model_partitions=tp, num_seq_partitions=sp,
            num_pipeline_stages=pp, zero1=case.get("zero1", False)))


def _train_model(cfg, mesh, sd):
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        attach_mesh, shard_params)

    model = MotionTransformer(cfg.model)
    model.load_state_dict(sd)
    attach_mesh(model, mesh)
    shard_params(model)
    return model


def run_train_step(spec, case, arrays):
    """One update at the case's mesh (see the module doc)."""
    from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
        make_schedule)
    from motiondiffusion_moe_tpu_torch.ops import performer as PF
    from motiondiffusion_moe_tpu_torch.parallel import moe_parallel as MP
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        make_mesh, whole_model, whole_state_dict)
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        TrainStep, create_train_state)

    cfg = _train_config(spec, case)
    mesh = make_mesh(cfg)
    sd = torch.load(spec["weights"][case.get("weights", "train")],
                    weights_only=True)
    model = _train_model(cfg, mesh, sd)
    state = create_train_state(model, cfg, dp=mesh)
    stats = ((arrays["norm_mean"], arrays["norm_std"])
             if cfg.train.w_structure > 0 else None)
    step = TrainStep(make_schedule(
        schedule_name=cfg.diffusion.beta_schedule,
        num_timesteps=cfg.diffusion.num_timesteps), cfg, stats, dp=mesh)
    pre = case["prefix"]
    n = arrays[f"{pre}_motion"].shape[0] // mesh.holders
    rows = slice(mesh.q * n, (mesh.q + 1) * n)
    batch = {k: torch.from_numpy(np.array(arrays[f"{pre}_{k}"][rows]))
             for k in ("motion", "length", "text_ids", "t", "t_weight")}
    for k in ("length", "text_ids", "t"):
        batch[k] = batch[k].long()
    noise = torch.from_numpy(np.array(arrays[f"{pre}_noise"][rows]))
    # the whole kernel 1 and 3 (their forms the autograd Function calls
    # on the CPU) and the split's steps
    names = ("favor_qkv_plain", "favor_qkv_bwd", "favor_qkv_moments",
             "favor_qkv_apply", "favor_qkv_bwd_kv", "favor_qkv_bwd_q",
             "favor_qkv_bwd_k")
    calls = dict.fromkeys(names, 0)
    wrapped = {n: getattr(PF, n) for n in names}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return wrapped[name](*a, **k)
        return call

    for name in names:
        setattr(PF, name, counting(name))
    slots, dropped = MP.capacity_slots, [0]

    def counting_slots(*a):  # the pairs the expert-parallel dispatch drops
        slot, keep = slots(*a)
        dropped[0] += int((~keep).sum())
        return slot, keep

    MP.capacity_slots = counting_slots
    try:
        metrics = step.apply_update(state, step.backward(
            state, batch, None, noise=noise))
    finally:
        for name in names:
            setattr(PF, name, wrapped[name])
        MP.capacity_slots = slots
    mu = state.optimizer.state_dict()["mu"]  # the global layout, rank 0
    res = {"metrics": {k: float(v) for k, v in metrics.items()
                       if v.dim() == 0},
           "params": whole_state_dict(model),
           "mu": mu and dict(zip((n for n, p in whole_model(
               model).named_parameters() if p.requires_grad), mu)),
           "per_sample": all_gather_objects(
               metrics["per_sample_mse"].tolist()),
           "calls": all_gather_objects(calls),
           "dropped": all_gather_objects(dropped[0])}
    if case.get("save"):
        gen = torch.Generator().manual_seed(100 + mesh.q)
        torch.randn(3, generator=gen)
        CheckpointManager(case["save"], cfg=cfg).save(state.step, state, 0,
                                                      gen)
        res["rng"] = all_gather_objects(gen.get_state())
    return res


def run_train_fit(spec, case):
    """``Trainer.fit`` of the seeded init (see the module doc)."""
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import whole_state_dict
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    cfg = _train_config(spec, case)
    trainer = Trainer(cfg, device="cpu")
    batches = [(caps, np.asarray(m, np.float32), lens)
               for caps, m, lens in spec["fit"]]
    state = trainer.fit(trainer.init_state(), batches)
    sampler = trainer.sampler
    return {"params": whole_state_dict(state.model),
            "sampler": all_gather_objects(
                (sampler._loss_history.tolist(),
                 sampler._loss_counts.tolist())),
            "step": state.step}


def run_train_resume(spec, case):
    """A restore of ``case["path"]`` at this mesh, held to the save: each
    rank's (parameters, moments and EMA its part of the saved ones bit for
    bit, the generator state it gets)."""
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        local_leaves, local_state_dict, make_mesh)
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        create_train_state)

    cfg = _train_config(spec, case)
    mesh = make_mesh(cfg)
    sd = torch.load(spec["weights"][case.get("weights", "train")],
                    weights_only=True)
    state = create_train_state(_train_model(cfg, mesh, sd), cfg, dp=mesh)
    ckpt = CheckpointManager(case["path"], cfg=cfg)
    _, epoch, rng = ckpt.restore_with_rng(state)
    payload = ckpt.read()
    want = local_state_dict(state.model, payload["params"])
    ok = all(torch.equal(v, want[k])
             for k, v in state.model.state_dict().items())
    opt = state.optimizer
    for mine, whole in ((opt.mu, payload["opt_state"]["mu"]),
                        (opt.nu, payload["opt_state"]["nu"])):
        part = local_leaves(whole, opt.cuts, mesh)
        if opt.zero1:
            part = opt.layout.local(part)
        ok = ok and all(torch.equal(a, b) for a, b in zip(mine, part))
    got = rng[mesh.q] if isinstance(rng, list) else rng
    return {"held": all_gather_objects((ok, state.step, epoch)),
            "rng": all_gather_objects(got)}


def run_train_units(spec, case):
    """The training mesh's errors (or 'no error')."""
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    got = {}
    for name, layout, fields in case["checks"]:
        c = _train_config(spec, dict(case, layout=layout, **fields))
        try:
            Trainer(c, device="cpu")
            got[name] = "no error"
        except (ValueError, NotImplementedError) as e:
            got[name] = f"{type(e).__name__}: {e}"
    return got


def run_pipe_gpipe(case, arrays):
    """A toy stage through the ring (see the module doc)."""
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import ExpertMesh
    from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel import (
        gpipe, stage_range)

    mesh = ExpertMesh(pp=case["S"])
    pre = case["prefix"]
    w = torch.from_numpy(arrays[f"{pre}_w"])
    x = torch.from_numpy(arrays[f"{pre}_x"])
    held = stage_range(w.shape[0], mesh.pp, mesh.p)
    w_local = w[held.start:held.stop].clone().requires_grad_()
    context = {"c": x} if case.get("context") else {}

    def stage_fn(h, c, m):
        for wl in w_local:
            h = h + c["c"] if context else torch.tanh(h @ wl)
        return h, h.mean()

    out, aux = gpipe(mesh, stage_fn, x, context, case["M"])
    (out ** 2).sum().backward()
    grad = (w_local.grad if w_local.grad is not None  # the context's
            else torch.zeros_like(w_local))
    return {"out": out.detach(),
            "aux": all_gather_objects(float(aux.detach())),
            "grads": all_gather_objects((mesh.d, mesh.p, grad.clone()))}


def run_pipe_forward(spec, case, arrays):
    """A denoiser forward on the data rank's rows, gathered."""
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import generation_mesh

    mesh = generation_mesh(*case["layout"])
    pipe = _pipeline(spec, case, mesh)
    x, t, length, ids = (torch.from_numpy(arrays[f"{case['prefix']}_{k}"])
                         for k in ("x", "t", "length", "ids"))
    rows = mesh.rows(x.shape[0])
    with torch.no_grad():
        out = pipe.model(x[rows], t[rows], length[rows],
                         text_ids=ids[rows])
        if mesh.dp > 1:
            out = mesh.data.all_gather(out)
    return {"out": out, "held": all_gather_objects(sorted(
        n for n, _ in pipe.model.named_parameters()))}


def run_pipe_fit(spec, case):
    """``Trainer.fit`` with the replicated leaves and the draws recorded
    after each step (see the module doc)."""
    import hashlib

    from motiondiffusion_moe_tpu_torch.parallel import pipeline_parallel as PPL
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import leaf_cuts
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    cfg = _train_config(spec, case)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    cuts = leaf_cuts(state.model)
    steps, draws = [], []
    update, drawing = trainer.train_step.apply_update, PPL.ring_draws

    def recording_update(st, metrics):
        out = update(st, metrics)
        digest = hashlib.sha256()
        for n, p in st.model.named_parameters():
            if not cuts[n].stage:
                digest.update(p.detach().numpy().tobytes())
        steps.append((float(out["loss_total"]), digest.hexdigest()))
        return out

    def recording_draws(*a, **k):
        coins, seeds = drawing(*a, **k)
        draws.append((None if coins is None else coins.tolist(), seeds))
        return coins, seeds

    trainer.train_step.apply_update = recording_update
    PPL.ring_draws = recording_draws
    try:
        n = len(spec["fit"][0][0]) // trainer.holders
        rows = slice(trainer.q * n, (trainer.q + 1) * n)
        batches = [(caps[rows], np.asarray(m, np.float32)[rows], lens[rows])
                   for caps, m, lens in spec["fit"]]
        trainer.fit(state, batches)
    finally:
        PPL.ring_draws = drawing
    return {"steps": all_gather_objects(steps),
            "draws": all_gather_objects(draws),
            "mesh": all_gather_objects((trainer.dp.d, trainer.dp.p))}


def run_pipe_memory(spec, case):
    """The rank's held bytes beside the stage memory report."""
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import whole_model
    from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel import (
        pp_stage_memory_report)
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    cfg = _train_config(spec, case)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                            for t in ts)
    params = list(state.model.parameters())
    held = (nbytes(params)
            + nbytes(p.grad for p in params if p.requires_grad)
            + nbytes(state.optimizer.mu) + nbytes(state.optimizer.nu)
            + nbytes(state.ema.params))
    report = pp_stage_memory_report(
        list(whole_model(state.model).named_parameters()),
        cfg.parallel.num_pipeline_stages, ema=True, hbm_bytes=1 << 40)
    return {"held": all_gather_objects(held), "report": report}


def main(spec_path, rank):
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        all_gather_objects, initialize_distributed)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import generation_mesh

    torch.set_num_threads(1)
    with open(spec_path) as fh:
        spec = json.load(fh)
    W = spec["world"]
    initialize_distributed(spec["init"], W, rank, backend="gloo",
                           device="cpu", timeout_s=120)
    arrays = dict(np.load(spec["inputs"]))
    for case in spec["cases"]:
        if case["kind"] == "units":
            res, pipe = run_units(spec, case, W), None
        elif case["kind"] == "seq_units":
            res, pipe = all_gather_objects(run_seq_units(spec, case, W)), None
        elif case["kind"] == "train_step":
            res, pipe = run_train_step(spec, case, arrays), None
        elif case["kind"] == "train_fit":
            res, pipe = run_train_fit(spec, case), None
        elif case["kind"] == "train_resume":
            res, pipe = run_train_resume(spec, case), None
        elif case["kind"] == "train_units":
            res, pipe = run_train_units(spec, case), None
        elif case["kind"] == "pipe_gpipe":
            res, pipe = run_pipe_gpipe(case, arrays), None
        elif case["kind"] == "pipe_forward":
            res, pipe = run_pipe_forward(spec, case, arrays), None
        elif case["kind"] == "pipe_fit":
            res, pipe = run_pipe_fit(spec, case), None
        elif case["kind"] == "pipe_memory":
            res, pipe = run_pipe_memory(spec, case), None
        elif case["kind"] == "forward":
            res, pipe = run_forward(spec, case, generation_mesh(
                *case["layout"]), arrays)
        else:
            mesh = generation_mesh(*case["layout"])
            res, pipe = (run_sample(spec, case, mesh, arrays)
                         if case["kind"] == "sample"
                         else run_generate(spec, case, mesh))
            res["elements"] = all_gather_objects(_elements(pipe))
        if rank == 0:
            torch.save(res, f"{spec['out']}/{case['name']}.pt")
        del pipe
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
