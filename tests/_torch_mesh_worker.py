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
