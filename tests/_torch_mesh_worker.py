"""One rank of the port's sampling-over-ranks tests
(``test_torch_sharded_sampling.py``).

    python -m tests._torch_mesh_worker SPEC.json RANK

Joins a gloo process group of ``spec["world"]`` processes at
``spec["init"]`` (a ``file://`` URL), then runs ``spec["cases"]`` in
order, each on its own ``parallel.mesh.generation_mesh(dp, ep, tp)`` over
the whole world:

- ``sample``: ``GenerationPipeline(mesh=...).sample`` of one micro-batch
  (``inputs.npz``: token ids, lengths, the injected noise) from the global
  state dict ``spec["weights"][case["weights"]]``, with the case's
  ``model`` fields over the base config; ``control`` "bias_every_rank"
  adds the row-parallel biases on every model rank;
- ``generate``: ``GenerationPipeline.generate`` of ``spec["prompts"]``
  from a generator seeded with ``spec["seed"]``;
- ``units``: the errors of the mesh's checks.

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
        num_inference_steps=spec["steps"], micro_batch=spec["micro_batch"],
        device="cpu", mesh=mesh)


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
