"""Sampling over ranks (``GenerationPipeline(mesh=...)``, the ``(data,
expert, model)`` mesh of ``parallel/mesh.py``), on the CPU.

Ranks run as gloo processes (``tests/_torch_mesh_worker.py``, a ``file://``
rendezvous under ``tmp_path``): 2, 4 and 8 of them, started before the JAX
references are computed. The tiny widths of ``tests/_torch_parity.py``
(latent 64, expert hidden 32, 4 experts, one block a scale, 16 frames),
seeded flax weights (every leaf nonzero, the head 10x smaller), one
micro-batch of 4 prompts with ragged lengths and injected noise, 3 DDIM
steps.

Held against the JAX package:

- f32, ``dense_fused`` as given and ``dense``: data 2, expert 2, model 2,
  ``(2, 2, 2)`` and ``(1, 4, 1)`` (and the dense-FFN model at model 2)
  against the one-device JAX sampler (as ``GenerationPipeline._sample_fn``
  builds it) within JAX's own atol 2e-4 (``tests/test_sharded_sampling.
  py``), and against the port's one process within 1e-4 (the samples
  reach ~45, where an f32 ulp is 4e-6 and guidance 7.5 scales the
  denoiser's differences);
- bf16 at model 2 against the JAX mesh (``make_mesh(2,
  tensor_parallel=2)``) within a relative RMS of 3e-2, inside
  ``DIVERGENCES.md``'s bf16 bounds (25 % on a 5-step DDIM trajectory);
- ``dispatch`` with drops (capacity factor 1) at ``(dp, ep) = (2, 2)`` and
  ``(2, 1)`` against the JAX mesh pipeline on the virtual CPU mesh (JAX's
  chunks of ``P((data, expert))``, and the global capacity at ``ep = 1``)
  within 2e-4; at (2, 1) the rank-local chunking (each data rank's own
  prompts, doubled, at their own capacity: the port's one process on each
  half) misses by more than 10x that;
- the row-parallel biases join the sum once: adding them on every model
  rank misses by more than 10x;
- ``generate`` from one seed gives the same motions at data 1, 2 and 4;
- each rank holds 1 / ep of the expert elements and 1 / tp of the split
  FFN columns: JAX's ``param_shardings`` per device, leaf by leaf summed;
- the errors: ``micro_batch % dp``, a world that is not ``dp ep tp``,
  ``E % ep``, a degree above 1 in one process, and training with
  ``num_model_partitions = 2`` in one process (a mismatch:
  ``tests/test_torch_tensor_parallel.py`` trains over the model axis).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from motiondiffusion_moe_tpu.diffusion import (
    ddim_sample_loop as jax_ddim_loop,
    make_schedule as jax_make_schedule,
    respace_schedule as jax_respace,
    space_timesteps as jax_space,
)
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu.parallel import make_mesh, param_shardings
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.parallel.mesh import generation_mesh
from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

from tests._torch_parity import random_params, rel_rms, tiny_config, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB, STEPS, CF = 4, 3, 1.0
PROMPTS = ["a person walks forward", "jump", "", "turns and waves"]
LENGTHS = [16, 9, 1, 12]
GEN = (["walk", "a person runs", "sit down", "", "wave", "kick"],
       [16, 5, 12, 1, 16, 7])  # two micro-batches, the second padded
F32_JAX, F32_PORT = 2e-4, 1e-4
BF16_REL = 3e-2

DISPATCH = {"moe_compute": "dispatch", "moe_capacity_factor": CF}
JOBS = {  # world: [(name, kind, layout, model fields, extra)]
    2: [("dp2_dense_fused", "sample", (2, 1, 1), {}, {}),
        ("dp2_dense", "sample", (2, 1, 1), {"moe_compute": "dense"}, {}),
        ("ep2_dense_fused", "sample", (1, 2, 1), {}, {}),
        ("ep2_dense", "sample", (1, 2, 1), {"moe_compute": "dense"}, {}),
        ("tp2_dense_fused", "sample", (1, 1, 2), {}, {}),
        ("tp2_dense", "sample", (1, 1, 2), {"moe_compute": "dense"}, {}),
        ("tp2_dense_ffn", "sample", (1, 1, 2), {"use_moe": False},
         {"weights": "dense"}),
        ("tp2_bf16", "sample", (1, 1, 2), {"dtype": "bfloat16"}, {}),
        ("tp2_bias_every_rank", "sample", (1, 1, 2),
         {"moe_compute": "dense"}, {"control": "bias_every_rank"}),
        ("tp2_ffn_bias_every_rank", "sample", (1, 1, 2),
         {"use_moe": False}, {"weights": "dense",
                              "control": "bias_every_rank"}),
        ("dp2_dispatch", "sample", (2, 1, 1), DISPATCH, {}),
        ("dp2_generate", "generate", (2, 1, 1), {}, {}),
        ("units2", "units", None, {}, {})],
    4: [("ep4_dense_fused", "sample", (1, 4, 1), {}, {}),
        ("ep4_dense", "sample", (1, 4, 1), {"moe_compute": "dense"}, {}),
        ("dp2ep2_dispatch", "sample", (2, 2, 1), DISPATCH, {}),
        ("dp4_generate", "generate", (4, 1, 1), {}, {})],
    8: [("mesh222_dense_fused", "sample", (2, 2, 2), {}, {}),
        ("mesh222_dense", "sample", (2, 2, 2), {"moe_compute": "dense"},
         {}),
        ("units8", "units", None, {}, {})],
}
CASES = {c[0]: c for cases in JOBS.values() for c in cases}


def _cfg(dtype="float32", **model):
    return tiny_config(dtype, num_layers=1, **model)


def _inputs(cfg):
    tok = cfg.model.text_max_tokens
    T, F = cfg.model.max_frames, cfg.model.input_feats
    return {"ids_c": hash_tokenize(PROMPTS, tok),
            "ids_u": hash_tokenize([""] * MB, tok),
            "lengths": np.asarray(LENGTHS, np.int64),
            "noise": np.random.default_rng(7).standard_normal(
                (MB, T, F)).astype(np.float32)}


def _flax_params(cfg, a):
    T = cfg.model.max_frames
    params = random_params(JaxMotionTransformer(cfg.model), a["noise"],
                           np.zeros(MB, np.int32), np.full(MB, T, np.int32),
                           text_ids=a["ids_c"])
    params["out"] = {k: 0.1 * v for k, v in params["out"].items()}
    return params


def _start(root, world, cases, spec):
    spec = dict(spec, init=f"file://{root / f'rdv{world}'}", world=world,
                out=str(root), cases=[
                    dict(name=n, kind=k, layout=lay, model=m, **extra)
                    for n, k, lay, m, extra in cases])
    path = root / f"job{world}.json"
    path.write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-m", "tests._torch_mesh_worker",
                              str(path), str(r)], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def _wait(procs, timeout=400):
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    return outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The three jobs started, the JAX references and the port's one
    process computed meanwhile, then the jobs' results."""
    root = tmp_path_factory.mktemp("mesh")
    cfg = _cfg()
    a = _inputs(cfg)
    np.savez(root / "inputs.npz", **a)
    moe = _flax_params(cfg, a)
    dense = _flax_params(_cfg(use_moe=False), a)
    weights = {}
    for tag, p in (("moe", moe), ("dense", dense)):
        weights[tag] = str(root / f"{tag}.pt")
        torch.save(jax_to_state_dict(p), weights[tag])
    spec = {"cfg": to_port(cfg).to_dict(), "weights": weights,
            "inputs": str(root / "inputs.npz"), "steps": STEPS,
            "micro_batch": MB, "prompts": list(GEN), "seed": 5}
    jobs = [_start(root, w, cases, spec) for w, cases in JOBS.items()]

    refs = {c: _jax_sample(_cfg(moe_compute=c), moe, a)
            for c in ("dense_fused", "dense")}
    refs["dense_ffn"] = _jax_sample(_cfg(use_moe=False), dense, a)
    refs["bf16_tp2"] = _jax_sample(_cfg("bfloat16"), moe, a,
                                   make_mesh(2, tensor_parallel=2))
    refs["dispatch_dp2"] = _jax_sample(_cfg(**DISPATCH), moe, a,
                                       make_mesh(2))
    refs["dispatch_dp2ep2"] = _jax_sample(_cfg(**DISPATCH), moe, a,
                                          make_mesh(4, expert_parallel=2))
    port = {c: _port_one(_cfg(moe_compute=c), moe, a)
            for c in ("dense_fused", "dense")}
    port["dense_ffn"] = _port_one(_cfg(use_moe=False), dense, a)
    # the rank-local chunking at (2, 1): each data rank's prompts doubled,
    # at its own capacity, is the one process on each half
    port["dispatch_halves"] = np.concatenate([
        _port_one(_cfg(**DISPATCH), moe, {k: v[lo:hi] for k, v in a.items()})
        for lo, hi in ((0, 2), (2, 4))])
    pipe = GenerationPipeline(to_port(cfg), params=jax_to_state_dict(moe),
                              sampler="ddim", num_inference_steps=STEPS,
                              micro_batch=MB, device="cpu")
    port["generate"] = pipe.generate(*GEN, torch.Generator().manual_seed(5))

    outs = _wait([p for job in jobs for p in job])
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    got = {n: torch.load(root / f"{n}.pt", weights_only=False)
           for n in CASES}
    return dict(cfg=cfg, refs=refs, port=port, got=got, moe=moe,
                dense=dense)


def _jax_sample(cfg, params, a, mesh=None):
    """The JAX sampler as ``GenerationPipeline._sample_fn`` builds it (with
    a mesh: the model built with it, the params placed by
    ``param_shardings``, the batch over 'data'), the noise injected."""
    model = JaxMotionTransformer(cfg.model, mesh=mesh)
    d = cfg.diffusion
    base = jax_make_schedule(schedule_name=d.beta_schedule,
                             num_timesteps=d.num_timesteps)
    sched, tmap = jax_respace(np.asarray(base.betas, np.float64),
                              jax_space(d.num_timesteps, f"ddim{STEPS}"))
    ids_c, ids_u = jnp.asarray(a["ids_c"]), jnp.asarray(a["ids_u"])
    lengths = jnp.asarray(a["lengths"], jnp.int32)

    def fn(variables, noise, key):
        enc_c = model.apply(variables, ids_c,
                            method=lambda m, i: m.encode_text(i))
        enc_u = model.apply(variables, ids_u,
                            method=lambda m, i: m.encode_text(i))
        xf_proj = jnp.concatenate([enc_c.pooled, enc_u.pooled])
        xf_out = jnp.concatenate([enc_c.tokens, enc_u.tokens])
        length2 = jnp.concatenate([lengths, lengths])

        def model_doubled(x2, t2):
            return model.apply(variables, x2, t2, length2, xf_proj=xf_proj,
                               xf_out=xf_out,
                               mutable=["moe_losses", "moe_metrics"])[0]

        return jax_ddim_loop(sched, model_doubled, noise, key,
                             guidance_scale=d.cfg_scale, timestep_map=tmap)

    variables = {"params": params}
    noise = jnp.asarray(a["noise"])
    if mesh is None:
        out = jax.jit(fn)(variables, noise, jax.random.key(3))
    else:
        shard = param_shardings(variables, mesh)
        batch = NamedSharding(mesh, P("data"))
        with mesh:
            out = jax.jit(fn, in_shardings=(
                shard, batch, NamedSharding(mesh, P())),
                out_shardings=batch)(jax.device_put(variables, shard),
                                     jax.device_put(noise, batch),
                                     jax.random.key(3))
    return np.asarray(out)


def _port_one(cfg, params, a):
    pipe = GenerationPipeline(to_port(cfg), params=jax_to_state_dict(params),
                              sampler="ddim", num_inference_steps=STEPS,
                              micro_batch=MB, device="cpu")
    return pipe.sample(torch.from_numpy(a["ids_c"]),
                       torch.from_numpy(a["ids_u"]),
                       torch.from_numpy(a["lengths"]),
                       noise=torch.from_numpy(a["noise"])).numpy()


def _err(x, ref) -> float:
    x = x.numpy() if isinstance(x, torch.Tensor) else x
    return float(np.abs(x - ref).max())


F32_CASES = {  # case: (JAX reference, the port's one process)
    "dp2_dense_fused": "dense_fused", "dp2_dense": "dense",
    "ep2_dense_fused": "dense_fused", "ep2_dense": "dense",
    "tp2_dense_fused": "dense_fused", "tp2_dense": "dense",
    "tp2_dense_ffn": "dense_ffn", "ep4_dense_fused": "dense_fused",
    "ep4_dense": "dense", "mesh222_dense_fused": "dense_fused",
    "mesh222_dense": "dense"}


@pytest.mark.parametrize("name", sorted(F32_CASES))
def test_f32_layouts_match_jax_and_the_one_process(run, name):
    ref = F32_CASES[name]
    out = run["got"][name]["out"]
    assert out.shape == run["refs"][ref].shape
    assert _err(out, run["refs"][ref]) <= F32_JAX
    assert _err(out, run["port"][ref]) <= F32_PORT
    layout = CASES[name][2]
    # under an expert or a model axis dense_fused computes dense
    if name.endswith("dense_fused") and layout[1] * layout[2] > 1:
        assert run["got"][name]["computes"] == ["dense"]


def test_bf16_under_model_parallelism_matches_the_jax_mesh(run):
    out = run["got"]["tp2_bf16"]["out"].numpy()
    assert np.isfinite(out).all()
    assert rel_rms(out, run["refs"]["bf16_tp2"]) <= BF16_REL


@pytest.mark.parametrize("name,ref", [
    ("dp2_dispatch", "dispatch_dp2"), ("dp2ep2_dispatch", "dispatch_dp2ep2")])
def test_dispatch_with_drops_takes_jax_chunks(run, name, ref):
    assert _err(run["got"][name]["out"], run["refs"][ref]) <= F32_JAX


def test_rank_local_chunking_misses_jax(run):
    """The control: each data rank's own prompts, doubled, routed at the
    capacity of its own tokens (at (2, 1) the one process on each half).
    At (2, 2) JAX's four chunks are the conditional and the unconditional
    rows of each half of the prompts, which is what that layout makes too:
    the layouts part only where JAX takes the global capacity (ep = 1)."""
    assert _err(run["port"]["dispatch_halves"],
                run["refs"]["dispatch_dp2"]) > 10 * F32_JAX


@pytest.mark.parametrize("name,ref", [
    ("tp2_bias_every_rank", "dense"), ("tp2_ffn_bias_every_rank",
                                       "dense_ffn")])
def test_row_parallel_biases_count_once(run, name, ref):
    """Adding the row-parallel biases on every model rank misses by far;
    the cases that add them once match (the f32 cases above)."""
    assert _err(run["got"][name]["out"], run["refs"][ref]) > 10 * F32_JAX


def test_generate_does_not_depend_on_the_data_axis(run):
    one = run["port"]["generate"]
    for name in ("dp2_generate", "dp4_generate"):
        got = run["got"][name]["out"]
        assert [g.shape[0] for g in got] == GEN[1]
        for g, o in zip(got, one):
            assert _err(g, o) <= F32_PORT


def _jax_elements(params, ep, tp):
    """Per-device elements under JAX's rules: (expert leaves, the leaves
    the model axis cuts outside them, all)."""
    mesh = make_mesh(ep * tp, expert_parallel=ep, tensor_parallel=tp)
    shard = param_shardings({"params": params}, mesh)
    out = {"all": 0, "experts": 0, "split": 0}
    leaves = jax.tree_util.tree_leaves_with_path(params)
    specs = jax.tree_util.tree_leaves(
        shard, is_leaf=lambda x: isinstance(x, NamedSharding))
    for (path, leaf), sh in zip(leaves, specs):
        n = int(np.prod(sh.shard_shape(leaf.shape)))
        key = jax.tree_util.keystr(path)
        out["all"] += n
        if "_moe" in key and key.endswith(("['w1']", "['b1']", "['w2']",
                                           "['b2']")):
            out["experts"] += n
        elif any(x in key for x in ("_fc1", "_fc2", "ffn_0", "ffn_1")) \
                and not key.endswith("_fc2']['bias']") \
                and not key.endswith("ffn_1']['bias']"):
            out["split"] += n
    return out


@pytest.mark.parametrize("name", ["ep2_dense", "tp2_dense", "tp2_dense_ffn",
                                  "ep4_dense", "mesh222_dense"])
def test_each_rank_holds_its_share_as_jax_places_it(run, name):
    _, _, (dp, ep, tp), _, extra = CASES[name]
    params = run[extra.get("weights", "moe")]
    want = _jax_elements(params, ep, tp)
    for per_rank in run["got"][name]["elements"]:
        assert per_rank == want
    whole = _jax_elements(params, 1, 1)
    b2 = sum(v.size for p, v in jax.tree_util.tree_leaves_with_path(params)
             if jax.tree_util.keystr(p).endswith("_moe']['b2']"))
    # 1 / ep of the experts (w1, b1, w2 also 1 / tp: b2 stays whole over
    # the model axis), 1 / tp of the split FFN columns
    assert want["experts"] == (whole["experts"] - b2) // (ep * tp) + b2 // ep
    assert want["split"] * tp == whole["split"]


def test_mesh_errors(run):
    units2, units8 = run["got"]["units2"], run["got"]["units8"]
    assert "but the process group has 2" in units2["world"]
    assert "but the process group has 2" in units2["world_dp"]
    assert "micro_batch 3 not divisible by the mesh data axis (2)" in \
        units2["micro_batch"]
    assert "4 experts over 8 expert partitions" in units8["experts"]


def test_degrees_above_one_in_one_process_raise():
    with pytest.raises(ValueError, match="one process per device"):
        generation_mesh(2, 1, 1)
    with pytest.raises(ValueError, match="one process per device"):
        generation_mesh(1, 1, 2)
    assert generation_mesh(1, 1, 1) is None


def test_training_over_the_model_axis_still_raises():
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    cfg = to_port(_cfg())
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, num_model_partitions=2))
    with pytest.raises(ValueError, match="1 process: launch a multiple of 2"):
        Trainer(cfg, device="cpu")
