"""Pipeline parallelism (``parallel/pipeline_parallel.py``: the GPipe ring
over the pipe axis of the ``(data, pipe)`` mesh), on the CPU.

Ranks run as gloo processes (``tests/_torch_mesh_worker.py``'s ``pipe_*``
kinds and its training and sampling kinds at a pipe layout, a ``file://``
rendezvous under ``tmp_path``): one set of four for the data 2 x pipe 2
and pipe 4 cases, one of two for pipe 2 alone, and the train CLI as two
processes, all started before the JAX references, which run on the
8-device CPU mesh of ``tests/conftest.py`` (``make_mesh(n,
pipeline_parallel=S)``), each compiled on a thread while the next is
traced. The tiny widths of ``tests/_torch_parity.py`` at 2 blocks a scale,
f32, 4 experts computing ``dense``, one batch of 8 rows with ragged
lengths and t below 50.

Held against the JAX package:

- the ring against JAX's ``gpipe`` on the same toy weights (``tanh(h @
  w_l)``, 4 layers) at (S, M) = (2, 2), (2, 4) and (4, 4): the output
  within 1e-6 and the gradient of sum(out^2) within 1e-5 of each stage's
  layers (JAX ``test_matches_sequential``, ``test_gradient_matches_
  sequential``); the context read per microbatch, never circulated
  (``test_context_not_circulated``: exactly ``x (1 + S)``);
- the denoiser's forward at data 2 x pipe 2, M = 2, against JAX's PP
  forward within atol 2e-5, rtol 1e-5 (``test_forward_matches_single_
  device``), each rank holding only its stage's blocks;
- ``GenerationPipeline`` over ``(data 2, pipe 2)`` against JAX's sampler on
  its ``(data, pipe)`` mesh (DDIM, 10 steps, the noise injected) within
  atol 2e-4 (``test_pipeline_pp_mesh_matches_single_device``);
- one train step at data 2 x pipe 2 (M = 2), at pipe 2 alone (M = 4: the
  same four chunks of two rows, so the same Switch aux estimate and one
  JAX reference for both) and at data 2 x pipe 2 with ZeRO-1, MoE on with
  the balance weight 0.1, dropout 0, survival 1, the EMA on and no clip
  (``grad_clip_norm`` 1e6, so that Adam's first moment is 0.1 g), against
  JAX's ``make_sharded_train_step`` on its ``(data 2, pipe 2)`` mesh: the
  loss and the balance term rel 1e-5, every updated parameter within atol
  1e-5 (2 lr where JAX's first moment is within 1e-4 of its leaf's largest
  entry: there the gradient is zero up to rounding and Adam's first step
  moves it by up to lr either way, as in ``test_torch_seq_training.py``)
  and the first moment within 1e-4 of its leaf's largest entry (the aux
  term's weight in the backward shows there), but for the up-sampling
  kernel (:data:`PP_SKEW`: JAX's PP step differentiates its first tap
  otherwise than its one-device step does), and so not the clip's norm;
  and at data 2 x pipe 2 without the balance term against JAX's one-device
  step on every leaf and the clip's norm (rel 1e-5).

Port against port: a fit at data 2 x pipe 2 with dropout 0.1 and
stochastic depth (finite, moving losses; the coins and dropout seeds the
same on every pipe rank of a data index; the replicated leaves bit for bit
the same on every rank after each step); each stage launches kernels 1-4
(their plain forms on the CPU) for its own blocks alone; a save at pipe 2
by ``tools/train.py --pipeline_parallel 2 --pp_microbatches 2`` (two
processes) resumes in one process, and a one-process save resumes at pipe
2; ``pp_stage_memory_report`` equals the rank's held bytes; the layout
errors of ``check_mesh`` and ``GenerationPipeline`` with JAX's numbers.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from motiondiffusion_moe_tpu.diffusion import (
    ddim_sample_loop as jax_ddim_loop,
    make_schedule as jax_schedule,
    respace_schedule as jax_respace,
    space_timesteps as jax_space,
)
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu.parallel import (
    make_mesh as jax_make_mesh,
    make_sharded_train_step,
    param_shardings,
    shard_batch,
)
from motiondiffusion_moe_tpu.parallel import pipeline_parallel as JPP
from motiondiffusion_moe_tpu.training.train_state import (
    TrainState as JaxTrainState,
    make_optimizer,
    make_train_step,
)
from motiondiffusion_moe_tpu_torch.config import ParallelConfig
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.models.transformer import (
    MotionTransformer,
)
from motiondiffusion_moe_tpu_torch.parallel import pipeline_parallel as PPL
from motiondiffusion_moe_tpu_torch.parallel.mesh import (
    Cut,
    contract_stages,
    expand_stages,
)
from motiondiffusion_moe_tpu_torch.tools import train as train_cli
from motiondiffusion_moe_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from motiondiffusion_moe_tpu_torch.training.train_state import (
    create_train_state,
)
from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

from tests._torch_parity import random_params, tiny_config, to_port
from tests.test_torch_parallel import TINY_CLI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, F = 8, 16, 26
LR = 2e-4
LENGTHS = [16, 12, 9, 16, 5, 16, 14, 8]
WORDS = ["a person walks", "", "turn left twice", "jump", "wave",
         "sit down", "", "run in a circle"]
PROMPTS = ["a person walks", "turn left", "jump", "wave"]
MB = len(PROMPTS)
STEPS_DDIM = 10
TOY = {(2, 2): "s2m2", (2, 4): "s2m4", (4, 4): "s4m4"}  # (S, M): prefix
# the port's train steps: name -> (layout (dp, ep, tp, sp, pp), M, the
# JAX reference, ZeRO-1)
STEPS = {"dp2_pp2": ((2, 1, 1, 1, 2), 2, "dp2", False),
         "pp2": ((1, 1, 1, 1, 2), 4, "dp2", False),
         "dp2_pp2_zero1": ((2, 1, 1, 1, 2), 2, "dp2", True),
         "dp2_pp2_no_aux": ((2, 1, 1, 1, 2), 2, "one", False)}
# the JAX references: name -> (devices of the pipe mesh, or None for the
# one-device step without the ring, M, the MoE balance weight); pipe 2
# alone at M = 4 takes the same four chunks of two rows as data 2 x pipe 2
# at M = 2, so the same step: one compile for both
REFS = {"dp2": (4, 2, 0.1), "one": (None, 2, 0.0)}
# JAX's PP step differentiates the up-sampling kernel's first tap
# otherwise than its one-device step does (the two 1.4x its norm apart; the
# second tap and the bias alike, as is every other leaf); the port's ring
# gives the one-device gradient of it (the case without the balance term,
# held to the one-device step)
PP_SKEW = {"upsample.weight"}
FIT = {"model": {"dropout": 0.1, "stochastic_depth_min": 0.8},
       "train": {"batch_size": 4, "num_epochs": 1, "uncond_step": True}}
ERRORS = [  # name, layout, config fields, the words of the error
    ("builds", (2, 1, 1, 1, 2), {}, "no error"),
    ("layers", (2, 1, 1, 1, 2), {"model": {"num_layers": 3}},
     "num_layers=3 must be divisible by the 'pipe' mesh axis (2)"),
    ("rows", (2, 1, 1, 1, 2), {"train": {"batch_size": 6}},
     "global batch (6) must split into pipeline_microbatches=2 "
     "microbatches whose size divides the 'data' mesh axis (2)"),
    ("microbatches", (2, 1, 1, 1, 2),
     {"model": {"pipeline_microbatches": 3}},
     "global batch (8) must split into pipeline_microbatches=3"),
    ("accumulated", (2, 1, 1, 1, 2), {"train": {"grad_accum_steps": 4}},
     "global batch (2) must split into pipeline_microbatches=2"),
    ("with_expert", (1, 2, 1, 1, 2), {},
     "composes with 'data' only; mesh has expert=2"),
    ("with_model", (1, 1, 2, 1, 2), {},
     "composes with 'data' only; mesh has model=2"),
    ("with_seq", (1, 1, 1, 2, 2), {},
     "composes with 'data' only; mesh has seq=2"),
    ("dispatch", (2, 1, 1, 1, 2), {"model": {"moe_compute": "dispatch"}},
     "moe_compute='dispatch' (the all-to-all) cannot nest inside the "
     "pipeline ring"),
    ("world", (1, 1, 1, 1, 3), {}, "launch a multiple of 3 processes")]


def _config(**model):
    model = {"pipeline_microbatches": 2, "moe_aux_loss_weight": 0.1,
             **model}
    cfg = tiny_config(num_layers=2, moe_compute="dense", scan_blocks=True,
                      **model)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=B, lr=LR, ema_decay=0.9, grad_clip_norm=1e6,
        uncond_step=False))


def _port(cfg):
    """The port's config: the same, without JAX's stacked layout."""
    return to_port(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, scan_blocks=False)))


def _arrays():
    rng = np.random.default_rng(24)
    a = {"b_motion": rng.standard_normal((B, T, F)).astype(np.float32),
         "b_length": np.asarray(LENGTHS, np.int64),
         "b_text_ids": hash_tokenize(WORDS, 12).astype(np.int64),
         "b_t": rng.integers(0, 50, B).astype(np.int64),
         "b_t_weight": rng.uniform(0.5, 2.0, B).astype(np.float32),
         "ids_c": hash_tokenize(PROMPTS, 12),
         "ids_u": hash_tokenize([""] * MB, 12),
         "lengths": np.asarray([16, 11, 6, 16], np.int64),
         "noise": rng.standard_normal((MB, T, F)).astype(np.float32)}
    a["f_x"], a["f_t"] = a["b_motion"], a["b_t"]
    a["f_length"], a["f_ids"] = a["b_length"], a["b_text_ids"]
    for (S, M), pre in TOY.items():
        a[f"{pre}_w"] = rng.standard_normal((4, 16, 16)).astype(
            np.float32) / 4
        a[f"{pre}_x"] = rng.standard_normal((8, 16)).astype(np.float32)
    a["ctx_w"] = np.zeros((2, 4, 4), np.float32)
    a["ctx_x"] = np.tile(np.arange(4, dtype=np.float32).repeat(2)[:, None],
                         (1, 4))
    return a


# ------------------------------------------------------------ JAX references

def _jax_toy(S, M, w, x, context=False):
    """JAX's ``gpipe`` of the toy stage on ``make_mesh(S,
    pipeline_parallel=S)``: (output, gradient of sum(out^2))."""
    mesh = jax_make_mesh(S, pipeline_parallel=S)

    def stage_fn(w_local, ring, ctx, xs, m):
        if context:
            return dict(ring, h=ring["h"] + ctx["c"]), jnp.zeros(())
        h, _ = jax.lax.scan(lambda c, wl: (jnp.tanh(c @ wl), None),
                            ring["h"], w_local)
        return dict(ring, h=h), jnp.zeros(())

    ctx = {"c": jnp.asarray(x)} if context else {}

    def loss(w):
        out, _ = JPP.gpipe(stage_fn, w, {"h": jnp.asarray(x)}, ctx, mesh, M)
        return jnp.sum(out["h"] ** 2), out["h"]

    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(w))
    return np.asarray(out), np.asarray(grad)


def _jax_noise(a, key):
    return np.asarray(jax.random.normal(jax.random.split(key, 3)[0],
                                        a["b_motion"].shape, jnp.float32))


def _jax_pp_step(cfg, params, a, key, mesh):
    """JAX's ``make_sharded_train_step`` update on the pipe mesh, traced
    and lowered here: a function that compiles and runs it (new params,
    Adam's first moment, both as state dicts, and the metrics)."""
    model = JaxMotionTransformer(cfg.model, mesh=mesh)
    sched = jax_schedule(schedule_name=cfg.diffusion.beta_schedule,
                         num_timesteps=cfg.diffusion.num_timesteps)
    raw = make_train_step(model, sched, cfg, jit=False)
    if mesh is None:  # the one-device step, the ring's stacked scan
        mesh = jax_make_mesh(1)
    tx = make_optimizer(cfg)
    p = {"params": params}
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=p,
                          opt_state=tx.init(p), tx=tx,
                          ema_params={"params": params})
    batch = {k: np.asarray(a[f"b_{k}"]).astype(
        np.int32 if k in ("length", "text_ids", "t") else np.float32)
        for k in ("motion", "length", "text_ids", "t", "t_weight")}
    with mesh:
        step, sstate = make_sharded_train_step(raw, state, mesh)
        sbatch = shard_batch(batch, mesh)
        lowered = step.lower(sstate, sbatch, key)

    def finish():
        with mesh:
            new, metrics = lowered.compile()(sstate, sbatch, key)
        new = jax.device_get(new)
        return (jax_to_state_dict(new.params["params"]),
                jax_to_state_dict(new.opt_state[1][0].mu["params"]),
                {k: float(v) for k, v in metrics.items()
                 if np.ndim(v) == 0})
    return finish


def _jax_forward(cfg, params, a):
    mesh = jax_make_mesh(4, pipeline_parallel=2)
    model = JaxMotionTransformer(cfg.model, mesh=mesh)
    with mesh:
        lowered = jax.jit(lambda p: model.apply(
            {"params": p}, jnp.asarray(a["f_x"]), jnp.asarray(a["f_t"]),
            jnp.asarray(a["f_length"], jnp.int32),
            text_ids=jnp.asarray(a["f_ids"], jnp.int32),
            mutable=["moe_losses", "moe_metrics"])[0]).lower(params)
    return lambda: np.asarray(lowered.compile()(params))


def _jax_sample(cfg, params, a):
    """JAX's sampler as ``GenerationPipeline._sample_fn`` builds it on the
    ``(data 2, pipe 2)`` mesh (the model built with the mesh, the params
    placed by ``param_shardings``), the noise injected."""
    mesh = jax_make_mesh(4, pipeline_parallel=2)
    model = JaxMotionTransformer(cfg.model, mesh=mesh)
    d = cfg.diffusion
    base = jax_schedule(schedule_name=d.beta_schedule,
                        num_timesteps=d.num_timesteps)
    sched, tmap = jax_respace(np.asarray(base.betas, np.float64),
                              jax_space(d.num_timesteps,
                                        f"ddim{STEPS_DDIM}"))
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
    shard = param_shardings(variables, mesh)
    batch = NamedSharding(mesh, P("data"))
    with mesh:
        lowered = jax.jit(fn, in_shardings=(
            shard, batch, NamedSharding(mesh, P())),
            out_shardings=batch).lower(
                jax.device_put(variables, shard),
                jax.device_put(jnp.asarray(a["noise"]), batch),
                jax.random.key(3))
    return lambda: np.asarray(lowered.compile()(
        jax.device_put(variables, shard),
        jax.device_put(jnp.asarray(a["noise"]), batch), jax.random.key(3)))


# ------------------------------------------------------------ the ranks

def _spawn(argvs):
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv in argvs]


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


def _one_process_save(pcfg, sd, path):
    """A one-process state with moments and a generator state, saved for
    the resume at pipe 2."""
    model = MotionTransformer(pcfg.model)
    model.load_state_dict(sd)
    state = create_train_state(model, pcfg)
    with torch.no_grad():
        for m, p in zip(state.optimizer.mu, state.optimizer.params):
            m.copy_(0.01 * p)
        for e, p in zip(state.ema.params, model.parameters()):
            e.copy_(0.5 * p)
    state.step = 3
    gen = torch.Generator().manual_seed(78)
    torch.randn(5, generator=gen)
    CheckpointManager(path, cfg=pcfg).save(state.step, state, 0, gen)
    return gen.get_state()


def _cli_base(root):
    return TINY_CLI + ["--num_layers", "2", "--checkpoint_dir",
                       str(root / "cli")]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks and the CLI's two processes started, the JAX references
    computed meanwhile, then every result."""
    root = tmp_path_factory.mktemp("pipe")
    cfg = _config()
    a = _arrays()
    params = random_params(JaxMotionTransformer(cfg.model),
                           a["b_motion"], a["b_t"], a["b_length"],
                           text_ids=a["b_text_ids"])
    # the head 50x smaller: the 10-step DDIM samples then stay within +-40,
    # where an f32 ulp is 4e-6 (guidance 7.5 scales the denoiser's
    # differences between the two packages' summation orders)
    params["out"] = {k: 0.02 * v for k, v in params["out"].items()}
    sd = jax_to_state_dict(params)
    torch.save(sd, root / "weights.pt")
    pcfg = _port(cfg)
    saved_rng = _one_process_save(pcfg, sd, str(root / "one_process"))
    noise = _jax_noise(a, jax.random.key(9))
    a["b_noise"] = noise
    np.savez(root / "inputs.npz", **a)
    steps = [dict(name=name, kind="train_step", layout=layout, prefix="b",
                  zero1=zero1, model={"pipeline_microbatches": M,
                                      "moe_aux_loss_weight": REFS[ref][2]},
                  save=str(root / name) if name == "pp2" else None)
             for name, (layout, M, ref, zero1) in STEPS.items()]
    four = [dict(name=f"toy_{pre}", kind="pipe_gpipe", S=S, M=M, prefix=pre)
            for (S, M), pre in TOY.items()]
    four += [dict(name="toy_context", kind="pipe_gpipe", S=2, M=4,
                  prefix="ctx", context=True),
             dict(name="forward", kind="pipe_forward",
                  layout=(2, 1, 1, 1, 2), prefix="f"),
             dict(name="sample", kind="sample", layout=(2, 1, 1, 1, 2),
                  steps=STEPS_DDIM),
             *[c for c in steps if c["layout"][0] == 2],
             dict(name="fit", kind="pipe_fit", layout=(2, 1, 1, 1, 2),
                  **FIT),
             dict(name="memory", kind="pipe_memory", layout=(2, 1, 1, 1, 2),
                  train={"ema_decay": 0.9}),
             dict(name="units", kind="train_units", layout=(2, 1, 1, 1, 2),
                  checks=[(n, lay, f) for n, lay, f, _ in ERRORS])]
    two = [c for c in steps if c["layout"][0] == 1]
    two += [dict(name="resume", kind="train_resume", layout=(1, 1, 1, 1, 2),
                 path=str(root / "one_process"))]
    spec = {"train_cfg": pcfg.to_dict(), "cfg": pcfg.to_dict(),
            "weights": {"train": str(root / "weights.pt"),
                        "moe": str(root / "weights.pt")},
            "inputs": str(root / "inputs.npz"), "steps": STEPS_DDIM,
            "micro_batch": MB,
            "fit": [(WORDS[:4], a["b_motion"][:4].tolist(), LENGTHS[:4])],
            "out": str(root)}
    argvs = []
    for tag, world, cases in (("four", 4, four), ("two", 2, two)):
        path = root / f"job_{tag}.json"
        path.write_text(json.dumps(dict(
            spec, init=f"file://{root / f'rdv_{tag}'}", world=world,
            cases=cases)))
        argvs += [["-m", "tests._torch_mesh_worker", str(path), str(r)]
                  for r in range(world)]
    argvs += [["-m", "motiondiffusion_moe_tpu_torch.tools.train",
               *_cli_base(root), "--coordinator_address",
               f"file://{root / 'rdv_cli'}", "--num_processes", "2",
               "--process_id", str(r), "--pipeline_parallel", "2",
               "--pp_microbatches", "2"] for r in range(2)]
    procs = _spawn(argvs)

    with ThreadPoolExecutor(4) as pool:
        refs = {ref: pool.submit(_jax_pp_step(
            _config(pipeline_microbatches=M, moe_aux_loss_weight=w), params,
            a, jax.random.key(9),
            n and jax_make_mesh(n, pipeline_parallel=2)))
            for ref, (n, M, w) in REFS.items()}
        fwd = pool.submit(_jax_forward(cfg, params, a))
        smp = pool.submit(_jax_sample(cfg, params, a))
        toys = {pre: _jax_toy(S, M, a[f"{pre}_w"], a[f"{pre}_x"])
                for (S, M), pre in TOY.items()}
        toys["ctx"] = _jax_toy(2, 4, a["ctx_w"], a["ctx_x"], context=True)
        refs = {k: f.result() for k, f in refs.items()}
        fwd, smp = fwd.result(), smp.result()

    outs = _wait(procs)
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    got = {c["name"]: torch.load(root / f"{c['name']}.pt",
                                 weights_only=False) for c in four + two}
    return dict(cfg=cfg, pcfg=pcfg, sd=sd, a=a, got=got, refs=refs,
                toys=toys, fwd=fwd, smp=smp, root=root,
                saved_rng=saved_rng, cli=[o for _, o in outs[6:]])


# ------------------------------------------------------------ the schedule

@pytest.mark.parametrize("S,M", sorted(TOY))
def test_ring_matches_jax_gpipe(run, S, M):
    pre = TOY[(S, M)]
    out, grad = run["toys"][pre]
    got = run["got"][f"toy_{pre}"]
    np.testing.assert_allclose(got["out"].numpy(), out, atol=1e-6)
    k = 4 // S
    for d, p, g in got["grads"]:
        np.testing.assert_allclose(g.numpy(), grad[p * k:(p + 1) * k],
                                   atol=1e-5)
    assert sorted((d, p) for d, p, _ in got["grads"]) == sorted(
        (d, p) for d in range(4 // S) for p in range(S))


def test_context_is_read_per_microbatch_not_circulated(run):
    got = run["got"]["toy_context"]["out"].numpy()
    x = run["a"]["ctx_x"]
    np.testing.assert_array_equal(got, x * 3)
    np.testing.assert_array_equal(got, run["toys"]["ctx"][0])


# ------------------------------------------------------------ forward, sampling

def test_forward_at_data2_pipe2_matches_jax(run):
    np.testing.assert_allclose(run["got"]["forward"]["out"].numpy(),
                               run["fwd"], atol=2e-5, rtol=1e-5)


def test_a_pipe_rank_holds_only_its_stage(run):
    """Rank d * 2 + p holds blocks p of each scale (1 a stage at 2 a
    scale) and every replicated leaf."""
    held = run["got"]["forward"]["held"]
    every = list(run["sd"])
    for r, names in enumerate(held):
        p = r % 2
        blocks = {n.split(".")[1] for n in names
                  if n.startswith(("blocks_low.", "blocks_high."))}
        assert blocks == {str(p)}, (r, blocks)
        assert {n for n in every if not n.startswith("blocks_")} <= set(
            names)


def test_generation_pipeline_at_data2_pipe2_matches_jax(run):
    got = run["got"]["sample"]["out"].numpy()
    np.testing.assert_allclose(got, run["smp"], atol=2e-4)


# ------------------------------------------------------------ train steps

def _assert_params(got, want, mu, steps=1, what="params"):
    """Every updated parameter within atol 1e-5 of ``want``, but where the
    reference's first moment ``mu`` is within 1e-4 of its leaf's largest
    entry plus 1e-8 (see the module doc): there within 2 lr a step."""
    for n, v in want.items():
        err = (got[n].cpu().float() - v.float()).abs()
        m = mu.get(n)
        small = (torch.zeros_like(err, dtype=torch.bool) if m is None
                 else m.abs() <= 1e-4 * m.abs().max() + 1e-8)
        assert float(torch.where(small, 0, err).max()) <= 1e-5, (what, n)
        assert float(err.max()) <= 2 * steps * LR, (what, n)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_pipe_step_matches_jax(run, name):
    """Against JAX's PP step, but for :data:`PP_SKEW`, and the case without
    the balance term against JAX's one-device step, every leaf and the
    clip's norm (the norm of the whole gradient)."""
    ref = STEPS[name][2]
    new, mu, metrics = run["refs"][ref]
    got = run["got"][name]
    skip = PP_SKEW if ref != "one" else set()
    keys = ("loss_total", "loss_moe") + (("grad_norm",) if not skip else ())
    assert (metrics["loss_moe"] > 0) == (ref != "one")
    for key in keys:
        np.testing.assert_allclose(got["metrics"][key], metrics[key],
                                   rtol=1e-5, err_msg=key)
    assert set(got["params"]) == set(new)
    _assert_params(got["params"], {n: v for n, v in new.items()
                                   if n not in skip}, mu)
    for n, m in got["mu"].items():
        if n in skip:
            continue
        tol = 1e-4 * float(mu[n].abs().max()) + 1e-8
        assert float((m.cpu() - mu[n]).abs().max()) <= tol, ("mu", n)


def test_each_stage_launches_the_kernels_of_its_blocks_alone(run):
    """Kernels 1 and 3 (the whole ones, by their plain forms here): 2
    Performers a block, 1 block a stage a scale, 2 scales, once a
    microbatch each way (on the CPU kernel 3's plain form runs kernel 1's
    again inside it)."""
    for name, (_, M, _, _) in STEPS.items():
        for calls in run["got"][name]["calls"]:
            assert calls["favor_qkv_bwd"] == 4 * M, (name, calls)
            assert calls["favor_qkv_plain"] == 2 * 4 * M, (name, calls)
            assert calls["favor_qkv_moments"] == 0, (name, calls)


# ------------------------------------------------------------ port against port

def test_fit_with_dropout_and_stochastic_depth(run):
    got = run["got"]["fit"]
    steps = got["steps"]
    losses = [loss for loss, _ in steps[0]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[0] != losses[1]
    for s in range(len(losses)):  # the replicated leaves, every rank
        assert len({rank[s][1] for rank in steps}) == 1, s


def test_the_pipe_ranks_draw_the_same_coins_and_seeds(run):
    got = run["got"]["fit"]
    draws, where = got["draws"], got["mesh"]
    for r, (d, p) in enumerate(where):
        assert draws[r] == draws[where.index((d, 0))], r
        coins, seeds = draws[r][0]
        assert len(coins) == 2 and len(coins[0]) == 2
        assert len(seeds) == 2 and len(seeds[0][0]) == 2
    # the two data ranks' generators differ
    assert draws[where.index((0, 0))] != draws[where.index((1, 0))]


def test_the_stage_memory_report_is_the_held_bytes(run):
    got = run["got"]["memory"]
    held, report = got["held"], got["report"]
    assert len(set(held)) == 1, held
    assert report["stage_state_bytes"] == held[0]
    assert report["stage_state_bytes"] < report["single_device_state_bytes"]


def test_a_pipe_2_save_resumes_in_one_process(run):
    """The train CLI as two processes at pipe 2 (4 steps: 2 batches and
    their unconditional steps), then the one-process CLI resumes it."""
    first, second = run["cli"]
    assert "loss_total" in first and "loss_total" not in second
    run_dir = os.path.join(run["root"], "cli", "t2m_moe_small")
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    assert ckpt.all_steps() == [4]
    payload = ckpt.read()
    assert len(payload["rng"]) == 1  # one row-holder
    assert {n.split(".")[1] for n in payload["params"]
            if n.startswith("blocks_high.")} == {"0", "1"}
    state = train_cli.main(_cli_base(run["root"]))
    for a, b in zip(state.model.state_dict().values(),
                    payload["params"].values()):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(state.optimizer.state_dict()[k],
                        payload["opt_state"][k]):
            assert torch.equal(a, b)


def test_a_one_process_save_resumes_at_pipe_2(run):
    got = run["got"]["resume"]
    assert got["held"] == [(True, 3, 0)] * 2
    for state in got["rng"]:
        assert torch.equal(state, run["saved_rng"])


def test_a_pipe_2_step_save_reads_back_whole(run):
    """The pp2 step's save: the global layout, every block of both stages,
    the moments in the one-process order."""
    path = str(run["root"] / "pp2")
    payload = CheckpointManager(path, cfg=run["pcfg"]).read()
    got = run["got"]["pp2"]
    model = MotionTransformer(run["pcfg"].model)
    assert list(payload["params"]) == list(model.state_dict())
    for n, v in payload["params"].items():
        assert torch.equal(v, got["params"][n].cpu()), n
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    for n, m in zip(names, payload["opt_state"]["mu"]):
        assert torch.equal(m, got["mu"][n].cpu()), n


# ------------------------------------------------------------ errors, units

@pytest.mark.parametrize("name,words", [(n, w) for n, _, _, w in ERRORS])
def test_pipe_layout_errors(run, name, words):
    assert words in run["got"]["units"][name], run["got"]["units"][name]


@pytest.mark.parametrize("pp,dp,L,batch,M", [
    (2, 2, 3, 8, 2), (2, 2, 4, 6, 2), (2, 2, 4, 8, 3), (4, 1, 4, 8, 0),
    (2, 1, 2, 4, 0)])
def test_validate_pp_layout_raises_as_jax_does(pp, dp, L, batch, M):
    mesh = jax_make_mesh(pp * dp, pipeline_parallel=pp)

    def message(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    want = message(lambda: JPP.validate_pp_layout(
        mesh, L, batch, M, batch_desc="CFG-doubled micro_batch"))
    got = message(lambda: PPL.validate_pp_layout(
        pp, dp, L, batch, M, batch_desc="CFG-doubled micro_batch"))
    if want is None:
        assert got is None
    else:  # the same numbers; the reason of L % S speaks of the layout
        assert got.split(" — ")[0] == want.split(" — ")[0]
    assert PPL.pp_num_microbatches(M, pp) == JPP.pp_num_microbatches(M, pp)


def test_generation_pipeline_checks_the_cfg_doubled_micro_batch():
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    class _Pipe:  # the mesh's degrees, no process group needed
        dp, sp, pp, ep, tp = 2, 1, 2, 1, 1

    cfg = _port(_config(pipeline_microbatches=16))
    with pytest.raises(ValueError, match="CFG-doubled micro_batch"):
        GenerationPipeline(cfg, params={}, micro_batch=4, device="cpu",
                           mesh=_Pipe())


def test_rank_of_is_jax_device_order_with_a_pipe_axis():
    """Rank d * PP + p is the device JAX puts at (data d, pipe p)."""
    from types import SimpleNamespace

    from motiondiffusion_moe_tpu_torch.parallel.mesh import ExpertMesh

    for n, pp in ((4, 2), (8, 4), (8, 2)):
        mesh = jax_make_mesh(n, pipeline_parallel=pp)
        assert mesh.axis_names == ("data", "pipe", "expert", "model")
        ns = SimpleNamespace(sp=1, pp=pp, ep=1, tp=1)
        for (d, p, e, m), device in np.ndenumerate(mesh.devices):
            assert ExpertMesh.rank_of(ns, d, e, m, 0, p) == device.id


def test_expand_and_contract_the_stage_leaves():
    cuts = [Cut(), Cut(stage=1), Cut(stage=1), Cut(stage=2), Cut()]
    held = ["a", "l0x", "l0y", "h0x", "z"]
    stages = {0: ["l0x", "l0y", "h0x"], 1: ["l1x", "l1y", "h1x"]}
    whole = expand_stages(held, cuts, stages)
    assert whole == ["a", "l0x", "l0y", "l1x", "l1y", "h0x", "h1x", "z"]
    assert contract_stages(whole, cuts, 2, 1) == [
        "a", "l1x", "l1y", "h1x", "z"]
    assert PPL.stage_name("blocks_low.1.ffn.w1", 2) == "blocks_low.3.ffn.w1"


def test_the_memory_report_counts_as_jax_does():
    """On the tiny model: the block and replicated bytes
    of the port's named leaves equal JAX's on its stacked tree, and so do
    the inference state and the ring bytes."""
    cfg = _config()
    a = _arrays()
    shapes = jax.eval_shape(lambda: JaxMotionTransformer(cfg.model).init(
        jax.random.key(0), a["b_motion"], a["b_t"], a["b_length"],
        text_ids=a["b_text_ids"]))
    kw = dict(batch=8, num_microbatches=4, max_frames=T, latent_dim=64,
              hbm_bytes=1 << 20)
    # the parameters alone (JAX's init output carries the sown values too)
    want = JPP.pp_stage_memory_report({"params": shapes["params"]}, 2,
                                      train=False, **kw)
    with torch.device("meta"):
        model = MotionTransformer(_port(cfg).model)
    got = PPL.pp_stage_memory_report(list(model.named_parameters()), 2,
                                     train=False, **kw)
    for key in ("param_bytes_total", "param_bytes_blocks",
                "param_bytes_replicated", "stage_state_bytes",
                "single_device_state_bytes", "min_stages_to_fit",
                "ring_bytes_per_tick", "ring_bytes_backward"):
        assert got[key] == want[key], key
    assert "PP-2 stage memory" in PPL.format_pp_memory_report(got)
    if not torch.cuda.is_available():  # no card to size for: say so
        with pytest.raises(ValueError, match="give hbm_bytes"):
            PPL.pp_stage_memory_report(list(model.named_parameters()), 2)


def test_pipe_2_in_one_process_is_a_mismatch():
    cfg = to_port(tiny_config())
    with pytest.raises(ValueError, match="1 process"):
        Trainer(dataclasses.replace(
            cfg, parallel=ParallelConfig(num_pipeline_stages=2)),
            device="cpu")


def test_scan_blocks_raises_and_says_pipe_needs_none():
    with pytest.raises(NotImplementedError, match="needs no --scan_blocks"):
        train_cli.main(["--dataset", "synthetic", "--device", "cpu",
                        "--pipeline_parallel", "2", "--scan_blocks"])
