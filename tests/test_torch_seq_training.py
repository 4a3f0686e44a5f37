"""Training over the seq axis (``ParallelConfig.num_seq_partitions``, JAX's
``(data, seq, expert, model)`` mesh), on the CPU.

Each seq rank trains on its frames of its row-holder's rows
(``parallel/mesh.py::ExpertMesh.frames``); the Performers close kv and its
gradient g_kv over the seq ranks (kernel 3's backward in three steps,
``ops/performer.py::favor_qkv_split``); the losses, the MoE balance and
the metrics count each token once.

- Kernel 3's plain split in one process: the kv step on 2 and 4 cuts of T
  (odd T, masks that end inside a cut), their kv summed, the q step, their
  g_kv summed, the k step give d(qkv) per frame and, summed, d(ln_scale),
  d(ln_bias), d(proj) within 1e-6 relative of ``favor_qkv_bwd_plain`` on
  the whole T; on one rank the autograd Function is ``favor_qkv``.
- Four gloo ranks (``tests/_torch_mesh_worker.py``'s ``train_*`` kinds,
  one set of processes for every case, started before the JAX references)
  take one update of the port's ``TrainStep`` from the weights of a seeded
  flax tree (through ``models/bridge.py``) against JAX's one-device
  ``make_train_step`` (``jax.jit(raw)(state, batch, key)``; the port gets
  the noise JAX draws from the key). Two JAX references, one compile each
  (on a thread, while the next is traced):
  T = 14 with all four losses on x0 (velocity, acceleration, progressive,
  structure through ``recover_from_ric``; normalizer stats given) and two
  accumulated microbatches, for seq 2 x expert 2 and data 2 x seq 2 (the
  batch's rows laid out so that each row-holder's microbatches are JAX's
  chunks), seq 4 (cut 4 / 4 / 4 / 2) and seq 2 x model 2 with ZeRO-1,
  all computing ``dense``; T = 15 (the last rank's share odd) for seq 2 x
  expert 2 computing ``dispatch`` at capacity factor 1, against the JAX
  model on its expert mesh, whose per-chunk capacity drops tokens. All
  with lengths below T that end inside other ranks' frames, the MoE
  balance term and the EMA on, and no clip (``grad_clip_norm`` 1e6, so
  that Adam's first moment is 0.1 g).
  Tolerances (JAX's ``test_train_step_matches_single_device``): the loss
  within rel 1e-5, every updated parameter within atol 1e-5, except where
  JAX's gradient is zero up to rounding (within 1e-4 of its leaf's largest
  entry, the gradient tolerance of ``tests/test_torch_train_step.py``: the
  key biases of a softmax over keys, experts that few tokens reach): two
  summation orders may give it either sign, and Adam's first step moves
  such an entry by up to lr either way, so it is held within 2 lr. Beside
  them, what a wrong factor of sp in the gradient would move (Adam's first
  step does not see a scale): the clip's norm rtol 1e-5 and the first
  moment (0.1 g) within 1e-4 of each leaf's largest entry.
- Port against port (JAX's draws cannot be matched): ``Trainer.fit`` at
  seq 2 x model 2, dropout 0.1, stochastic depth and a loss-aware sampler,
  one batch and its unconditional second step, against the one-process
  fit: the parameters within atol 1e-5 (4 lr where the one-process first
  moment is within 1e-4 of its leaf's largest entry), and
  every rank's sampler state the same as the one-process one.
- A data 2 x seq 2 save holds one generator state per row-holder in row
  order and restores in one process; a one-process save resumes at seq 2 x
  model 2 with its generator state on every rank; ``tools/train.py
  --seq_parallel 2`` as two processes takes two steps (loss finite and
  moving, JAX's ``test_seq_only_mesh_two_steps``).
- The errors: fewer than 2 frames a seq rank, a microbatch that the data
  ranks do not divide, a world that seq x expert x model does not divide,
  the pipe axis beside the seq axis or in one process.
"""

import contextlib
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

from motiondiffusion_moe_tpu.diffusion import make_schedule as jax_schedule
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu.parallel import make_mesh as jax_make_mesh
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
from motiondiffusion_moe_tpu_torch.ops import performer as PF
from motiondiffusion_moe_tpu_torch.parallel.mesh import generation_mesh
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
from tests.test_torch_seq_parallel import _rel, _split_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4
B, F = 8, 26
LR = 2e-4
SPLIT_REL = 1e-6
LOSSES = {"w_velocity": 0.5, "w_acceleration": 0.3, "w_progressive": 0.2,
          "w_structure": 0.4}
BATCHES = {  # prefix: (T, lengths)
    "t14": (14, [13, 12, 5, 2, 11, 9, 7, 3]),
    "t15": (15, [15, 9, 4, 1, 12, 8, 14, 6])}
WORDS = ["a person walks", "", "turn left twice", "jump", "wave",
         "sit down", "", "run in a circle"]
# the JAX references: (batch, config fields, on the expert mesh); the
# longer compile first
REFS = {"dispatch": ("t15", {"model": {"moe_compute": "dispatch"}}, True),
        "main": ("t14", {"train": {**LOSSES, "grad_accum_steps": 2}},
                 False)}
STEPS = {  # name: (layout (dp, ep, tp, sp), JAX reference, ZeRO-1)
    "sp2_ep2_dense": ((1, 2, 1, 2), "main", False),
    "dp2_sp2": ((2, 1, 1, 2), "main", False),
    "sp4_t14": ((1, 1, 1, 4), "main", False),
    "sp2_tp2_zero1": ((1, 1, 2, 2), "main", True),
    "sp2_ep2_dispatch": ((1, 2, 1, 2), "dispatch", False)}
FIT = {"model": {"dropout": 0.1, "stochastic_depth_min": 0.8,
                 "num_layers": 2},
       "diffusion": {"schedule_sampler": "loss-second-moment"},
       "train": {"batch_size": 4, "num_epochs": 1}}


def _config():
    cfg = tiny_config(num_layers=1, moe_aux_loss_weight=0.1,
                      moe_compute="dense", moe_capacity_factor=1.0)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.9, grad_clip_norm=1e6))


def _with(cfg, fields):
    return dataclasses.replace(cfg, **{
        part: dataclasses.replace(getattr(cfg, part), **kw)
        for part, kw in fields.items() if part in ("model", "train")})


def _arrays():
    rng = np.random.default_rng(23)
    a = {"norm_mean": 0.1 * rng.standard_normal(F).astype(np.float32),
         "norm_std": (1 + 0.1 * rng.standard_normal(F)).astype(np.float32)}
    for pre, (T, lengths) in BATCHES.items():
        a[f"{pre}_motion"] = rng.standard_normal((B, T, F)).astype(
            np.float32)
        a[f"{pre}_length"] = np.asarray(lengths, np.int64)
        a[f"{pre}_text_ids"] = hash_tokenize(WORDS, 12).astype(np.int64)
        # t below 50: the x0 losses' sqrt(1 / abar) stays small
        a[f"{pre}_t"] = rng.integers(0, 50, B).astype(np.int64)
        a[f"{pre}_t_weight"] = rng.uniform(0.5, 2.0, B).astype(np.float32)
    return a


REF_KEYS = {"main": 7, "dispatch": 8}


def _jax_noise(cfg, a, prefix, key):
    """The noise ``make_train_step``'s ``loss_fn`` draws from ``key`` (one
    key a microbatch under accumulation), in batch order."""
    shape = a[f"{prefix}_motion"].shape
    A = max(1, cfg.train.grad_accum_steps)
    keys = jax.random.split(key, A) if A > 1 else [key]
    chunk = (shape[0] // A,) + shape[1:]
    return np.concatenate([np.asarray(jax.random.normal(
        jax.random.split(k, 3)[0], chunk, jnp.float32)) for k in keys])


def _holder_order(holders, accum):
    """The batch's rows in the order that gives row-holder q (a contiguous
    block of ``B / holders`` rows, cut into ``accum`` microbatches) JAX's
    chunk q of each microbatch (``accum`` contiguous blocks of the batch,
    each cut over the row-holders)."""
    rows = np.arange(B).reshape(accum, holders, -1)
    return rows.transpose(1, 0, 2).reshape(-1)


def _jax_step(cfg, params, a, prefix, key, mesh=None):
    """One JAX ``make_train_step`` update, traced and lowered here: a
    function that compiles and runs it and returns (new params as a state
    dict, Adam's first moment as one, the metrics). XLA's compile holds no
    lock, so the fixture runs it on a thread while it traces the next
    reference."""
    model = JaxMotionTransformer(cfg.model, mesh=mesh)
    sched = jax_schedule(schedule_name=cfg.diffusion.beta_schedule,
                         num_timesteps=cfg.diffusion.num_timesteps)
    stats = ((a["norm_mean"], a["norm_std"]) if cfg.train.w_structure > 0
             else None)
    raw = make_train_step(model, sched, cfg, normalizer_stats=stats,
                          jit=False)
    tx = make_optimizer(cfg)
    p = {"params": params}
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=p,
                          opt_state=tx.init(p), tx=tx,
                          ema_params={"params": params})
    batch = {k: jnp.asarray(a[f"{prefix}_{k}"].astype(
        np.int32 if k in ("length", "text_ids", "t") else np.float32))
        for k in ("motion", "length", "text_ids", "t", "t_weight")}
    A = max(1, cfg.train.grad_accum_steps)
    if A > 1:
        batch = {k: v.reshape((A, v.shape[0] // A) + v.shape[1:])
                 for k, v in batch.items()}
    with mesh or contextlib.nullcontext():
        lowered = jax.jit(raw).lower(state, batch, key)

    def finish():
        new, metrics = lowered.compile()(state, batch, key)
        new = jax.device_get(new)
        return (jax_to_state_dict(new.params["params"]),
                jax_to_state_dict(new.opt_state[1][0].mu["params"]),
                {k: float(v) for k, v in metrics.items()
                 if np.ndim(v) == 0})
    return finish


def _spawn(argvs):
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv in argvs]


def _wait(procs, timeout=300):
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


def _fit_batches(a):
    return [(WORDS[:4], a["t14_motion"][:4].tolist(),
             a["t14_length"][:4].tolist())]


def _one_process_save(pcfg, sd, path):
    """A one-process state (the weights, moments of one update's worth)
    saved with a generator state, for the seq 2 x model 2 resume."""
    model = MotionTransformer(pcfg.model)
    model.load_state_dict(sd)
    state = create_train_state(model, pcfg)
    with torch.no_grad():
        for m, p in zip(state.optimizer.mu, state.optimizer.params):
            m.copy_(0.01 * p)
    state.step = 3
    gen = torch.Generator().manual_seed(77)
    torch.randn(5, generator=gen)
    CheckpointManager(path, cfg=pcfg).save(state.step, state, 0, gen)
    return gen.get_state()


def _one_process_fit(pcfg, a):
    """The port's ``Trainer.fit`` of :data:`FIT` in one process: its
    parameters and its sampler's state."""
    cfg = _with(pcfg, FIT)
    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, **FIT["diffusion"]))
    trainer = Trainer(cfg, device="cpu")
    batches = [(c, np.asarray(m, np.float32), n)
               for c, m, n in _fit_batches(a)]
    state = trainer.fit(trainer.init_state(), batches)
    opt = state.optimizer
    return {"params": state.model.state_dict(), "step": state.step,
            "mu": {n: m for (n, p), m in zip(
                ((n, p) for n, p in state.model.named_parameters()
                 if p.requires_grad), opt.mu)},
            "sampler": (trainer.sampler._loss_history.tolist(),
                        trainer.sampler._loss_counts.tolist())}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks and the CLI's two processes started, the JAX references
    and the one-process fit computed meanwhile, then their results."""
    root = tmp_path_factory.mktemp("seq_train")
    cfg = _config()
    a = _arrays()
    params = random_params(JaxMotionTransformer(cfg.model),
                           a["t14_motion"], a["t14_t"], a["t14_length"],
                           text_ids=a["t14_text_ids"])
    sd = jax_to_state_dict(params)
    torch.save(sd, root / "weights.pt")
    pcfg = to_port(cfg)
    saved_rng = _one_process_save(pcfg, sd, str(root / "one_process"))
    noise = {ref: _jax_noise(_with(cfg, fields), a, prefix,
                             jax.random.key(REF_KEYS[ref]))
             for ref, (prefix, fields, _) in REFS.items()}
    cases = []
    for name, (layout, ref, zero1) in STEPS.items():
        prefix, fields, _ = REFS[ref]
        dp, ep, _, _ = layout
        order = _holder_order(
            dp * ep, fields.get("train", {}).get("grad_accum_steps", 1))
        for k in ("motion", "length", "text_ids", "t", "t_weight"):
            a[f"{name}_{k}"] = a[f"{prefix}_{k}"][order]
        a[f"{name}_noise"] = noise[ref][order]
        cases.append(dict(name=name, kind="train_step", layout=layout,
                          prefix=name, zero1=zero1, **fields,
                          save=str(root / name) if name == "dp2_sp2"
                          else None))
    np.savez(root / "inputs.npz", **a)
    cases += [
        dict(name="fit", kind="train_fit", layout=(1, 1, 2, 2), **FIT),
        dict(name="resume", kind="train_resume", layout=(1, 1, 2, 2),
             path=str(root / "one_process")),
        dict(name="units", kind="train_units", layout=(2, 1, 1, 2),
             checks=[("builds", (2, 1, 1, 2), {}),
                     ("short", (2, 1, 1, 2),
                      {"data": {"max_motion_length": 3}}),
                     ("microbatch", (1, 2, 1, 2),
                      {"train": {"batch_size": 3}}),
                     ("world", (1, 1, 1, 3), {})])]
    spec = {"train_cfg": pcfg.to_dict(), "weights": {"train": str(
        root / "weights.pt")}, "inputs": str(root / "inputs.npz"),
        "fit": _fit_batches(a), "init": f"file://{root / 'rdv'}",
        "world": W, "out": str(root), "cases": cases}
    (root / "job.json").write_text(json.dumps(spec))
    procs = _spawn(
        [["-m", "tests._torch_mesh_worker", str(root / "job.json"), str(r)]
         for r in range(W)]
        + [["-m", "motiondiffusion_moe_tpu_torch.tools.train", *TINY_CLI,
            "--checkpoint_dir", str(root / "cli"),
            "--coordinator_address", f"file://{root / 'rdv_cli'}",
            "--num_processes", "2", "--process_id", str(r),
            "--seq_parallel", "2"] for r in range(2)])

    with ThreadPoolExecutor(len(REFS)) as pool:
        refs = {ref: pool.submit(_jax_step(
            _with(cfg, fields), params, a, prefix,
            jax.random.key(REF_KEYS[ref]),
            jax_make_mesh(2, expert_parallel=2) if on_mesh else None))
            for ref, (prefix, fields, on_mesh) in REFS.items()}
        fit = _one_process_fit(pcfg, a)
        refs = {ref: f.result() for ref, f in refs.items()}

    outs = _wait(procs)
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    got = {c["name"]: torch.load(root / f"{c['name']}.pt",
                                 weights_only=False) for c in cases}
    return dict(cfg=cfg, pcfg=pcfg, sd=sd, got=got, refs=refs, fit=fit,
                root=root, saved_rng=saved_rng, cli=[o for _, o in outs[W:]])


# ------------------------------------------------ kernel 3's split, one process

@pytest.mark.parametrize("T,cuts", [(14, [0, 8, 14]), (15, [0, 8, 15]),
                                    (14, [0, 4, 8, 12, 14]),
                                    (15, [0, 4, 8, 12, 15])])
def test_kernel_3_split_sums_to_the_whole_backward(T, cuts):
    qkv, ln, mask, parts = _split_case(T, cuts, 5 * T + len(cuts))
    g = torch.randn(qkv.shape[0], T, qkv.shape[-1] // 3,
                    generator=torch.Generator().manual_seed(T))
    whole = PF.favor_qkv_bwd_plain(qkv, *ln, mask, g)
    kvs, splits = zip(*(PF.favor_qkv_bwd_kv(qkv[:, a:b], *ln, mask[:, a:b])
                        for a, b in parts))
    kv = sum(kvs)
    g_kv = sum(PF.favor_qkv_bwd_q(s, kv, g[:, a:b])
               for s, (a, b) in zip(splits, parts))
    steps = [PF.favor_qkv_bwd_k(s, g_kv) for s in splits]
    got = (torch.cat([d for d, *_ in steps], 1),
           *(sum(x[i] for x in steps) for i in (1, 2, 3)))
    for name, a, b in zip(("dqkv", "d_ln_scale", "d_ln_bias", "d_proj"),
                          got, whole):
        assert _rel(a, b) <= SPLIT_REL, name
    # the steps are the wrappers' plain versions on the CPU
    a, b = parts[0]
    assert torch.equal(kvs[0], PF.favor_qkv_bwd_kv_plain(
        qkv[:, a:b], *ln, mask[:, a:b]))


class _OneRank:
    """A seq group of one rank: its sums are the identity."""

    world, rank = 1, 0

    @staticmethod
    def sum_(t):
        return t


@pytest.mark.parametrize("split", ["favor_qkv_split",
                                   "favor_qkv_split_plain"])
def test_the_split_function_on_one_rank_is_favor_qkv(split):
    qkv, ln, mask, _ = _split_case(15, [0, 15], 2)
    g = torch.randn(qkv.shape[0], 15, qkv.shape[-1] // 3,
                    generator=torch.Generator().manual_seed(4))
    outs = []
    for fn in (lambda x, s, b: PF.favor_qkv(x, s, b, ln[2], mask),
               lambda x, s, b: getattr(PF, split)(x, s, b, ln[2], mask,
                                                  _OneRank())):
        xs = [t.clone().requires_grad_() for t in (qkv, ln[0], ln[1])]
        y = fn(*xs)
        y.backward(g)
        outs.append([y.detach()] + [x.grad for x in xs])
    for a, b in zip(*outs):
        assert _rel(a, b) <= SPLIT_REL


# ------------------------------------------------ the ranks against JAX

def _assert_params(got, want, mu, steps=1, what="params"):
    """Every updated parameter within atol 1e-5 of ``want``, but where
    the reference's first moment ``mu`` (a multiple of the gradient) is
    within 1e-4 of its leaf's largest entry plus 1e-8: there two summation
    orders may give the gradient either sign, and Adam moves the entry by
    up to lr a step either way (see the module doc)."""
    for n, v in want.items():
        err = (got[n].cpu().float() - v.float()).abs()
        m = mu.get(n)
        small = (torch.zeros_like(err, dtype=torch.bool) if m is None
                 else m.abs() <= 1e-4 * m.abs().max() + 1e-8)
        assert float(torch.where(small, 0, err).max()) <= 1e-5, (what, n)
        assert float(err.max()) <= 2 * steps * LR, (what, n)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_seq_step_matches_jax(run, name):
    new, mu, metrics = run["refs"][STEPS[name][1]]
    got = run["got"][name]
    np.testing.assert_allclose(got["metrics"]["loss_total"],
                               metrics["loss_total"], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["grad_norm"],
                               metrics["grad_norm"], rtol=1e-5)
    _assert_params(got["params"], new, mu)
    for n, m in got["mu"].items():
        tol = 1e-4 * float(mu[n].abs().max()) + 1e-8
        assert float((m.cpu() - mu[n]).abs().max()) <= tol, ("mu", n)


def test_seq_ranks_run_only_the_split_kernels(run):
    """Kernels 1 and 3 on every rank: the split's steps, one of each a
    Performer and a microbatch, never the whole T's."""
    for name, (_, ref, _) in STEPS.items():
        A = REFS[ref][1].get("train", {}).get("grad_accum_steps", 1)
        for calls in run["got"][name]["calls"]:
            # 2 Performers a block, 1 block a scale, 2 scales
            assert calls == {"favor_qkv_plain": 0, "favor_qkv_bwd": 0,
                             **{k: 4 * A for k in (
                                 "favor_qkv_moments", "favor_qkv_apply",
                                 "favor_qkv_bwd_kv", "favor_qkv_bwd_q",
                                 "favor_qkv_bwd_k")}}, (name, calls)


def test_the_dispatch_case_drops_tokens(run):
    """At capacity factor 1 every rank's all-to-all dispatch drops pairs
    (JAX's per-chunk capacity decides which), and the others drop none."""
    for name in STEPS:
        dropped = run["got"][name]["dropped"]
        if name == "sp2_ep2_dispatch":
            assert min(dropped) > 0, dropped
        else:
            assert dropped == [0] * W, (name, dropped)


def test_every_seq_rank_sees_its_rows_whole_per_sample_losses(run):
    """``per_sample_mse`` is each row's over its whole T, the same on the
    seq and model ranks of a row-holder."""
    for name, ((dp, ep, tp, sp), _, _) in STEPS.items():
        per = run["got"][name]["per_sample"]
        for r, row in enumerate(per):
            d, e = r // (tp * ep * sp), r // tp % ep
            assert row == per[(d * sp * ep + e) * tp], (name, r)


# ------------------------------------------------ port against port

def test_fit_with_dropout_stochastic_depth_and_a_loss_aware_sampler(run):
    got, ref = run["got"]["fit"], run["fit"]
    assert got["step"] == ref["step"] == 2
    _assert_params(got["params"], ref["params"], ref["mu"], steps=2,
                   what="fit")
    for history, counts in got["sampler"]:
        np.testing.assert_allclose(history, ref["sampler"][0], rtol=1e-5,
                                   atol=1e-7)
        assert counts == ref["sampler"][1]
    assert sum(ref["sampler"][1]) == 8  # 2 steps x 4 rows


# ------------------------------------------------ checkpoints, the CLI

def test_a_dp2_sp2_save_holds_one_generator_a_row_holder(run):
    """Ranks ((d sp + s) ep + e) tp + m: the states of s = m = 0 in row
    order, and a one-process restore reads the same parameters."""
    got = run["got"]["dp2_sp2"]
    path = str(run["root"] / "dp2_sp2")
    payload = CheckpointManager(path, cfg=run["pcfg"]).read()
    assert len(payload["rng"]) == 2
    for q, r in enumerate((0, 2)):
        assert torch.equal(payload["rng"][q], got["rng"][r])
    assert torch.equal(got["rng"][0], got["rng"][1])  # a seq group draws
    model = MotionTransformer(run["pcfg"].model)
    state = create_train_state(model, run["pcfg"])
    _, epoch, rng = CheckpointManager(
        path, cfg=run["pcfg"]).restore_with_rng(state)
    assert state.step == 1 and epoch == 0 and len(rng) == 2
    for n, v in model.state_dict().items():
        assert torch.equal(v, got["params"][n].cpu()), n


def test_a_one_process_save_resumes_at_seq_2(run):
    got = run["got"]["resume"]
    assert got["held"] == [(True, 3, 0)] * W
    for state in got["rng"]:
        assert torch.equal(state, run["saved_rng"])


def test_train_cli_over_seq_as_two_processes(run):
    """Loss finite and moving (JAX's ``test_seq_only_mesh_two_steps``);
    only the primary prints."""
    first, second = run["cli"]
    losses = [float(line.split("loss_total: ")[1].split()[0])
              for line in first.splitlines() if "loss_total: " in line]
    assert len(losses) >= 2, first[-2000:]
    assert all(np.isfinite(losses)) and losses[0] != losses[1]
    assert "loss_total" not in second


# ------------------------------------------------ errors

def test_seq_training_errors(run):
    units = run["got"]["units"]
    assert units["builds"] == "no error"
    assert "3 over 2 seq partitions" in units["short"]
    assert "not divisible by the 2 data ranks" in units["microbatch"]
    assert "launch a multiple of 3 processes" in units["world"]


def test_pipe_axis_still_raises():
    """The pipe axis trains (tests/test_torch_pipeline_parallel.py); beside
    the seq axis, or in one process, it raises."""
    cfg = to_port(tiny_config())
    with pytest.raises(ValueError, match="1 process"):
        Trainer(dataclasses.replace(
            cfg, parallel=ParallelConfig(num_pipeline_stages=2)),
            device="cpu")
    with pytest.raises(ValueError, match="1 process"):
        train_cli.main(["--dataset", "synthetic", "--device", "cpu",
                        "--pipeline_parallel", "2"])
    with pytest.raises(ValueError, match="mesh has seq=2"):
        generation_mesh(1, 1, 1, 2, 2)
