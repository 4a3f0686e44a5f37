"""Data-parallel training and ZeRO-1 over ``torch.distributed``
(``motiondiffusion_moe_tpu_torch/parallel/``), on the CPU.

Two ranks run as two processes over gloo (``tests/_torch_dp_worker.py``,
a ``file://`` rendezvous under ``tmp_path``, so parallel test workers
never share a port), at the tiny widths of ``test_torch_train_step.py``:
one decoder block, injected t and noise, dropout 0. The global batch of 8
rows has ragged lengths, long on rank 0 and short on rank 1, so the ranks'
mask sums differ; the MoE balance weight, the velocity loss and the EMA are
on. Rank r holds rows ``r`` of each microbatch: under gradient
accumulation microbatch i of the global batch is rank 0's chunk i, then
rank 1's (the JAX package's ``shard_batch`` layout).

Held against (1) the port's one-process step on the global batch, two
optimizer steps, and (2) the JAX package's loss, gradient and Adam update
on the global batch (composed as ``test_torch_train_step.py`` composes
them, with the velocity loss and the importance weights). Tolerances:
those of ``test_torch_train_step.py`` (loss rtol 1e-5; each gradient
within 1e-4 of its largest entry plus 1e-7; a parameter after one update
within 2e-6 where its gradient is at least 1e-6, within 2 lr elsewhere),
doubled for the parameters and the EMA after two updates; the moments
after two updates are sums of the gradients and their squares, so within
1e-4 (mu) and 2e-4 (nu) of their largest entry, plus what the gradients'
1e-7 floor makes of them (0.19 x 1e-7 in mu, 1e-15 in nu). A control
takes each rank's own denominators and misses the gradient tolerance.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motiondiffusion_moe_tpu.diffusion import gaussian as JG
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
    generate_src_mask as jax_src_mask,
    sum_moe_aux_losses as jax_sum_aux,
)
from motiondiffusion_moe_tpu.training import losses as JL
from motiondiffusion_moe_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from motiondiffusion_moe_tpu.training.train_state import (
    TrainState as JaxTrainState,
    make_optimizer,
)
from motiondiffusion_moe_tpu_torch.diffusion.gaussian import make_schedule
from motiondiffusion_moe_tpu_torch.diffusion.samplers import (
    LossSecondMomentResampler,
    UniformSampler,
)
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.models.transformer import (
    MotionTransformer,
)
from motiondiffusion_moe_tpu_torch.parallel import data_parallel as DP
from motiondiffusion_moe_tpu_torch.parallel import distributed as D
from motiondiffusion_moe_tpu_torch.tools import train as train_cli
from motiondiffusion_moe_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from motiondiffusion_moe_tpu_torch.training.train_state import (
    TrainStep,
    create_train_state,
)
from motiondiffusion_moe_tpu_torch.utils import orbax_format

from tests._torch_parity import random_params, tiny_config, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, ROWS, T, F, STEPS = 2, 4, 16, 26, 2   # ranks, rows a rank, frames, ...
LENGTHS = ([16, 14, 12, 16], [3, 5, 2, 4])  # rank 0 long, rank 1 short
CASES = {  # name: (zero1, grad_accum_steps)
    "replicated_accum1": (False, 1), "zero1_accum1": (True, 1),
    "replicated_accum2": (False, 2), "zero1_accum2": (True, 2)}
METRICS = ("loss_total", "loss_mot_rec", "loss_moe", "loss_velocity",
           "grad_norm")


def _config():
    cfg = tiny_config(num_layers=1, moe_aux_loss_weight=0.1)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.9, w_velocity=0.5))


def _rank_arrays():
    """Each rank's rows, [step, row, ...]."""
    rng = np.random.default_rng(31)
    words = ["a person walks", "", "turn left twice", "jump", "wave",
             "sit down", "", "run in a circle"]
    out = {}
    for r in range(W):
        caps = [[words[(4 * r + i + s) % 8] for i in range(ROWS)]
                for s in range(STEPS)]
        out.update({
            f"motion_{r}": rng.standard_normal(
                (STEPS, ROWS, T, F)).astype(np.float32),
            f"length_{r}": np.tile(np.array(LENGTHS[r], np.int32),
                                   (STEPS, 1)),
            f"text_ids_{r}": np.stack([hash_tokenize(c, 12) for c in caps]),
            # t < 50: the velocity loss reads x0 from eps through
            # sqrt(1 / abar), at most 3.9 there and 221 at t = 99, where
            # its gradient's f32 sums lose the digits any order compares
            f"t_{r}": rng.integers(0, 50, (STEPS, ROWS)).astype(np.int32),
            f"t_weight_{r}": rng.uniform(0.5, 2.0, (STEPS, ROWS)).astype(
                np.float32),
            f"noise_{r}": rng.standard_normal(
                (STEPS, ROWS, T, F)).astype(np.float32)})
    return out


def global_batch(arrays, step, accum):
    """The global batch (and noise) of ``step`` in the layout of
    ``accum`` microbatches: chunk i is rank 0's chunk i, then rank 1's."""
    m = ROWS // accum

    def cat(key):
        return np.concatenate([arrays[f"{key}_{r}"][step][i * m:(i + 1) * m]
                               for i in range(accum) for r in range(W)])

    batch = {k: cat(k) for k in ("motion", "length", "text_ids", "t",
                                 "t_weight")}
    return batch, cat("noise")


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if k in ("length", "text_ids", "t")
            else torch.from_numpy(v) for k, v in b.items()}


def _spawn(argvs, timeout=300):
    """Run one process per argv from the repo root; (rc, output) each."""
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
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
    """The two-rank run of every case, and the one-process references."""
    root = tmp_path_factory.mktemp("dp")
    cfg = _config()
    arrays = _rank_arrays()
    b0, _ = global_batch(arrays, 0, 1)
    params = random_params(JaxMotionTransformer(cfg.model), b0["motion"],
                           b0["t"], b0["length"], text_ids=b0["text_ids"])
    torch.save(jax_to_state_dict(params), root / "params.pt")
    np.savez(root / "batch.npz", **arrays)
    cases = [dict(name=n, zero1=z, accum=a, save=(n == "zero1_accum1"))
             for n, (z, a) in CASES.items()]
    cases.append(dict(name="control", zero1=False, accum=1, control=True))
    spec = {"init": f"file://{root / 'rendezvous'}", "world": W,
            "cfg": to_port(cfg).to_dict(), "state_dict": str(
                root / "params.pt"), "batch": str(root / "batch.npz"),
            "steps": STEPS, "cases": cases, "out": str(root)}
    with open(root / "spec.json", "w") as f:
        json.dump(spec, f)
    outs = _spawn([["-m", "tests._torch_dp_worker", str(root / "spec.json"),
                    str(r)] for r in range(W)])
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    got = {c["name"]: torch.load(root / f"{c['name']}.pt",
                                 weights_only=False) for c in cases}
    units = [torch.load(root / f"units_{r}.pt", weights_only=False)
             for r in range(W)]
    refs = {a: _one_process(cfg, params, arrays, a, root) for a in (1, 2)}
    return dict(cfg=cfg, params=params, arrays=arrays, got=got, units=units,
                refs=refs, root=root)


def _one_process(cfg, params, arrays, accum, root):
    """The port's one-process step on the global batch; with accum 1 the
    state is also saved in both formats under ``root/w1_<fmt>``."""
    pcfg = to_port(cfg)
    pcfg = dataclasses.replace(pcfg, train=dataclasses.replace(
        pcfg.train, grad_accum_steps=accum))
    model = MotionTransformer(pcfg.model)
    model.load_state_dict(jax_to_state_dict(params))
    state = create_train_state(model, pcfg)
    sched = make_schedule(schedule_name=pcfg.diffusion.beta_schedule,
                          num_timesteps=pcfg.diffusion.num_timesteps)
    step = TrainStep(sched, pcfg)
    out = {"metrics": [], "grads": []}
    for s in range(STEPS):
        batch, noise = global_batch(arrays, s, accum)
        metrics = step.backward(state, _torch_batch(batch), None,
                                noise=torch.from_numpy(noise))
        out["grads"].append({n: p.grad.clone() if p.grad is not None
                             else torch.zeros_like(p)
                             for n, p in model.named_parameters()})
        metrics = step.apply_update(state, metrics)
        out["metrics"].append({k: float(v) for k, v in metrics.items()
                               if v.dim() == 0})
        if s == 0:
            out["params1"] = {k: v.clone()
                              for k, v in model.state_dict().items()}
    out["params"] = model.state_dict()
    out["opt"] = state.optimizer.state_dict()
    out["ema"] = state.ema.state_dict()["params"]
    if accum == 1:
        for fmt in ("torch", "orbax"):
            CheckpointManager(str(root / f"w1_{fmt}"), fmt=fmt,
                              cfg=pcfg).save(state.step, state, 0)
    return out


# ----------------------------------------------------------- the tolerances

def _grad_excess(grads, ref) -> float:
    """The largest gradient error over its tolerance (<= 1 passes)."""
    worst = 0.0
    for name, r in ref.items():
        r = np.asarray(r, np.float64)
        tol = 1e-4 * np.abs(r).max() + 1e-7
        err = np.abs(np.asarray(grads[name], np.float64) - r).max()
        worst = max(worst, err / tol)
    return worst


def _assert_params(params, ref, grads, lr, updates=1, what="params"):
    """A parameter within 2e-6 per update where its first gradient is at
    least 1e-6, within 2 lr per update everywhere."""
    for name, r in ref.items():
        if name not in grads:
            continue
        err = np.abs(np.asarray(params[name]) - np.asarray(r))
        large = np.abs(np.asarray(grads[name])) >= 1e-6
        assert (err[large] <= 2e-6 * updates).all(), (what, name)
        assert (err <= 2 * lr * updates).all(), (what, name)


def _assert_moments(got, ref, rel, floor, what):
    for g, r in zip(got, ref):
        tol = rel * float(r.abs().max()) + floor
        assert float((g - r).abs().max()) <= tol, what


def _named(model_names, tensors):
    return dict(zip(model_names, tensors))


# ------------------------------------------------ against the port's step

@pytest.mark.parametrize("case", list(CASES))
def test_data_parallel_step_equals_the_one_process_step(run, case):
    got, ref = run["got"][case], run["refs"][CASES[case][1]]
    lr = run["cfg"].train.lr
    for g, r in zip(got["metrics"], ref["metrics"]):
        for k in METRICS:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
    assert _grad_excess(got["grads"], ref["grads"][0]) <= 1
    first = ref["grads"][0]
    _assert_params(got["params1"], ref["params1"], first, lr)
    _assert_params(got["params"], ref["params"], first, lr, updates=2)
    names = list(first)
    trainable = [n for n in names if n in got["grads"]
                 and "fa_projection" not in n]
    _assert_params(_named(names, got["ema"]), _named(names, ref["ema"]),
                   first, lr, updates=2, what="ema")
    assert len(got["opt"]["mu"]) == len(ref["opt"]["mu"]) >= len(trainable)
    _assert_moments(got["opt"]["mu"], ref["opt"]["mu"], 1e-4, 2e-8, "mu")
    _assert_moments(got["opt"]["nu"], ref["opt"]["nu"], 2e-4, 1e-15, "nu")
    assert got["opt"]["count"] == ref["opt"]["count"] == STEPS


def test_zero1_ranks_hold_their_shard_and_replicated_ranks_the_whole(run):
    """Under ZeRO-1 a rank's moment is 1/W of the optimizer's flat buffer,
    which holds the trainable elements and, before each tensor and at the
    end, fewer than ALIGN_BYTES of zeros (at most ceil(n / W) plus that
    padding); its EMA ceil(n / W) of all the parameters."""
    align = DP.ALIGN_BYTES // 4  # f32 parameters
    for case, (zero1, _) in CASES.items():
        for res in run["got"][case]["resident"]:
            n, m = res["trainable"], res["all"]
            if zero1:
                pad = res["padded"] - n
                assert 0 <= pad < align * (res["tensors"] + W), (case, res)
                want = (res["padded"] // W, -(-m // W))
            else:
                want = (n, m)
            assert (res["mu"], res["nu"], res["ema"]) == (
                want[0], want[0], want[1]), (case, res)
            assert res["padded"] % W == 0, (case, res)


# ----------------------------------------------- against the JAX package

def _jax_step(cfg, params, arrays):
    """The JAX loss (``loss_fn``'s terms: importance-weighted masked MSE,
    the MoE balance term, the velocity loss on the predicted x0), its
    gradient and one ``make_optimizer`` update, on step 0's global
    batch."""
    model = JaxMotionTransformer(cfg.model)
    sched = JG.make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                             num_timesteps=cfg.diffusion.num_timesteps)

    def loss(p, batch, noise):
        x0, tt = batch["motion"], batch["t"]
        x_t = JG.q_sample(sched, x0, tt, noise)
        out, cols = model.apply(
            {"params": p}, x_t, tt, batch["length"],
            text_ids=batch["text_ids"], deterministic=False,
            rngs={"dropout": jax.random.key(0),
                  "stochdepth": jax.random.key(1)},
            mutable=["moe_losses", "moe_metrics"])
        terms = JG.training_loss_terms(sched, out, x0, x_t, tt, noise)
        mask = jax_src_mask(x0.shape[1], batch["length"])
        rec = JL.masked_frame_mse(terms["pred"], terms["target"], mask,
                                  sample_weight=batch["t_weight"])
        x0_pred = JG.pred_xstart_from_eps(sched, x_t, tt, terms["pred"])
        vel = JL.velocity_loss(x0_pred, x0, mask)
        return (rec + jax_sum_aux(cols) * cfg.model.moe_aux_loss_weight
                + cfg.train.w_velocity * vel)

    batch, noise = global_batch(arrays, 0, 1)
    value, grads = jax.jit(jax.value_and_grad(loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(noise))
    tx = make_optimizer(cfg)
    new = jax.jit(lambda p, g: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(params, grads)
    return (float(value), jax_to_state_dict(jax.device_get(grads)),
            jax_to_state_dict(jax.device_get(new)))


@pytest.fixture(scope="module")
def jax_step(run):
    return _jax_step(run["cfg"], run["params"], run["arrays"])


def test_two_zero1_ranks_match_the_jax_step_on_the_global_batch(run,
                                                                jax_step):
    loss, grads, params1 = jax_step
    got = run["got"]["zero1_accum1"]
    np.testing.assert_allclose(got["metrics"][0]["loss_total"], loss,
                               rtol=1e-5)
    trainable = {n: g for n, g in grads.items() if "fa_projection" not in n}
    assert _grad_excess(got["grads"], trainable) <= 1
    _assert_params(got["params1"], params1, trainable, run["cfg"].train.lr)


def test_per_rank_denominators_miss_the_jax_gradient(run, jax_step):
    """The naive step (each rank's mean of its own rows, then the mean of
    the ranks' gradients) on the same batch: this batch tells the two
    apart, by far."""
    _, grads, _ = jax_step
    trainable = {n: g for n, g in grads.items() if "fa_projection" not in n}
    assert _grad_excess(run["got"]["control"]["grads"], trainable) > 100


# --------------------------------------------------------------- units

@pytest.mark.parametrize("numels,world", [((5,), 2), ((3, 4, 1), 2),
                                          ((7, 9, 2, 30), 3),
                                          ((1,), 4), ((6, 6), 3)])
def test_flat_partition_shards_cover_the_whole(numels, world):
    tensors = [torch.arange(n, dtype=torch.float32) + 100 * i
               for i, n in enumerate(numels)]
    parts = [DP.FlatPartition(numels, world, r) for r in range(world)]
    total = sum(numels)
    shard = -(-total // world)
    shards = [p.local(tensors) for p in parts]
    assert all(s.numel() == shard for s in shards)
    assert sum(p.pad for p in parts) == shard * world - total
    flat = torch.cat(shards)
    assert torch.equal(flat, parts[0].flat(tensors))
    assert torch.equal(flat[:total], torch.cat(tensors))
    assert not flat[total:].any()
    for a, b in zip(parts[0].split(flat), tensors):
        assert torch.equal(a, b)


@pytest.mark.parametrize("numels,world,align", [((5,), 2, 4),
                                                ((3, 4, 1), 2, 4),
                                                ((7, 9, 2, 30), 3, 8),
                                                ((64, 1, 65), 4, 64)])
def test_aligned_flat_partition_starts_each_tensor_on_a_boundary(
        numels, world, align):
    """Each tensor starts at a multiple of ``align``; the shards, each a
    multiple of ``align``, cover the buffer; gaps and padding are zero."""
    tensors = [torch.arange(1, n + 1, dtype=torch.float32) + 100 * i
               for i, n in enumerate(numels)]
    parts = [DP.FlatPartition(numels, world, r, align)
             for r in range(world)]
    p = parts[0]
    assert all(o % align == 0 for o in p.offsets)
    assert p.shard % align == 0 and p.size == world * p.shard
    assert p.offsets[-1] + numels[-1] <= p.size < (
        sum(-(-n // align) * align for n in numels) + world * align)
    flat = torch.cat([q.local(tensors) for q in parts])
    assert torch.equal(flat, p.flat(tensors))
    for v, t in zip(p.split(flat), tensors):
        assert torch.equal(v, t)
    assert int((flat != 0).sum()) == sum(numels)  # the rest is zeros
    assert sum(q.pad for q in parts) == p.size - sum(numels)
    for q in parts:
        assert torch.equal(q.own(flat), q.local(tensors))


def test_loss_aware_sampler_gathers_in_rank_order(run):
    u0, u1 = (u["sampler"] for u in run["units"])
    one = LossSecondMomentResampler(50, history_per_term=2)
    one.update_with_local_losses(np.concatenate([u0["ts"], u1["ts"]]),
                                 np.concatenate([u0["losses"],
                                                 u1["losses"]]))
    for u in (u0, u1):
        np.testing.assert_array_equal(u["history"], one._loss_history)
        np.testing.assert_array_equal(u["counts"], one._loss_counts)


def test_rank_host_rng_is_the_jax_process_stream(run):
    """Rank r draws t from ``default_rng(seed + 1_000_003 * r)``, the JAX
    trainer's process-r stream (``trainer.py:119-125``)."""
    for r, u in enumerate(run["units"]):
        t_want, _ = UniformSampler(100).sample(
            4, np.random.default_rng(5 + 1_000_003 * r))
        np.testing.assert_array_equal(u["t"], t_want)
    assert not np.array_equal(run["units"][0]["t"], run["units"][1]["t"])


@pytest.mark.parametrize("name,kind,words", [
    ("data_partitions", "ValueError", "2 processes"),
    ("microbatch", "ValueError", "not divisible by the 2 data ranks")])
def test_data_parallel_errors(run, name, kind, words):
    for u in run["units"]:
        err = u["errors"][name]
        assert err is not None and err[0] == kind and words in err[1], err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("how", ["no_peer", "cuda_without_a_card",
                                 "given_in_part"])
def test_an_explicit_launch_that_fails_raises(how, tmp_path):
    """No fallback: the error propagates, no group is left, and nothing
    turns into one process or another backend."""
    if how == "no_peer":   # rank 1 of 2, no rank 0 ever comes
        kw = dict(coordinator_address=f"127.0.0.1:{_free_port()}",
                  num_processes=2, process_id=1, device="cpu", timeout_s=2)
        err = Exception
    elif how == "cuda_without_a_card":
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        kw = dict(coordinator_address=f"file://{tmp_path / 'rdv'}",
                  num_processes=1, process_id=0, device="cuda")
        err = Exception
    else:
        kw = dict(num_processes=2)
        err = ValueError
    with pytest.raises(err):
        D.initialize_distributed(**kw)
    assert not torch.distributed.is_initialized()


def test_no_launch_is_one_process(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert D.launch_config() is None
    assert D.initialize_distributed() is False
    assert (D.world_size(), D.rank(), D.is_primary()) == (1, 0, True)
    assert D.local_batch_slice(32) == 32
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert D.launch_config() == ("env://", 4, 3)
    assert D.launch_config("10.0.0.1:1234", 2, 1) == (
        "tcp://10.0.0.1:1234", 2, 1)


# ---------------------------------------------------------- checkpoints

def _names(cfg):
    """The parameters in the model's order (the order of the optimizer's
    and the EMA's lists; a JAX-layout payload's ``params`` dict has the
    bridge's)."""
    with torch.device("meta"):
        return [n for n, _ in MotionTransformer(cfg.model).named_parameters()]


def _payload_close(got, ref, grads, lr, names):
    assert got.keys() == ref.keys()
    assert got["step"] == ref["step"] == STEPS and got["epoch"] == 0
    assert list(got["params"]) == list(ref["params"])
    for a, b in zip(got["params"].values(), ref["params"].values()):
        assert a.dtype == b.dtype and a.shape == b.shape
    _assert_params(got["params"], ref["params"], grads, lr, updates=2)
    _assert_params(_named(names, got["ema_params"]["params"]),
                   _named(names, ref["ema_params"]["params"]), grads, lr,
                   updates=2, what="ema")
    for k, rel, floor in (("mu", 1e-4, 2e-8), ("nu", 2e-4, 1e-15)):
        a, b = got["opt_state"][k], ref["opt_state"][k]
        assert [(x.dtype, x.shape) for x in a] == [(x.dtype, x.shape)
                                                   for x in b]
        _assert_moments(a, b, rel, floor, k)
    assert got["opt_state"]["count"] == ref["opt_state"]["count"]


@pytest.mark.parametrize("fmt", ["torch", "orbax"])
def test_a_two_rank_zero1_save_is_the_one_process_save_and_resumes(run,
                                                                  fmt):
    """The same tree as the one-process run's after the same global steps
    (keys, dtypes and shapes equal; values within the step tolerances),
    restored at W = 2 (each rank's shards and the gathered whole bit for
    bit, each rank its own generator) and at W = 1."""
    root, cfg = run["root"], to_port(run["cfg"])
    got = CheckpointManager(str(root / f"ckpt_{fmt}"), cfg=cfg).read()
    ref = CheckpointManager(str(root / f"w1_{fmt}"), cfg=cfg).read()
    assert isinstance(got["rng"], list) and len(got["rng"]) == W
    got["rng"] = ref["rng"] = None
    _payload_close(got, ref, run["refs"][1]["grads"][0], cfg.train.lr,
                   _names(cfg))
    if fmt == "orbax":  # the same leaves, as the JAX layout writes them
        a = orbax_format.flatten(orbax_format.read_step(str(
            root / f"ckpt_{fmt}" / str(STEPS))))
        b = orbax_format.flatten(orbax_format.read_step(str(
            root / f"w1_{fmt}" / str(STEPS))))
        assert [p for p, _ in a] == [p for p, _ in b]
    held = run["got"]["zero1_accum1"]["saved"][fmt]
    assert held == [{"shards": True, "state": True, "rng": True}] * W
    model = MotionTransformer(cfg.model)
    state = create_train_state(model, cfg)
    _, epoch, rng = CheckpointManager(str(root / f"ckpt_{fmt}"),
                                      cfg=cfg).restore_with_rng(state)
    payload = CheckpointManager(str(root / f"ckpt_{fmt}"), cfg=cfg).read()
    for a, b in zip(state.optimizer.mu, payload["opt_state"]["mu"]):
        assert torch.equal(a, b)
    for a, b in zip(state.ema.params, payload["ema_params"]["params"]):
        assert torch.equal(a, b)
    assert state.step == STEPS and epoch == 0 and len(rng) == W


def test_the_jax_manager_restores_the_two_rank_save(run):
    cfg = run["cfg"]
    b0, _ = global_batch(run["arrays"], 0, 1)
    shapes = jax.eval_shape(lambda: JaxMotionTransformer(cfg.model).init(
        jax.random.key(0), b0["motion"], b0["t"], b0["length"],
        text_ids=b0["text_ids"]))  # the init's tree, no init run
    params = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                                    shapes)
    tx = make_optimizer(cfg)
    template = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                             opt_state=tx.init(params), tx=tx,
                             ema_params={"params": params["params"]})
    root = run["root"]
    jstate, epoch, rng = JaxCheckpointManager(str(
        root / "ckpt_orbax")).restore_with_rng(template)
    assert int(jstate.step) == STEPS and epoch == 0 and rng is None
    payload = CheckpointManager(str(root / "ckpt_orbax"),
                                cfg=to_port(cfg)).read()
    names = _names(to_port(cfg))
    adam = jstate.opt_state[1][0]
    for tree, want in ((jstate.params["params"], payload["params"]),
                       (jstate.ema_params["params"],
                        dict(zip(names, payload["ema_params"]["params"])))):
        sd = jax_to_state_dict(jax.device_get(tree))
        for name, v in want.items():
            assert torch.equal(sd[name], v), name
    names = [n for n in names if "fa_projection" not in n]
    for k in ("mu", "nu"):
        sd = jax_to_state_dict(jax.device_get(getattr(adam, k)["params"]))
        for name, v in zip(names, payload["opt_state"][k]):
            assert torch.equal(sd[name], v), (k, name)


# ------------------------------------------------------------ the CLI

TINY_CLI = ["--dataset", "synthetic", "--num_layers", "1", "--latent_dim",
            "64", "--ff_size", "32", "--text_latent_dim", "16",
            "--batch_size", "2", "--synthetic_size", "4", "--log_every", "1",
            "--num_epochs", "1", "--device", "cpu", "--ema_decay", "0.9"]


def test_train_cli_as_two_processes_then_one_resumes(tmp_path, capsys):
    ck = str(tmp_path / "runs")
    base = TINY_CLI + ["--checkpoint_dir", ck]
    outs = _spawn([["-m", "motiondiffusion_moe_tpu_torch.tools.train", *base,
                    "--coordinator_address", f"file://{tmp_path / 'rdv'}",
                    "--num_processes", "2", "--process_id", str(r),
                    "--data_parallel", "2", "--zero1"] for r in range(2)])
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    (_, out0), (_, out1) = outs
    assert "loss_total" in out0 and "2 processes over gloo" in out0
    assert "loss_total" not in out1 and "[train]" not in out1
    run_dir = os.path.join(ck, "t2m_moe_small")
    assert sorted(os.listdir(run_dir)) == ["ckpt", "config.json", "meta"]
    # 4 samples over 2 ranks of 1 row: 2 batches, cond + uncond each
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    assert ckpt.all_steps() == [4]
    payload = ckpt.read()
    assert len(payload["rng"]) == 2 and payload["epoch"] == 1
    state = train_cli.main(base)
    text = capsys.readouterr().out
    assert "resumed from step 4 (epoch 1)" in text
    assert "holds 2 ranks' generator states, this run has 1" in text
    assert state.step == 4
    for a, b in zip(state.model.state_dict().values(),
                    payload["params"].values()):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(state.optimizer.state_dict()[k],
                        payload["opt_state"][k]):
            assert torch.equal(a, b)
    for a, b in zip(state.ema.params, payload["ema_params"]["params"]):
        assert torch.equal(a, b)
