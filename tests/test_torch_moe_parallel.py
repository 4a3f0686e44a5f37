"""Expert-parallel MoE training over ``torch.distributed``
(``motiondiffusion_moe_tpu_torch/parallel/{mesh,moe_parallel}.py``), on
the CPU.

Ranks run as processes over gloo (``tests/_torch_ep_worker.py``, a
``file://`` rendezvous under ``tmp_path``), spawned once per module: four
ranks for the layer and the expert-parallel steps (``ep = 4``, and ``ep =
2`` x ``dp = 2``), two for ``dispatch`` over data ranks, the checkpoints
and the errors, both started before the JAX references are computed. The
tiny widths of ``tests/_torch_parity.py::tiny_config`` (latent 64, expert
hidden 32, 4 experts, one block a scale), f32, dropout 0, t below 50 (see
``test_torch_parallel.py``), the MoE balance weight, the velocity loss and
the EMA on; the global batch of 8 rows has ragged lengths; rank r holds
rows ``[r B / W, (r + 1) B / W)``, JAX's token chunk r.

Held against the JAX package:

- the layer: ``make_ep_moe_layer`` on ``make_mesh(4, expert_parallel=ep)``
  against the port's ``make_ep_moe_layer`` on four ranks, with ample
  capacity (cf = E) and with drops (cf = 0.5, the gate skewed towards
  experts 0 and 1): the output and the gradients of x, the gate and the
  experts of ``sum(y * cot)`` within 1e-5 of their largest value (f32, the
  same math in another order, as ``test_torch_moe_compute.py``);
- bf16 routing: the port's ``dispatch`` layer under ``ep = 4`` against
  JAX's ``SwitchMoELayer(compute="dispatch", mesh=...)``, which hands the
  bf16 logits to ``ep_moe_ffn_sharded``: the port's own top-2 differs from
  JAX's at no more than 1 in 20 tokens, and routed as JAX routes, the
  output within ``assert_bf16_close``;
- the train step: one step of the port over the ranks against the JAX
  loss, ``jax.grad`` and one ``make_optimizer`` update on the global batch
  -- the one-device ``dense`` model for ``dense``, the JAX model with the
  expert mesh (``ep_moe_ffn_sharded``: the per-chunk capacity) for the
  expert-parallel ``dispatch``, the one-device ``dispatch`` model (global
  capacity) for ``dispatch`` over two data ranks. Tolerances of
  ``test_torch_parallel.py``: the loss rtol 1e-5, each gradient within
  1e-4 of its largest entry plus 1e-7. The update is held to
  ``make_optimizer``'s update of the port's own gradient (the clip's norm,
  which counts each expert once, rtol 1e-5; the parameters and the EMA
  within 2e-6; mu within 1e-5 of its largest entry): Adam's first step
  moves a parameter by about lr sign(g), so a gradient entry near zero
  whose sign the f32 summation order flips moves it by 2 lr, and the
  clip scales entries near Adam's eps, whatever the tolerance of the
  gradient.

Two controls miss the gradient tolerance by far: the expert gradients
divided by dp instead of W, and ``dispatch`` over data ranks with each
rank's own capacity where JAX's is the global batch's.
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
import optax
import pytest
import torch

from motiondiffusion_moe_tpu.diffusion import gaussian as JG
from motiondiffusion_moe_tpu.models import moe as JM
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
    generate_src_mask as jax_src_mask,
    sum_moe_aux_losses as jax_sum_aux,
)
from motiondiffusion_moe_tpu.parallel.mesh import make_mesh
from motiondiffusion_moe_tpu.parallel.moe_parallel import make_ep_moe_layer
from motiondiffusion_moe_tpu.training import losses as JL
from motiondiffusion_moe_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from motiondiffusion_moe_tpu.training.train_state import (
    TrainState as JaxTrainState,
    make_optimizer,
)
from motiondiffusion_moe_tpu_torch.diffusion.gaussian import make_schedule
from motiondiffusion_moe_tpu_torch.models import moe as TM
from motiondiffusion_moe_tpu_torch.models.bridge import (
    jax_to_state_dict,
    state_dict_to_jax,
)
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.parallel.mesh import is_expert_param
from motiondiffusion_moe_tpu_torch.models.transformer import (
    MotionTransformer,
)
from motiondiffusion_moe_tpu_torch.tools import train as train_cli
from motiondiffusion_moe_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from motiondiffusion_moe_tpu_torch.training.train_state import (
    TrainStep,
    create_train_state,
)

from tests._torch_parity import (
    assert_bf16_close,
    load_into,
    random_params,
    tiny_config,
    to_port,
)
from tests.test_torch_parallel import TINY_CLI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, F = 8, 16, 26                  # the global batch
LENGTHS = [16, 14, 12, 16, 3, 5, 9, 4]
S_LOC, D, HID, E = 20, 64, 32, 4     # the layer: tokens a rank, widths
TIGHT = 1.0                          # the steps' dispatch capacity factor
STEPS4 = {  # name: (ep, compute, zero1, control)
    "ep4_dense": (4, "dense", False, None),
    "ep2x2_dense_zero1": (2, "dense", True, None),
    "ep4_dispatch_zero1": (4, "dispatch", True, None),
    "ep2x2_dispatch": (2, "dispatch", False, None),
    "control_dp_divide": (2, "dense", False, "dp_divide")}
STEPS2 = {
    "dp2_dispatch": (1, "dispatch", False, None),
    "control_local_capacity": (1, "dispatch", False, "local_capacity"),
    "ep2_save": (2, "dense", True, None),
    "ep2_resume": (2, "dispatch", False, None)}


def _config():
    cfg = tiny_config(num_layers=1, moe_aux_loss_weight=0.1)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.9, w_velocity=0.5))


def _with(cfg, compute, cf=TIGHT):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, moe_compute=compute, moe_capacity_factor=cf))


def _batch():
    rng = np.random.default_rng(41)
    words = ["a person walks", "", "turn left twice", "jump", "wave",
             "sit down", "", "run in a circle"]
    return {
        "motion": rng.standard_normal((B, T, F)).astype(np.float32),
        "length": np.array(LENGTHS, np.int32),
        "text_ids": hash_tokenize(words, 12),
        "t": rng.integers(0, 50, B).astype(np.int32),
        "t_weight": rng.uniform(0.5, 2.0, B).astype(np.float32),
        "noise": rng.standard_normal((B, T, F)).astype(np.float32)}


def _layer_arrays(W=4):
    rng = np.random.default_rng(43)
    jmod = JM.SwitchMoELayer(latent_dim=D, hidden_dim=HID, num_experts=E)
    x = rng.standard_normal((W * S_LOC, D)).astype(np.float32)
    p = random_params(jmod, x, seed=5)
    # skewed towards experts 0 and 1, so that cf = 0.5 drops
    gate_b = p["gate"]["bias"] + np.array([1.0, 0.6, 0.0, -0.5], np.float32)
    out = {"x": x, "cot": rng.standard_normal(x.shape),
           "gate_w": p["gate"]["kernel"], "gate_b": gate_b,
           **{k: p[k] for k in ("w1", "b1", "w2", "b2")}}
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _flax_layer_params(a):
    return {"gate": {"kernel": a["gate_w"], "bias": a["gate_b"]},
            **{k: a[k] for k in ("w1", "b1", "w2", "b2")}}


def _start(argvs):
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


def _spawn(argvs, timeout=300):
    return _wait(_start(argvs), timeout)


def _job(root, name, world, cases, spec):
    spec = dict(spec, init=f"file://{root / f'rdv_{name}'}", world=world,
                cases=cases, out=str(root))
    path = root / f"{name}.json"
    with open(path, "w") as f:
        json.dump(spec, f)
    return _start([["-m", "tests._torch_ep_worker", str(path), str(r)]
                   for r in range(world)])


def _step_cases(steps, **extra):
    return [dict(kind="step", name=n, ep=ep, compute=c, zero1=z,
                 cf=TIGHT, control=ctl, **extra.get(n, {}))
            for n, (ep, c, z, ctl) in steps.items()]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both jobs started, the JAX references computed meanwhile, then the
    jobs' results."""
    root = tmp_path_factory.mktemp("ep")
    cfg = _config()
    batch = _batch()
    params = random_params(JaxMotionTransformer(cfg.model), batch["motion"],
                           batch["t"], batch["length"],
                           text_ids=batch["text_ids"])
    torch.save(jax_to_state_dict(params), root / "params.pt")
    np.savez(root / "batch.npz", **batch)
    layer = _layer_arrays()
    jp = _flax_layer_params(layer)
    top2 = _jax_bf16_top2(jp, layer["x"])
    np.savez(root / "layer.npz", **layer, top2=top2)
    torch.save(load_into(TM.SwitchMoELayer(D, HID, E, 2), jp).state_dict(),
               root / "layer_sd.pt")
    resume = _one_process_save(cfg, params, batch, root / "w1")
    base = {"cfg": to_port(cfg).to_dict(), "state_dict": str(
        root / "params.pt"), "batch": str(root / "batch.npz"),
        "layer": str(root / "layer.npz"), "layer_sd": str(
            root / "layer_sd.pt"), "resume": resume}
    layers = [dict(kind="layer", name=f"layer_ep{ep}_{tag}", ep=ep, cf=cf)
              for ep in (4, 2) for tag, cf in (("ample", float(E)),
                                                ("tight", 0.5))]
    layers.append(dict(kind="bf16", name="bf16_ep4", ep=4, cf=float(E)))
    job4 = _job(root, "four", 4, layers + _step_cases(STEPS4), base)
    job2 = _job(root, "two", 2, _step_cases(
        STEPS2, ep2_save={"save": True}, ep2_resume={"resume": True})
        + [dict(kind="units", ep=2)], base)
    refs = {"layer": {(ep, cf): _jax_layer(ep, cf, layer)
                      for ep in (4, 2) for cf in (float(E), 0.5)},
            "bf16": _jax_bf16_layer(jp, layer["x"])}
    refs["dense"] = _jax_step(_with(cfg, "dense"), params, batch)
    for ep in (4, 2):
        mesh = make_mesh(4, expert_parallel=ep)
        refs[("dispatch", ep)] = _jax_step(_with(cfg, "dispatch"), params,
                                           batch, mesh)
    refs["dispatch_global"] = _jax_step(_with(cfg, "dispatch"), params,
                                        batch)
    outs = _wait(job4 + job2)
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    names = ([c["name"] for c in layers] + list(STEPS4) + list(STEPS2)
             + ["units"])
    got = {n: torch.load(root / f"{n}.pt", weights_only=False)
           for n in names}
    return dict(cfg=cfg, params=params, batch=batch, got=got, refs=refs,
                root=root)


# --------------------------------------------------------- JAX references

def _jax_layer(ep, cf, a):
    """JAX's EP layer on the CPU mesh: the output and the gradients of
    ``sum(y * cot)``."""
    mesh = make_mesh(4, expert_parallel=ep)
    layer = make_ep_moe_layer(mesh, num_experts=E, top_k=2,
                              capacity_factor=cf)
    p = {k: jnp.asarray(a[k]) for k in ("gate_w", "gate_b", "w1", "b1",
                                        "w2", "b2")}
    with mesh:
        y, vjp = jax.vjp(layer, jnp.asarray(a["x"]), p)
        dx, dp = vjp(jnp.asarray(a["cot"]))
    out = {"y": y, "dx": dx, **{"d" + k: v for k, v in dp.items()}}
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_ep_moe(dtype):
    return JM.SwitchMoELayer(latent_dim=D, hidden_dim=HID, num_experts=E,
                             capacity_factor=float(E), compute="dispatch",
                             mesh=make_mesh(4, expert_parallel=4),
                             dtype=dtype)


def _jax_bf16_top2(p, x):
    """JAX's expert-parallel routing in bf16: top-2 of the bf16 logits it
    hands to the shard_map body."""
    jmod = _jax_ep_moe(jnp.bfloat16)
    with jmod.mesh:
        _, state = jax.jit(lambda p_, a: jmod.apply(
            {"params": p_}, a,
            capture_intermediates=lambda m, _: m.name == "gate",
            mutable=["moe_metrics", "moe_losses", "intermediates"]))(p, x)
    logits = state["intermediates"]["gate"]["__call__"][0]
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, 2)[1])


def _jax_bf16_layer(p, x):
    jmod = _jax_ep_moe(jnp.bfloat16)
    with jmod.mesh:
        out, _ = jax.jit(lambda p_, a: jmod.apply(
            {"params": p_}, a, mutable=["moe_metrics", "moe_losses"]))(p, x)
    return np.asarray(out.astype(jnp.float32))


def _jax_step(cfg, params, batch, mesh=None):
    """The JAX loss (importance-weighted masked MSE, the MoE balance term,
    the velocity loss), its gradient and one ``make_optimizer`` update on
    the global batch; the MoE layers on ``mesh`` when given."""
    model = JaxMotionTransformer(cfg.model, mesh=mesh)
    sched = JG.make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                             num_timesteps=cfg.diffusion.num_timesteps)

    def loss(p, b, noise):
        x0, tt = b["motion"], b["t"]
        x_t = JG.q_sample(sched, x0, tt, noise)
        out, cols = model.apply(
            {"params": p}, x_t, tt, b["length"], text_ids=b["text_ids"],
            deterministic=False, rngs={"dropout": jax.random.key(0),
                                       "stochdepth": jax.random.key(1)},
            mutable=["moe_losses", "moe_metrics"])
        terms = JG.training_loss_terms(sched, out, x0, x_t, tt, noise)
        mask = jax_src_mask(x0.shape[1], b["length"])
        rec = JL.masked_frame_mse(terms["pred"], terms["target"], mask,
                                  sample_weight=b["t_weight"])
        x0_pred = JG.pred_xstart_from_eps(sched, x_t, tt, terms["pred"])
        vel = JL.velocity_loss(x0_pred, x0, mask)
        return (rec + jax_sum_aux(cols) * cfg.model.moe_aux_loss_weight
                + cfg.train.w_velocity * vel)

    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "noise"}
    vg = jax.jit(jax.value_and_grad(loss))
    if mesh is None:
        value, grads = vg(params, b, jnp.asarray(batch["noise"]))
    else:
        with mesh:
            value, grads = vg(params, b, jnp.asarray(batch["noise"]))
    return float(value), jax_to_state_dict(jax.device_get(grads))


_UPDATES = {}  # one jitted update per TrainConfig


def _jax_update(cfg, params, grads):
    """One ``make_optimizer`` update of ``params`` from the port's
    gradients ``grads`` (a state dict): the new parameters, mu and the
    norm of the clip."""
    key = repr(cfg.train)
    if key not in _UPDATES:
        tx = make_optimizer(cfg)

        @jax.jit
        def update(p, g):
            upd, state = tx.update(g, tx.init(p), p)
            return (optax.apply_updates(p, upd), state[1][0].mu,
                    optax.global_norm(g))

        _UPDATES[key] = update
    new, mu, norm = _UPDATES[key](params, state_dict_to_jax(
        grads, to_port(cfg)))
    return (jax_to_state_dict(jax.device_get(new)),
            jax_to_state_dict(jax.device_get(mu)), float(norm))


def _one_process_save(cfg, params, batch, path):
    """The port's one-process state after one ``dispatch`` step on the
    global batch, saved (the port's format) for the ``ep = 2`` resume."""
    pcfg = to_port(_with(cfg, "dispatch"))
    model = MotionTransformer(pcfg.model)
    model.load_state_dict(jax_to_state_dict(params))
    state = create_train_state(model, pcfg)
    step = TrainStep(make_schedule(
        schedule_name=pcfg.diffusion.beta_schedule,
        num_timesteps=pcfg.diffusion.num_timesteps), pcfg)
    b = {k: torch.from_numpy(v) for k, v in batch.items() if k != "noise"}
    for k in ("length", "text_ids", "t"):
        b[k] = b[k].long()
    step.apply_update(state, step.backward(
        state, b, None, noise=torch.from_numpy(batch["noise"])))
    CheckpointManager(str(path), cfg=pcfg).save(state.step, state, 0)
    return str(path)


# ------------------------------------------------------------ tolerances

def _grad_excess(grads, ref) -> float:
    """The largest gradient error over its tolerance (<= 1 passes)."""
    worst = 0.0
    for name, r in ref.items():
        r = np.asarray(r, np.float64)
        tol = 1e-4 * np.abs(r).max() + 1e-7
        err = np.abs(np.asarray(grads[name], np.float64) - r).max()
        worst = max(worst, err / tol)
    return worst


def _trainable(ref):
    return {n: g for n, g in ref.items() if "fa_projection" not in n}


def _names(cfg):
    """The parameters in the model's order (the EMA's and the moments')."""
    with torch.device("meta"):
        return [n for n, _ in MotionTransformer(
            to_port(cfg).model).named_parameters()]


def _assert_step(run, name, ref):
    """One step over the ranks against the JAX step ``ref`` (loss and
    gradient); the update against ``make_optimizer``'s of the same
    gradient: grad_norm rtol 1e-5, the parameters and the EMA within 2e-6,
    mu within 1e-5 of its largest entry."""
    got, cfg = run["got"][name], run["cfg"]
    loss, grads = ref
    np.testing.assert_allclose(got["metrics"]["loss_total"], loss, rtol=1e-5)
    assert _grad_excess(got["grads"], _trainable(grads)) <= 1
    new, mu, norm = _jax_update(cfg, run["params"], got["grads"])
    np.testing.assert_allclose(got["metrics"]["grad_norm"], norm, rtol=1e-5)
    names = _names(cfg)
    p0 = jax_to_state_dict(run["params"])
    for what, tensors, want in (
            ("params", got["params"], new),
            ("ema", dict(zip(names, got["ema"])),
             {n: 0.9 * p0[n] + 0.1 * new[n] for n in names})):
        for n in names:
            err = float((tensors[n].cpu() - want[n]).abs().max())
            assert err <= 2e-6, (what, n, err)
    for n, m in zip([n for n in names if "fa_projection" not in n],
                    got["opt"]["mu"]):
        tol = 1e-5 * float(mu[n].abs().max()) + 1e-12
        assert float((m.cpu() - mu[n]).abs().max()) <= tol, ("mu", n)


# --------------------------------------------------------------- the layer

@pytest.mark.parametrize("cf", ["ample", "tight"])
@pytest.mark.parametrize("ep", [4, 2])
def test_ep_layer_matches_jax_make_ep_moe_layer(run, ep, cf):
    """The output and every gradient within 1e-5 of the largest value; the
    experts a rank does not hold get no gradient on it; at cf = 0.5 the
    layer drops (its output differs from the ample one)."""
    got = run["got"][f"layer_ep{ep}_{cf}"]
    ref = run["refs"]["layer"][(ep, float(E) if cf == "ample" else 0.5)]
    for k in ("y", "dx", "dgate_w", "dgate_b", "dw1", "db1", "dw2", "db2"):
        r = ref[k]
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=k)
        assert np.abs(r).max() > 0, k
    assert all(got[f"unheld_{k}"] == 0 for k in ("w1", "b1", "w2", "b2"))
    if cf == "tight":
        ample = run["refs"]["layer"][(ep, float(E))]["y"]
        assert np.abs(ample - got["y"].numpy()).max() > 1e-2


def test_ep_layer_bf16_routes_as_jax_ep_moe_ffn_sharded(run):
    got = run["got"]["bf16_ep4"]
    print(f"bf16 ep = 4: the port's own top-2 differs from JAX's at "
          f"{got['flips']} of {4 * S_LOC} tokens")
    assert got["flips"] <= 4 * S_LOC // 20
    assert got["held"] == E // 4
    assert_bf16_close(got["y"].numpy(), run["refs"]["bf16"])


# -------------------------------------------------------------- the steps

@pytest.mark.parametrize("name", [n for n, v in STEPS4.items()
                                  if v[3] is None])
def test_expert_parallel_step_matches_jax(run, name):
    ep, compute = STEPS4[name][:2]
    ref = run["refs"]["dense" if compute == "dense" else ("dispatch", ep)]
    _assert_step(run, name, ref)
    drops = run["got"][name]["drops"]
    if compute == "dispatch":  # every rank drops pairs at this capacity
        assert all(d["dropped"] > 0 for d in drops), drops


def test_expert_parallel_ranks_hold_their_experts(run):
    """Each rank holds 1/ep of the expert elements, and of the moments and
    the EMA at most its share (ZeRO-1 over the data group as well)."""
    with torch.device("meta"):
        model = MotionTransformer(to_port(run["cfg"]).model)
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if is_expert_param(n))
    every = sum(p.numel() for p in model.parameters())
    for name, (ep, _, zero1, _) in STEPS4.items():
        for held in run["got"][name]["held"]:
            assert held["experts"] * ep == experts, (name, held)
            local = every - experts + experts // ep
            if zero1:
                assert held["ema"] <= -(-local // (4 // ep)) + 2 * E, held
            else:
                assert held["ema"] == local, (name, held)


def test_dispatch_over_two_data_ranks_takes_the_global_capacity(run):
    _assert_step(run, "dp2_dispatch", run["refs"]["dispatch_global"])
    drops = run["got"]["dp2_dispatch"]["drops"]
    assert all(d["dropped"] > 0 for d in drops), drops


def test_ep2_dense_zero1_step_matches_jax(run):
    _assert_step(run, "ep2_save", run["refs"]["dense"])


@pytest.mark.parametrize("name,ref", [
    ("control_dp_divide", "dense"),
    ("control_local_capacity", "dispatch_global")])
def test_controls_miss_the_jax_gradient(run, name, ref):
    """Expert gradients divided by dp (not W), and each rank's own capacity
    where JAX's spans the global batch: both miss by far."""
    _, grads = run["refs"][ref]
    assert _grad_excess(run["got"][name]["grads"], _trainable(grads)) > 10


# ---------------------------------------------------------- checkpoints

@pytest.mark.parametrize("fmt", ["torch", "orbax"])
def test_an_ep2_save_is_global_and_resumes_at_ep2_and_in_one_process(
        run, fmt):
    got = run["got"]["ep2_save"]
    assert got["saved"][fmt] == [True, True]
    root, cfg = run["root"], to_port(run["cfg"])
    payload = CheckpointManager(str(root / f"ckpt_{fmt}"), cfg=cfg).read()
    for n, v in got["params"].items():
        assert torch.equal(payload["params"][n], v.cpu()), n
        assert payload["params"][n].shape == v.shape
    model = MotionTransformer(cfg.model)
    state = create_train_state(model, cfg)
    _, epoch, rng = CheckpointManager(str(root / f"ckpt_{fmt}"),
                                      cfg=cfg).restore_with_rng(state)
    assert state.step == 1 and epoch == 0 and len(rng) == 2
    for a, b in zip(model.state_dict().values(), got["params"].values()):
        assert torch.equal(a, b.cpu())
    for k in ("mu", "nu"):
        for a, b in zip(state.optimizer.mu if k == "mu"
                        else state.optimizer.nu, got["opt"][k]):
            assert torch.equal(a, b.cpu()), k
    for a, b in zip(state.ema.params, got["ema"]):
        assert torch.equal(a, b.cpu())


def test_the_jax_manager_restores_the_ep2_save(run):
    cfg = run["cfg"]
    b = run["batch"]
    shapes = jax.eval_shape(lambda: JaxMotionTransformer(cfg.model).init(
        jax.random.key(0), b["motion"], b["t"], b["length"],
        text_ids=b["text_ids"]))
    params = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                                    shapes)
    tx = make_optimizer(cfg)
    template = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                             opt_state=tx.init(params), tx=tx,
                             ema_params={"params": params["params"]})
    jstate, epoch, _ = JaxCheckpointManager(str(
        run["root"] / "ckpt_orbax")).restore_with_rng(template)
    assert int(jstate.step) == 1 and epoch == 0
    got = run["got"]["ep2_save"]
    sd = jax_to_state_dict(jax.device_get(jstate.params["params"]))
    for n, v in got["params"].items():
        assert torch.equal(sd[n], v.cpu()), n
    names = [n for n in _names(cfg) if "fa_projection" not in n]
    mu = jax_to_state_dict(jax.device_get(
        jstate.opt_state[1][0].mu["params"]))
    for n, v in zip(names, got["opt"]["mu"]):
        assert torch.equal(mu[n], v.cpu()), n
    assert sd["blocks_high.0.ffn.branch_0_moe.w1"].shape[0] == E


def test_a_one_process_save_resumes_at_ep2(run):
    assert run["got"]["ep2_resume"]["resumed"] == [True, True]


# ------------------------------------------------------------ errors, CLI

@pytest.mark.parametrize("name,kind,words", [
    ("experts", "ValueError", "num_experts 3 not divisible by 2"),
    ("data_partitions", "ValueError", "2 processes over 2 expert"),
    ("caller_dense_fused", "ValueError", "dense_fused"),
    ("tensor", "ValueError", "launch a multiple of 4 processes")])
def test_expert_parallel_errors(run, name, kind, words):
    err = run["got"]["units"][name]
    assert err is not None and err[0] == kind and words in err[1], err


def test_dense_fused_becomes_dense_under_an_expert_axis(run):
    assert run["got"]["units"]["dense_fused_became"] == "dense"


def test_train_cli_expert_parallel_as_two_processes_then_one_resumes(
        tmp_path, capsys):
    ck = str(tmp_path / "runs")
    base = TINY_CLI + ["--checkpoint_dir", ck]
    outs = _spawn([["-m", "motiondiffusion_moe_tpu_torch.tools.train", *base,
                    "--coordinator_address", f"file://{tmp_path / 'rdv'}",
                    "--num_processes", "2", "--process_id", str(r),
                    "--expert_parallel", "2", "--zero1"] for r in range(2)])
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    assert "loss_total" in outs[0][1] and "loss_total" not in outs[1][1]
    run_dir = os.path.join(ck, "t2m_moe_small")
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    assert ckpt.all_steps() == [4]
    payload = ckpt.read()
    w1 = payload["params"]["blocks_high.0.ffn.branch_0_moe.w1"]
    assert w1.shape[0] == 4  # the global layout, every expert
    state = train_cli.main(base)
    assert "resumed from step 4 (epoch 1)" in capsys.readouterr().out
    for a, b in zip(state.model.state_dict().values(),
                    payload["params"].values()):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(state.optimizer.state_dict()[k],
                        payload["opt_state"][k]):
            assert torch.equal(a, b)

