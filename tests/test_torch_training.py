"""The port's training pieces against the JAX package's, on the same seeded
inputs: the diffusion loss terms, the schedule samplers, the frame losses,
grouped clipping + Adam (against ``make_optimizer``), the learning-rate
schedules, the EMA and ``grad_clamp``.

Tolerances: f32 losses and their gradients, the same math in another
order -> rtol 1e-4 / atol 1e-5 (the VB terms pass through exp, tanh and log).
Parameters after f32 Adam updates of size ~lr = 2e-4: atol 1e-6 (f32
rounding of the moments and the update). With bf16 moments a moment that
rounds to the other neighbour moves an update by ~2**-8 of lr: atol 5e-6.
Samplers: exact. Learning rates: the port evaluates the schedule in f64,
optax in f32 -> 1e-6 of the peak lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motiondiffusion_moe_tpu.config import ExperimentConfig, TrainConfig
from motiondiffusion_moe_tpu.diffusion import gaussian as JG
from motiondiffusion_moe_tpu.diffusion import samplers as JS
from motiondiffusion_moe_tpu.models.embeddings import (
    grad_clamp as jax_grad_clamp,
)
from motiondiffusion_moe_tpu.training import losses as JL
from motiondiffusion_moe_tpu.training import train_state as JT
from motiondiffusion_moe_tpu_torch.diffusion import gaussian as TG
from motiondiffusion_moe_tpu_torch.diffusion import samplers as TS
from motiondiffusion_moe_tpu_torch.models.embeddings import grad_clamp
from motiondiffusion_moe_tpu_torch.training import losses as TL
from motiondiffusion_moe_tpu_torch.training import train_state as TT

from tests._torch_parity import t, to_port

B, T, F = 3, 6, 5


def _n(*shape, seed=0, s=1.0):
    return (s * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _close(a, b, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------- loss terms

LOSS_CASES = [
    ("epsilon", "fixed_small", "mse"), ("start_x", "fixed_small", "mse"),
    ("previous_x", "fixed_small", "mse"), ("epsilon", "fixed_large", "mse"),
    ("epsilon", "learned_range", "mse"), ("epsilon", "learned", "mse"),
    ("epsilon", "learned_range", "rescaled_mse"),
    ("epsilon", "fixed_small", "kl"), ("epsilon", "fixed_small",
                                       "rescaled_kl"),
    ("start_x", "learned_range", "kl"),
]


@pytest.mark.parametrize("mean,var,loss", LOSS_CASES)
def test_training_loss_terms_and_their_gradients(mean, var, loss):
    jsched = JG.make_schedule(schedule_name="linear", num_timesteps=100)
    tsched = TG.make_schedule(schedule_name="linear", num_timesteps=100)
    learned = var.startswith("learned")
    x0 = np.clip(_n(B, T, F, seed=1, s=0.5), -1, 1)
    noise = _n(B, T, F, seed=2)
    ts = np.array([0, 37, 99], np.int32)  # t = 0 takes the decoder NLL
    mo = _n(B, T, 2 * F if learned else F, seed=3, s=0.5)
    kw = dict(mean_type=JG.ModelMeanType(mean), var_type=JG.ModelVarType(var),
              loss_type=JG.LossType(loss))
    tkw = dict(mean_type=TG.ModelMeanType(mean),
               var_type=TG.ModelVarType(var), loss_type=TG.LossType(loss))

    def jax_terms(m):
        x_t = JG.q_sample(jsched, jnp.asarray(x0), jnp.asarray(ts),
                          jnp.asarray(noise))
        return JG.training_loss_terms(jsched, m, jnp.asarray(x0), x_t,
                                      jnp.asarray(ts), jnp.asarray(noise),
                                      **kw)

    ref = jax_terms(jnp.asarray(mo))
    jgrad = jax.grad(lambda m: jax_terms(m)["loss"].sum())(jnp.asarray(mo))
    tm = t(mo).requires_grad_()
    x_t = TG.q_sample(tsched, t(x0), t(ts).long(), t(noise))
    out = TG.training_loss_terms(tsched, tm, t(x0), x_t, t(ts).long(),
                                 t(noise), **tkw)
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k].detach().numpy(), ref[k], msg=k)
    out["loss"].sum().backward()
    # the learned-variance VB term sees a detached mean: the mean half's
    # gradient is the MSE's alone, in both. At t = 0 (row 0) the decoder NLL
    # differentiates cdf(x + 1/255) - cdf(x - 1/255) at the smallest
    # variance, where f32 cancellation leaves up to ~2% relative noise in
    # the gradient (its value is compared above at the tight tolerance)
    grad, jgrad = tm.grad.numpy(), np.asarray(jgrad)
    _close(grad[1:], jgrad[1:], msg="d loss / d model_output")
    _close(grad[0], jgrad[0], rtol=5e-2, atol=1e-3, msg="at t = 0")


def test_q_mean_variance_and_normal_kl():
    js = JG.make_schedule(num_timesteps=100)
    ts_ = TG.make_schedule(num_timesteps=100)
    x0, tt = _n(B, T, F), np.array([0, 5, 99], np.int32)
    for a, b in zip(TG.q_mean_variance(ts_, t(x0), t(tt).long()),
                    JG.q_mean_variance(js, jnp.asarray(x0), jnp.asarray(tt))):
        _close(a.numpy(), b)
    args = [_n(4, seed=i) for i in range(4)]
    _close(TG.normal_kl(*map(t, args)).numpy(),
           JG.normal_kl(*map(jnp.asarray, args)))


# ---------------------------------------------------------------- samplers

@pytest.mark.parametrize("name", ["uniform", "loss-second-moment",
                                  "adaptive-loss"])
def test_schedule_samplers_match(name):
    js = JS.create_named_schedule_sampler(name, 50)
    ts_ = TS.create_named_schedule_sampler(name, 50)
    rng = np.random.default_rng(0)
    for step in range(40):
        a = js.sample(8, np.random.default_rng(step))
        b = ts_.sample(8, np.random.default_rng(step))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], rtol=1e-6)
        if name != "uniform":
            losses = rng.random(8)
            js.update_with_local_losses(a[0], losses)
            ts_.update_with_local_losses(b[0], losses)
    np.testing.assert_allclose(js.weights(), ts_.weights(), rtol=1e-12)
    with pytest.raises(NotImplementedError):
        TS.create_named_schedule_sampler("nope", 5)


# ---------------------------------------------------------------- frame losses

def test_masked_frame_mse_with_weights_and_the_optional_losses():
    J = 4
    D = 4 + (J - 1) * 9 + J * 3 + 4
    pred, tgt = _n(B, 9, D, seed=4, s=0.3), _n(B, 9, D, seed=5, s=0.3)
    mask = (np.arange(9)[None] < np.array([9, 5, 1])[:, None]).astype(
        np.float32)
    w = np.array([1.0, 2.5, 0.5], np.float32)
    jp, jt, jm = map(jnp.asarray, (pred, tgt, mask))
    tp, tt_, tm = map(t, (pred, tgt, mask))
    _close(TL.masked_frame_mse(tp, tt_, tm, t(w)).numpy(),
           JL.masked_frame_mse(jp, jt, jm, sample_weight=jnp.asarray(w)))
    _close(TL.masked_frame_mse(tp, tt_, tm).numpy(),
           JL.masked_frame_mse(jp, jt, jm))
    for name in ("velocity_loss", "acceleration_loss", "progressive_loss"):
        _close(getattr(TL, name)(tp, tt_, tm).numpy(),
               getattr(JL, name)(jp, jt, jm), msg=name)
    _close(TL.structure_loss(tp, tt_, tm, J).numpy(),
           JL.structure_loss(jp, jt, jm, J), msg="structure")
    parents = (-1, 0, 1, 1)
    _close(TL.structure_loss(tp, tt_, tm, J, parents).numpy(),
           JL.structure_loss(jp, jt, jm, J, parents), msg="structure/parents")
    # a fully masked batch divides by max(sum, 1), not by zero
    zero = torch.zeros_like(tm)
    assert TL.masked_frame_mse(tp, tt_, zero).item() == 0.0


# ---------------------------------------------------------------- optimizer

SHAPES = {"a": (600, 512), "b": (64, 32), "c": (32,)}  # "a" is a big leaf


def _tree(seed, s=1.0):
    return {k: _n(*shape, seed=seed + i, s=s)
            for i, (k, shape) in enumerate(sorted(SHAPES.items()))}


def _cfg(**train):
    return ExperimentConfig(train=TrainConfig(**train))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("moments", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "bfloat16")])
def test_clip_and_adam_match_make_optimizer(steps, moments):
    cfg = _cfg(adam_mu_dtype=moments[0], adam_nu_dtype=moments[1])
    params = _tree(100, 0.1)
    tx = JT.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.nn.Parameter(t(params[k])) for k in sorted(SHAPES)]
    opt = TT.Optimizer(tp, to_port(cfg))
    for i in range(steps):
        # step 0: global norm ~0.3, under the clip; later steps ~3x over it
        g = _tree(200 + 10 * i, 0.001 if i == 0 else 0.01)
        norm = JT.grouped_global_norm(g)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tp, sorted(SHAPES)):
            p.grad = t(g[k])
        tnorm = opt.step()
        _close(tnorm.item(), norm, rtol=1e-5, msg="grad norm")
    atol = 1e-6 if moments == ("float32", "float32") else 5e-6
    for p, k in zip(tp, sorted(SHAPES)):
        _close(p.detach().numpy(), jp[k], rtol=0, atol=atol, msg=k)
    if moments[1] == "bfloat16":
        assert opt.nu[0].dtype == torch.bfloat16
    if moments[0] == "bfloat16":
        assert opt.mu[0].dtype == torch.bfloat16


def test_grouped_global_norm_matches_optax():
    g = _tree(7)
    _close(TT.grouped_global_norm([t(v) for v in g.values()]).item(),
           optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}),
           rtol=1e-6)


@pytest.mark.parametrize("train", [
    dict(), dict(lr_warmup_steps=5),
    dict(lr_schedule="cosine", lr_decay_steps=20),
    dict(lr_schedule="cosine", lr_warmup_steps=4, lr_decay_steps=20)])
def test_make_lr_matches(train):
    cfg = _cfg(**train)
    jl, tl = JT.make_lr(cfg), TT.make_lr(to_port(cfg))
    if not callable(jl):
        assert tl == jl
        return
    for count in range(30):
        _close(tl(count), jl(count), rtol=0, atol=1e-6 * cfg.train.lr,
               msg=str(count))


def test_make_lr_rejects_bad_settings():
    with pytest.raises(ValueError):
        TT.make_lr(to_port(_cfg(lr_schedule="cosine")))
    with pytest.raises(ValueError):
        TT.make_lr(to_port(_cfg(lr_schedule="step")))


def test_ema_tracks_params():
    model = torch.nn.Linear(3, 2)
    ema = TT.EMA(model, 0.9)
    start = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ema.update(model)
    for e, s, p in zip(ema.params, start, model.parameters()):
        torch.testing.assert_close(e, 0.9 * s + 0.1 * p.detach())


def test_grad_clamp_matches():
    x = _n(4, 5, seed=8)
    g = 3 * _n(4, 5, seed=9)
    _, vjp = jax.vjp(jax_grad_clamp, jnp.asarray(x))
    tx = t(x).requires_grad_()
    y = grad_clamp(tx)
    assert torch.equal(y, t(x))
    y.backward(t(g))
    np.testing.assert_array_equal(tx.grad.numpy(), vjp(jnp.asarray(g))[0])
    assert tx.grad.abs().max() <= 1.0
