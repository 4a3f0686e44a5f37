"""One train step of the port against the JAX package's, at a tiny width.

The JAX loss is composed from the package's public pieces as its
``loss_fn`` does (``train_state.py:290-356``): q_sample, the denoiser
forward with ``deterministic=False`` and the MoE aux losses collected,
``training_loss_terms``, the importance-weighted masked frame MSE plus the
weighted aux sum. Noise and t are injected (the two frameworks' random
streams differ); dropout is 0 and stochastic depth off, so no random draw
is left. Parameters come from one seeded flax tree through the bridge, the
gradients go back through the same bridge.

Tolerances: f32 everywhere. The loss: the same math in another order ->
rtol 1e-5. Gradients: two decoder blocks deep, reassociated -> each
gradient within 1e-4 of its own largest entry, plus 1e-7 for gradients that
are zero up to rounding (the key biases of a softmax over keys). Parameters
after the update: Adam's first step moves each by lr (2e-4) times
g / (|g| + eps), which a 1e-4 relative gradient difference moves by
~lr * 1e-4 -> atol 2e-6 where |g| >= 1e-6; where |g| nears eps only the
bound of the step itself holds -> atol 2 lr.
"""

import dataclasses

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
from motiondiffusion_moe_tpu.training.train_state import make_optimizer
from motiondiffusion_moe_tpu_torch.diffusion.gaussian import make_schedule
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from motiondiffusion_moe_tpu_torch.models.layers import TrainContext
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.models.transformer import (
    MotionTransformer,
)
from motiondiffusion_moe_tpu_torch.training.train_state import (
    TrainStep,
    create_train_state,
)

from tests._torch_parity import (
    load_into,
    random_params,
    t,
    tiny_config,
    to_port,
)

B, T = 2, 16  # one microbatch; the accumulation test takes two


def _batch():
    """Two microbatches of B."""
    rng = np.random.default_rng(21)
    return {
        "motion": rng.standard_normal((2 * B, T, 26)).astype(np.float32),
        "length": np.array([T, 11, 5, T], np.int32),
        "text_ids": hash_tokenize(["a person walks", "", "turn left twice",
                                   "jump"], 12),
        "t": np.array([3, 50, 99, 0], np.int32),
        "t_weight": np.array([1.0, 0.5, 2.0, 1.5], np.float32),
    }, rng.standard_normal((2 * B, T, 26)).astype(np.float32)


def _half(batch, noise, i):
    return ({k: v[i * B:(i + 1) * B] for k, v in batch.items()},
            noise[i * B:(i + 1) * B])


def _port_batch(b):
    return {k: t(v).long() if k in ("length", "text_ids", "t") else t(v)
            for k, v in b.items()}


def _jax_loss_fn(cfg):
    model = JaxMotionTransformer(cfg.model)
    sched = JG.make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                             num_timesteps=cfg.diffusion.num_timesteps)

    def loss(params, batch, noise):
        x0, tt = batch["motion"], batch["t"]
        x_t = JG.q_sample(sched, x0, tt, noise)
        out, cols = model.apply(
            {"params": params}, x_t, tt, batch["length"],
            text_ids=batch["text_ids"], deterministic=False,
            rngs={"dropout": jax.random.key(0),
                  "stochdepth": jax.random.key(1)},
            mutable=["moe_losses", "moe_metrics"])
        terms = JG.training_loss_terms(sched, out, x0, x_t, tt, noise)
        mask = jax_src_mask(x0.shape[1], batch["length"])
        rec = JL.masked_frame_mse(terms["pred"], terms["target"], mask,
                                  sample_weight=batch["t_weight"])
        return rec + jax_sum_aux(cols) * cfg.model.moe_aux_loss_weight

    return model, jax.jit(jax.value_and_grad(loss))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(num_layers=1)
    model, vg = _jax_loss_fn(cfg)
    batch, noise = _batch()
    params = random_params(model, batch["motion"], batch["t"],
                           batch["length"], text_ids=batch["text_ids"])
    halves = []
    for i in range(2):
        hb, hn = _half(batch, noise, i)
        halves.append(vg(params, {k: jnp.asarray(v) for k, v in hb.items()},
                         jnp.asarray(hn)))
    return cfg, params, batch, noise, halves


def _port(cfg, params):
    cfg = to_port(cfg)
    model = load_into(MotionTransformer(cfg.model), params)
    state = create_train_state(model, cfg)
    sched = make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                          num_timesteps=cfg.diffusion.num_timesteps)
    return state, TrainStep(sched, cfg)


def _check_grads(model, jax_grads):
    ref = jax_to_state_dict(jax.device_get(jax_grads))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        if not p.requires_grad:  # the frozen FAVOR projection
            assert p.grad is None and not r.any(), name
            continue
        assert p.grad is not None, name
        tol = 1e-4 * np.abs(r).max() + 1e-7
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0, atol=tol,
                                   err_msg=name)


def _apply_jax_update(cfg, params, grads):
    tx = make_optimizer(cfg)

    @jax.jit
    def update(p, g):
        return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

    return jax_to_state_dict(jax.device_get(update(params, grads)))


def _check_params(model, ref, jax_grads, lr):
    grads = jax_to_state_dict(jax.device_get(jax_grads))
    for name, p in model.named_parameters():
        err = np.abs(p.detach().numpy() - ref[name].numpy())
        large = np.abs(grads[name].numpy()) >= 1e-6
        assert (err[large] <= 2e-6).all(), name
        assert (err <= 2 * lr).all(), name


def test_loss_gradients_and_update_match_jax(setup):
    cfg, params, batch, noise, ((jloss, jgrads), _) = setup
    batch, noise = _half(batch, noise, 0)
    state, step = _port(cfg, params)
    metrics = step.backward(state, _port_batch(batch), None, noise=t(noise))
    np.testing.assert_allclose(metrics["loss_total"].item(), float(jloss),
                               rtol=1e-5)
    assert metrics["per_sample_mse"].shape == (B,)
    _check_grads(state.model, jgrads)
    metrics = step.apply_update(state, metrics)
    assert state.step == 1 and metrics["grad_norm"].item() > 0
    _check_params(state.model, _apply_jax_update(cfg, params, jgrads),
                  jgrads, cfg.train.lr)


def test_loss_and_gradients_match_jax_with_fast_xattn(monkeypatch):
    """The dropout-0 train step with ``use_fast_xattn=True`` (widths that
    are multiples of 128): the port's exact cross-attention goes through
    ``xattn_fastlayout`` and autograd of its plain version, JAX through its
    ``custom_vjp``; same loss and gradients, same tolerances as above."""
    from motiondiffusion_moe_tpu_torch.models import attention as TA

    cfg = tiny_config(num_layers=1, latent_dim=128, ff_size=128,
                      use_fast_xattn=True)
    model, vg = _jax_loss_fn(cfg)
    batch, noise = _half(*_batch(), 0)
    params = random_params(model, batch["motion"], batch["t"],
                           batch["length"], text_ids=batch["text_ids"],
                           seed=5)
    jloss, jgrads = vg(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.asarray(noise))
    calls = []
    fast = TA.xattn_fastlayout
    monkeypatch.setattr(TA, "xattn_fastlayout",
                        lambda *a: calls.append(1) or fast(*a))
    state, step = _port(cfg, params)
    metrics = step.backward(state, _port_batch(batch), None, noise=t(noise))
    assert len(calls) == 2  # one exact cross-attention per block
    np.testing.assert_allclose(metrics["loss_total"].item(), float(jloss),
                               rtol=1e-5)
    _check_grads(state.model, jgrads)


def test_gradient_accumulation_is_the_mean_of_microbatch_grads(setup):
    cfg, params, batch, noise, halves = setup
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=2))
    state, step = _port(cfg2, params)
    metrics = step.backward(state, _port_batch(batch), None, noise=t(noise))
    mean_grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                        halves[0][1], halves[1][1])
    _check_grads(state.model, mean_grads)
    np.testing.assert_allclose(
        metrics["loss_total"].item(),
        (float(halves[0][0]) + float(halves[1][0])) / 2, rtol=1e-5)
    assert metrics["per_sample_mse"].shape == (2 * B,)
    step.apply_update(state, metrics)
    _check_params(state.model, _apply_jax_update(cfg2, params, mean_grads),
                  mean_grads, cfg.train.lr)


def test_train_mode_dropout_differs_and_eval_equals_deterministic(setup):
    _, params, batch, _, _ = setup  # dropout leaves the parameters alone
    cfg = tiny_config(num_layers=1, dropout=0.1, stochastic_depth_min=0.5)
    jm = JaxMotionTransformer(cfg.model)
    ref = jax.jit(lambda p, x, tt, n, ids: jm.apply(
        {"params": p}, x, tt, n, text_ids=ids,
        mutable=["moe_losses", "moe_metrics"])[0])(
            params, *(jnp.asarray(batch[k]) for k in
                      ("motion", "t", "length", "text_ids")))
    model = load_into(MotionTransformer(to_port(cfg.model)), params)
    pb = _port_batch(batch)
    args = (pb["motion"], pb["t"], pb["length"])
    with torch.no_grad():
        evald = model(*args, text_ids=pb["text_ids"])
        np.testing.assert_allclose(evald.numpy(), np.asarray(ref), atol=1e-4)
        model.train()
        ctx = TrainContext(torch.Generator().manual_seed(0))
        a = model(*args, text_ids=pb["text_ids"], ctx=ctx)
        b = model(*args, text_ids=pb["text_ids"],
                  ctx=TrainContext(torch.Generator().manual_seed(0)))
        c = model(*args, text_ids=pb["text_ids"],
                  ctx=TrainContext(torch.Generator().manual_seed(1)))
    assert torch.equal(a, b)            # same generator, same draws
    assert not torch.allclose(a, evald)  # dropout is live in train mode
    assert not torch.allclose(a, c)
    assert len(ctx.aux_losses) == 2 * 2  # 2 blocks x 2 MoE branches
    with pytest.raises(ValueError):      # no generator, no random draw
        model(*args, text_ids=pb["text_ids"])


def test_bridge_maps_a_gradient_tree_linearly(setup):
    """The bridge's rules are re-layouts (transpose, merge, flip, reshape),
    so it maps a gradient tree as it maps parameters: bridge(a P + G) =
    a bridge(P) + bridge(G), leaf for leaf."""
    _, params, _, _, ((_, grads), _) = setup
    grads = jax.device_get(grads)
    combo = jax.tree_util.tree_map(lambda p, g: 3.0 * p + g, params, grads)
    bp, bg, bc = (jax_to_state_dict(x) for x in (params, grads, combo))
    assert bp.keys() == bg.keys() == bc.keys()
    for k in bc:
        torch.testing.assert_close(bc[k], 3.0 * bp[k] + bg[k], rtol=1e-6,
                                   atol=1e-6)
