"""Classifier guidance, the unguided DDPM loop and the bits-per-dim loop of
the port against the JAX package's, on the CPU.

The same numpy inputs go through ``motiondiffusion_moe_tpu.diffusion``
(``guidance.py``, ``sampling.py``) and the port; the loops run on a
20-step schedule respaced from the 1000-step linear one, with a toy model
and a toy classifier gradient that keep x O(1). JAX's per-step draws,
``jax.random.normal(jax.random.split(rng, T)[i])``, are recreated here and
injected into the port as ``step_noise``.

Tolerances: one step of f32 arithmetic -> 1e-6 of the output's largest
value (x0 = sqrt(1/abar) x_t - ... reaches ~1e2 at the last respaced step,
so a few of its ulps are ~1e-5 absolute); a 20-step loop compounds it ->
1e-5 of the output's largest value. ``prior_bpd`` is KL(N(sqrt(abar_T) x0,
1 - abar_T) || N(0, 1)) with abar_T ~ 4e-5: terms ~1 that cancel to
~1e-5 bits in f32, where one ulp of torch's or XLA's exp / log is already
~5e-4 of the result -> 1e-6 absolute, wherever it appears.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.diffusion import (
    ddim_sample_loop as jax_ddim_loop,
    ddpm_sample_loop as jax_ddpm_loop,
    ddpm_step as jax_ddpm_step,
    get_named_beta_schedule as jax_betas,
    make_schedule as jax_make_schedule,
    p_mean_variance as jax_pmv,
    respace_schedule as jax_respace,
    space_timesteps as jax_space,
)
from motiondiffusion_moe_tpu.diffusion import guidance as JG
from motiondiffusion_moe_tpu_torch import diffusion as D
from motiondiffusion_moe_tpu_torch.diffusion import guidance as G

from tests._torch_parity import t

B, TS, F = 3, 6, 4
STEPS = 20


def _n(seed=0, s=1.0):
    return (s * np.random.default_rng(seed).standard_normal((B, TS, F))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def scheds():
    base = jax_betas("linear", 1000)
    jsched, jmap = jax_respace(base, jax_space(1000, f"ddim{STEPS}"))
    sched, tmap = D.respace_schedule(base, D.space_timesteps(
        1000, f"ddim{STEPS}"))
    return jsched, jnp.asarray(jmap), sched, torch.from_numpy(tmap).long()


TARGET = _n(9, 0.5)


def _models():
    """(JAX, port) toy eps models and classifier gradients."""
    def jm(x, t_):
        return 0.3 * x + jnp.sin(t_.astype(jnp.float32) / 300.0
                                 )[:, None, None] * 0.2

    def tm(x, t_):
        return 0.3 * x + torch.sin(t_.float() / 300.0)[:, None, None] * 0.2

    def jc(x, t_):
        return -0.5 * (x - jnp.asarray(TARGET))

    def tc(x, t_):
        return -0.5 * (x - t(TARGET))

    return jm, tm, jc, tc


def _draws(rng, n):
    return [t(np.asarray(jax.random.normal(k, (B, TS, F))))
            for k in jax.random.split(rng, n)]


def _rel(out, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=tol * np.abs(ref).max())


def test_condition_mean_score_and_prior_bpd(scheds):
    jsched, _, sched, _ = scheds
    jm, tm, jc, tc = _models()
    x = _n(1)
    ts = np.array([0, 7, 19], np.int32)
    jout = jax_pmv(jsched, jm(jnp.asarray(x), jnp.asarray(ts)),
                   jnp.asarray(x), jnp.asarray(ts))
    out = D.p_mean_variance(sched, tm(t(x), t(ts).long()), t(x), t(ts).long())
    _rel(G.condition_mean(tc, out, t(x), t(ts).long()),
         JG.condition_mean(jc, jout, jnp.asarray(x), jnp.asarray(ts)), 1e-6)
    got = G.condition_score(sched, tc, out, t(x), t(ts).long())
    ref = JG.condition_score(jsched, jc, jout, jnp.asarray(x),
                             jnp.asarray(ts))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _rel(got[k], ref[k], 1e-6)
    x0 = np.clip(_n(2, 0.5), -1, 1)
    np.testing.assert_allclose(G.prior_bpd(sched, t(x0)).numpy(),
                               np.asarray(JG.prior_bpd(jsched,
                                                       jnp.asarray(x0))),
                               atol=1e-6)


def test_ddpm_step_with_cond_fn(scheds):
    jsched, _, sched, _ = scheds
    jm, tm, jc, tc = _models()
    x, z = _n(3), _n(4)
    ts = np.array([0, 5, 19], np.int32)
    for jcond, tcond in ((None, None), (jc, tc)):
        ref = jax_ddpm_step(jsched, jm(jnp.asarray(x), jnp.asarray(ts)),
                            jnp.asarray(x), jnp.asarray(ts), jnp.asarray(z),
                            cond_fn=jcond)
        out = D.ddpm_step(sched, tm(t(x), t(ts).long()), t(x), t(ts).long(),
                          t(z), cond_fn=tcond)
        _rel(out, ref, 1e-6)


@pytest.mark.parametrize("guided", [False, True])
def test_ddpm_sample_loop(scheds, guided):
    """The unguided DDPM loop (one forward a step, no CFG), and with a
    classifier gradient; respaced, the model sees the original timesteps."""
    jsched, jmap, sched, tmap = scheds
    jm, tm, jc, tc = _models()
    noise, rng = _n(5), jax.random.key(11)
    ref = jax.jit(lambda n, r: jax_ddpm_loop(
        jsched, jm, n, r, timestep_map=jmap,
        cond_fn=jc if guided else None))(jnp.asarray(noise), rng)
    out = D.ddpm_sample_loop(sched, tm, t(noise),
                             step_noise=_draws(rng, STEPS),
                             timestep_map=tmap,
                             cond_fn=tc if guided else None)
    _rel(out, ref)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_with_cond_fn(scheds, eta):
    jsched, jmap, sched, tmap = scheds
    jm, tm, jc, tc = _models()
    noise, rng = _n(6), jax.random.key(12)
    ref = jax.jit(lambda n, r: jax_ddim_loop(
        jsched, jm, n, r, eta=eta, timestep_map=jmap, cond_fn=jc))(
        jnp.asarray(noise), rng)
    out = D.ddim_sample_loop(sched, tm, t(noise), eta=eta,
                             step_noise=_draws(rng, STEPS),
                             timestep_map=tmap, cond_fn=tc)
    _rel(out, ref)
    unguided = D.ddim_sample_loop(sched, tm, t(noise), eta=eta,
                                  step_noise=_draws(rng, STEPS),
                                  timestep_map=tmap)
    assert not torch.allclose(out, unguided)


def test_ddim_rejects_cfg_with_cond_fn(scheds):
    _, _, sched, _ = scheds
    _, tm, _, tc = _models()
    with pytest.raises(ValueError, match="cond_fn"):
        D.ddim_sample_loop(sched, tm, t(_n()), guidance_scale=2.5,
                           cond_fn=tc)


@pytest.mark.parametrize("clip", [True, False])
def test_calc_bpd_loop(scheds, clip):
    jsched, _, sched, _ = scheds
    jm, tm, _, _ = _models()
    x0 = np.clip(_n(7, 0.5), -1, 1)
    rng = jax.random.key(13)
    ref = jax.jit(lambda x, r: JG.calc_bpd_loop(
        jsched, jm, x, r, clip_denoised=clip))(jnp.asarray(x0), rng)
    out = G.calc_bpd_loop(sched, tm, t(x0), step_noise=_draws(rng, STEPS),
                          clip_denoised=clip)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape
        if k == "prior_bpd":
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       atol=1e-6)
        else:
            _rel(out[k], ref[k])
    # a generator instead of injected draws: finite, reproducible
    a = G.calc_bpd_loop(sched, tm, t(x0),
                        generator=torch.Generator().manual_seed(0))
    b = G.calc_bpd_loop(sched, tm, t(x0),
                        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(a["total_bpd"]).all()
    assert torch.equal(a["total_bpd"], b["total_bpd"])


def test_exact_model_bpd_is_small_and_prior_dominates():
    """An eps model that knows x0 (the JAX test's exact model): every vb
    term but the decoder's is ~0 in both packages."""
    jsched = jax_make_schedule(schedule_name="linear", num_timesteps=100)
    sched = D.make_schedule(schedule_name="linear", num_timesteps=100)
    x0 = np.full((B, TS, F), 0.25, np.float32)

    def tm(x, t_):
        a = torch.sqrt(sched.alphas_cumprod[t_])[:, None, None]
        s = torch.sqrt(1 - sched.alphas_cumprod[t_])[:, None, None]
        return (x - a * 0.25) / s

    def jm(x, t_):
        a = jnp.sqrt(jsched.alphas_cumprod[t_])[:, None, None]
        s = jnp.sqrt(1 - jsched.alphas_cumprod[t_])[:, None, None]
        return (x - a * 0.25) / s

    rng = jax.random.key(1)
    ref = JG.calc_bpd_loop(jsched, jm, jnp.asarray(x0), rng)
    out = G.calc_bpd_loop(sched, tm, t(x0), step_noise=[
        t(np.asarray(jax.random.normal(k, x0.shape)))
        for k in jax.random.split(rng, 100)])
    assert float(out["vb"][:, :-1].abs().max()) < 1e-3
    np.testing.assert_allclose(out["total_bpd"].numpy(),
                               np.asarray(ref["total_bpd"]), rtol=1e-5)
