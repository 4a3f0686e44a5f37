"""The port's diffusion core and samplers against the JAX package.

The same numpy inputs go through ``motiondiffusion_moe_tpu.diffusion`` (on
the CPU) and ``motiondiffusion_moe_tpu_torch.diffusion``; the single-step
math is also held to the reference goldens in
``tests/fixtures/diffusion_goldens.npz``, and ``recover_from_ric`` to
``tests/fixtures/motion_goldens.npz``, as the JAX package's own tests are.

Tolerances: the schedule tables are the same float64 host math cast once
to float32 -> equal to 1 ulp (rtol 1e-6). Single steps in f32 -> atol 1e-5
(the goldens' own tolerances where they are looser: 2e-4 for DDIM, 5e-3
for the CFG step, as tests/test_sampling.py). Whole sampler loops on a
toy model that keeps x O(1) -> atol 1e-4: f32 rounding compounds over
the steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.diffusion import (
    ModelMeanType as JMean,
    ModelVarType as JVar,
    ddim_sample_loop as jax_ddim_loop,
    ddim_step as jax_ddim_step,
    ddpm_sample_loop_cfg as jax_ddpm_loop_cfg,
    get_named_beta_schedule as jax_betas,
    make_schedule as jax_make_schedule,
    p_mean_variance as jax_pmv,
    respace_schedule as jax_respace,
    space_timesteps as jax_space,
)
from motiondiffusion_moe_tpu.diffusion.dpm_solver import (
    dpm_solver_pp_2m as jax_dpm,
    dpm_solver_timesteps as jax_dpm_ts,
)
from motiondiffusion_moe_tpu.motion.recover import (
    recover_from_ric as jax_recover_from_ric,
)
from motiondiffusion_moe_tpu_torch.data.normalizer import MotionNormalizer
from motiondiffusion_moe_tpu_torch.diffusion.dpm_solver import (
    dpm_solver_pp_2m,
    dpm_solver_timesteps,
)
from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
    ModelMeanType,
    ModelVarType,
    make_schedule,
    p_mean_variance,
    pred_eps_from_xstart,
    pred_xstart_from_eps,
    q_posterior_mean_variance,
    q_sample,
)
from motiondiffusion_moe_tpu_torch.diffusion.respace import (
    respace_schedule,
    space_timesteps,
)
from motiondiffusion_moe_tpu_torch.diffusion.sampling import (
    ddim_sample_loop,
    ddim_step,
    ddpm_cfg_step,
    ddpm_sample_loop_cfg,
)
from motiondiffusion_moe_tpu_torch.diffusion.schedules import (
    get_named_beta_schedule,
)
from motiondiffusion_moe_tpu_torch.motion.recover import (
    recover_from_ric,
    recover_root_rot_pos,
)

from tests._torch_parity import t

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MEAN = {"eps": ModelMeanType.EPSILON, "x0": ModelMeanType.START_X,
        "xprev": ModelMeanType.PREVIOUS_X}
VAR = {"small": ModelVarType.FIXED_SMALL, "large": ModelVarType.FIXED_LARGE}


@pytest.fixture(scope="module")
def g():
    return np.load(os.path.join(FIXTURES, "diffusion_goldens.npz"))


@pytest.fixture(scope="module")
def sched(g):
    return make_schedule(g["betas_linear"])


def _x_t(sched, g):
    return q_sample(sched, t(g["x_start"]), t(g["t"]).long(), t(g["noise"]))


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("name", ["linear", "cosine", "sqrt"])
def test_beta_schedules_match_jax_and_goldens(name, g):
    ours = get_named_beta_schedule(name, 100)
    np.testing.assert_array_equal(ours, jax_betas(name, 100))
    np.testing.assert_allclose(ours, g[f"betas_{name}"], rtol=1e-12)
    np.testing.assert_array_equal(get_named_beta_schedule(name, 1000),
                                  jax_betas(name, 1000))


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_make_schedule_tables_match_jax(name):
    ours = make_schedule(schedule_name=name, num_timesteps=1000)
    ref = jax_make_schedule(schedule_name=name, num_timesteps=1000)
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                  "alphas_cumprod_next", "sqrt_alphas_cumprod",
                  "sqrt_one_minus_alphas_cumprod",
                  "log_one_minus_alphas_cumprod",
                  "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                  "posterior_variance", "posterior_log_variance_clipped",
                  "posterior_mean_coef1", "posterior_mean_coef2"):
        a = getattr(ours, field)
        assert a.dtype == torch.float32, field
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(ref, field)),
                                   rtol=1e-6, err_msg=field)


def test_make_schedule_rejects_bad_betas():
    with pytest.raises(ValueError):
        make_schedule(np.array([0.1, 1.5]))


@pytest.mark.parametrize("spec", ["ddim50", "ddim20", "10", "5,3", [10, 10]])
def test_space_timesteps_match_jax(spec):
    assert space_timesteps(1000, spec) == jax_space(1000, spec)


@pytest.mark.parametrize("steps", [25, 50])
def test_respace_schedule_matches_jax(steps):
    base = jax_betas("linear", 1000)
    use = space_timesteps(1000, f"ddim{steps}")
    ours, tmap = respace_schedule(base, use)
    ref, ref_map = jax_respace(base, jax_space(1000, f"ddim{steps}"))
    np.testing.assert_array_equal(tmap, ref_map)
    assert ours.num_timesteps == steps
    for field in ("betas", "alphas_cumprod", "posterior_mean_coef1",
                  "posterior_mean_coef2", "posterior_log_variance_clipped"):
        np.testing.assert_allclose(getattr(ours, field).numpy(),
                                   np.asarray(getattr(ref, field)), rtol=1e-6,
                                   err_msg=field)


def test_dpm_timesteps_match_jax():
    for n in (10, 20):
        np.testing.assert_array_equal(dpm_solver_timesteps(1000, n),
                                      jax_dpm_ts(1000, n))


# ---------------------------------------------------------------- one step

@pytest.mark.parametrize("mean", list(MEAN))
@pytest.mark.parametrize("var", list(VAR))
def test_p_mean_variance_goldens_and_jax(sched, g, mean, var):
    x_t = _x_t(sched, g)
    out = p_mean_variance(sched, t(g["model_output"]), x_t,
                          t(g["t"]).long(), mean_type=MEAN[mean],
                          var_type=VAR[var])
    ref = jax_pmv(jax_make_schedule(g["betas_linear"]),
                  jnp.asarray(g["model_output"]), jnp.asarray(x_t.numpy()),
                  jnp.asarray(g["t"]), mean_type=JMean(MEAN[mean].value),
                  var_type=JVar(VAR[var].value))
    for k in ("mean", "pred_xstart"):  # x0 reaches ~1e2 at t = 99
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    key = f"{mean}_{var}"
    np.testing.assert_allclose(out["mean"].numpy(), g[f"pmv_mean_{key}"],
                               atol=1e-4)
    np.testing.assert_allclose(out["log_variance"].expand_as(
        out["mean"]).numpy(), g[f"pmv_logvar_{key}"], atol=1e-4)
    np.testing.assert_allclose(out["pred_xstart"].numpy(),
                               g[f"pmv_xstart_{key}"], atol=1e-3)


def test_q_sample_and_posterior_goldens(sched, g):
    tt = t(g["t"]).long()
    np.testing.assert_allclose(_x_t(sched, g).numpy(), g["q_sample"],
                               atol=1e-5)
    mean, var, logvar = q_posterior_mean_variance(
        sched, t(g["x_start"]), t(g["model_output"]), tt)
    np.testing.assert_allclose(mean.numpy(), g["qpost_mean"], atol=1e-5)
    np.testing.assert_allclose(var.expand_as(mean).numpy(), g["qpost_var"],
                               atol=1e-6)
    np.testing.assert_allclose(logvar.expand_as(mean).numpy(),
                               g["qpost_logvar"], atol=1e-5)


def test_eps_xstart_roundtrip(sched, g):
    tt = t(g["t"]).long()
    x_t = _x_t(sched, g)
    x0 = pred_xstart_from_eps(sched, x_t, tt, t(g["noise"]))
    np.testing.assert_allclose(pred_eps_from_xstart(sched, x_t, tt,
                                                    x0).numpy(),
                               g["noise"], atol=1e-3)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_golden(sched, g, eta):
    tt = t(g["t"]).long()
    x_t = _x_t(sched, g)
    x0 = p_mean_variance(sched, t(g["model_output"]), x_t, tt)["pred_xstart"]
    out = ddim_step(sched, x0, x_t, tt, torch.zeros_like(x_t), eta=eta)
    np.testing.assert_allclose(out.numpy(), g[f"ddim_sample_eta{eta}"],
                               atol=2e-4)
    ref = jax_ddim_step(jax_make_schedule(g["betas_linear"]),
                        jnp.asarray(x0.numpy()), jnp.asarray(x_t.numpy()),
                        jnp.asarray(g["t"]), jnp.zeros(x_t.shape), eta=eta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_cfg_step_golden(sched, g):
    """cond = model_output, uncond = 0.5 * model_output, scale 7.5, zero
    injected noise (the reference's p_sample_with_cfg)."""
    x_t = _x_t(sched, g)
    cond = t(g["model_output"])
    out = ddpm_cfg_step(sched, cond, 0.5 * cond, x_t, t(g["t"]).long(),
                        torch.zeros_like(x_t), guidance_scale=7.5)
    np.testing.assert_allclose(out.numpy(), g["cfg_sample"], atol=5e-3)


# ---------------------------------------------------------------- loops

B, TS, F = 2, 6, 5


def _toy_tables(num_timesteps):
    rng = np.random.default_rng(3)
    abar = np.cumprod(1.0 - jax_betas("linear", num_timesteps))
    # 1/sqrt(1 - abar): the eps of clean data x0 = 0, which keeps x O(1)
    inv_sigma = (1.0 / np.sqrt(1.0 - abar)).astype(np.float32)
    # different outputs for the conditional and unconditional halves
    row_off = (0.1 * rng.standard_normal((2 * B, 1, F))).astype(np.float32)
    w = (rng.standard_normal((F, F)) / np.sqrt(F)).astype(np.float32)
    return inv_sigma, row_off, w


def _toy_models(num_timesteps):
    """The same doubled-batch toy denoiser in both frameworks: the ideal
    eps of x0 = 0 plus a nonlinear term and per-row offsets."""
    inv_sigma, row_off, w = _toy_tables(num_timesteps)

    def jax_model(x2, t2):
        s = jnp.asarray(inv_sigma)[t2].reshape(-1, 1, 1)
        return (0.9 * x2 * s + 0.1 * jnp.tanh(x2 @ jnp.asarray(w))
                + jnp.asarray(row_off))

    def torch_model(x2, t2):
        s = torch.from_numpy(inv_sigma)[t2].reshape(-1, 1, 1)
        return (0.9 * x2 * s + 0.1 * torch.tanh(x2 @ torch.from_numpy(w))
                + torch.from_numpy(row_off))

    return jax_model, torch_model


def _noise(seed=0):
    return np.random.default_rng(seed).standard_normal((B, TS, F)).astype(
        np.float32)


def test_ddpm_cfg_loop_with_injected_step_noise():
    """The JAX loop draws z from jax.random.split(rng, T)[i]; the port takes
    the same draws as step_noise."""
    T_diff = 100
    jsched = jax_make_schedule(schedule_name="linear", num_timesteps=T_diff)
    sched = make_schedule(schedule_name="linear", num_timesteps=T_diff)
    jm, tm = _toy_models(T_diff)
    noise, rng = _noise(), jax.random.key(7)
    ref = jax.jit(lambda n, r: jax_ddpm_loop_cfg(
        jsched, jm, n, r, guidance_scale=2.5))(jnp.asarray(noise), rng)
    steps = [np.asarray(jax.random.normal(k, noise.shape))
             for k in jax.random.split(rng, T_diff)]
    out = ddpm_sample_loop_cfg(sched, tm, t(noise),
                               step_noise=[t(s) for s in steps],
                               guidance_scale=2.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_respaced_cfg_loop(eta):
    T_diff, n = 100, 10
    base = jax_betas("linear", T_diff)
    jsched, jmap = jax_respace(base, jax_space(T_diff, f"ddim{n}"))
    sched, tmap = respace_schedule(base, space_timesteps(T_diff, f"ddim{n}"))
    jm, tm = _toy_models(T_diff)
    noise, rng = _noise(1), jax.random.key(3)
    ref = jax.jit(lambda x, r: jax_ddim_loop(
        jsched, jm, x, r, eta=eta, guidance_scale=2.5,
        timestep_map=jnp.asarray(jmap)))(jnp.asarray(noise), rng)
    steps = [t(np.asarray(jax.random.normal(k, noise.shape)))
             for k in jax.random.split(rng, n)]
    out = ddim_sample_loop(sched, tm, t(noise), eta=eta, guidance_scale=2.5,
                           step_noise=steps,
                           timestep_map=torch.from_numpy(tmap).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_ddim_loop_without_guidance():
    T_diff = 100
    jsched = jax_make_schedule(schedule_name="linear", num_timesteps=T_diff)
    sched = make_schedule(schedule_name="linear", num_timesteps=T_diff)
    jm2, tm2 = _toy_models(T_diff)

    def jm(x, t_):  # the conditional half only
        return jm2(jnp.concatenate([x, x]), jnp.concatenate([t_, t_]))[:B]

    def tm(x, t_):
        return tm2(torch.cat([x, x]), torch.cat([t_, t_]))[:B]

    noise = _noise(2)
    ref = jax_ddim_loop(jsched, jm, jnp.asarray(noise), jax.random.key(0))
    out = ddim_sample_loop(sched, tm, t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("num_steps", [3, 20])
@pytest.mark.parametrize("clip", [False, True])
def test_dpm_solver_pp_2m_cfg(num_steps, clip):
    T_diff = 1000
    jsched = jax_make_schedule(schedule_name="linear", num_timesteps=T_diff)
    sched = make_schedule(schedule_name="linear", num_timesteps=T_diff)
    jm, tm = _toy_models(T_diff)
    noise = _noise(4)
    ref = jax.jit(lambda x: jax_dpm(jsched, jm, x, num_steps=num_steps,
                                    guidance_scale=2.5,
                                    clip_denoised=clip))(jnp.asarray(noise))
    out = dpm_solver_pp_2m(sched, tm, t(noise), num_steps=num_steps,
                           guidance_scale=2.5, clip_denoised=clip)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_dpm_solver_counts_forwards():
    calls = []
    sched = make_schedule(schedule_name="linear", num_timesteps=1000)
    _, tm = _toy_models(1000)

    def counted(x2, t2):
        calls.append(x2.shape[0])
        return tm(x2, t2)

    dpm_solver_pp_2m(sched, counted, t(_noise()), num_steps=20,
                     guidance_scale=2.5)
    assert calls == [2 * B] * 21  # 20 steps + the final denoise, CFG-doubled


def test_generator_draws_are_reproducible():
    sched = make_schedule(schedule_name="linear", num_timesteps=100)
    _, tm = _toy_models(100)

    def run(seed):
        return ddpm_sample_loop_cfg(
            sched, tm, t(_noise()), guidance_scale=2.5,
            generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(5), run(5)) and not torch.equal(run(5), run(6))


# ---------------------------------------------------------------- motion

@pytest.fixture(scope="module")
def mg():
    return np.load(os.path.join(FIXTURES, "motion_goldens.npz"))


def test_recover_root_rot_pos_golden(mg):
    rq, rp = recover_root_rot_pos(t(mg["feats_t2m"]))
    np.testing.assert_allclose(rq.numpy(), mg["root_quat"], atol=1e-5)
    np.testing.assert_allclose(rp.numpy(), mg["root_pos"], atol=1e-5)


def test_recover_from_ric_golden_and_jax(mg):
    joints = recover_from_ric(t(mg["feats_t2m"]), 22)
    assert joints.shape == (2, 16, 22, 3)
    np.testing.assert_allclose(joints.numpy(), mg["ric_joints"], atol=1e-5)
    ref = jax_recover_from_ric(jnp.asarray(mg["feats_t2m"]), 22)
    np.testing.assert_allclose(joints.numpy(), np.asarray(ref), atol=1e-5)
    # unbatched input: one sequence at a time gives the same joints
    np.testing.assert_allclose(recover_from_ric(t(mg["feats_t2m"][1]),
                                                22).numpy(),
                               mg["ric_joints"][1], atol=1e-5)


def test_normalizer_roundtrip_and_feat_bias():
    from motiondiffusion_moe_tpu.data.normalizer import (
        MotionNormalizer as JaxNormalizer,
    )

    rng = np.random.default_rng(0)
    motions = rng.standard_normal((50, 263)).astype(np.float32)
    ours = MotionNormalizer.fit(motions, 22)
    ref = JaxNormalizer.fit(motions, 22)
    np.testing.assert_allclose(ours.std, ref.std, rtol=1e-6)
    np.testing.assert_allclose(ours.mean, ref.mean, rtol=1e-6)
    x = motions[:7]
    np.testing.assert_allclose(ours.denormalize_np(ours.normalize_np(x)), x,
                               atol=1e-5)
    np.testing.assert_allclose(
        ours.denormalize(t(ours.normalize_np(x))).numpy(), x, atol=1e-5)
    ident = MotionNormalizer.identity(263)
    assert np.array_equal(ident.denormalize_np(x), x)
    with pytest.raises(ValueError):
        MotionNormalizer.fit(motions[:, :100], 22)
