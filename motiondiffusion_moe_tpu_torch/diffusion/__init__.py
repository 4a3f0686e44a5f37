"""Diffusion schedules, posterior math and samplers (the JAX package's
``diffusion`` exports)."""

from motiondiffusion_moe_tpu_torch.diffusion.schedules import (  # noqa: F401
    get_named_beta_schedule,
    betas_for_alpha_bar,
)
from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (  # noqa: F401
    DiffusionSchedule,
    ModelMeanType,
    ModelVarType,
    LossType,
    make_schedule,
    q_mean_variance,
    q_sample,
    q_posterior_mean_variance,
    pred_xstart_from_eps,
    pred_eps_from_xstart,
    pred_xstart_from_xprev,
    p_mean_variance,
    training_loss_terms,
    normal_kl,
    discretized_gaussian_log_likelihood,
)
from motiondiffusion_moe_tpu_torch.diffusion.respace import (  # noqa: F401
    space_timesteps,
    respace_schedule,
)
from motiondiffusion_moe_tpu_torch.diffusion.sampling import (  # noqa: F401
    ddpm_sample_loop,
    ddim_sample_loop,
    ddpm_sample_loop_cfg,
    cfg_model_fn,
    ddpm_step,
    ddpm_cfg_step,
    ddim_step,
)
from motiondiffusion_moe_tpu_torch.diffusion.samplers import (  # noqa: F401
    create_named_schedule_sampler,
    UniformSampler,
    LossSecondMomentResampler,
    AdaptiveLossSampler,
)
