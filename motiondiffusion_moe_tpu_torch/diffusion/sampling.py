"""Sampling loops: DDPM and DDIM, with classifier-free or classifier
guidance.

Port of ``motiondiffusion_moe_tpu/diffusion/sampling.py``: the ``lax.scan``
loops become Python loops over the steps. A CFG loop does ONE forward of
the CFG-doubled batch a step (conditional rows over unconditional rows).
Guidance is applied to x0, ``x0_u + s * (x0_c - x0_u)``, the posterior mean
is recomputed from the guided x0, and the noise term uses the conditional
branch's variance (``p_sample_with_cfg``). Classifier guidance,
``cond_fn(x, t) -> grad log p(y | x)``, shifts the DDPM mean
(``guidance.condition_mean``) or the DDIM score
(``guidance.condition_score``).

Randomness: per-step noise ``z`` is drawn from an explicit
``torch.Generator`` on the noise's device, or injected as ``step_noise``
(``step_noise[i]`` is the noise of the i-th step of the loop, the first
step being t = T-1) so that a test can feed both packages the same draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
    DiffusionSchedule,
    ModelMeanType,
    ModelVarType,
    _extract,
    p_mean_variance,
    pred_eps_from_xstart,
    q_posterior_mean_variance,
)
from motiondiffusion_moe_tpu_torch.diffusion.guidance import (
    CondFn,
    condition_mean,
    condition_score,
)

# model_fn(x, t) -> model output; conditioning is closed over by the caller
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def cfg_model_fn(model_fn_doubled: ModelFn) -> Callable[
        [torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Wrap a doubled-batch model into ``(cond_out, uncond_out)``: rows
    [0, B) of its batch carry the conditional text, rows [B, 2B) the
    unconditional (empty-text) embeddings."""

    def fn(x: torch.Tensor, t: torch.Tensor):
        b = x.shape[0]
        out2 = model_fn_doubled(torch.cat([x, x]), torch.cat([t, t]))
        return out2[:b], out2[b:]

    return fn


def _map_t(timestep_map: Optional[torch.Tensor],
           t: torch.Tensor) -> torch.Tensor:
    """Respaced step index -> original-scale timestep for the model."""
    return t if timestep_map is None else timestep_map[t]


def _nonzero_mask(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return (t != 0).to(like.dtype).reshape((-1,) + (1,) * (like.dim() - 1))


def _step_noise(i: int, x: torch.Tensor,
                step_noise: Optional[Sequence[torch.Tensor]],
                generator: Optional[torch.Generator]) -> torch.Tensor:
    if step_noise is not None:
        return step_noise[i].to(x.device, x.dtype)
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def ddpm_step(sched: DiffusionSchedule, model_out: torch.Tensor,
              x: torch.Tensor, t: torch.Tensor, z: torch.Tensor, *,
              mean_type: ModelMeanType = ModelMeanType.EPSILON,
              var_type: ModelVarType = ModelVarType.FIXED_SMALL,
              clip_denoised: bool = False,
              cond_fn: Optional[CondFn] = None) -> torch.Tensor:
    """One ancestral step x_t -> x_{t-1} given the model output and noise
    z (no noise at t = 0); ``cond_fn`` shifts the mean."""
    out = p_mean_variance(sched, model_out, x, t, mean_type=mean_type,
                          var_type=var_type, clip_denoised=clip_denoised)
    if cond_fn is not None:
        out["mean"] = condition_mean(cond_fn, out, x, t)
    return out["mean"] + _nonzero_mask(t, x) * torch.exp(
        0.5 * out["log_variance"]) * z


def ddpm_cfg_step(sched: DiffusionSchedule, out_c_raw: torch.Tensor,
                  out_u_raw: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                  z: torch.Tensor, *, guidance_scale: float = 7.5,
                  mean_type: ModelMeanType = ModelMeanType.EPSILON,
                  var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                  clip_denoised: bool = False) -> torch.Tensor:
    """One CFG ancestral step x_t -> x_{t-1} given noise z."""
    kw = dict(mean_type=mean_type, var_type=var_type,
              clip_denoised=clip_denoised)
    out_c = p_mean_variance(sched, out_c_raw, x, t, **kw)
    out_u = p_mean_variance(sched, out_u_raw, x, t, **kw)
    guided_x0 = out_u["pred_xstart"] + guidance_scale * (
        out_c["pred_xstart"] - out_u["pred_xstart"])
    new_mean, _, _ = q_posterior_mean_variance(sched, guided_x0, x, t)
    return new_mean + _nonzero_mask(t, x) * torch.exp(
        0.5 * out_c["log_variance"]) * z


def ddim_step(sched: DiffusionSchedule, pred_xstart: torch.Tensor,
              x: torch.Tensor, t: torch.Tensor, z: Optional[torch.Tensor], *,
              eta: float = 0.0) -> torch.Tensor:
    """One DDIM step from a (possibly guided) pred_xstart; ``z`` may be None
    when ``eta`` is 0 (no noise term)."""
    eps = pred_eps_from_xstart(sched, x, t, pred_xstart)
    nd = x.dim()
    abar = _extract(sched.alphas_cumprod, t, nd)
    abar_prev = _extract(sched.alphas_cumprod_prev, t, nd)
    sigma = (eta * torch.sqrt((1 - abar_prev) / (1 - abar))
             * torch.sqrt(1 - abar / abar_prev))
    mean_pred = (pred_xstart * torch.sqrt(abar_prev)
                 + torch.sqrt(torch.clamp(1 - abar_prev - sigma ** 2, min=0.0))
                 * eps)
    if eta == 0.0:
        return mean_pred
    return mean_pred + _nonzero_mask(t, x) * sigma * z


def ddpm_sample_loop(sched: DiffusionSchedule, model_fn: ModelFn,
                     noise: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     step_noise: Optional[Sequence[torch.Tensor]] = None,
                     mean_type: ModelMeanType = ModelMeanType.EPSILON,
                     var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                     clip_denoised: bool = False,
                     timestep_map: Optional[torch.Tensor] = None,
                     cond_fn: Optional[CondFn] = None) -> torch.Tensor:
    """Ancestral DDPM loop without CFG, one forward of ``model_fn`` a step;
    optional classifier guidance through ``cond_fn``."""
    x = noise
    B = noise.shape[0]
    for i, t_idx in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t = torch.full((B,), t_idx, dtype=torch.long, device=x.device)
        model_out = model_fn(x, _map_t(timestep_map, t))
        z = _step_noise(i, x, step_noise, generator)
        x = ddpm_step(sched, model_out, x, t, z, mean_type=mean_type,
                      var_type=var_type, clip_denoised=clip_denoised,
                      cond_fn=cond_fn)
    return x


def ddpm_sample_loop_cfg(sched: DiffusionSchedule, model_fn_doubled: ModelFn,
                         noise: torch.Tensor, *,
                         generator: Optional[torch.Generator] = None,
                         step_noise: Optional[Sequence[torch.Tensor]] = None,
                         guidance_scale: float = 7.5,
                         mean_type: ModelMeanType = ModelMeanType.EPSILON,
                         var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                         clip_denoised: bool = False,
                         timestep_map: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """CFG DDPM loop, one doubled-batch forward per step."""
    both = cfg_model_fn(model_fn_doubled)
    x = noise
    B = noise.shape[0]
    for i, t_idx in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t = torch.full((B,), t_idx, dtype=torch.long, device=x.device)
        out_c, out_u = both(x, _map_t(timestep_map, t))
        z = _step_noise(i, x, step_noise, generator)
        x = ddpm_cfg_step(sched, out_c, out_u, x, t, z,
                          guidance_scale=guidance_scale, mean_type=mean_type,
                          var_type=var_type, clip_denoised=clip_denoised)
    return x


def ddim_sample_loop(sched: DiffusionSchedule, model_fn: ModelFn,
                     noise: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     step_noise: Optional[Sequence[torch.Tensor]] = None,
                     eta: float = 0.0,
                     guidance_scale: Optional[float] = None,
                     mean_type: ModelMeanType = ModelMeanType.EPSILON,
                     var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                     clip_denoised: bool = False,
                     timestep_map: Optional[torch.Tensor] = None,
                     cond_fn: Optional[CondFn] = None,
                     ) -> torch.Tensor:
    """DDIM loop with optional respacing (``timestep_map``), optional
    doubled-batch CFG (``guidance_scale``; ``model_fn`` is then a
    doubled-batch model) or optional classifier guidance (``cond_fn``,
    through ``condition_score``); not both kinds of guidance."""
    if guidance_scale is not None and cond_fn is not None:
        raise ValueError(
            "guidance_scale (CFG) and cond_fn (classifier guidance) are "
            "separate paths in this loop — passing both would silently "
            "drop cond_fn; apply classifier guidance inside model_fn or "
            "sample without CFG")
    both = cfg_model_fn(model_fn) if guidance_scale is not None else None
    kw = dict(mean_type=mean_type, var_type=var_type,
              clip_denoised=clip_denoised)
    x = noise
    B = noise.shape[0]
    for i, t_idx in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t = torch.full((B,), t_idx, dtype=torch.long, device=x.device)
        t_model = _map_t(timestep_map, t)
        if both is not None:
            out_c_raw, out_u_raw = both(x, t_model)
            x0_c = p_mean_variance(sched, out_c_raw, x, t, **kw)["pred_xstart"]
            x0_u = p_mean_variance(sched, out_u_raw, x, t, **kw)["pred_xstart"]
            pred_xstart = x0_u + guidance_scale * (x0_c - x0_u)
        else:
            out = p_mean_variance(sched, model_fn(x, t_model), x, t, **kw)
            if cond_fn is not None:
                out = condition_score(sched, cond_fn, out, x, t)
            pred_xstart = out["pred_xstart"]
        z = _step_noise(i, x, step_noise, generator) if eta != 0.0 else None
        x = ddim_step(sched, pred_xstart, x, t, z, eta=eta)
    return x
