"""Gaussian diffusion core: the coefficient tables and the posterior math.

Port of the sampling half of ``motiondiffusion_moe_tpu/diffusion/gaussian.py``
(``make_schedule``, ``q_posterior_mean_variance``, ``pred_xstart_from_eps``,
``pred_eps_from_xstart``, ``pred_xstart_from_xprev``, ``p_mean_variance``).
Tables are computed in float64 numpy and stored as float32 tensors, the JAX
package's precision split; ``t`` is a ``[B]`` integer tensor and every
coefficient is gathered as ``coef[t]`` and right-broadcast.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional

import numpy as np
import torch

from motiondiffusion_moe_tpu_torch.diffusion.schedules import (
    get_named_beta_schedule,
)


class ModelMeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType(enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep coefficient tables, [T] float32 each, on one
    device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(betas: Optional[np.ndarray] = None, *,
                  schedule_name: str = "linear", num_timesteps: int = 1000,
                  device="cpu") -> DiffusionSchedule:
    """Build the coefficient tables from betas (float64 host math)."""
    if betas is None:
        betas = get_named_beta_schedule(schedule_name, num_timesteps)
    betas = np.asarray(betas, dtype=np.float64)
    if not (betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")

    alphas = 1.0 - betas
    abar = np.cumprod(alphas, axis=0)
    abar_prev = np.append(1.0, abar[:-1])
    abar_next = np.append(abar[1:], 0.0)
    post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
    fixed_large = np.append(post_var[1], betas[1:])

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(abar),
        alphas_cumprod_prev=f32(abar_prev),
        alphas_cumprod_next=f32(abar_next),
        sqrt_alphas_cumprod=f32(np.sqrt(abar)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - abar)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - abar)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / abar)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / abar - 1)),
        posterior_variance=f32(post_var),
        # clipped: the posterior variance is 0 at t = 0
        posterior_log_variance_clipped=f32(
            np.log(np.append(post_var[1], post_var[1:]))),
        posterior_mean_coef1=f32(betas * np.sqrt(abar_prev) / (1.0 - abar)),
        posterior_mean_coef2=f32(
            (1.0 - abar_prev) * np.sqrt(alphas) / (1.0 - abar)),
        fixed_large_variance=f32(fixed_large),
        fixed_large_log_variance=f32(np.log(fixed_large)),
    )


def _extract(coef: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """coef[t], right-broadcast to ``ndim`` dims."""
    out = coef[t].float()
    return out.reshape(out.shape + (1,) * (ndim - out.dim()))


def q_posterior_mean_variance(sched: DiffusionSchedule,
                              x_start: torch.Tensor, x_t: torch.Tensor,
                              t: torch.Tensor):
    """q(x_{t-1} | x_t, x_0): (mean, variance, log_variance)."""
    nd = x_t.dim()
    mean = (_extract(sched.posterior_mean_coef1, t, nd) * x_start
            + _extract(sched.posterior_mean_coef2, t, nd) * x_t)
    return (mean, _extract(sched.posterior_variance, t, nd),
            _extract(sched.posterior_log_variance_clipped, t, nd))


def pred_xstart_from_eps(sched: DiffusionSchedule, x_t: torch.Tensor,
                         t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    nd = x_t.dim()
    return (_extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - _extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def pred_xstart_from_xprev(sched: DiffusionSchedule, x_t: torch.Tensor,
                           t: torch.Tensor,
                           xprev: torch.Tensor) -> torch.Tensor:
    nd = x_t.dim()
    c1 = _extract(1.0 / sched.posterior_mean_coef1, t, nd)
    c2 = _extract(sched.posterior_mean_coef2 / sched.posterior_mean_coef1,
                  t, nd)
    return c1 * xprev - c2 * x_t


def pred_eps_from_xstart(sched: DiffusionSchedule, x_t: torch.Tensor,
                         t: torch.Tensor, xstart: torch.Tensor) -> torch.Tensor:
    nd = x_t.dim()
    return ((_extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - xstart)
            / _extract(sched.sqrt_recipm1_alphas_cumprod, t, nd))


def p_mean_variance(sched: DiffusionSchedule, model_output: torch.Tensor,
                    x: torch.Tensor, t: torch.Tensor, *,
                    mean_type: ModelMeanType = ModelMeanType.EPSILON,
                    var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                    clip_denoised: bool = False,
                    denoised_fn: Optional[Callable] = None,
                    ) -> Dict[str, torch.Tensor]:
    """p(x_{t-1} | x_t) mean / variance / log-variance / pred_xstart from
    a raw model output (``gaussian.py:241-307``)."""
    nd = x.dim()
    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        model_output, var_values = model_output.chunk(2, dim=-1)
        if var_type == ModelVarType.LEARNED:
            model_log_variance = var_values
        else:
            min_log = _extract(sched.posterior_log_variance_clipped, t, nd)
            max_log = _extract(torch.log(sched.betas), t, nd)
            frac = (var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    elif var_type == ModelVarType.FIXED_LARGE:
        model_variance = _extract(sched.fixed_large_variance, t, nd)
        model_log_variance = _extract(sched.fixed_large_log_variance, t, nd)
    else:
        model_variance = _extract(sched.posterior_variance, t, nd)
        model_log_variance = _extract(sched.posterior_log_variance_clipped,
                                      t, nd)

    def process_xstart(x0):
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        return x0.clamp(-1.0, 1.0) if clip_denoised else x0

    if mean_type == ModelMeanType.PREVIOUS_X:
        pred_xstart = process_xstart(
            pred_xstart_from_xprev(sched, x, t, model_output))
        model_mean = model_output
    else:
        if mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
        else:
            pred_xstart = process_xstart(
                pred_xstart_from_eps(sched, x, t, model_output))
        model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return {"mean": model_mean, "variance": model_variance,
            "log_variance": model_log_variance, "pred_xstart": pred_xstart}


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor,
             t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(abar) x0 + sqrt(1 - abar) eps."""
    nd = x_start.dim()
    return (_extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise)
