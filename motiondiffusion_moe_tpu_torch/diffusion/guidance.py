"""Classifier guidance hooks and the full bits-per-dim evaluation.

Port of ``motiondiffusion_moe_tpu/diffusion/guidance.py``
(``condition_mean`` / ``condition_score``, ``prior_bpd`` /
``calc_bpd_loop``). ``cond_fn(x, t) -> gradient`` is a classifier's
log-prob gradient; the caller closes over labels or targets.

``calc_bpd_loop`` is a Python loop over t = T-1 ... 0 (the JAX package's
``lax.scan``); step i's noise comes from an explicit ``torch.Generator`` on
``x_start``'s device, or is injected as ``step_noise[i]`` so that a test
can feed both packages the same draws.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch

from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
    DiffusionSchedule,
    ModelMeanType,
    ModelVarType,
    _extract,
    mean_flat,
    normal_kl,
    pred_eps_from_xstart,
    pred_xstart_from_eps,
    q_mean_variance,
    q_posterior_mean_variance,
    q_sample,
    vb_terms_bpd,
)

CondFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def condition_mean(cond_fn: CondFn, p_mean_var: Dict[str, torch.Tensor],
                   x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The reverse step's mean shifted by variance * grad log p(y | x)."""
    return p_mean_var["mean"] + p_mean_var["variance"] * cond_fn(x, t)


def condition_score(sched: DiffusionSchedule, cond_fn: CondFn,
                    p_mean_var: Dict[str, torch.Tensor], x: torch.Tensor,
                    t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Score conditioning: eps shifted by -sqrt(1 - abar) * grad, then x0
    and the posterior mean derived again."""
    alpha_bar = _extract(sched.alphas_cumprod, t, x.dim())
    eps = pred_eps_from_xstart(sched, x, t, p_mean_var["pred_xstart"])
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, t)
    out = dict(p_mean_var)
    out["pred_xstart"] = pred_xstart_from_eps(sched, x, t, eps)
    out["mean"], _, _ = q_posterior_mean_variance(sched, out["pred_xstart"],
                                                  x, t)
    return out


def prior_bpd(sched: DiffusionSchedule, x_start: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) in bits per dim, [B]."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1,
                   dtype=torch.long, device=x_start.device)
    qt_mean, _, qt_log_variance = q_mean_variance(sched, x_start, t)
    zeros = torch.zeros_like(qt_mean)
    return mean_flat(normal_kl(qt_mean, qt_log_variance, zeros, zeros)
                     ) / math.log(2.0)


def calc_bpd_loop(sched: DiffusionSchedule,
                  model_fn: Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor],
                  x_start: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  step_noise: Optional[Sequence[torch.Tensor]] = None,
                  mean_type: ModelMeanType = ModelMeanType.EPSILON,
                  var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                  clip_denoised: bool = True) -> Dict[str, torch.Tensor]:
    """The full variational bound over every timestep: ``total_bpd`` and
    ``prior_bpd`` [B], ``vb``, ``xstart_mse`` and ``mse`` [B, T], column i
    from the loop's step i (t = T-1-i), as the JAX scan stacks them."""
    from motiondiffusion_moe_tpu_torch.diffusion.sampling import _step_noise

    B, T = x_start.shape[0], sched.num_timesteps
    vb, xstart_mse, mse = [], [], []
    for i, t_idx in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), t_idx, dtype=torch.long, device=x_start.device)
        noise = _step_noise(i, x_start, step_noise, generator)
        x_t = q_sample(sched, x_start, t, noise)
        out = vb_terms_bpd(sched, model_fn(x_t, t), x_start, x_t, t,
                           mean_type=mean_type, var_type=var_type,
                           clip_denoised=clip_denoised)
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        eps = pred_eps_from_xstart(sched, x_t, t, out["pred_xstart"])
        mse.append(mean_flat((eps - noise) ** 2))
    vb = torch.stack(vb, dim=1)
    p_bpd = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=1) + p_bpd, "prior_bpd": p_bpd,
            "vb": vb, "xstart_mse": torch.stack(xstart_mse, dim=1),
            "mse": torch.stack(mse, dim=1)}
