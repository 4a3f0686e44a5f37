"""DPM-Solver++(2M): multistep second-order ODE sampling in x0 form.

Port of ``motiondiffusion_moe_tpu/diffusion/dpm_solver.py``. With
alpha_t = sqrt(abar_t), sigma_t = sqrt(1 - abar_t),
lambda_t = log(alpha_t / sigma_t), step i:

    h_i = lambda_i - lambda_{i-1},   r_i = h_{i-1} / h_i
    D_i = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}
    x_i = (sigma_i / sigma_{i-1}) x_{i-1} - alpha_i (e^{-h_i} - 1) D_i

The first step (no history) is first order (DDIM, eta = 0). The per-step
scalars are computed once, in f32 as in the JAX package, and applied as
Python numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
    DiffusionSchedule,
    ModelMeanType,
    ModelVarType,
    p_mean_variance,
)
from motiondiffusion_moe_tpu_torch.diffusion.sampling import (
    ModelFn,
    cfg_model_fn,
)


def dpm_solver_timesteps(num_train_steps: int, num_steps: int) -> np.ndarray:
    """Uniform-in-t step selection t_0 = T-1 > ... > t_N = 0."""
    return np.linspace(num_train_steps - 1, 0, num_steps + 1).round().astype(
        np.int32)


def dpm_solver_pp_2m(sched: DiffusionSchedule, model_fn: ModelFn,
                     noise: torch.Tensor, *, num_steps: int = 10,
                     guidance_scale: Optional[float] = None,
                     mean_type: ModelMeanType = ModelMeanType.EPSILON,
                     var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                     clip_denoised: bool = False,
                     denoise_final: bool = True) -> torch.Tensor:
    """Sample with DPM-Solver++(2M); ``model_fn`` is a doubled-batch model
    when ``guidance_scale`` is set (CFG on x0, as in the DDIM loop).
    ``denoise_final`` adds one last x0 prediction at t = 0 (num_steps + 1
    model calls in all)."""
    B = noise.shape[0]
    ts = dpm_solver_timesteps(sched.num_timesteps, num_steps)
    abar = sched.alphas_cumprod.detach().float().cpu()
    alpha = torch.sqrt(abar)
    sigma = torch.sqrt(1.0 - abar)
    lam = (torch.log(alpha) - torch.log(sigma)).tolist()
    alpha, sigma = alpha.tolist(), sigma.tolist()
    f32 = np.float32
    both = cfg_model_fn(model_fn) if guidance_scale is not None else None
    kw = dict(mean_type=mean_type, var_type=var_type,
              clip_denoised=clip_denoised)

    def pred_x0(x, t_idx):
        t = torch.full((B,), int(t_idx), dtype=torch.long, device=x.device)
        if both is None:
            return p_mean_variance(sched, model_fn(x, t), x, t,
                                   **kw)["pred_xstart"]
        out_c, out_u = both(x, t)
        x0_c = p_mean_variance(sched, out_c, x, t, **kw)["pred_xstart"]
        x0_u = p_mean_variance(sched, out_u, x, t, **kw)["pred_xstart"]
        return x0_u + guidance_scale * (x0_c - x0_u)

    x, x0_prev, h_prev = noise, None, None
    for i in range(num_steps):
        t_prev, t_cur = ts[i], ts[i + 1]
        x0 = pred_x0(x, t_prev)
        h = f32(lam[t_cur]) - f32(lam[t_prev])
        sig_ratio = f32(sigma[t_cur]) / f32(sigma[t_prev])
        coef = f32(alpha[t_cur]) * (np.exp(-h) - f32(1.0))
        if x0_prev is None:
            d = x0
        else:
            c = f32(1.0) / (f32(2.0) * (h_prev / h))
            d = float(f32(1.0) + c) * x0 - float(c) * x0_prev
        x = float(sig_ratio) * x - float(coef) * d
        x0_prev, h_prev = x0, h
    if denoise_final:
        x = pred_x0(x, ts[-1])
    return x
