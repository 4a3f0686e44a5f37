"""Beta schedules (float64 numpy).

A copy of ``motiondiffusion_moe_tpu/diffusion/schedules.py``: the module is
pure numpy, but importing it from the JAX package runs that package's
``diffusion/__init__``, which imports JAX. Tables are computed in float64
on the host and cast to float32 when the schedule is built.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def betas_for_alpha_bar(num_diffusion_timesteps: int,
                        alpha_bar: Callable[[float], float],
                        max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha_bar(t) into betas.

    Mirrors ``gaussian_diffusion.py:44-56`` (Nichol & Dhariwal).
    """
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_named_beta_schedule(schedule_name: str,
                            num_diffusion_timesteps: int) -> np.ndarray:
    """Named schedules, semantics of ``gaussian_diffusion.py:19-68``.

    - ``linear``: Ho et al. beta_1..beta_T linear ramp, scaled so that any T
      behaves like the T=1000 reference (scale = 1000/T).
    - ``cosine``: squared-cosine alpha_bar.
    - ``sqrt``: betas = 1 - alpha^2 over a linear alpha ramp, min-max
      normalized into [1e-4, 0.02] (``gaussian_diffusion.py:42-52``).
    """
    if schedule_name == "linear":
        scale = 1000.0 / num_diffusion_timesteps
        beta_start = scale * 0.0001
        beta_end = scale * 0.02
        return np.linspace(beta_start, beta_end, num_diffusion_timesteps,
                           dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    if schedule_name == "sqrt":
        max_beta, min_beta = 0.02, 0.0001
        alphas = np.linspace(1.0, 0.0, num_diffusion_timesteps, dtype=np.float64)
        betas = 1 - alphas ** 2
        betas = (betas - betas.min()) / (betas.max() - betas.min())
        return betas * (max_beta - min_beta) + min_beta
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")
