"""Timestep respacing (strided DDIM).

Port of ``motiondiffusion_moe_tpu/diffusion/respace.py`` (host-side numpy
apart from the schedule it builds): select a subset of timesteps, rebuild
betas from the cumulative-alpha ratios at those steps, and keep a
``timestep_map`` so the model is still conditioned on original-scale t.
"""

from __future__ import annotations

from typing import Iterable, List, Set, Tuple, Union

import numpy as np

from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
    DiffusionSchedule,
    make_schedule,
)


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Iterable[int]]) -> Set[int]:
    """Choose which original timesteps to keep.

    Accepts ``"ddimN"`` for the fixed-stride DDIM spacing, an int-list for
    per-section counts, or ``"N"`` for a single section (standard
    improved-diffusion semantics).
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    section_counts = list(section_counts)  # once: input may be a generator
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: List[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        if section_count <= 1:
            frac_stride = 1.0
        else:
            frac_stride = (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


def respace_schedule(base_betas: np.ndarray,
                     use_timesteps: Iterable[int], device="cpu"
                     ) -> Tuple[DiffusionSchedule, np.ndarray]:
    """Build a respaced schedule plus the timestep map.

    Returns ``(schedule, timestep_map)`` where ``schedule`` has
    ``len(use_timesteps)`` steps and ``timestep_map[i]`` is the original
    timestep index the i-th respaced step corresponds to — pass
    ``timestep_map[t]`` to the model so its time conditioning stays on the
    original 0..T-1 scale.
    """
    base_betas = np.asarray(base_betas, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - base_betas, axis=0)

    timestep_map: List[int] = []
    new_betas: List[float] = []
    last_alpha_cumprod = 1.0
    use = set(use_timesteps)  # once: a generator would drain on i=0
    for i, alpha_cumprod in enumerate(alphas_cumprod):
        if i in use:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return (make_schedule(np.array(new_betas, dtype=np.float64),
                          device=device),
            np.array(timestep_map, dtype=np.int32))
