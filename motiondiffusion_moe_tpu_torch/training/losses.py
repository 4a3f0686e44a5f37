"""Training losses.

Port of ``motiondiffusion_moe_tpu/training/losses.py``: the reference's
masked per-frame MSE (with schedule-sampler importance weights) and the
four optional losses on the predicted x0 (velocity, acceleration, bone-length
structure through the port's ``recover_from_ric``, multi-scale progressive).

Each loss is a masked mean, or the mean of several (the progressive
loss's scales). Its ``*_sums`` form returns the numerator and denominator
of each (:data:`Sums`): a data-parallel step adds the denominators over
the ranks before it divides (``train_state.py::TrainStep``), since the mean
of the ranks' own means is not the global batch's where their masks hold
different numbers of frames.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from motiondiffusion_moe_tpu_torch.motion.recover import recover_from_ric

# a masked mean's numerator (the masked sum) and denominator (the mask's)
Sums = Tuple[torch.Tensor, torch.Tensor]


def mean_of(sums: List[Sums], scale=1) -> torch.Tensor:
    """The mean over ``sums`` of num x scale / max(den, 1)."""
    loss = 0.0
    for num, den in sums:
        loss = loss + num * scale / den.clamp(min=1.0)
    return loss / len(sums)


def _masked_sums(per_frame: torch.Tensor, src_mask: torch.Tensor) -> Sums:
    return (per_frame * src_mask).sum(), src_mask.sum()


def frame_mse_sums(pred: torch.Tensor, target: torch.Tensor,
                   src_mask: torch.Tensor,
                   sample_weight: Optional[torch.Tensor] = None
                   ) -> List[Sums]:
    per_frame = ((pred - target) ** 2).mean(-1)
    if sample_weight is not None:
        per_frame = per_frame * sample_weight[:, None].to(per_frame.dtype)
    return [_masked_sums(per_frame, src_mask)]


def masked_frame_mse(pred: torch.Tensor, target: torch.Tensor,
                     src_mask: torch.Tensor,
                     sample_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """((pred - target)^2 .mean(-1) * mask).sum() / max(mask.sum(), 1);
    ``src_mask`` [B, T]; ``sample_weight`` [B] multiplies each sample's
    frames (importance weights; all-ones gives the plain loss)."""
    return mean_of(frame_mse_sums(pred, target, src_mask, sample_weight))


def _pair_mask(src_mask: torch.Tensor, order: int) -> torch.Tensor:
    """Valid where every frame of the order-th difference stencil is."""
    m = src_mask
    for _ in range(order):
        m = m[:, 1:] * m[:, :-1]
    return m


def velocity_sums(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                  src_mask: torch.Tensor) -> List[Sums]:
    return frame_mse_sums(pred_x0[:, 1:] - pred_x0[:, :-1],
                          target_x0[:, 1:] - target_x0[:, :-1],
                          _pair_mask(src_mask, 1))


def velocity_loss(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                  src_mask: torch.Tensor) -> torch.Tensor:
    """MSE of first temporal differences."""
    return mean_of(velocity_sums(pred_x0, target_x0, src_mask))


def acceleration_sums(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                      src_mask: torch.Tensor) -> List[Sums]:
    def acc(x):
        return x[:, 2:] - 2 * x[:, 1:-1] + x[:, :-2]

    return frame_mse_sums(acc(pred_x0), acc(target_x0),
                          _pair_mask(src_mask, 2))


def acceleration_loss(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                      src_mask: torch.Tensor) -> torch.Tensor:
    """MSE of second temporal differences."""
    return mean_of(acceleration_sums(pred_x0, target_x0, src_mask))


def structure_loss(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                   src_mask: torch.Tensor, joints_num: int,
                   parents: Optional[tuple] = None) -> torch.Tensor:
    """Bone-length consistency in joint space (inputs DENORMALIZED):
    consecutive-joint distances, or parent-child ones with ``parents``."""
    return mean_of(structure_sums(pred_x0, target_x0, src_mask, joints_num,
                                  parents))


def structure_sums(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                   src_mask: torch.Tensor, joints_num: int,
                   parents: Optional[tuple] = None) -> List[Sums]:
    pj = recover_from_ric(pred_x0, joints_num)
    tj = recover_from_ric(target_x0, joints_num)
    if parents is None:
        pb = torch.linalg.vector_norm(pj[:, :, 1:] - pj[:, :, :-1], dim=-1)
        tb = torch.linalg.vector_norm(tj[:, :, 1:] - tj[:, :, :-1], dim=-1)
    else:
        idx = list(range(1, joints_num))
        par = [parents[j] for j in idx]
        pb = torch.linalg.vector_norm(pj[:, :, idx] - pj[:, :, par], dim=-1)
        tb = torch.linalg.vector_norm(tj[:, :, idx] - tj[:, :, par], dim=-1)
    return [_masked_sums(((pb - tb) ** 2).mean(-1), src_mask)]


def progressive_sums(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                     src_mask: torch.Tensor,
                     num_scales: int = 2) -> List[Sums]:
    out = []
    p, t, m = pred_x0, target_x0, src_mask
    for _ in range(num_scales):
        T2 = (p.shape[1] // 2) * 2
        p = 0.5 * (p[:, 0:T2:2] + p[:, 1:T2:2])
        t = 0.5 * (t[:, 0:T2:2] + t[:, 1:T2:2])
        m = m[:, 0:T2:2] * m[:, 1:T2:2]
        out += frame_mse_sums(p, t, m)
    return out


def progressive_loss(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                     src_mask: torch.Tensor,
                     num_scales: int = 2) -> torch.Tensor:
    """MSE at temporally average-pooled scales (stride 2 per level)."""
    return mean_of(progressive_sums(pred_x0, target_x0, src_mask,
                                    num_scales))
