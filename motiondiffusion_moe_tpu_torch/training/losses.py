"""Training losses.

Port of ``motiondiffusion_moe_tpu/training/losses.py``: the reference's
masked per-frame MSE (with schedule-sampler importance weights) and the
four optional losses on the predicted x0 (velocity, acceleration, bone-length
structure through the port's ``recover_from_ric``, multi-scale progressive).
"""

from __future__ import annotations

from typing import Optional

import torch

from motiondiffusion_moe_tpu_torch.motion.recover import recover_from_ric


def masked_frame_mse(pred: torch.Tensor, target: torch.Tensor,
                     src_mask: torch.Tensor,
                     sample_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """((pred - target)^2 .mean(-1) * mask).sum() / max(mask.sum(), 1);
    ``src_mask`` [B, T]; ``sample_weight`` [B] multiplies each sample's
    frames (importance weights; all-ones gives the plain loss)."""
    per_frame = ((pred - target) ** 2).mean(-1)
    if sample_weight is not None:
        per_frame = per_frame * sample_weight[:, None].to(per_frame.dtype)
    return (per_frame * src_mask).sum() / src_mask.sum().clamp(min=1.0)


def _pair_mask(src_mask: torch.Tensor, order: int) -> torch.Tensor:
    """Valid where every frame of the order-th difference stencil is."""
    m = src_mask
    for _ in range(order):
        m = m[:, 1:] * m[:, :-1]
    return m


def velocity_loss(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                  src_mask: torch.Tensor) -> torch.Tensor:
    """MSE of first temporal differences."""
    return masked_frame_mse(pred_x0[:, 1:] - pred_x0[:, :-1],
                            target_x0[:, 1:] - target_x0[:, :-1],
                            _pair_mask(src_mask, 1))


def acceleration_loss(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                      src_mask: torch.Tensor) -> torch.Tensor:
    """MSE of second temporal differences."""
    def acc(x):
        return x[:, 2:] - 2 * x[:, 1:-1] + x[:, :-2]

    return masked_frame_mse(acc(pred_x0), acc(target_x0),
                            _pair_mask(src_mask, 2))


def structure_loss(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                   src_mask: torch.Tensor, joints_num: int,
                   parents: Optional[tuple] = None) -> torch.Tensor:
    """Bone-length consistency in joint space (inputs DENORMALIZED):
    consecutive-joint distances, or parent-child ones with ``parents``."""
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
    per_frame = ((pb - tb) ** 2).mean(-1)
    return (per_frame * src_mask).sum() / src_mask.sum().clamp(min=1.0)


def progressive_loss(pred_x0: torch.Tensor, target_x0: torch.Tensor,
                     src_mask: torch.Tensor,
                     num_scales: int = 2) -> torch.Tensor:
    """MSE at temporally average-pooled scales (stride 2 per level)."""
    loss = 0.0
    p, t, m = pred_x0, target_x0, src_mask
    for _ in range(num_scales):
        T2 = (p.shape[1] // 2) * 2
        p = 0.5 * (p[:, 0:T2:2] + p[:, 1:T2:2])
        t = 0.5 * (t[:, 0:T2:2] + t[:, 1:T2:2])
        m = m[:, 0:T2:2] * m[:, 1:T2:2]
        loss = loss + masked_frame_mse(p, t, m)
    return loss / num_scales
