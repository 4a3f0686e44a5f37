"""Quaternion helpers (wxyz), batch-agnostic over leading dims.

The part of ``motiondiffusion_moe_tpu/motion/quaternion.py`` that feature
decoding needs: ``qinv`` and ``qrot``.
"""

from __future__ import annotations

import torch


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s) [..., 4]."""
    if q.shape[-1] != 4:
        raise ValueError("q must have shape (*, 4)")
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v [..., 3] by quaternion(s) q [..., 4] (Rodrigues
    form v + 2 (w (qv x v) + qv x (qv x v)))."""
    if q.shape[-1] != 4 or v.shape[-1] != 3:
        raise ValueError("q must be (*, 4) and v (*, 3)")
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2 * (q[..., :1] * uv + uuv)
