"""Quaternion / continuous-6D rotation algebra (wxyz), batch-agnostic over
leading dims; every function runs on its tensors' device.

Port of ``motiondiffusion_moe_tpu/motion/quaternion.py``, function for
function and in the same order of arithmetic. ``qfix`` takes numpy arrays,
as the JAX package's does (dataset preprocessing), and tensors.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s) [..., 4]."""
    _need(q.shape[-1] == 4, "q must have shape (*, 4)")
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    """Normalise to unit length."""
    _need(q.shape[-1] == 4, "q must have shape (*, 4)")
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q * r, shapes (*, 4), broadcast."""
    _need(q.shape[-1] == 4 and r.shape[-1] == 4, "q, r must be (*, 4)")
    qw, qx, qy, qz = q.split(1, dim=-1)
    rw, rx, ry, rz = r.split(1, dim=-1)
    w = qw * rw - qx * rx - qy * ry - qz * rz
    x = qw * rx + qx * rw + qy * rz - qz * ry
    y = qw * ry - qx * rz + qy * rw + qz * rx
    z = qw * rz + qx * ry - qy * rx + qz * rw
    return torch.cat([w, x, y, z], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v [..., 3] by quaternion(s) q [..., 4] (Rodrigues
    form v + 2 (w (qv x v) + qv x (qv x v)))."""
    _need(q.shape[-1] == 4 and v.shape[-1] == 3,
          "q must be (*, 4) and v (*, 3)")
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2 * (q[..., :1] * uv + uuv)


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating v0 onto v1, shapes (*, 3)."""
    _need(v0.shape[-1] == 3 and v1.shape[-1] == 3, "v0, v1 must be (*, 3)")
    v = torch.linalg.cross(v0, v1, dim=-1)
    w = torch.sqrt((v0 ** 2).sum(dim=-1, keepdim=True)
                   * (v1 ** 2).sum(dim=-1, keepdim=True)) \
        + (v0 * v1).sum(dim=-1, keepdim=True)
    return qnormalize(torch.cat([w, v], dim=-1))


def qfix(q: Union[np.ndarray, torch.Tensor]):
    """Sign continuity along the time axis of (L, J, 4) quaternions: a frame
    whose dot product with the previous one is negative flips, and so does
    every frame after it until the next flip. numpy in, numpy out; a tensor
    in, a tensor out (on its device)."""
    if isinstance(q, np.ndarray):
        return qfix(torch.from_numpy(np.array(q, copy=True))).numpy()
    _need(q.dim() == 3 and q.shape[-1] == 4, "q must have shape (L, J, 4)")
    dots = (q[1:] * q[:-1]).sum(dim=2)
    flip = torch.remainder(torch.cumsum((dots < 0).to(torch.int64), dim=0),
                           2).bool()
    sign = torch.where(flip, -1.0, 1.0).to(q.dtype)
    return torch.cat([q[:1], q[1:] * sign[..., None]], dim=0)


def qeuler(q: torch.Tensor, order: str, epsilon: float = 0.0,
           deg: bool = True) -> torch.Tensor:
    """Quaternion -> Euler angles in one of the six orders."""
    _need(q.shape[-1] == 4, "q must have shape (*, 4)")
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

    def clip(x):
        return torch.clamp(x, -1 + epsilon, 1 - epsilon)

    if order == "xyz":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = torch.asin(clip(2 * (q1 * q3 + q0 * q2)))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    elif order == "yzx":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = torch.asin(clip(2 * (q1 * q2 + q0 * q3)))
    elif order == "zxy":
        x = torch.asin(clip(2 * (q0 * q1 + q2 * q3)))
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "xzy":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 + q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = torch.asin(clip(2 * (q0 * q3 - q1 * q2)))
    elif order == "yxz":
        x = torch.asin(clip(2 * (q0 * q1 - q2 * q3)))
        y = torch.atan2(2 * (q1 * q3 + q0 * q2), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "zyx":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = torch.asin(clip(2 * (q0 * q2 - q1 * q3)))
        z = torch.atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    else:
        raise ValueError(f"unknown euler order: {order}")
    e = torch.stack([x, y, z], dim=-1)
    return e * 180.0 / math.pi if deg else e


def euler2quat(e: torch.Tensor, order: str, deg: bool = True
               ) -> torch.Tensor:
    """Euler angles -> quaternion; the axes composed in ``order``."""
    _need(e.shape[-1] == 3, "e must have shape (*, 3)")
    if deg:
        e = e * math.pi / 180.0
    x, y, z = e[..., 0], e[..., 1], e[..., 2]
    zeros = torch.zeros_like(x)
    rs = {"x": torch.stack([torch.cos(x / 2), torch.sin(x / 2), zeros, zeros],
                           dim=-1),
          "y": torch.stack([torch.cos(y / 2), zeros, torch.sin(y / 2), zeros],
                           dim=-1),
          "z": torch.stack([torch.cos(z / 2), zeros, zeros, torch.sin(z / 2)],
                           dim=-1)}
    result = None
    for coord in order:
        result = rs[coord] if result is None else qmul(result, rs[coord])
    if order in ("xyz", "yzx", "zxy"):
        result = result * -1
    return result


def expmap_to_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> quaternion, in the stable sinc form (``torch.sinc`` is
    the normalised sinc, as ``jnp.sinc``)."""
    _need(e.shape[-1] == 3, "e must have shape (*, 3)")
    theta = torch.linalg.norm(e, dim=-1, keepdim=True)
    w = torch.cos(0.5 * theta)
    xyz = 0.5 * torch.sinc(0.5 * theta / math.pi) * e
    return torch.cat([w, xyz], dim=-1)


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion -> 3x3 rotation matrix."""
    r, i, j, k = quaternions.unbind(-1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k),
        two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r),
        1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r),
        two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def quaternion_to_cont6d(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternion -> continuous 6D (the first two matrix columns)."""
    m = quaternion_to_matrix(quaternions)
    return torch.cat([m[..., 0], m[..., 1]], dim=-1)


def cont6d_to_matrix(cont6d: torch.Tensor) -> torch.Tensor:
    """Continuous 6D -> rotation matrix by Gram-Schmidt."""
    _need(cont6d.shape[-1] == 6, "last dim must be 6")
    x_raw = cont6d[..., 0:3]
    y_raw = cont6d[..., 3:6]
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y_raw, dim=-1)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def qpow(q0: torch.Tensor, t) -> torch.Tensor:
    """Quaternion power q0 ** t via axis-angle; t a scalar or a tensor of
    fractions, which becomes the leading dim of the result."""
    q0 = qnormalize(q0)
    theta0 = torch.acos(torch.clamp(q0[..., 0], -1.0, 1.0))
    v0 = q0[..., 1:] / torch.clamp(
        torch.linalg.norm(q0[..., 1:], dim=-1, keepdim=True), min=1e-12)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == 0:
        t = t[None]
    theta = t[..., None] * theta0[None, ...]
    w = torch.cos(theta)[..., None]
    xyz = torch.sin(theta)[..., None] * v0[None, ...]
    return torch.cat([w, xyz], dim=-1)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation q0 -> q1 at fractions t."""
    q0 = qnormalize(q0)
    q1 = qnormalize(q1)
    q_ = qpow(qmul(q1, qinv(q0)), t)
    return qmul(q_, q0[None, ...].expand(q_.shape))


def lerp(p0: torch.Tensor, p1: torch.Tensor, t) -> torch.Tensor:
    """Linear interpolation over a grid of fractions t."""
    t = torch.as_tensor(t, dtype=p0.dtype, device=p0.device)
    if t.dim() == 0:
        t = t[None]
    tb = t.reshape(t.shape + (1,) * p0.dim())
    return p0[None, ...] + tb * (p1 - p0)[None, ...]
