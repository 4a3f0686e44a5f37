"""Motion feature decoding (263/251-dim features -> 3D joints).

Port of ``recover_root_rot_pos`` and ``recover_from_ric`` from
``motiondiffusion_moe_tpu/motion/recover.py``. Feature layout: [0] root yaw
velocity, [1:3] root XZ velocity, [3] root height, [4 : 4+(J-1)*3] the
rotation-invariant joint coordinates (ric), then rotations, velocities and
foot contacts. Batch-agnostic over leading dims; runs on the tensor's device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from motiondiffusion_moe_tpu_torch.motion.quaternion import qinv, qrot


def recover_root_rot_pos(data: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate root yaw and XZ velocity (each frame uses the PREVIOUS
    frames' velocities) into (r_rot_quat [..., T, 4], r_pos [..., T, 3])."""
    rot_vel = data[..., 0]
    shifted = torch.cat([torch.zeros_like(rot_vel[..., :1]),
                         rot_vel[..., :-1]], dim=-1)
    r_rot_ang = torch.cumsum(shifted, dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros,
                              torch.sin(r_rot_ang), zeros], dim=-1)

    vel_xz = data[..., 1:3]
    vel_xz = torch.cat([torch.zeros_like(vel_xz[..., :1, :]),
                        vel_xz[..., :-1, :]], dim=-2)
    r_vel = torch.stack([vel_xz[..., 0], torch.zeros_like(vel_xz[..., 0]),
                         vel_xz[..., 1]], dim=-1)
    r_pos = torch.cumsum(qrot(qinv(r_rot_quat), r_vel), dim=-2)
    r_pos = torch.cat([r_pos[..., :1], data[..., 3:4], r_pos[..., 2:]],
                      dim=-1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """Feature vectors [..., T, D] -> world joints [..., T, J, 3]."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4:(joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    q = qinv(r_rot_quat)[..., None, :].expand(positions.shape[:-1] + (4,))
    positions = qrot(q, positions)
    offset = torch.stack([r_pos[..., 0], torch.zeros_like(r_pos[..., 0]),
                          r_pos[..., 2]], dim=-1)[..., None, :]
    return torch.cat([r_pos[..., None, :], positions + offset], dim=-2)
