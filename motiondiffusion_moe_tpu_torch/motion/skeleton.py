"""Skeleton forward / inverse kinematics.

Port of ``motiondiffusion_moe_tpu/motion/skeleton.py``: the chain walk over
the static lists of joint indices, batch-first ([B, J, ...]). The math runs
on the tensors' device; offsets given as numpy go to the skeleton's
``device``. Joint positions are gathered in a list and stacked, as in the
JAX package. ``inverse_kinematics`` takes and returns numpy arrays, as the
JAX package's does (dataset preprocessing), and computes on ``device``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from motiondiffusion_moe_tpu_torch.motion.quaternion import (
    cont6d_to_matrix,
    qbetween,
    qinv,
    qmul,
    qrot,
)


class Skeleton:
    """Kinematic-tree FK / IK. ``raw_offsets``: [J, 3] unit bone
    directions; ``kinematic_tree``: root-first index chains; ``device``:
    where offsets given as numpy and the IK's math go (the CPU when
    None)."""

    def __init__(self, raw_offsets: np.ndarray,
                 kinematic_tree: Sequence[Sequence[int]], device=None):
        self._raw_offset = np.asarray(raw_offsets, dtype=np.float32)
        self._kinematic_tree = [list(c) for c in kinematic_tree]
        self._device = torch.device(device if device is not None else "cpu")
        self._offset: Optional[torch.Tensor] = None
        self._parents = [0] * len(self._raw_offset)
        self._parents[0] = -1
        for chain in self._kinematic_tree:
            for j in range(1, len(chain)):
                self._parents[chain[j]] = chain[j - 1]

    @property
    def njoints(self) -> int:
        return len(self._raw_offset)

    @property
    def kinematic_tree(self) -> List[List[int]]:
        return self._kinematic_tree

    @property
    def parents(self) -> List[int]:
        return self._parents

    def offset(self) -> Optional[torch.Tensor]:
        return self._offset

    def set_offset(self, offsets) -> None:
        """Offsets [J, 3] or [B, J, 3]; numpy goes to the skeleton's
        device, a tensor stays on its own."""
        if isinstance(offsets, torch.Tensor):
            self._offset = offsets.to(torch.float32)
        else:
            self._offset = torch.as_tensor(
                np.asarray(offsets, np.float32), device=self._device)

    def _raw(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self._raw_offset, device=like.device)

    def get_offsets_joints(self, joints: torch.Tensor) -> torch.Tensor:
        """Bone-length-scaled offsets from one reference pose [J, 3]; the
        root's offset is zero."""
        if joints.dim() != 2:
            raise ValueError("joints must be [J, 3]")
        idx = torch.arange(1, self.njoints, device=joints.device)
        par = torch.as_tensor(self._parents[1:], device=joints.device)
        lengths = torch.linalg.norm(joints[idx] - joints[par], dim=-1)
        scale = torch.cat([torch.ones_like(lengths[:1]), lengths])[:, None]
        offsets = self._raw(joints) * scale
        offsets = torch.cat([joints[:1] * 0, offsets[1:]], dim=0)
        self._offset = offsets
        return offsets

    def get_offsets_joints_batch(self, joints: torch.Tensor) -> torch.Tensor:
        """Batch variant, [B, J, 3]."""
        if joints.dim() != 3:
            raise ValueError("joints must be [B, J, 3]")
        diffs = joints[:, 1:] - joints[:, self._parents[1:]]
        lengths = torch.linalg.norm(diffs, dim=-1)
        lengths = torch.cat([torch.zeros_like(lengths[:, :1]), lengths],
                            dim=1)
        offsets = lengths[..., None] * self._raw(joints)[None]
        self._offset = offsets
        return offsets

    def _resolve_offsets(self, batch: int,
                         skel_joints: Optional[torch.Tensor]
                         ) -> torch.Tensor:
        if skel_joints is not None:
            offsets = self.get_offsets_joints_batch(skel_joints)
        else:
            if self._offset is None:
                raise ValueError("call set_offset / get_offsets_joints "
                                 "first")
            offsets = self._offset
        if offsets.dim() == 2:
            offsets = offsets[None].expand((batch,) + offsets.shape)
        return offsets

    def forward_kinematics(self, quat_params: torch.Tensor,
                           root_pos: torch.Tensor,
                           skel_joints: Optional[torch.Tensor] = None,
                           do_root_R: bool = True) -> torch.Tensor:
        """Quaternion FK: [B, J, 4] local rotations and [B, 3] root position
        -> [B, J, 3] joints."""
        b = quat_params.shape[0]
        offsets = self._resolve_offsets(b, skel_joints)
        joints: List[Optional[torch.Tensor]] = [None] * self.njoints
        joints[0] = root_pos
        for chain in self._kinematic_tree:
            if do_root_R:
                R = quat_params[:, 0]
            else:
                R = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=quat_params.dtype,
                                 device=quat_params.device).expand(b, 4)
            for i in range(1, len(chain)):
                R = qmul(R, quat_params[:, chain[i]])
                joints[chain[i]] = (qrot(R, offsets[:, chain[i]])
                                    + joints[chain[i - 1]])
        return torch.stack(joints, dim=1)

    def forward_kinematics_cont6d(self, cont6d_params: torch.Tensor,
                                  root_pos: torch.Tensor,
                                  skel_joints: Optional[torch.Tensor] = None,
                                  do_root_R: bool = True) -> torch.Tensor:
        """Cont6d FK: [B, J, 6] and [B, 3] -> [B, J, 3]. The 3x3 products
        are f32 matmuls (TF32 must stay off on the card, its default)."""
        b = cont6d_params.shape[0]
        offsets = self._resolve_offsets(b, skel_joints)
        joints: List[Optional[torch.Tensor]] = [None] * self.njoints
        joints[0] = root_pos
        for chain in self._kinematic_tree:
            if do_root_R:
                matR = cont6d_to_matrix(cont6d_params[:, 0])
            else:
                matR = torch.eye(3, dtype=cont6d_params.dtype,
                                 device=cont6d_params.device).expand(b, 3, 3)
            for i in range(1, len(chain)):
                matR = torch.matmul(
                    matR, cont6d_to_matrix(cont6d_params[:, chain[i]]))
                offset_vec = offsets[:, chain[i]][..., None]
                joints[chain[i]] = (torch.matmul(matR, offset_vec)[..., 0]
                                    + joints[chain[i - 1]])
        return torch.stack(joints, dim=1)

    def inverse_kinematics_t(self, joints: torch.Tensor,
                             face_joint_idx: Sequence[int],
                             smooth_forward: bool = False) -> torch.Tensor:
        """Joints [T, J, 3] -> local quaternions [T, J, 4], on the joints'
        device. ``smooth_forward`` filters the facing direction with
        scipy's Gaussian (sigma 20 frames, nearest edges) on the host, as
        the JAX package does."""
        if len(face_joint_idx) != 4:
            raise ValueError("face_joint_idx must name 4 joints")
        dev = joints.device
        l_hip, r_hip, sdr_r, sdr_l = face_joint_idx
        across = (joints[:, r_hip] - joints[:, l_hip]
                  + joints[:, sdr_r] - joints[:, sdr_l])
        across = across / torch.linalg.norm(across, dim=-1, keepdim=True)
        up = torch.tensor([[0.0, 1.0, 0.0]], device=dev)
        forward = torch.linalg.cross(up.expand_as(across), across, dim=-1)
        if smooth_forward:
            from scipy.ndimage import gaussian_filter1d
            forward = torch.as_tensor(gaussian_filter1d(
                forward.cpu().numpy(), 20, axis=0, mode="nearest"),
                device=dev)
        forward = forward / torch.linalg.norm(forward, dim=-1, keepdim=True)

        target = torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand_as(
            forward)
        root_quat = qbetween(forward, target)
        root_quat = torch.cat([torch.tensor([[1.0, 0.0, 0.0, 0.0]],
                                            device=dev), root_quat[1:]])

        T = joints.shape[0]
        quat_params = torch.zeros(joints.shape[:-1] + (4,), device=dev)
        quat_params[:, 0] = root_quat
        raw = torch.as_tensor(self._raw_offset, device=dev)
        for chain in self._kinematic_tree:
            R = root_quat
            for j in range(len(chain) - 1):
                u = raw[chain[j + 1]][None].expand(T, 3)
                v = joints[:, chain[j + 1]] - joints[:, chain[j]]
                v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
                R_loc = qmul(qinv(R), qbetween(u, v))
                quat_params[:, chain[j + 1]] = R_loc
                R = qmul(R, R_loc)
        return quat_params

    def inverse_kinematics(self, joints: np.ndarray,
                           face_joint_idx: Sequence[int],
                           smooth_forward: bool = False) -> np.ndarray:
        """Joints [T, J, 3] (numpy) -> local quaternions [T, J, 4] (numpy),
        computed on the skeleton's device."""
        out = self.inverse_kinematics_t(
            torch.as_tensor(np.asarray(joints, np.float32),
                            device=self._device),
            face_joint_idx, smooth_forward)
        return out.cpu().numpy()
