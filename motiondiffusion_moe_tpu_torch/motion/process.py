"""Raw joints -> 263/251-dim motion features (dataset construction).

Port of ``motiondiffusion_moe_tpu/motion/process.py`` (``uniform_skeleton``,
``extract_features``, ``process_file``, ``build_target_offsets``): the
encoder side of the motion codec whose decoder is :mod:`recover`. The public
functions take and return numpy arrays, as the JAX package's do, and run
their math in torch f32 on ``device``; a clip stays on the device from the
retarget to its features. ``process_file`` extracts the facing rotations
once and returns them with the features (the JAX package runs the same
deterministic IK a second time for its last two outputs).

Dataset constants (the reference's ``motion_process.py`` __main__ blocks):
t2m : lower legs (5, 8), feet r [8, 11] / l [7, 10], face [2, 1, 17, 16],
      feet_thre 0.002, 20 fps
kit : lower legs (17, 18), feet r [14, 15] / l [19, 20],
      face [11, 16, 5, 8], feet_thre 0.05, 12.5 fps
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from motiondiffusion_moe_tpu_torch.motion.params import (
    KIT_KINEMATIC_CHAIN,
    KIT_RAW_OFFSETS,
    T2M_KINEMATIC_CHAIN,
    T2M_RAW_OFFSETS,
)
from motiondiffusion_moe_tpu_torch.motion.quaternion import (
    qbetween,
    qfix,
    qinv,
    qmul,
    qrot,
    quaternion_to_cont6d,
)
from motiondiffusion_moe_tpu_torch.motion.skeleton import Skeleton


@dataclass(frozen=True)
class ProcessConfig:
    """Per-dataset constants for feature extraction."""

    raw_offsets: np.ndarray
    kinematic_chain: List[List[int]]
    l_idx: Tuple[int, int]          # lower legs (scale reference)
    fid_r: Tuple[int, int]          # right foot joints
    fid_l: Tuple[int, int]          # left foot joints
    face_joint_indx: Tuple[int, int, int, int]
    feet_thre: float
    joints_num: int

    @staticmethod
    def t2m() -> "ProcessConfig":
        return ProcessConfig(T2M_RAW_OFFSETS, T2M_KINEMATIC_CHAIN,
                             (5, 8), (8, 11), (7, 10), (2, 1, 17, 16),
                             0.002, 22)

    @staticmethod
    def kit() -> "ProcessConfig":
        return ProcessConfig(KIT_RAW_OFFSETS, KIT_KINEMATIC_CHAIN,
                             (17, 18), (14, 15), (19, 20), (11, 16, 5, 8),
                             0.05, 21)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _uniform_skeleton(positions: torch.Tensor, target_offsets: torch.Tensor,
                      cfg: ProcessConfig) -> torch.Tensor:
    dev = positions.device
    skel = Skeleton(cfg.raw_offsets, cfg.kinematic_chain, dev)
    src_offset = skel.get_offsets_joints(positions[0])
    l1, l2 = cfg.l_idx
    src_leg_len = src_offset[l1].abs().max() + src_offset[l2].abs().max()
    tgt_leg_len = (target_offsets[l1].abs().max()
                   + target_offsets[l2].abs().max())
    tgt_root_pos = positions[:, 0] * (tgt_leg_len / src_leg_len)
    quat_params = skel.inverse_kinematics_t(positions,
                                            list(cfg.face_joint_indx))
    skel.set_offset(target_offsets)
    return skel.forward_kinematics(quat_params, tgt_root_pos)


def uniform_skeleton(positions: np.ndarray, target_offsets: np.ndarray,
                     cfg: ProcessConfig, device="cpu") -> np.ndarray:
    """Retarget a clip [T, J, 3] onto the canonical skeleton: leg-length
    scaling of the root path and an IK / FK round trip."""
    return _uniform_skeleton(_f32(positions, device),
                             _f32(target_offsets, device),
                             cfg).cpu().numpy()


def _foot_detect(positions: torch.Tensor, thres: float, fid_l, fid_r):
    """Foot-contact labels from the squared foot velocity (1.0 below
    ``thres``)."""
    def contact(fid):
        d = positions[1:, list(fid)] - positions[:-1, list(fid)]
        return ((d ** 2).sum(-1) < thres).to(torch.float32)

    return contact(fid_l), contact(fid_r)


def _cont6d_params(positions: torch.Tensor, cfg: ProcessConfig):
    """(cont6d params, root angular velocity, root linear velocity in the
    facing frame, root rotation)."""
    skel = Skeleton(cfg.raw_offsets, cfg.kinematic_chain, positions.device)
    quat_params = qfix(skel.inverse_kinematics_t(
        positions, list(cfg.face_joint_indx), smooth_forward=True))
    cont_6d = quaternion_to_cont6d(quat_params)
    r_rot = quat_params[:, 0]
    velocity = qrot(r_rot[1:], positions[1:, 0] - positions[:-1, 0])
    r_velocity = qmul(r_rot[1:], qinv(r_rot[:-1]))
    return cont_6d, r_velocity, velocity, r_rot


def _rifke(positions: torch.Tensor, r_rot: torch.Tensor) -> torch.Tensor:
    """Root-relative (XZ), facing-aligned joint positions."""
    rel = torch.stack([positions[..., 0] - positions[:, 0:1, 0],
                       positions[..., 1],
                       positions[..., 2] - positions[:, 0:1, 2]], dim=-1)
    return qrot(r_rot[:, None].expand(rel.shape[:-1] + (4,)), rel)


def _extract(positions: torch.Tensor, cfg: ProcessConfig):
    """Features [T-1, D] of world joints [T, J, 3], with the rifke positions
    and the facing-frame root velocity."""
    T, J = positions.shape[:2]
    feet_l, feet_r = _foot_detect(positions, cfg.feet_thre, cfg.fid_l,
                                  cfg.fid_r)
    cont_6d, r_velocity, velocity, r_rot = _cont6d_params(positions, cfg)
    rifke = _rifke(positions, r_rot)

    root_y = rifke[:, 0, 1:2]
    r_velocity = torch.asin(torch.clamp(r_velocity[:, 2:3], -1.0, 1.0))
    l_velocity = velocity[:, [0, 2]]
    root_data = torch.cat([r_velocity, l_velocity, root_y[:-1]], dim=-1)
    rot_data = cont_6d[:, 1:].reshape(T, -1)
    ric_data = rifke[:, 1:].reshape(T, -1)
    local_vel = qrot(r_rot[:-1, None].expand(T - 1, J, 4),
                     positions[1:] - positions[:-1]).reshape(T - 1, -1)
    data = torch.cat([root_data, ric_data[:-1], rot_data[:-1], local_vel,
                      feet_l, feet_r], dim=-1)
    return data, rifke, velocity


def extract_features(positions: np.ndarray, cfg: ProcessConfig,
                     device="cpu") -> np.ndarray:
    """[T, J, 3] world joints -> [T-1, D] feature vectors. Layout:
    [rot_vel(1), lin_vel_xz(2), root_y(1), ric (J-1)*3, rot6d (J-1)*6,
    local_vel J*3, foot_contact(4)]."""
    return _extract(_f32(positions, device), cfg)[0].cpu().numpy()


def process_file(positions: np.ndarray, cfg: ProcessConfig,
                 target_offsets: np.ndarray, device="cpu"
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The whole clip pipeline: retarget, put on the floor, root XZ at the
    origin, face Z+ at the first frame, then the features. Returns
    (features [T-1, D], global positions [T, J, 3], rifke positions
    [T, J, 3], root XZ velocity [T-1, 2]), numpy."""
    positions = _uniform_skeleton(_f32(positions, device),
                                  _f32(target_offsets, device), cfg)
    dev = positions.device

    # on the floor, then the first frame's root XZ at the origin
    zero = torch.zeros((), device=dev)
    positions = positions - torch.stack([zero, positions[..., 1].min(), zero])
    root_pos_init = positions[0]
    positions = positions - root_pos_init[0] * torch.tensor([1.0, 0.0, 1.0],
                                                            device=dev)

    # every clip faces Z+ at its first frame
    r_hip, l_hip, sdr_r, sdr_l = cfg.face_joint_indx
    across = (root_pos_init[r_hip] - root_pos_init[l_hip]
              + root_pos_init[sdr_r] - root_pos_init[sdr_l])
    across = across / torch.sqrt((across ** 2).sum())
    forward_init = torch.linalg.cross(
        torch.tensor([0.0, 1.0, 0.0], device=dev), across, dim=-1)
    forward_init = forward_init / torch.sqrt((forward_init ** 2).sum())
    root_quat_init = qbetween(forward_init[None],
                              torch.tensor([[0.0, 0.0, 1.0]], device=dev))
    positions = qrot(root_quat_init.expand(positions.shape[:-1] + (4,)),
                     positions)

    data, rifke, velocity = _extract(positions, cfg)
    return (data.cpu().numpy(), positions.cpu().numpy(),
            rifke.cpu().numpy(), velocity[:, [0, 2]].cpu().numpy())


def build_target_offsets(example_joints: np.ndarray, cfg: ProcessConfig,
                         device="cpu") -> np.ndarray:
    """Target skeleton offsets from the first frame of the canonical
    example clip."""
    skel = Skeleton(cfg.raw_offsets, cfg.kinematic_chain, device)
    return skel.get_offsets_joints(
        _f32(example_joints[0], device)).cpu().numpy()
