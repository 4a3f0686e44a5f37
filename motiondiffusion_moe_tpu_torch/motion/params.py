"""Skeleton constants for HumanML3D (t2m, 22 joints) and KIT-ML (21 joints).

A copy of ``motiondiffusion_moe_tpu/motion/params.py`` (the port imports
nothing of the JAX package).

Data constants from ``text2motion/utils/paramUtil.py:4-62`` — kinematic
chains (root-first joint index paths) and unit raw offset directions.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# HumanML3D / SMPL 22-joint tree (paramUtil.py:55)
T2M_KINEMATIC_CHAIN: List[List[int]] = [
    [0, 2, 5, 8, 11],          # right leg
    [0, 1, 4, 7, 10],          # left leg
    [0, 3, 6, 9, 12, 15],      # spine -> head
    [9, 14, 17, 19, 21],       # right arm
    [9, 13, 16, 18, 20],       # left arm
]

# (paramUtil.py:32-53)
T2M_RAW_OFFSETS = np.array([
    [0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, -1, 0],
    [0, 1, 0], [0, -1, 0], [0, -1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1],
    [0, 1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, -1, 0], [0, -1, 0],
    [0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0],
], dtype=np.float32)

# KIT-ML 21-joint tree (paramUtil.py:4)
KIT_KINEMATIC_CHAIN: List[List[int]] = [
    [0, 11, 12, 13, 14, 15],
    [0, 16, 17, 18, 19, 20],
    [0, 1, 2, 3, 4],
    [3, 5, 6, 7],
    [3, 8, 9, 10],
]

# (paramUtil.py:6-29)
KIT_RAW_OFFSETS = np.array([
    [0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [1, 0, 0],
    [0, -1, 0], [0, -1, 0], [-1, 0, 0], [0, -1, 0], [0, -1, 0], [1, 0, 0],
    [0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
    [0, -1, 0], [0, 0, 1], [0, 0, 1],
], dtype=np.float32)

# face_joint_idx for IK: [r_hip, l_hip, sdr_r, sdr_l]
T2M_FACE_JOINTS = [2, 1, 17, 16]
KIT_FACE_JOINTS = [11, 16, 5, 8]

KIT_TGT_SKEL_ID = "03950"    # paramUtil.py:60
T2M_TGT_SKEL_ID = "000021"   # paramUtil.py:62


def get_skeleton_params(dataset_name: str) -> Tuple[np.ndarray, List[List[int]], List[int]]:
    """(raw_offsets, kinematic_chain, face_joints) for a dataset."""
    if dataset_name in ("t2m", "humanml3d", "humanml"):
        return T2M_RAW_OFFSETS, T2M_KINEMATIC_CHAIN, T2M_FACE_JOINTS
    if dataset_name in ("kit", "kit-ml"):
        return KIT_RAW_OFFSETS, KIT_KINEMATIC_CHAIN, KIT_FACE_JOINTS
    raise ValueError(f"unknown dataset: {dataset_name}")
