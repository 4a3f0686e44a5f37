"""Text-to-motion datasets (host-side numpy).

From ``motiondiffusion_moe_tpu/data/dataset.py``: a copy of
``SyntheticText2MotionDataset``, the JAX CLI's ``--dataset synthetic``
(smooth random walks shaped like HumanML3D, procedural captions, identity
normalizer). ``Text2MotionDataset`` (HumanML3D / KIT-ML files) is not ported
yet: it raises until the data port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from motiondiffusion_moe_tpu_torch.config import DataConfig
from motiondiffusion_moe_tpu_torch.data.normalizer import MotionNormalizer

_VERBS = ["walks", "runs", "jumps", "turns", "waves", "sits", "kicks",
          "dances", "crouches", "stretches"]
_MODS = ["slowly", "quickly", "in a circle", "forward", "backward",
         "to the left", "to the right", "twice", "with both arms", "in place"]


class Text2MotionDataset:
    """HumanML3D / KIT-ML training data: not ported yet."""

    def __init__(self, cfg: DataConfig, *args, **kwargs):
        raise NotImplementedError(
            "Text2MotionDataset (HumanML3D / KIT-ML) is not ported yet; "
            "use SyntheticText2MotionDataset (--dataset synthetic)")


class SyntheticText2MotionDataset:
    """Deterministic synthetic dataset shaped like HumanML3D: item ``i`` is
    drawn from ``default_rng(seed * 100003 + i)``, so the JAX package and
    the port give the same items."""

    def __init__(self, cfg: DataConfig, size: int = 256, seed: int = 0):
        self.cfg = cfg
        self.size = size
        self.seed = seed
        self.normalizer = MotionNormalizer.identity(cfg.dim_pose)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, item: int) -> Tuple[str, np.ndarray, int]:
        rng = np.random.default_rng(self.seed * 100003 + item)
        cfg = self.cfg
        m_length = int(rng.integers(cfg.min_motion_length,
                                    min(200, cfg.max_motion_length + 1)))
        steps = rng.standard_normal((m_length, cfg.dim_pose)).astype(
            np.float32)
        motion = np.cumsum(steps * 0.05, axis=0)
        caption = (f"a person {_VERBS[int(rng.integers(len(_VERBS)))]} "
                   f"{_MODS[int(rng.integers(len(_MODS)))]}")
        max_len = cfg.max_motion_length
        if m_length < max_len:
            motion = np.concatenate(
                [motion, np.zeros((max_len - m_length, cfg.dim_pose),
                                  np.float32)], axis=0)
        else:
            motion = motion[:max_len]
            m_length = max_len
        return caption, motion, m_length
