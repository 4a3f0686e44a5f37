"""Motion feature normalization with the feat_bias scheme.

Port of ``motiondiffusion_moe_tpu/data/normalizer.py`` (which imports jnp):
z-norm with the std of the root-velocity channels (0:4) and foot-contact
channels (last 4) divided by ``feat_bias``. ``normalize`` / ``denormalize``
act on tensors (on their device), the ``*_np`` forms on numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class MotionNormalizer:
    """Holds (mean, std) with the feat_bias adjustment applied."""

    def __init__(self, mean: np.ndarray, std: np.ndarray):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    @staticmethod
    def fit(motions: np.ndarray, joints_num: int,
            feat_bias: float = 25.0) -> "MotionNormalizer":
        """mean/std over all frames of ``motions`` [N, D], then
        :meth:`apply_feat_bias`."""
        mean = motions.mean(axis=0).astype(np.float64)
        std = motions.std(axis=0).astype(np.float64)
        return MotionNormalizer(mean, MotionNormalizer.apply_feat_bias(
            std, joints_num, feat_bias))

    @staticmethod
    def apply_feat_bias(std: np.ndarray, joints_num: int,
                        feat_bias: float) -> np.ndarray:
        """Divide root (0:4) and foot-contact (last 4) stds by feat_bias."""
        std = np.array(std, copy=True)
        j = joints_num
        if 4 + (j - 1) * 9 + j * 3 + 4 != std.shape[-1]:
            raise ValueError(f"{std.shape[-1]} features do not match "
                             f"{joints_num} joints")
        std[0:4] = std[0:4] / feat_bias
        std[4 + (j - 1) * 9 + j * 3:] = std[4 + (j - 1) * 9 + j * 3:] / feat_bias
        return std

    def normalize(self, motion: torch.Tensor) -> torch.Tensor:
        mean = torch.as_tensor(self.mean, device=motion.device)
        std = torch.as_tensor(self.std, device=motion.device)
        return (motion - mean) / std

    def denormalize(self, motion: torch.Tensor) -> torch.Tensor:
        mean = torch.as_tensor(self.mean, device=motion.device)
        std = torch.as_tensor(self.std, device=motion.device)
        return motion * std + mean

    def normalize_np(self, motion: np.ndarray) -> np.ndarray:
        return (motion - self.mean) / self.std

    def denormalize_np(self, motion: np.ndarray) -> np.ndarray:
        return motion * self.std + self.mean

    def save(self, meta_dir: str) -> None:
        """``meta/mean.npy`` and ``meta/std.npy``, the JAX package's
        layout."""
        os.makedirs(meta_dir, exist_ok=True)
        np.save(os.path.join(meta_dir, "mean.npy"), self.mean)
        np.save(os.path.join(meta_dir, "std.npy"), self.std)

    @staticmethod
    def load(meta_dir: str) -> "MotionNormalizer":
        return MotionNormalizer(np.load(os.path.join(meta_dir, "mean.npy")),
                                np.load(os.path.join(meta_dir, "std.npy")))

    @staticmethod
    def identity(dim: int) -> "MotionNormalizer":
        return MotionNormalizer(np.zeros(dim), np.ones(dim))
