"""Text-to-motion datasets (host-side numpy).

Port of ``motiondiffusion_moe_tpu/data/dataset.py``: ``TextAnnotation``,
``parse_text_annotation`` and ``Text2MotionDataset`` (the HumanML3D / KIT-ML
directory layout, the length filter, ``caption#tokens#f_tag#to_tag``
annotations with sub-clips, the ``times`` multiplier, random crop / zero pad
to ``max_motion_length`` and feat_bias z-normalisation, with batches
assembled by the native C++ store of :mod:`native`), and
``SyntheticText2MotionDataset``, the JAX CLI's ``--dataset synthetic``
(smooth random walks shaped like HumanML3D, procedural captions, identity
normalizer).

One divergence: where the JAX package swallows any failure of the native
store and takes the Python path in silence, here ``use_native_io=True``
with a library that does not build or load raises (with the compiler's
message); ``use_native=False`` is the explicit way to the Python path.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from motiondiffusion_moe_tpu_torch.config import DataConfig
from motiondiffusion_moe_tpu_torch.data.normalizer import MotionNormalizer

_VERBS = ["walks", "runs", "jumps", "turns", "waves", "sits", "kicks",
          "dances", "crouches", "stretches"]
_MODS = ["slowly", "quickly", "in a circle", "forward", "backward",
         "to the left", "to the right", "twice", "with both arms", "in place"]


_SUBCLIP_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVW"


@dataclass
class TextAnnotation:
    caption: str
    tokens: List[str]
    f_tag: float
    to_tag: float


def parse_text_annotation(line: str) -> TextAnnotation:
    """One ``caption#tokens#f_tag#to_tag`` line; missing fields and NaN
    tags read as empty / 0.0."""
    parts = line.strip().split("#")
    caption = parts[0]
    tokens = parts[1].split(" ") if len(parts) > 1 else []
    f_tag = float(parts[2]) if len(parts) > 2 else 0.0
    to_tag = float(parts[3]) if len(parts) > 3 else 0.0
    f_tag = 0.0 if np.isnan(f_tag) else f_tag
    to_tag = 0.0 if np.isnan(to_tag) else to_tag
    return TextAnnotation(caption, tokens, f_tag, to_tag)


class Text2MotionDataset:
    """HumanML3D / KIT-ML training data. Layout:

        <data_root>/new_joint_vecs/<id>.npy   [T, dim_pose] features
        <data_root>/texts/<id>.txt            annotation lines
        <data_root>/<split>.txt               ids, one per line

    A motion of ``min_motion_length <= len < 200`` frames with at least one
    whole-clip line (tags 0, 0) is an item; each line with tags is a
    sub-clip at 20 fps, an item of its own named ``<letter>_<id>`` with the
    letter drawn from ``random.Random(seed)``. Items are sorted by length.
    Returns ``(caption, motion [max_len, D] normalised, m_length)``.
    """

    def __init__(self, cfg: DataConfig, split: str = "train",
                 normalizer: Optional[MotionNormalizer] = None,
                 times: Optional[int] = None, seed: int = 0,
                 use_native: Optional[bool] = None):
        self.cfg = cfg
        self.times = times if times is not None else cfg.times
        self.rng = random.Random(seed)

        motion_dir = os.path.join(cfg.data_root, "new_joint_vecs")
        text_dir = os.path.join(cfg.data_root, "texts")
        with open(os.path.join(cfg.data_root, f"{split}.txt")) as f:
            id_list = [line.strip() for line in f if line.strip()]

        data_dict: Dict[str, dict] = {}
        new_name_list: List[str] = []
        length_list: List[int] = []
        min_len = cfg.min_motion_length
        for name in id_list:
            try:
                motion = np.load(os.path.join(motion_dir, name + ".npy"))
            except (FileNotFoundError, OSError):
                continue  # KIT lacks some motions
            if len(motion) < min_len or len(motion) >= 200:
                continue
            try:
                with open(os.path.join(text_dir, name + ".txt")) as f:
                    lines = f.readlines()
            except (FileNotFoundError, OSError):
                continue
            text_data: List[TextAnnotation] = []
            whole = False
            for line in lines:
                if not line.strip():
                    continue
                ann = parse_text_annotation(line)
                if ann.f_tag == 0.0 and ann.to_tag == 0.0:
                    whole = True
                    text_data.append(ann)
                    continue
                n_motion = motion[int(ann.f_tag * 20): int(ann.to_tag * 20)]
                if len(n_motion) < min_len or len(n_motion) >= 200:
                    continue
                new_name = f"{self.rng.choice(_SUBCLIP_LETTERS)}_{name}"
                while new_name in data_dict:
                    new_name = f"{self.rng.choice(_SUBCLIP_LETTERS)}_{name}"
                data_dict[new_name] = {"motion": n_motion,
                                       "length": len(n_motion),
                                       "text": [ann]}
                new_name_list.append(new_name)
                length_list.append(len(n_motion))
            if whole:
                data_dict[name] = {"motion": motion, "length": len(motion),
                                   "text": text_data}
                new_name_list.append(name)
                length_list.append(len(motion))

        if not new_name_list:
            raise FileNotFoundError(
                f"no usable motions under {cfg.data_root} (split {split})")
        pairs = sorted(zip(new_name_list, length_list), key=lambda x: x[1])
        self.name_list = [p[0] for p in pairs]
        self.length_arr = np.array([p[1] for p in pairs])
        self.data_dict = data_dict

        if normalizer is None:
            # every kept motion in data_dict's order, as the JAX package
            # concatenates them: the float32 sums depend on it
            all_frames = np.concatenate(
                [d["motion"] for d in data_dict.values()], axis=0)
            normalizer = MotionNormalizer(
                all_frames.mean(axis=0), MotionNormalizer.apply_feat_bias(
                    all_frames.std(axis=0), cfg.num_joints, cfg.feat_bias))
        self.normalizer = normalizer

        # native batch assembly: the raw motions registered once, then
        # crop + pad + normalise per batch in C++ threads
        self._store = None
        self._native_idx: Dict[str, int] = {}
        if use_native if use_native is not None else cfg.use_native_io:
            from motiondiffusion_moe_tpu_torch.data.native import (
                NativeMotionStore)
            store = NativeMotionStore()  # raises if it cannot be built
            for name in self.name_list:
                self._native_idx[name] = store.add_array(
                    self.data_dict[name]["motion"])
            self._store = store

    @property
    def has_native(self) -> bool:
        return self._store is not None

    def get_batch(self, indices: List[int], seed: int
                  ) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """(captions, motions [B, max_len, D], lengths [B]). The captions
        are drawn in Python from ``self.rng``; with the native store the
        motions are cropped, padded and normalised in C++ with crops drawn
        from ``seed``, else item by item in Python."""
        if self._store is None:
            from motiondiffusion_moe_tpu_torch.data.loader import collate
            return collate([self[i] for i in indices])
        captions: List[str] = []
        store_idx: List[int] = []
        for item in indices:
            name = self.name_list[item % self.real_len()]
            captions.append(
                self.rng.choice(self.data_dict[name]["text"]).caption)
            store_idx.append(self._native_idx[name])
        motions, lengths = self._store.assemble_batch(
            store_idx, self.cfg.max_motion_length, self.normalizer.mean,
            self.normalizer.std, seed=seed)
        return captions, motions, lengths

    def real_len(self) -> int:
        return len(self.data_dict)

    def __len__(self) -> int:
        return self.real_len() * self.times

    def __getitem__(self, item: int) -> Tuple[str, np.ndarray, int]:
        data = self.data_dict[self.name_list[item % self.real_len()]]
        motion, m_length = data["motion"], data["length"]
        caption = self.rng.choice(data["text"]).caption
        max_len = self.cfg.max_motion_length
        if m_length >= max_len:
            start = self.rng.randint(0, len(motion) - max_len)
            motion = motion[start: start + max_len]
            m_length = max_len
        else:
            motion = np.concatenate(
                [motion, np.zeros((max_len - m_length, motion.shape[1]),
                                  dtype=motion.dtype)], axis=0)
        motion = self.normalizer.normalize_np(motion).astype(np.float32)
        return caption, motion, m_length


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
