"""GloVe word vectorizer and POS one-hots for the evaluator.

The port's own copy of ``motiondiffusion_moe_tpu/eval/word_vectorizer.py``:
a 300-d GloVe lookup with the 15-way POS one-hot, including the
motion-specific VIP word classes. When the GloVe files are not on disk,
:class:`HashedWordVectorizer` is a deterministic stand-in with the same
interface (and the same vectors as the JAX package's), so that the
protocol still runs end to end.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

POS_enumerator = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5,
    "PRON": 6, "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10,
    "Obj_VIP": 11, "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

Loc_list = ("left", "right", "clockwise", "counterclockwise", "anticlockwise",
            "forward", "back", "backward", "up", "down", "straight", "curve")
Body_list = ("arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
             "waist", "eye", "knee", "shoulder", "thigh")
Obj_List = ("stair", "dumbbell", "chair", "window", "floor", "car", "ball",
            "handrail", "baseball", "basketball")
Act_list = ("walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
            "throw", "hop", "dance", "jump", "turn", "stumble", "dance",
            "stop", "sit", "lift", "lower", "raise", "wash", "stand", "kneel",
            "stroll", "rub", "bend", "balance", "flap", "jog", "shuffle",
            "lean", "rotate", "spin", "spread", "climb")
Desc_list = ("slowly", "carefully", "fast", "careful", "slow", "quickly",
             "happy", "angry", "sad", "happily", "angrily", "sadly")

VIP_dict = {
    "Loc_VIP": Loc_list,
    "Body_VIP": Body_list,
    "Obj_VIP": Obj_List,
    "Act_VIP": Act_list,
    "Desc_VIP": Desc_list,
}


def _pos_ohot(pos: str) -> np.ndarray:
    vec = np.zeros(len(POS_enumerator))
    vec[POS_enumerator.get(pos, POS_enumerator["OTHER"])] = 1
    return vec


def _vip_pos(word: str):
    for key, values in VIP_dict.items():
        if word in values:
            return key
    return None


class WordVectorizer:
    """GloVe-backed vectorizer (``word_vectorizer.py:46-80``). Items are
    ``"word/POS"`` strings; returns (300-d vec, 15-d one-hot)."""

    def __init__(self, meta_root: str, prefix: str = "our_vab"):
        vectors = np.load(os.path.join(meta_root, f"{prefix}_data.npy"))
        with open(os.path.join(meta_root, f"{prefix}_words.pkl"), "rb") as f:
            words = pickle.load(f)
        with open(os.path.join(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
            word2idx = pickle.load(f)
        self.word2vec = {w: vectors[word2idx[w]] for w in words}

    def __len__(self) -> int:
        return len(self.word2vec)

    def __getitem__(self, item: str) -> Tuple[np.ndarray, np.ndarray]:
        word, pos = item.split("/")
        if word in self.word2vec:
            word_vec = self.word2vec[word]
            vip = _vip_pos(word)
            pos_vec = _pos_ohot(vip) if vip is not None else _pos_ohot(pos)
        else:
            word_vec = self.word2vec["unk"]
            pos_vec = _pos_ohot("OTHER")
        return word_vec, pos_vec


class HashedWordVectorizer:
    """Deterministic GloVe stand-in: unit-normalized hash-seeded gaussian
    vectors per word, same ``word/POS`` protocol and VIP handling."""

    def __init__(self, dim: int = 300):
        self.dim = dim

    def __len__(self) -> int:
        return 1 << 30

    def _vec(self, word: str) -> np.ndarray:
        h = np.uint64(14695981039346656037)
        for ch in word.encode("utf-8"):
            h = np.uint64((int(h) ^ ch) * 1099511628211 % (1 << 64))
        rng = np.random.default_rng(int(h) % (1 << 63))
        v = rng.standard_normal(self.dim)
        return (v / np.linalg.norm(v)).astype(np.float32)

    def __getitem__(self, item: str) -> Tuple[np.ndarray, np.ndarray]:
        word, pos = item.split("/")
        vip = _vip_pos(word)
        pos_vec = _pos_ohot(vip) if vip is not None else _pos_ohot(pos)
        return self._vec(word), pos_vec


def get_word_vectorizer(meta_root: str = "./glove",
                        prefix: str = "our_vab"):
    """WordVectorizer when the GloVe files exist, hashed fallback otherwise."""
    try:
        return WordVectorizer(meta_root, prefix)
    except (FileNotFoundError, OSError):
        return HashedWordVectorizer()
