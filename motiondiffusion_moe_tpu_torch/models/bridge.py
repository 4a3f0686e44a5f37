"""Weight bridge: a flax parameter tree -> the port's ``state_dict``.

Input: the ``params`` collection of a ``MotionTransformer`` as nested dicts
of numpy arrays (what ``jax.device_get(variables["params"])`` gives; this
module never imports JAX). A tree in the stacked ``scan_blocks`` layout
(``blocks_low/block/...`` with a leading layer axis) is unstacked first.

Mapping rules (each one is pinned by ``tests/test_torch_bridge.py``):

- a Dense ``kernel [in, out]`` -> ``weight [out, in]``; the Performer's
  merged ``qkv`` Dense is ``[D, 3D]`` with column blocks q|k|v, so its
  weight rows come out q|k|v as well;
- LayerNorm ``scale`` -> ``weight`` (eps stays 1e-6 in the module);
- ``nn.Embed`` ``embedding`` -> ``weight``;
- ``nn.Conv(k=2, s=2)`` kernel ``[k, in, out]`` -> ``Conv1d`` weight
  ``[out, in, k]``;
- ``nn.ConvTranspose(k=2, s=2)`` kernel ``[k, in, out]`` ->
  ``ConvTranspose1d`` weight ``[in, out, k]`` with the spatial axis flipped
  (flax does not transpose the kernel; torch's transposed convolution is
  the gradient of a correlation, which reverses it);
- the flax MHA ``DenseGeneral`` kernels of the text encoder, ``[D, H, dh]``
  (query/key/value) and ``[H, dh, D]`` (out), -> Linear weights
  ``[H*dh, D]`` and ``[D, H*dh]``; their ``[H, dh]`` biases are flattened;
- ``block_low_i`` / ``block_high_i`` -> ``blocks_low.i`` / ``blocks_high.i``;
- every other leaf (raw ``self.param`` arrays such as
  ``sequence_embedding``, ``fa_projection``, the MoE ``w1``/``w2``, the
  style blocks' ``out_kernel``) keeps its name and layout.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_MHA_PARTS = ("query", "key", "value", "out")


def unstack_block_params(params: Mapping) -> dict:
    """numpy copy of ``models/transformer.py::unstack_block_params`` on a
    ``params`` tree: ``blocks_low/block`` (leading [L] axis) -> named
    ``block_low_i`` subtrees. A tree without stacked scales passes
    through."""
    p = dict(params)
    for stacked, prefix in (("blocks_low", "block_low_"),
                            ("blocks_high", "block_high_")):
        if stacked not in p:
            continue
        sub = p.pop(stacked)["block"]
        L = _first_leaf(sub).shape[0]
        for i in range(L):
            p[f"{prefix}{i}"] = _map_leaves(sub, lambda x, i=i: x[i])
    return p


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


def _map_leaves(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(np.asarray(tree))


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _module_name(part: str) -> str:
    m = re.fullmatch(r"block_(low|high)_(\d+)", part)
    return f"blocks_{m.group(1)}.{m.group(2)}" if m else part


def convert_leaf(path: tuple, leaf: np.ndarray):
    """(torch key, numpy array) for one flax leaf at ``path``."""
    *mods, name = path
    parent = mods[-1] if mods else ""
    in_mha = len(mods) >= 2 and re.fullmatch(r"attn_\d+", mods[-2] or "")
    key_mods = [_module_name(m) for m in mods]
    x = leaf
    if name == "kernel":
        name = "weight"
        if parent == "downsample":            # [k, in, out] -> [out, in, k]
            x = x.transpose(2, 1, 0)
        elif parent == "upsample":            # flip k; -> [in, out, k]
            x = x[::-1].transpose(1, 2, 0)
        elif in_mha and parent in _MHA_PARTS and x.ndim == 3:
            if parent == "out":               # [H, dh, D] -> [D, H*dh]
                x = x.reshape(-1, x.shape[-1]).T
            else:                             # [D, H, dh] -> [H*dh, D]
                x = x.reshape(x.shape[0], -1).T
        elif x.ndim == 2:
            x = x.T
        else:
            raise ValueError(f"unexpected kernel {'/'.join(path)} "
                             f"{x.shape}")
    elif name == "bias" and in_mha and x.ndim == 2:
        x = x.reshape(-1)                     # [H, dh] -> [H*dh]
    elif name == "scale":
        name = "weight"
    elif name == "embedding":
        name = "weight"
    return ".".join(key_mods + [name]), np.ascontiguousarray(x)


def jax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``MotionTransformer`` state_dict for a flax ``params``
    tree (named or stacked layout). Load it with
    ``model.load_state_dict(sd, strict=True)``, which also checks that
    every parameter was covered."""
    if "params" in params:  # a whole variables dict
        params = params["params"]
    sd = {}
    for path, leaf in _flatten(unstack_block_params(params)).items():
        key, x = convert_leaf(path, leaf)
        sd[key] = torch.from_numpy(np.array(x, dtype=np.float32))
    return sd
