"""Weight bridge: a flax parameter tree <-> the port's ``state_dict``.

Input of :func:`jax_to_state_dict`: the ``params`` collection of a
``MotionTransformer`` as nested dicts of numpy arrays (what
``jax.device_get(variables["params"])`` gives; this module never imports
JAX). A tree in the stacked ``scan_blocks`` layout (``blocks_low/block/...``
with a leading layer axis) is unstacked first. A bf16 leaf (a
``torch.bfloat16`` tensor, as ``utils/flax_msgpack.py`` reads one, or a
numpy array of JAX's bf16 dtype) stays bf16, its words moved as they are;
every other leaf becomes f32.
:func:`state_dict_to_jax` is the inverse, into the named layout.

Mapping rules (each one is pinned by ``tests/test_torch_bridge.py``):

- a Dense ``kernel [in, out]`` -> ``weight [out, in]``; the Performer's
  merged ``qkv`` Dense is ``[D, 3D]`` with column blocks q|k|v, so its
  weight rows come out q|k|v as well;
- LayerNorm ``scale`` -> ``weight`` (eps stays in the module: 1e-6, and
  1e-7 in DeBERTa's backbone);
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
  style blocks' ``out_kernel``) keeps its name and layout. An unfused
  Performer's tree (``query``/``key``/``value`` Dense kernels,
  ``fast_attention/norm/{scale,bias}``, ``fast_attention/projection``)
  follows the same rules.

:func:`unfuse_performers` carries a fused Performer's parameters to an
unfused twin, as ``tests/test_ops.py`` grafts them in the JAX package: the
merged qkv weight and bias split into their q|k|v blocks, ``fa_norm_*``
becomes the shared ``fast_attention.norm``, ``fa_projection`` its
``projection``, and the rest is copied.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from motiondiffusion_moe_tpu_torch.utils.flax_msgpack import (
    bf16_words,
    is_bf16,
)

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


def _leaf(x):
    """A leaf as an array: torch tensors as they are, the rest as numpy."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return _leaf(tree)


def _map_leaves(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(_leaf(tree))


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = _leaf(v)
    return out


def _as_array(leaf) -> np.ndarray:
    """A leaf as numpy with no copy where one is not needed: a bf16 leaf as
    its uint16 words (the layout rules only move words, so its bits stay
    as they are, never widened), every other leaf as f32."""
    if is_bf16(leaf):
        return bf16_words(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().float().numpy()
    return np.asarray(leaf, dtype=np.float32)


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
    return ".".join(key_mods + [name]), _contiguous(x)


def _contiguous(x: np.ndarray, tile: int = 128) -> np.ndarray:
    """``np.ascontiguousarray(x)``; a transposed 2-D view is copied in
    square tiles, which keeps both sides in cache (several times faster
    than numpy's strided copy for a large kernel)."""
    if (x.ndim != 2 or x.flags.c_contiguous or x.strides[0] >= x.strides[1]
            or min(x.shape) < tile):
        return np.ascontiguousarray(x)
    out = np.empty(x.shape, x.dtype)
    for i in range(0, x.shape[0], tile):
        for j in range(0, x.shape[1], tile):
            out[i:i + tile, j:j + tile] = x[i:i + tile, j:j + tile]
    return out


def jax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``MotionTransformer`` state_dict for a flax ``params``
    tree (named or stacked layout): f32 tensors, and bf16 ones for the bf16
    leaves (the same bits). Load it with
    ``model.load_state_dict(sd, strict=True)``, which also checks that
    every parameter was covered (and widens bf16 into an f32 module; keep
    the bf16 storage with ``GenerationPipeline.set_params``). A tensor
    whose layout needs no change shares a writable leaf's memory; every
    other tensor (a re-laid-out leaf, or one that is read-only, as a JAX
    array's host copy is) owns fresh memory."""
    if "params" in params:  # a whole variables dict
        params = params["params"]
    sd = {}
    for path, leaf in _flatten(unstack_block_params(params)).items():
        words = _as_array(leaf)
        key, x = convert_leaf(path, words)
        if np.may_share_memory(x, words) and not x.flags.writeable:
            x = x.copy()
        t = torch.from_numpy(x)
        sd[key] = t.view(torch.bfloat16) if is_bf16(leaf) else t
    return sd


def _flax_parts(key: str) -> list:
    """A state_dict key's module path in the flax tree: ``blocks_low.3`` ->
    ``block_low_3``."""
    out = []
    for p in key.split(".") if key else ():
        if p.isdigit() and out and out[-1] in ("blocks_low", "blocks_high"):
            out[-1] = f"block_{out[-1][len('blocks_'):]}_{p}"
        else:
            out.append(p)
    return out


def flax_leaf(key: str, x: torch.Tensor, modules: Mapping[str, nn.Module]
              ) -> Tuple[list, str, torch.Tensor]:
    """A state_dict entry's place in the flax tree: (module path, leaf name,
    the tensor in flax's layout), the inverse of :func:`convert_leaf`.
    ``modules`` is ``dict(model.named_modules())``; ``x`` may live on any
    device, the meta device included."""
    from motiondiffusion_moe_tpu_torch.models.layers import LayerNorm
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        MultiHeadDotProductAttention)

    mod_name, _, name = key.rpartition(".")
    module = modules[mod_name]
    parent = modules.get(mod_name.rpartition(".")[0])
    mha = (isinstance(parent, MultiHeadDotProductAttention)
           and mod_name.rpartition(".")[2] in _MHA_PARTS)
    if name == "weight":
        if isinstance(module, nn.ConvTranspose1d):
            name, x = "kernel", x.permute(2, 0, 1).flip(0)
        elif isinstance(module, nn.Conv1d):
            name, x = "kernel", x.permute(2, 1, 0)
        elif isinstance(module, nn.Embedding):
            name = "embedding"
        elif isinstance(module, LayerNorm):
            name = "scale"
        elif mha:
            H = parent.num_heads
            name = "kernel"
            if mod_name.endswith(".out"):   # [D, H*dh] -> [H, dh, D]
                x = x.T.reshape(H, -1, x.shape[0])
            else:                           # [H*dh, D] -> [D, H, dh]
                x = x.T.reshape(x.shape[1], H, -1)
        else:
            name, x = "kernel", x.T
    elif name == "bias" and mha and not mod_name.endswith(".out"):
        x = x.reshape(parent.num_heads, -1)  # [H*dh] -> [H, dh]
    return _flax_parts(mod_name), name, x


def state_dict_to_jax(sd: Mapping[str, torch.Tensor], cfg) -> dict:
    """The flax ``params`` tree (named layout) of a port ``MotionTransformer``
    state_dict: the inverse of :func:`jax_to_state_dict`, case by case of
    :func:`convert_leaf` (:func:`flax_leaf`). ``cfg`` (a ``ModelConfig`` or
    an ``ExperimentConfig``) gives the module of each key, built on the
    meta device: a ``Conv1d`` / ``ConvTranspose1d`` weight goes back to the
    flax ``[k, in, out]`` kernel (the transposed one flipped back), a text
    encoder attention part's weight and bias to the ``DenseGeneral`` shapes
    of its head count, a LayerNorm weight to ``scale``, an ``Embedding``'s
    to ``embedding``, any other weight to the transposed ``kernel``. Leaves
    are f32 numpy arrays, and ``torch.bfloat16`` tensors (CPU, contiguous)
    where the state_dict holds bf16."""
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    cfg = getattr(cfg, "model", cfg)
    with torch.device("meta"):
        model = MotionTransformer(cfg, use_kernels=False)
    modules = dict(model.named_modules())
    tree: dict = {}
    for key, value in sd.items():
        # re-laid out where the tensor lives, then one copy to the host
        parts, name, x = flax_leaf(key, value.detach(), modules)
        x = x.contiguous().cpu()
        leaf = x if x.dtype == torch.bfloat16 else x.float().numpy()
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


# fused Performer leaf -> its place in the unfused twin
_FA_PARAMS = {"fa_norm_scale": "fast_attention.norm.weight",
              "fa_norm_bias": "fast_attention.norm.bias",
              "fa_projection": "fast_attention.projection"}


def unfuse_performer_state(sd: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """The state_dict of the unfused twin of every fused Performer in
    ``sd`` (one Performer's state_dict or a whole model's): each
    ``<p>qkv.weight`` [3D, D] / ``<p>qkv.bias`` [3D] becomes
    ``<p>query``/``key``/``value`` (row blocks q|k|v); ``<p>fa_norm_scale``,
    ``fa_norm_bias`` and ``fa_projection`` move under
    ``<p>fast_attention``; every other key is kept."""
    out = {}
    for key, x in sd.items():
        head, sep, last = key.rpartition(".")
        parent = head.rpartition(".")[2]
        if parent == "qkv" and last in ("weight", "bias"):
            base = head[:len(head) - len("qkv")]
            for part, block in zip(("query", "key", "value"),
                                   x.chunk(3, dim=0)):
                out[f"{base}{part}.{last}"] = block.clone()
        elif last in _FA_PARAMS:
            out[f"{head}{sep}{_FA_PARAMS[last]}"] = x
        else:
            out[key] = x
    return out


def unfuse_performers(model: nn.Module) -> nn.Module:
    """Replace, in place, every fused ``PerformerSelfAttention`` inside
    ``model`` by its unfused twin (``fused=False``) holding the same
    parameters (:func:`unfuse_performer_state`), on the same device, with
    each parameter in its source's dtype and the same mode and switches.
    Returns ``model``."""
    from motiondiffusion_moe_tpu_torch.models.attention import (
        PerformerSelfAttention)

    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if not (isinstance(child, PerformerSelfAttention) and child.fused):
                continue
            sd = unfuse_performer_state(child.state_dict())
            twin = PerformerSelfAttention(
                child.pre_norm.weight.shape[0], child.num_heads,
                child.time_embed_dim, child.num_features, child.use_kernels,
                child.dtype, child.dropout, fused=False)
            twin.style_block.fused = child.style_block.fused
            twin.load_state_dict(sd, strict=True)
            twin.to(child.pre_norm.weight.device).train(child.training)
            with torch.no_grad():
                for key, p in twin.named_parameters():
                    p.data = p.data.to(sd[key].dtype)
            setattr(parent, name, twin)
    return model
