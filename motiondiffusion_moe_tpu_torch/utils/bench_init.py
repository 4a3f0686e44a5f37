"""Fast non-degenerate benchmark weights.

Port of ``motiondiffusion_moe_tpu/utils/bench_init.py``. All-zero weights
are numerically degenerate for training benchmarks (every LayerNorm input
is the zero vector, the L2 stabilisation's backward amplifies by 1/1e-12
and the clipped update is NaN from the first step), and the flax
initialisers are slower than a benchmark needs. :func:`random_benchmark_params`
fills a module's parameters in place, on their device, from one
``torch.Generator``: ones for a ``*scale`` leaf, zeros for a ``*bias`` leaf
and for non-float and 0-d tensors, otherwise a normal with std
``1 / sqrt(fan_in)``, fan-in the flax leaf's ``shape[-2]`` (``shape[-1]``
at rank 1). The names and shapes are the flax tree's, read through
``models/bridge.py::flax_leaf``, so the rule picks the leaves the JAX
function picks (a LayerNorm ``weight`` is a flax ``scale``; the MoE ``b1``
/ ``b2`` are no ``bias`` and draw a normal, as in JAX). The draws are not
JAX's: the two random streams differ.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def random_benchmark_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer of ``model`` in its state_dict (the
    flax tree's leaves) in place; returns ``model``."""
    from motiondiffusion_moe_tpu_torch.models.bridge import flax_leaf

    modules = dict(model.named_modules())
    entries = model.state_dict(keep_vars=True)
    device = next(iter(entries.values())).device if entries else "cpu"
    g = torch.Generator(device).manual_seed(seed)
    for key, t in entries.items():
        _, name, flax = flax_leaf(key, torch.empty(t.shape, device="meta"),
                                  modules)
        name = name.lower()
        if name.endswith("scale"):
            t.fill_(1.0)
        elif (name.endswith("bias") or t.dim() == 0
              or not t.is_floating_point()):
            t.zero_()
        else:
            fan_in = flax.shape[-2] if flax.dim() >= 2 else flax.shape[-1]
            t.normal_(0.0, (1.0 / max(fan_in, 1)) ** 0.5, generator=g)
    return model
