"""Building blocks with the JAX package's numerics, and the seeded init.

- :class:`Dense` is ``flax.linen.Dense(dtype=...)``: input, weight and bias
  cast to the compute dtype, weight stored ``[out, in]`` (torch layout; the
  bridge transposes flax's ``[in, out]`` kernel).
- :class:`LayerNorm` is the hot-path ``nn.LayerNorm``: statistics and the
  affine step in f32, eps 1e-6 (not torch's 1e-5), result in the compute
  dtype.
- Parameters are created as zeros; :func:`init_weights` fills them from one
  ``torch.Generator``, mirroring the flax initialisers module by module
  (each module that owns parameters defines ``_init_own(g)``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  g: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: variance_scaling(1, fan_in, truncated_normal)
    (std corrected for the +-2 sigma truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


def xavier_normal_(t: torch.Tensor, fan_in: int, fan_out: int, gain: float,
                   g: torch.Generator) -> torch.Tensor:
    """flax ``variance_scaling(gain**2, fan_avg, normal)`` (torch
    xavier_normal_ with ``gain``)."""
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return nn.init.normal_(t, 0.0, std, generator=g)


class Dense(nn.Module):
    """``flax.linen.Dense`` in a compute dtype. ``init`` mirrors its
    ``kernel_init``: "lecun" (flax default), "zeros", ("xavier", gain) or
    ("normal", std); the bias starts at zero."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, init="lecun"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype
        self.init = init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        out_f, in_f = self.weight.shape
        w = torch.empty(in_f, out_f)  # draw in flax's [in, out] layout
        if self.init == "lecun":
            lecun_normal_(w, in_f, g)
        elif self.init == "zeros":
            w.zero_()
        elif self.init[0] == "xavier":
            xavier_normal_(w, in_f, out_f, self.init[1], g)
        elif self.init[0] == "normal":
            nn.init.normal_(w, 0.0, self.init[1], generator=g)
        else:
            raise ValueError(f"unknown Dense init {self.init!r}")
        self.weight.copy_(w.t())
        self.bias.zero_()


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=...)``: f32 statistics, eps 1e-6,
    output cast to the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape,
                            self.weight.float(), self.bias.float(),
                            LN_EPS).to(self.dtype)

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter of ``module`` from ``torch.Generator`` seeded
    with ``seed``, mirroring the JAX package's initialisers. Deterministic:
    modules are visited in registration order."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        init_own = getattr(m, "_init_own", None)
        if init_own is not None:
            init_own(g)
    return module
