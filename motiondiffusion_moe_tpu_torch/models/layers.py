"""Building blocks with the JAX package's numerics, and the seeded init.

- :class:`Dense` is ``flax.linen.Dense(dtype=...)``: input, weight and bias
  cast to the compute dtype, weight stored ``[out, in]`` (torch layout; the
  bridge transposes flax's ``[in, out]`` kernel). In bf16, as in flax, the
  product is rounded before the bias is added; an activation that follows
  (``forward(x, "gelu")``) takes that add into its own pass
  (``ops/activations.py``).
- :func:`weak_scalar` is a Python float as JAX multiplies a compute-dtype
  array by it: rounded to that dtype first.
- :class:`LayerNorm` is the hot-path ``nn.LayerNorm``: statistics and the
  affine step in f32, eps 1e-6 (flax's default, not torch's 1e-5) unless
  given (DeBERTa's norms take 1e-7), result in the compute dtype.
- Excess precision: XLA's compiled program (the JAX package under ``jit``)
  leaves out the bf16 rounding of a value that the program widens to f32
  straight away. A LayerNorm reads the unrounded f32 result of the bias add
  or residual add in front of it (:func:`round_keeping_f32`), while every
  other consumer reads the rounded value; a bf16 :func:`softmax` sums its
  exponentials unrounded; the MoE router adds the gate's bias in f32.
- Parameters are created as zeros; :func:`init_weights` fills them from one
  ``torch.Generator``, mirroring the flax initialisers module by module
  (each module that owns parameters defines ``_init_own(g)``).
- Training: a module in ``train()`` mode is the JAX ``deterministic=False``.
  A training forward threads one :class:`TrainContext` through the modules:
  every random draw (:func:`dropout`, stochastic depth) comes from its
  ``torch.Generator``, never from torch's global RNG, and the MoE layers
  append their aux losses to it (the JAX ``sow`` into ``moe_losses``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu_torch.ops import activations

LN_EPS = 1e-6


class MoEBalance(NamedTuple):
    """One MoE layer's balance statistics in a training forward: ``f``
    and ``p`` (``moe.py::switch_balance``) over the ``tokens`` it routed,
    and whether this rank's are the ones a global batch counts (``once``:
    False on the seq ranks but the first where every seq rank routed the
    same whole T, as ``dispatch`` does)."""

    f: torch.Tensor
    p: torch.Tensor
    tokens: int
    once: bool = True


@dataclass
class TrainContext:
    """What one training forward threads through the modules: the generator
    every random draw comes from (on the activations' device), and each
    MoE layer's balance statistics (:class:`MoEBalance`), from which
    :attr:`aux_losses` are its Switch aux losses."""

    generator: Optional[torch.Generator] = None
    moe_balance: List[MoEBalance] = field(default_factory=list)
    # on a seq rank, (t0, t1, T): the frames of T that the activations at
    # the scale being run hold (set by the denoiser; None without a seq
    # mesh)
    frames: Optional[Tuple[int, int, int]] = None
    # on a pipe rank, each ring's aux: its stage's MoE aux losses summed
    # over its microbatches, over M (parallel/pipeline_parallel.py)
    stage_aux: List[torch.Tensor] = field(default_factory=list)

    @property
    def aux_losses(self) -> List[torch.Tensor]:
        """The MoE aux losses the forward collected, E * sum_i f_i P_i a
        layer."""
        return [b.f.numel() * torch.sum(b.f * b.p) for b in self.moe_balance]


def dropout(x: torch.Tensor, rate: float, training: bool,
            ctx: Optional[TrainContext],
            columns: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``flax.linen.Dropout(rate)(x, deterministic=not training)``: keep
    each element with probability 1 - rate and scale the kept ones by
    1 / (1 - rate). The mask is drawn from ``ctx.generator``; a training
    forward with dropout and no generator raises. ``columns = (m, tp)``:
    ``x`` is block m of ``tp`` equal blocks of the last dim (a column-split
    hidden). While ``ctx.frames = (t0, t1, T)`` is set (a seq rank's
    denoiser blocks in training), dim -2 of ``x`` is T and holds frames t0
    .. t1 - 1 of it. The whole mask is drawn, as one process draws it, and
    the rank's block of it kept, so that the generators of the ranks that
    share rows stay in step."""
    if not training or rate <= 0.0:
        return x
    if ctx is None or ctx.generator is None:
        raise ValueError("dropout in training mode needs a TrainContext "
                         "with a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    m, tp = columns or (0, 1)
    n = x.shape[-1]
    shape = x.shape[:-1] + (n * tp,)
    if ctx.frames is not None:
        t0, t1, T = ctx.frames
        shape = x.shape[:-2] + (T, n * tp)
    keep = torch.empty(shape, device=x.device).bernoulli_(
        1.0 - rate, generator=ctx.generator)[..., m * n:(m + 1) * n]
    if shape[:-1] != x.shape[:-1]:
        keep = keep[..., t0:t1, :]
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


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
    ("normal", std); the bias starts at zero. ``forward(x, activation)``
    applies "silu", "gelu" or "sigmoid" of ``ops/activations.py`` to the
    output."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, init="lecun"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype
        self.init = init
        # tensor parallelism (parallel/mesh.py::attach_mesh): "column" holds
        # the rank's output columns, "row" its input columns and sums the
        # model ranks' partial products
        self.split: Optional[str] = None
        self.mesh = None

    def forward(self, x: torch.Tensor,
                activation: Optional[str] = None) -> torch.Tensor:
        dt = self.dtype
        x, w, b = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        if self.split is not None:
            from motiondiffusion_moe_tpu_torch.parallel import (
                moe_parallel as MP)
            if self.split == "column":  # x's gradient summed over the ranks
                x = MP.column_input(x, self.mesh)
            else:
                # the product in dt (a partial sum over the rank's columns),
                # the ranks' sum and the bias, once, in f32, rounded once
                y = MP.row_parallel_sum(F.linear(x, w), b, self.mesh, True)
                return y if activation is None else getattr(activations,
                                                            activation)(y)
        if dt == torch.float32:  # one f32 rounding apart from flax's two
            y = F.linear(x, w, b)
            return y if activation is None else getattr(activations,
                                                        activation)(y)
        y = F.linear(x, w)  # rounded to dt, then the bias added in dt
        if activation is None:
            return y + b
        return getattr(activations, activation)(y, b)

    def forward_keeping_f32(self, x: torch.Tensor) -> torch.Tensor:
        """``forward(x)`` for a value that a :class:`LayerNorm` reads next:
        in bf16 it also carries the bias add's unrounded f32 result (see
        :func:`round_keeping_f32`)."""
        dt = self.dtype
        if dt == torch.float32:
            return self(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return round_keeping_f32(y.float() + self.bias.to(dt), dt)

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
    """``flax.linen.LayerNorm(epsilon=eps, dtype=...)``: f32 statistics,
    output cast to the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = getattr(x, "unrounded", x)  # see round_keeping_f32
        return F.layer_norm(x.float(), self.weight.shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.dtype)

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


def round_keeping_f32(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The f32 result ``y`` of an add, rounded to ``dtype``, carrying ``y``
    itself as ``.unrounded`` for a :class:`LayerNorm` that reads it next: in
    bf16 XLA's compiled program fuses the add with the LayerNorm's widening
    to f32 and leaves the rounding out there, while every other consumer of
    the value reads it rounded."""
    if dtype == torch.float32:
        return y
    out = y.to(dtype)
    out.unrounded = y
    return out


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax`` as XLA's compiled CPU program computes it. In bf16
    the shifted logits and the exponentials are rounded to bf16, but the
    sum takes the exponentials unrounded (``jnp.sum`` widens them to f32
    straight away), and the sum and the quotient are rounded; f32 is
    ``torch.softmax``."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim)
    e = torch.exp((x - x.amax(dim, keepdim=True)).float())
    # bf16 / bf16: the quotient of the rounded values, rounded once
    return e.to(x.dtype) / e.sum(dim, keepdim=True).to(x.dtype)


@functools.lru_cache(maxsize=None)
def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` as JAX multiplies an array of ``dtype`` by a weakly typed
    Python scalar: rounded to ``dtype`` first (0.1 is 0.10009765625 in
    bf16). Cached: the forward calls it per module with a few fixed
    values."""
    return torch.tensor(value, dtype=dtype).item()


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
