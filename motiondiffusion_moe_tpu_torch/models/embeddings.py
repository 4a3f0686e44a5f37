"""Conditioning modules: time embedding, time-text fusion, AdaLN.

Port of ``motiondiffusion_moe_tpu/models/embeddings.py``: ``grad_clamp``
(an identity forward whose backward clamps the cotangent), the time
embedding, the time-text fusion, ``StylizationBlock`` (with its dropout on
the unfused path and its ``fused`` attribute) and ``stochastic_depth``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu_torch.models.layers import (
    LN_EPS,
    Dense,
    TrainContext,
    dropout,
    xavier_normal_,
)
from motiondiffusion_moe_tpu_torch.ops.activations import sigmoid, silu
from motiondiffusion_moe_tpu_torch.ops.adaln import adaln_dense
from motiondiffusion_moe_tpu_torch.ops.performer import performer_epilogue


class _GradClamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.limit, ctx.limit), None


def grad_clamp(x: torch.Tensor, limit: float = 1.0) -> torch.Tensor:
    """Identity forward; the backward clamps the cotangent to [-limit,
    limit] (``embeddings.py:17-36``, the reference's per-tensor
    ``register_hook`` on q/k/v)."""
    return _GradClamp.apply(x, limit)


def stochastic_depth(block_fn, x: torch.Tensor, survival_prob: float,
                     training: bool,
                     ctx: Optional[TrainContext]) -> torch.Tensor:
    """Drop a whole residual block with probability 1 - p in training
    (``embeddings.py:192-206``): ONE coin for the whole batch, the input
    returned unchanged when dropped, no rescaling. Branchless, as in JAX:
    the block always runs (so its MoE aux losses always count) and the coin
    selects on the device, with no host sync."""
    if not training or survival_prob >= 1.0:
        return block_fn(x)
    if ctx is None or ctx.generator is None:
        raise ValueError("stochastic depth in training mode needs a "
                         "TrainContext with a torch.Generator")
    keep = torch.rand((), device=x.device,
                      generator=ctx.generator) < survival_prob
    return torch.where(keep, block_fn(x), x)


def timestep_sinusoidal(timesteps: torch.Tensor, dim: int,
                        max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep features, cos first (``embeddings.py:39-51``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedding(nn.Module):
    """Sinusoidal -> Dense(2D) -> SiLU -> Dense(D)."""

    def __init__(self, embed_dim: int, dtype: torch.dtype = torch.float32,
                 max_period: int = 10000):
        super().__init__()
        self.embed_dim = embed_dim
        self.max_period = max_period
        self.dtype = dtype
        self.mlp_0 = Dense(embed_dim, 2 * embed_dim, dtype)
        self.mlp_1 = Dense(2 * embed_dim, embed_dim, dtype)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        h = timestep_sinusoidal(timesteps, self.embed_dim, self.max_period)
        return self.mlp_1(self.mlp_0(h.to(self.dtype), "silu"))


class GatedFusion(nn.Module):
    """g = sigmoid(Wt t + Wx x); fused = MLP(g*t + (1-g)*x)."""

    def __init__(self, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj_time = Dense(embed_dim, embed_dim, dtype)
        self.proj_text = Dense(embed_dim, embed_dim, dtype)
        self.post_mlp_0 = Dense(embed_dim, embed_dim, dtype)
        self.post_mlp_1 = Dense(embed_dim, embed_dim, dtype)

    def forward(self, time_emb: torch.Tensor,
                text_emb: torch.Tensor) -> torch.Tensor:
        t = self.proj_time(time_emb)
        x = self.proj_text(text_emb)
        gating = sigmoid(t + x)
        fused = gating * t + (1 - gating) * x
        return self.post_mlp_1(self.post_mlp_0(fused, "silu"))


class StylizationBlock(nn.Module):
    """AdaLN / FiLM modulation: ``silu(norm(h) * (1 + scale) + shift) @ W +
    b`` with the learned ``emb_proj`` (the JAX package's fix for the
    reference's per-forward random projection).

    ``out_init`` / ``emb_init`` mirror ``out_kernel_init`` /
    ``emb_kernel_init``: the output kernel starts at zero except inside the
    Performer, whose module-wide xavier(0.1) re-init overrides it.
    ``pre_ln`` (the Performer's post-LN parameters) routes the whole
    normalisation chain through the fused :func:`performer_epilogue`; the
    caller takes that path only when no dropout is active. Otherwise, with
    ``fused`` set and no dropout active, the body is one
    :func:`adaln_dense` (LayerNorm, modulation and SiLU in f32, one rounding
    before the product and one after), the JAX ``fused`` attribute that no
    config sets. Dropout (rate ``dropout``, training mode only) acts on the
    modulated activations of the unfused path.
    """

    def __init__(self, latent_dim: int, time_embed_dim: int, emb_dim: int,
                 dtype: torch.dtype = torch.float32, out_init="zeros",
                 emb_init="lecun", dropout: float = 0.0, fused: bool = False):
        super().__init__()
        D = latent_dim
        self.dtype = dtype
        self.dropout = dropout
        self.fused = fused
        self.out_init = out_init
        self.emb_proj = (Dense(emb_dim, time_embed_dim, dtype, emb_init)
                         if emb_dim != time_embed_dim else None)
        self.emb_layers = Dense(time_embed_dim, 2 * D, dtype, emb_init)
        self.norm_scale = nn.Parameter(torch.ones(D))
        self.norm_bias = nn.Parameter(torch.zeros(D))
        self.out_kernel = nn.Parameter(torch.zeros(D, D))  # flax [in, out]
        self.out_bias = nn.Parameter(torch.zeros(D))

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        D = self.out_kernel.shape[0]
        if self.out_init == "zeros":
            self.out_kernel.zero_()
        else:
            xavier_normal_(self.out_kernel, D, D, self.out_init[1], g)
        self.norm_scale.fill_(1.0)
        self.norm_bias.zero_()
        self.out_bias.zero_()

    def forward(self, h: torch.Tensor, emb: torch.Tensor,
                pre_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        dt = self.dtype
        emb = (silu(emb) if self.emb_proj is None
               else self.emb_proj(emb, "silu"))
        scale, shift = self.emb_layers(emb).chunk(2, dim=-1)
        w, b = self.out_kernel.to(dt), self.out_bias.to(dt)
        if pre_ln is not None:
            if self.training and self.dropout > 0:
                raise ValueError("the fused epilogue path takes no dropout")
            # scale and shift stay the chunk views of the Dense's output:
            # the kernel reads their rows where they are
            hmod = performer_epilogue(
                h, scale.to(h.dtype), shift.to(h.dtype), pre_ln[0].float(),
                pre_ln[1].float(), self.norm_scale.float(),
                self.norm_bias.float())
            return hmod @ w + b
        if self.fused and not (self.training and self.dropout > 0):
            return adaln_dense(h, scale.contiguous(), shift.contiguous(),
                               self.norm_scale.float(),
                               self.norm_bias.float(), w, b)
        normed = F.layer_norm(h.float(), (h.shape[-1],),
                              self.norm_scale.float(), self.norm_bias.float(),
                              LN_EPS).to(dt)
        hmod = silu(normed * (1 + scale[:, None, :]) + shift[:, None, :])
        hmod = dropout(hmod, self.dropout, self.training, ctx)
        return hmod @ w + b
