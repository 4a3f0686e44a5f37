"""Conditioning modules: time embedding, time-text fusion, AdaLN.

Port of ``motiondiffusion_moe_tpu/models/embeddings.py``. ``grad_clamp`` (an
identity forward whose backward clamps the cotangent) is the identity here:
the sampling path never differentiates; its ``autograd.Function`` comes with
the training port.
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
    xavier_normal_,
)
from motiondiffusion_moe_tpu_torch.ops.performer import performer_epilogue


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
        return self.mlp_1(F.silu(self.mlp_0(h.to(self.dtype))))


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
        gating = torch.sigmoid(t + x)
        fused = gating * t + (1 - gating) * x
        return self.post_mlp_1(F.silu(self.post_mlp_0(fused)))


class StylizationBlock(nn.Module):
    """AdaLN / FiLM modulation: ``silu(norm(h) * (1 + scale) + shift) @ W +
    b`` with the learned ``emb_proj`` (the JAX package's fix for the
    reference's per-forward random projection).

    ``out_init`` / ``emb_init`` mirror ``out_kernel_init`` /
    ``emb_kernel_init``: the output kernel starts at zero except inside the
    Performer, whose module-wide xavier(0.1) re-init overrides it.
    ``pre_ln`` (the Performer's post-LN parameters) routes the whole
    normalisation chain through the fused :func:`performer_epilogue`.
    """

    def __init__(self, latent_dim: int, time_embed_dim: int, emb_dim: int,
                 dtype: torch.dtype = torch.float32, out_init="zeros",
                 emb_init="lecun"):
        super().__init__()
        D = latent_dim
        self.dtype = dtype
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
                pre_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        dt = self.dtype
        if self.emb_proj is not None:
            emb = self.emb_proj(emb)
        scale, shift = self.emb_layers(F.silu(emb)).chunk(2, dim=-1)
        w, b = self.out_kernel.to(dt), self.out_bias.to(dt)
        if pre_ln is not None:
            hmod = performer_epilogue(
                h, scale.to(h.dtype).contiguous(),
                shift.to(h.dtype).contiguous(), pre_ln[0].float(),
                pre_ln[1].float(), self.norm_scale.float(),
                self.norm_bias.float())
            return hmod @ w + b
        normed = F.layer_norm(h.float(), (h.shape[-1],),
                              self.norm_scale.float(), self.norm_bias.float(),
                              LN_EPS).to(dt)
        hmod = F.silu(normed * (1 + scale[:, None, :]) + shift[:, None, :])
        return hmod @ w + b
