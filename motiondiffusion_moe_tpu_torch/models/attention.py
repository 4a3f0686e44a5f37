"""Attention suite: Performer (FAVOR+) self-attention, linear and exact text
cross-attention.

Port of ``motiondiffusion_moe_tpu/models/attention.py`` for sampling: the
fused Performer form only (merged ``[D, 3D]`` qkv Dense, the FAVOR+ core
and the epilogue as the two kernels of ``ops/performer.py``), no dropout.
``use_kernels=False`` keeps the same parameters and computes the FAVOR+ core
and the epilogue with plain PyTorch, as the JAX field does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu_torch.models.embeddings import StylizationBlock
from motiondiffusion_moe_tpu_torch.models.layers import (
    LN_EPS,
    Dense,
    LayerNorm,
    gelu,
)
from motiondiffusion_moe_tpu_torch.ops.performer import (
    favor_qkv,
    favor_qkv_plain,
)


def orthogonal_feature_init(d: int, m: int,
                            g: torch.Generator) -> torch.Tensor:
    """Orthogonal random-feature matrix [d, m], column-normalized and scaled
    by d**-0.25 (``attention.py:41-52``): the leading [d, m] block of a
    random orthogonal max(d, m)-square matrix."""
    n = max(d, m)
    q, r = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))
    q = q * torch.sign(torch.diagonal(r))[None, :]
    w = q[:d, :m]
    w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True)
    return (w * d ** -0.25).float()


class PerformerSelfAttention(nn.Module):
    """Performer self-attention block, fused form
    (``attention.py:107-238``): x + 0.1 * style(epilogue(MLP(favor(qkv))))."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 num_features: int = 256, use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        D = latent_dim
        self.head_dim = D // num_heads
        self.num_features = num_features
        self.use_kernels = use_kernels
        self.dtype = dtype
        xav = ("xavier", 0.1)  # fast_attention.py:155-158
        self.pre_norm = LayerNorm(D, dtype)
        # per-block torch xavier(0.1) statistics: std 0.1*sqrt(2/(D+D))
        self.qkv = Dense(D, 3 * D, dtype, ("normal", 0.1 * (1.0 / D) ** 0.5))
        self.fa_norm_scale = nn.Parameter(torch.ones(self.head_dim))
        self.fa_norm_bias = nn.Parameter(torch.zeros(self.head_dim))
        self.fa_projection = nn.Parameter(
            torch.zeros(self.head_dim, num_features), requires_grad=False)
        self.proj_out_0 = Dense(D, D, dtype, xav)
        self.proj_out_1 = Dense(D, D, dtype, xav)
        self.post_norm_scale = nn.Parameter(torch.ones(D))
        self.post_norm_bias = nn.Parameter(torch.zeros(D))
        self.style_block = StylizationBlock(D, time_embed_dim, D, dtype,
                                            out_init=xav, emb_init=xav)

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        self.fa_norm_scale.fill_(1.0)
        self.fa_norm_bias.zero_()
        self.fa_projection.copy_(orthogonal_feature_init(
            self.head_dim, self.num_features, g))
        self.post_norm_scale.fill_(1.0)
        self.post_norm_bias.zero_()

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, T, D]; emb: [B, D_emb]; src_mask: [B, T] float or None."""
        D = x.shape[-1]
        qkv = self.qkv(self.pre_norm(x))
        favor = favor_qkv if self.use_kernels else favor_qkv_plain
        attn = favor(qkv, self.fa_norm_scale.float(),
                     self.fa_norm_bias.float(), self.fa_projection.float(),
                     src_mask)
        attn = self.proj_out_1(gelu(self.proj_out_0(attn)))
        if self.use_kernels:
            style_out = self.style_block(
                attn, emb, pre_ln=(self.post_norm_scale, self.post_norm_bias))
        else:
            hf = F.layer_norm(attn.float(), (D,), self.post_norm_scale.float(),
                              self.post_norm_bias.float(), LN_EPS)
            hf = hf / torch.linalg.vector_norm(
                hf, dim=-1, keepdim=True).clamp_min(1e-12) * (D ** 0.5)
            style_out = self.style_block(hf.to(self.dtype), emb)
        return x + 0.1 * style_out


class DualSelfAttentionBlock(nn.Module):
    """Two stacked Performers ('local' then 'global') + projected skip."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 num_features: int = 256, use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        D = latent_dim
        self.pre_norm = LayerNorm(D, dtype)
        self.local_attn = PerformerSelfAttention(
            D, num_heads, time_embed_dim, num_features, use_kernels, dtype)
        self.global_attn = PerformerSelfAttention(
            D, num_heads, time_embed_dim, num_features, use_kernels, dtype)
        self.skip_proj = Dense(D, D, dtype)
        self.post_norm = LayerNorm(D, dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        local_out = self.local_attn(self.pre_norm(x), emb, src_mask)
        global_out = self.global_attn(local_out, emb, src_mask)
        skip = gelu(self.skip_proj(x))
        return self.post_norm(skip + 0.1 * global_out)


class LinearTemporalCrossAttention(nn.Module):
    """Softmax-kernel linear cross-attention over text tokens with a scalar
    sigmoid gate, in the batched-head form (``attention.py:330-337``; the
    per-head slicing of ``:302-321`` is a TPU layout trick, same math)."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 time_embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        D = latent_dim
        self.num_heads = num_heads
        self.norm = LayerNorm(D, dtype)
        self.text_norm = LayerNorm(text_latent_dim, dtype)
        self.query = Dense(D, D, dtype)
        self.key = Dense(text_latent_dim, D, dtype)
        self.value = Dense(text_latent_dim, D, dtype)
        self.adaptive_gate = nn.Parameter(torch.zeros(1))
        self.proj_out = StylizationBlock(D, time_embed_dim, D, dtype)
        self.dtype = dtype

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        self.adaptive_gate.zero_()

    def forward(self, x: torch.Tensor, xf: torch.Tensor,
                emb: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        N = xf.shape[1]
        H = self.num_heads
        tn = self.text_norm(xf)
        q = torch.softmax(self.query(self.norm(x)).view(B, T, H, -1), dim=-1)
        k = torch.softmax(self.key(tn).view(B, N, H, -1), dim=1)
        v = self.value(tn).view(B, N, H, -1)
        attention = torch.einsum("bnhd,bnhl->bhdl", k, v)
        y = torch.einsum("bnhd,bhdl->bnhl", q, attention).reshape(B, T, D)
        alpha = torch.sigmoid(self.adaptive_gate.to(self.dtype))
        return x + alpha * self.proj_out(y, emb)


class GatedCrossAttention(nn.Module):
    """Per-channel gated wrapper around LinearTemporalCrossAttention."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 time_embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.base_ca = LinearTemporalCrossAttention(
            latent_dim, text_latent_dim, num_heads, time_embed_dim, dtype)
        self.gate = nn.Parameter(torch.zeros(latent_dim))
        self.dtype = dtype

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        self.gate.zero_()

    def forward(self, x: torch.Tensor, xf: torch.Tensor,
                emb: torch.Tensor) -> torch.Tensor:
        ca_out = self.base_ca(x, xf, emb)
        alpha = torch.sigmoid(self.gate.to(self.dtype)).view(1, 1, -1)
        return x + alpha * (ca_out - x)


class CrossAttentionBlock(nn.Module):
    """Exact softmax cross-attention + small residual FFN, whole-sequence
    einsum form with no key mask (``attention.py:417-438``)."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        D = latent_dim
        self.num_heads = num_heads
        self.query = Dense(D, D, dtype)
        self.key = Dense(text_latent_dim, D, dtype)
        self.value = Dense(text_latent_dim, D, dtype)
        self.out = Dense(D, D, dtype)
        self.ffn_norm = LayerNorm(D, dtype)
        self.ffn_0 = Dense(D, 4 * D, dtype)
        self.ffn_1 = Dense(4 * D, D, dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        N = xf.shape[1]
        H = self.num_heads
        scale = (D // H) ** -0.5
        q = self.query(x).view(B, T, H, -1)
        k = self.key(xf).view(B, N, H, -1)
        v = self.value(xf).view(B, N, H, -1)
        scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
        probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
        out = self.out(out)
        h = self.ffn_1(gelu(self.ffn_0(self.ffn_norm(out))))
        return x + (out + h)
