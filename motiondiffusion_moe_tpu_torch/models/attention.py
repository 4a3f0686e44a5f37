"""Attention suite: Performer (FAVOR+) self-attention, linear and exact text
cross-attention.

Port of ``motiondiffusion_moe_tpu/models/attention.py``. The Performer has
both JAX forms. The fused one (``fused=True``, the default): a merged
``[D, 3D]`` qkv Dense and the FAVOR+ core as one kernel of
``ops/performer.py``, differentiable through its backward kernel. The
unfused one (``fused=False``): three ``query``/``key``/``value`` Dense
layers, head transposes and :class:`FastAttention`, whose core is
``ops/performer.py::favor_attention``. Both share the MLP and the epilogue
kernel. ``use_kernels=False`` keeps the same parameters and computes the
fused FAVOR+ core and the epilogue with plain PyTorch, as the JAX field
does; ``FastAttention(use_pallas=False)`` does the same for its core. In
training mode (``module.train()``, the JAX ``deterministic=False``) the
dropout sites of the JAX modules are live, with masks drawn from the
forward's :class:`TrainContext`, and the Performer takes the unfused
epilogue whenever dropout is active, as JAX does.
``CrossAttentionBlock(use_fast_xattn=True)`` runs its attention through
``ops/flash_attention.py::xattn_fastlayout`` whenever dropout is inactive
(the JAX ``use_fast_xattn`` path).

On a rank of a seq mesh (``seq``, the seq ranks' group, set by
``parallel/mesh.py::attach_mesh``) a Performer holds its own frames of T,
and the FAVOR+ kv, the one sum over T, is closed across the ranks: the
moments of its frames (``favor_qkv_moments``, or kernel 8's), an f32
all-reduce over ``seq``, then the apply (``favor_qkv_apply``), kernels or
plain versions as ``use_kernels`` / ``use_pallas`` say
(``ops/performer.py::favor_qkv_split``, ``favor_attention_split`` and
their plain forms). Under grad the backward closes kv and g_kv over the
ranks the same way (kernel 3 in three launches). Everything else in a block
is per position or over the text tokens; a dropout on the rank's frames
draws the whole T's mask (``models/layers.py::dropout``, ``ctx.frames``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu_torch.models.embeddings import (
    StylizationBlock,
    grad_clamp,
)
from motiondiffusion_moe_tpu_torch.models.layers import (
    LN_EPS,
    Dense,
    LayerNorm,
    TrainContext,
    dropout,
    round_keeping_f32,
    softmax,
    weak_scalar,
)
from motiondiffusion_moe_tpu_torch.ops.activations import gelu, sigmoid
from motiondiffusion_moe_tpu_torch.ops.flash_attention import (
    xattn_fastlayout,
)
from motiondiffusion_moe_tpu_torch.ops.performer import (
    favor_attention,
    favor_attention_plain,
    favor_attention_split,
    favor_attention_split_plain,
    favor_qkv,
    favor_qkv_plain,
    favor_qkv_split,
    favor_qkv_split_plain,
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


def _l2_compute_dtype(x: torch.Tensor) -> torch.Tensor:
    """``x / max(jnp.linalg.norm(x), 1e-12)`` in x's dtype, rounded where
    XLA rounds it (``attention.py:83-84``): the squares and their sum in f32
    (the compiler fuses the compute-dtype square into the f32 reduction),
    the sum rounded to x's dtype, then the square root and the division in
    x's dtype."""
    xf = x.float()
    n = torch.sqrt((xf * xf).sum(-1, keepdim=True).to(x.dtype))
    return x / n.clamp_min(1e-12)


class FastAttention(nn.Module):
    """FAVOR+ linear attention core of the unfused Performer
    (``attention.py:55-104``). q, k, v: [B, H, T, D] in the compute dtype;
    mask [B, T, 1], [B, 1, T] or [B, T]. One LayerNorm (``norm``: f32
    statistics, compute-dtype result) normalises q, k, v and the output;
    q and k are L2-normalised in the compute dtype; the core runs in f32
    through :func:`favor_attention` (``use_pallas``) or its plain version.
    ``projection`` [D, m] is fixed: it gets no gradient."""

    def __init__(self, head_dim: int, num_features: int = 256,
                 eps: float = 1e-6, use_pallas: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.use_pallas = use_pallas
        self.norm = LayerNorm(head_dim, dtype)
        self.projection = nn.Parameter(torch.zeros(head_dim, num_features),
                                       requires_grad=False)
        self.dtype = dtype
        self.seq = None  # the seq ranks' group under a seq mesh

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        self.projection.copy_(orthogonal_feature_init(
            *self.projection.shape, g))

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.norm(q), self.norm(k), self.norm(v)
        q, k = _l2_compute_dtype(q), _l2_compute_dtype(k)
        if mask is not None:
            mask = mask.float()
            if mask.dim() == 3 and mask.shape[-1] == 1:  # [B, T, 1]
                mask = mask.transpose(1, 2)
            elif mask.dim() == 2:                         # [B, T]
                mask = mask[:, None, :]
            mask = mask.contiguous()
        q, k, v = (t.float().contiguous() for t in (q, k, v))
        proj = self.projection.float()
        if self.seq is not None:  # kv closed over the seq ranks
            split = (favor_attention_split if self.use_pallas
                     else favor_attention_split_plain)
            out = split(q, k, v, proj, mask, self.seq, self.eps)
        else:
            fn = favor_attention if self.use_pallas else favor_attention_plain
            out = fn(q, k, v, proj, mask, self.eps)
        return self.norm(out.to(self.dtype))


class PerformerSelfAttention(nn.Module):
    """Performer self-attention block (``attention.py:107-238``):
    x + 0.1 * style(epilogue(MLP(favor(q, k, v)))). ``fused`` picks the
    JAX form (see the module doc); the two have different parameters, and
    ``models/bridge.py::unfuse_performers`` carries a fused block's
    parameters to an unfused twin."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 num_features: int = 256, use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 fused: bool = True):
        super().__init__()
        D = latent_dim
        self.num_heads = num_heads
        self.head_dim = D // num_heads
        self.num_features = num_features
        self.time_embed_dim = time_embed_dim
        self.use_kernels = use_kernels
        self.dtype = dtype
        self.dropout = dropout
        self.fused = fused
        self.seq = None  # the seq ranks' group under a seq mesh
        xav = ("xavier", 0.1)  # fast_attention.py:155-158
        self.pre_norm = LayerNorm(D, dtype)
        if fused:
            # per-block torch xavier(0.1) statistics: std 0.1*sqrt(2/(D+D))
            self.qkv = Dense(D, 3 * D, dtype,
                             ("normal", 0.1 * (1.0 / D) ** 0.5))
            self.fa_norm_scale = nn.Parameter(torch.ones(self.head_dim))
            self.fa_norm_bias = nn.Parameter(torch.zeros(self.head_dim))
            self.fa_projection = nn.Parameter(
                torch.zeros(self.head_dim, num_features), requires_grad=False)
        else:
            self.query = Dense(D, D, dtype, xav)
            self.key = Dense(D, D, dtype, xav)
            self.value = Dense(D, D, dtype, xav)
            # always the kernel, as JAX builds it; use_kernels governs only
            # the epilogue in this form
            self.fast_attention = FastAttention(self.head_dim, num_features,
                                                dtype=dtype)
        self.proj_out_0 = Dense(D, D, dtype, xav)
        self.proj_out_1 = Dense(D, D, dtype, xav)
        self.post_norm_scale = nn.Parameter(torch.ones(D))
        self.post_norm_bias = nn.Parameter(torch.zeros(D))
        self.style_block = StylizationBlock(D, time_embed_dim, D, dtype,
                                            out_init=xav, emb_init=xav,
                                            dropout=dropout)

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        if self.fused:
            self.fa_norm_scale.fill_(1.0)
            self.fa_norm_bias.zero_()
            self.fa_projection.copy_(orthogonal_feature_init(
                self.head_dim, self.num_features, g))
        self.post_norm_scale.fill_(1.0)
        self.post_norm_bias.zero_()

    def _unfused_attention(self, h, src_mask, ctx):
        """``attention.py:181-198``: three Dense layers, heads scaled by
        0.1 in the compute dtype, FastAttention, dropout, heads back."""
        B, T, D = h.shape
        H = self.num_heads
        tenth = weak_scalar(0.1, self.dtype)

        def heads(t):
            return grad_clamp(t).view(B, T, H, -1).transpose(1, 2) * tenth

        attn = self.fast_attention(heads(self.query(h)), heads(self.key(h)),
                                   heads(self.value(h)), src_mask)
        attn = dropout(attn, self.dropout, self.training, ctx)
        return attn.transpose(1, 2).reshape(B, T, D)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        """x: [B, T, D]; emb: [B, D_emb]; src_mask: [B, T] float or None."""
        D = x.shape[-1]
        p, training = self.dropout, self.training
        h = self.pre_norm(x)
        if self.fused:
            qkv = grad_clamp(self.qkv(h))
            ln = (self.fa_norm_scale.float(), self.fa_norm_bias.float(),
                  self.fa_projection.float())
            if self.seq is not None:  # kv closed over the seq ranks
                split = (favor_qkv_split if self.use_kernels
                         else favor_qkv_split_plain)
                attn = split(qkv, *ln, src_mask, self.seq)
            else:
                favor = favor_qkv if self.use_kernels else favor_qkv_plain
                attn = favor(qkv, *ln, src_mask)
            attn = dropout(attn, p, training, ctx)
        else:
            attn = self._unfused_attention(h, src_mask, ctx)
        attn = dropout(self.proj_out_0(attn, "gelu"), p, training, ctx)
        attn = dropout(self.proj_out_1(attn), p, training, ctx)
        if self.use_kernels and not (training and p > 0):
            style_out = self.style_block(
                attn, emb, pre_ln=(self.post_norm_scale, self.post_norm_bias))
        else:
            hf = F.layer_norm(attn.float(), (D,), self.post_norm_scale.float(),
                              self.post_norm_bias.float(), LN_EPS)
            hf = hf / torch.linalg.vector_norm(
                hf, dim=-1, keepdim=True).clamp_min(1e-12) * (D ** 0.5)
            style_out = self.style_block(hf.to(self.dtype), emb, ctx=ctx)
        res = weak_scalar(0.1, style_out.dtype) * style_out
        return round_keeping_f32(x.float() + res, x.dtype)


class DualSelfAttentionBlock(nn.Module):
    """Two stacked Performers ('local' then 'global') + projected skip."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 num_features: int = 256, use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        D = latent_dim
        self.dropout = dropout
        self.pre_norm = LayerNorm(D, dtype)
        self.local_attn = PerformerSelfAttention(
            D, num_heads, time_embed_dim, num_features, use_kernels, dtype,
            dropout)
        self.global_attn = PerformerSelfAttention(
            D, num_heads, time_embed_dim, num_features, use_kernels, dtype,
            dropout)
        self.skip_proj = Dense(D, D, dtype)
        self.post_norm = LayerNorm(D, dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        local_out = self.local_attn(self.pre_norm(x), emb, src_mask, ctx)
        global_out = self.global_attn(local_out, emb, src_mask, ctx)
        if self.training and self.dropout > 0:
            skip = gelu(dropout(self.skip_proj(x), self.dropout, True, ctx))
        else:
            skip = self.skip_proj(x, "gelu")
        res = weak_scalar(0.1, global_out.dtype) * global_out
        return self.post_norm(skip.float() + res)  # unrounded


class LinearTemporalCrossAttention(nn.Module):
    """Softmax-kernel linear cross-attention over text tokens with a scalar
    sigmoid gate, in the batched-head form (``attention.py:330-337``; the
    per-head slicing of ``:302-321`` is a TPU layout trick, same math)."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 time_embed_dim: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        D = latent_dim
        self.num_heads = num_heads
        self.norm = LayerNorm(D, dtype)
        self.text_norm = LayerNorm(text_latent_dim, dtype)
        self.query = Dense(D, D, dtype)
        self.key = Dense(text_latent_dim, D, dtype)
        self.value = Dense(text_latent_dim, D, dtype)
        self.adaptive_gate = nn.Parameter(torch.zeros(1))
        self.proj_out = StylizationBlock(D, time_embed_dim, D, dtype,
                                         dropout=dropout)
        self.dtype = dtype

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        self.adaptive_gate.zero_()

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        B, T, D = x.shape
        N = xf.shape[1]
        H = self.num_heads
        tn = self.text_norm(xf)
        q = softmax(self.query(self.norm(x)).view(B, T, H, -1), dim=-1)
        k = softmax(self.key(tn).view(B, N, H, -1), dim=1)
        v = self.value(tn).view(B, N, H, -1)
        attention = torch.einsum("bnhd,bnhl->bhdl", k, v)
        y = torch.einsum("bnhd,bhdl->bnhl", q, attention).reshape(B, T, D)
        alpha = sigmoid(self.adaptive_gate.to(self.dtype))
        return x + alpha * self.proj_out(y, emb, ctx=ctx)


class GatedCrossAttention(nn.Module):
    """Per-channel gated wrapper around LinearTemporalCrossAttention."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 time_embed_dim: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.base_ca = LinearTemporalCrossAttention(
            latent_dim, text_latent_dim, num_heads, time_embed_dim, dtype,
            dropout)
        self.gate = nn.Parameter(torch.zeros(latent_dim))
        self.dtype = dtype

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        self.gate.zero_()

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        ca_out = self.base_ca(x, xf, emb, ctx)
        alpha = sigmoid(self.gate.to(self.dtype)).view(1, 1, -1)
        res = alpha * (ca_out - x)
        return round_keeping_f32(x.float() + res, x.dtype)


class CrossAttentionBlock(nn.Module):
    """Exact softmax cross-attention + small residual FFN with no key mask
    (``attention.py:394-438``). With ``use_fast_xattn`` and dropout
    inactive, the attention is the fast-layout kernel on the Dense outputs
    (f32 probabilities and product, one rounding); otherwise the
    whole-sequence einsum form (probabilities rounded to the compute dtype
    before ``probs @ v``)."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 use_fast_xattn: bool = False):
        super().__init__()
        D = latent_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_fast_xattn = use_fast_xattn
        self.query = Dense(D, D, dtype)
        self.key = Dense(text_latent_dim, D, dtype)
        self.value = Dense(text_latent_dim, D, dtype)
        self.out = Dense(D, D, dtype)
        self.ffn_norm = LayerNorm(D, dtype)
        self.ffn_0 = Dense(D, 4 * D, dtype)
        self.ffn_1 = Dense(4 * D, D, dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, xf: torch.Tensor,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        B, T, D = x.shape
        N = xf.shape[1]
        H = self.num_heads
        scale = (D // H) ** -0.5
        q, k, v = self.query(x), self.key(xf), self.value(xf)
        if self.use_fast_xattn and not (self.training and self.dropout > 0):
            out = xattn_fastlayout(q, k, v, H, scale)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk",
                                  q.view(B, T, H, -1)
                                  * weak_scalar(scale, q.dtype),
                                  k.view(B, N, H, -1))
            probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
            probs = dropout(probs, self.dropout, self.training, ctx)
            out = torch.einsum("bhqk,bkhd->bqhd", probs,
                               v.view(B, N, H, -1)).reshape(B, T, D)
        out = self.out.forward_keeping_f32(out)
        h = self.ffn_1(self.ffn_0(self.ffn_norm(out), "gelu"))
        h = dropout(h, self.dropout, self.training, ctx)
        return round_keeping_f32(x.float() + (out + h), x.dtype)
