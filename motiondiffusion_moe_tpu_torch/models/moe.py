"""Top-k Switch-style Mixture-of-Experts feed-forward.

Port of ``motiondiffusion_moe_tpu/models/moe.py``, ``dense_fused`` path
(``moe.py:86-169``): f32 router softmax, top-k with ties broken toward the
lowest expert index (what ``jax.lax.top_k`` does; ``torch.topk`` promises no
order, and at init the zero gate makes every probability equal), all
experts as two stacked matmuls with the combine weights applied to the
hidden activations. The ``dense`` and ``dispatch`` paths come with the
expert-parallel port. A training forward appends each layer's Switch aux
loss to its :class:`TrainContext` (the JAX ``sow`` into ``moe_losses``,
``moe.py:105-109``).

With ``MOE_FUSED_KERNEL`` set to anything but ``0``, an eval-mode layer
whose widths are multiples of 128 runs the expert chain through
:func:`ops.moe.moe_dense_fused` (the fused kernel on the card): the JAX
package's own switch and condition (``moe.py:144-162``), read at every
forward. That form keeps the bias, gelu and combine weighting in f32 and
rounds once, where the inline chain rounds to the compute dtype after each
step; in f32 the two agree.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu_torch.models.embeddings import StylizationBlock
from motiondiffusion_moe_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    TrainContext,
    dropout,
    lecun_normal_,
)
from motiondiffusion_moe_tpu_torch.ops.activations import gelu
from motiondiffusion_moe_tpu_torch.ops.moe import moe_dense_fused


def top_k_lowest_index(probs: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; equal values keep ascending index order
    (a stable descending sort), matching ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def switch_aux_loss(probs: torch.Tensor, top1_idx: torch.Tensor,
                    num_experts: int) -> torch.Tensor:
    """Differentiable Switch load-balancing loss: E * sum_i f_i * P_i."""
    f = F.one_hot(top1_idx, num_experts).to(probs.dtype).mean(0)
    return num_experts * torch.sum(f * probs.mean(0))


def moe_metrics(probs: torch.Tensor, top_vals: torch.Tensor,
                top_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's usage / importance counters and the aux loss
    (what ``SwitchMoELayer`` sows in the JAX package)."""
    E = probs.shape[-1]
    usage = F.one_hot(top_idx[:, 0], E).float().sum(0)
    importance = (F.one_hot(top_idx, E).float()
                  * top_vals.float()[..., None]).sum((0, 1))
    return {"expert_usage": usage, "expert_importance": importance,
            "aux": switch_aux_loss(probs, top_idx[:, 0], E)}


class SwitchMoELayer(nn.Module):
    """Top-k gated MoE over per-token FFN experts (Dense(hidden) -> GELU ->
    Dense(latent)); the gate starts at zero."""

    def __init__(self, latent_dim: int, hidden_dim: int, num_experts: int = 8,
                 top_k: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        E, D = num_experts, latent_dim
        self.top_k = top_k
        self.dtype = dtype
        self.gate = Dense(D, E, dtype, init="zeros")
        self.w1 = nn.Parameter(torch.zeros(E, D, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(E, hidden_dim))
        self.w2 = nn.Parameter(torch.zeros(E, hidden_dim, D))
        self.b2 = nn.Parameter(torch.zeros(E, D))

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        # flax lecun_normal on a rank-3 kernel: fan_in = in * E
        E, D, hid = self.w1.shape
        lecun_normal_(self.w1, D * E, g)
        lecun_normal_(self.w2, hid * E, g)
        self.b1.zero_()
        self.b2.zero_()

    def _router_logits(self, x_flat: torch.Tensor) -> torch.Tensor:
        """The gate's logits in f32. In bf16 the product is rounded to bf16
        and the bias added in f32 without rounding the sum: the softmax
        widens it to f32 straight away, and XLA's compiled program leaves
        that rounding out."""
        if self.dtype == torch.float32:
            return self.gate(x_flat)
        dt = self.dtype
        y = F.linear(x_flat, self.gate.weight.to(dt))
        return y.float() + self.gate.bias.to(dt)

    def forward(self, x: torch.Tensor, with_metrics: bool = False,
                ctx: Optional[TrainContext] = None):
        """x: [..., D] -> same shape; with ``with_metrics`` also returns
        :func:`moe_metrics` of this call's routing. With a ``ctx`` the
        layer's aux loss is appended to ``ctx.aux_losses``."""
        dt = self.dtype
        shape = x.shape
        x_flat = x.reshape(-1, shape[-1]).to(dt)
        S, D = x_flat.shape
        E, _, hid = self.w1.shape
        probs = torch.softmax(self._router_logits(x_flat), dim=-1)
        top_vals, top_idx = top_k_lowest_index(probs, self.top_k)
        if ctx is not None:
            ctx.aux_losses.append(switch_aux_loss(probs, top_idx[:, 0], E))
        combine = torch.zeros(S, E, dtype=dt, device=x.device).scatter_add_(
            1, top_idx, top_vals.to(dt))
        w1, b1, w2, b2 = (p.to(dt) for p in (self.w1, self.b1, self.w2,
                                              self.b2))
        if (not self.training and hid % 128 == 0 and D % 128 == 0
                and os.environ.get("MOE_FUSED_KERNEL", "0") != "0"):
            out = moe_dense_fused(x_flat, combine, w1, b1, w2, b2)
        else:
            w1m = w1.permute(1, 0, 2).reshape(D, E * hid)
            # the bias add in the compute dtype, then gelu: one pass
            h = gelu(x_flat @ w1m, b1.reshape(E * hid)).view(S, E, hid)
            h = h * combine[:, :, None]
            out = h.reshape(S, E * hid) @ w2.reshape(E * hid, D) + combine @ b2
        out = out.reshape(shape)
        if with_metrics:
            return out, moe_metrics(probs, top_vals, top_idx)
        return out


class MoEMultiBranchFFN(nn.Module):
    """N parallel [LayerNorm -> SwitchMoE] branches, averaged, with a
    stylization residual."""

    def __init__(self, latent_dim: int, ffn_dim: int, num_experts: int = 8,
                 num_branches: int = 2, top_k: int = 2,
                 time_embed_dim: int = 512,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.num_branches = num_branches
        self.dropout = dropout
        for i in range(num_branches):
            self.add_module(f"branch_{i}_norm", LayerNorm(latent_dim, dtype))
            self.add_module(f"branch_{i}_moe", SwitchMoELayer(
                latent_dim, ffn_dim, num_experts, top_k, dtype))
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim,
                                         latent_dim, dtype, dropout=dropout)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        out = 0.0
        for i in range(self.num_branches):
            norm = getattr(self, f"branch_{i}_norm")
            h = getattr(self, f"branch_{i}_moe")(norm(x), ctx=ctx)
            out = out + dropout(h, self.dropout, self.training, ctx)
        return x + self.proj_out(out / self.num_branches, emb, ctx=ctx)


class DenseFFN(nn.Module):
    """Dense multi-branch FFN for the no-MoE config."""

    def __init__(self, latent_dim: int, ffn_dim: int, num_branches: int = 2,
                 time_embed_dim: int = 512,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.num_branches = num_branches
        self.dropout = dropout
        for i in range(num_branches):
            self.add_module(f"branch_{i}_norm", LayerNorm(latent_dim, dtype))
            self.add_module(f"branch_{i}_fc1",
                            Dense(latent_dim, ffn_dim, dtype))
            self.add_module(f"branch_{i}_fc2",
                            Dense(ffn_dim, latent_dim, dtype))
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim,
                                         latent_dim, dtype, dropout=dropout)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        out = 0.0
        for i in range(self.num_branches):
            h = getattr(self, f"branch_{i}_norm")(x)
            h = getattr(self, f"branch_{i}_fc1")(h, "gelu")
            h = dropout(h, self.dropout, self.training, ctx)
            out = out + getattr(self, f"branch_{i}_fc2")(h)
        return x + self.proj_out(out / self.num_branches, emb, ctx=ctx)
