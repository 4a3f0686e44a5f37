"""Top-k Switch-style Mixture-of-Experts feed-forward.

Port of ``motiondiffusion_moe_tpu/models/moe.py``, ``dense_fused`` path
(``moe.py:86-169``): f32 router softmax, top-k with ties broken toward the
lowest expert index (what ``jax.lax.top_k`` does; ``torch.topk`` promises no
order, and at init the zero gate makes every probability equal), all
experts as two stacked matmuls with the combine weights applied to the
hidden activations. The ``dense`` and ``dispatch`` paths come with the
expert-parallel port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu_torch.models.embeddings import StylizationBlock
from motiondiffusion_moe_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    gelu,
    lecun_normal_,
)


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

    def forward(self, x: torch.Tensor, with_metrics: bool = False):
        """x: [..., D] -> same shape; with ``with_metrics`` also returns
        :func:`moe_metrics` of this call's routing."""
        dt = self.dtype
        shape = x.shape
        x_flat = x.reshape(-1, shape[-1]).to(dt)
        S, D = x_flat.shape
        E, _, hid = self.w1.shape
        probs = torch.softmax(self.gate(x_flat).float(), dim=-1)
        top_vals, top_idx = top_k_lowest_index(probs, self.top_k)
        combine = torch.zeros(S, E, dtype=dt, device=x.device).scatter_add_(
            1, top_idx, top_vals.to(dt))
        w1m = self.w1.to(dt).permute(1, 0, 2).reshape(D, E * hid)
        h = (x_flat @ w1m).view(S, E, hid) + self.b1.to(dt)
        h = gelu(h) * combine[:, :, None]
        out = (h.reshape(S, E * hid) @ self.w2.to(dt).reshape(E * hid, D)
               + combine @ self.b2.to(dt))
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
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_branches = num_branches
        for i in range(num_branches):
            self.add_module(f"branch_{i}_norm", LayerNorm(latent_dim, dtype))
            self.add_module(f"branch_{i}_moe", SwitchMoELayer(
                latent_dim, ffn_dim, num_experts, top_k, dtype))
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim,
                                         latent_dim, dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        out = 0.0
        for i in range(self.num_branches):
            norm = getattr(self, f"branch_{i}_norm")
            out = out + getattr(self, f"branch_{i}_moe")(norm(x))
        return x + self.proj_out(out / self.num_branches, emb)


class DenseFFN(nn.Module):
    """Dense multi-branch FFN for the no-MoE config."""

    def __init__(self, latent_dim: int, ffn_dim: int, num_branches: int = 2,
                 time_embed_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_branches = num_branches
        for i in range(num_branches):
            self.add_module(f"branch_{i}_norm", LayerNorm(latent_dim, dtype))
            self.add_module(f"branch_{i}_fc1",
                            Dense(latent_dim, ffn_dim, dtype))
            self.add_module(f"branch_{i}_fc2",
                            Dense(ffn_dim, latent_dim, dtype))
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim,
                                         latent_dim, dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        out = 0.0
        for i in range(self.num_branches):
            h = getattr(self, f"branch_{i}_norm")(x)
            h = gelu(getattr(self, f"branch_{i}_fc1")(h))
            out = out + getattr(self, f"branch_{i}_fc2")(h)
        return x + self.proj_out(out / self.num_branches, emb)
