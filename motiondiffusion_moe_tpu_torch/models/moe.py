"""Top-k Switch-style Mixture-of-Experts feed-forward.

Port of ``motiondiffusion_moe_tpu/models/moe.py`` on one device: f32 router
softmax, top-k with ties broken toward the lowest expert index (what
``jax.lax.top_k`` does; ``torch.topk`` promises no order, and at init the
zero gate makes every probability equal), then one of the three expert
computes of ``ModelConfig.moe_compute`` (``moe.py:124-234``):

- ``dense_fused`` (the default): all experts as two stacked matmuls with the
  combine weights applied to the hidden activations;
- ``dense``: per-expert products, each expert's output (its ``b2`` added in
  the compute dtype) weighted by the combine weights and summed over the
  experts in f32, rounded once, as XLA's dot computes the JAX einsum;
- ``dispatch``: static-capacity dispatch, ``_capacity_dispatch_ffn``. Each
  expert takes at most ``C = max(1, ceil(S * cf / E))`` tokens; slots fill
  choice by choice (every token's first choice, then its second) in the
  row order of the flattened ``[B * T]`` batch, padding frames included,
  and a token past an expert's capacity gets nothing from that expert. The
  JAX form builds one-hot ``[S, E, C]`` dispatch and combine tensors; here
  the slots are indices (:func:`capacity_slots`, static shapes, no host
  sync), the experts' inputs an ``index_add`` into ``[E, C, D]`` and the
  output a gather of each token's k slots, weighted and summed in f32: the
  same sums (a token has at most k terms), with no ``[S, E, C]`` tensor.
  The router gets gradient through the gate values of the kept slots only;
  positions carry none.

Routing, the aux loss and :func:`moe_metrics` are the same in all three. A
training forward appends each layer's Switch aux loss to its
:class:`TrainContext` (the JAX ``sow`` into ``moe_losses``,
``moe.py:105-109``).

Over several processes the layer takes the run's mesh
(``parallel/mesh.py::attach_mesh``; ``mesh`` in JAX, ``moe.py:178-195``).
With an expert axis (``ep > 1``) its ``w1``, ``b1``, ``w2``, ``b2`` hold the
rank's ``E / ep`` experts under the same names (``shard_params``), and
``dispatch`` runs ``parallel/moe_parallel.py::ep_moe_ffn`` (the
all-to-all, the capacity of the rank's own chunk) and ``dense``
``sharded_dense_ffn``; ``dense_fused`` cannot be cut by expert and is
refused.
Under ``dispatch`` the slots are routed as JAX's shard_map body routes
them, from the logits rounded to the compute dtype (the bf16 array handed
to ``ep_moe_ffn_sharded``, ``moe.py:187-188``); the aux loss and the metrics
keep the layer's routing. With data ranks alone (``ep = 1``) ``dispatch``
takes the global batch's capacity and fill order
(``global_dispatch_ffn``); the dense computes need nothing. In generation
(``mesh.rows_replicated``) the ranks of a data index hold the same tokens:
``dense`` runs ``replicated_dense_ffn`` and ``dispatch`` over an expert
axis ``replicated_ep_moe_ffn``, which cuts them into JAX's chunks. A seq
rank holds its own frames of its rows: the dense computes are per token,
and ``dispatch``, whose chunks and capacity JAX counts on the flattened
``[B * T]`` tokens of whole T, gathers the seq ranks' frames first
(``ExpertMesh.gather_frames``; in training its backward sums each frame's
gradient over the seq ranks), routes and dispatches as above, and keeps
its own frames of the output; every seq rank then holds the same whole-T
balance statistics, which the first of them counts (``MoEBalance.once``).
With a
model axis (``model_split``: the hidden width cut as JAX's Megatron rule
cuts it; the model ranks hold the same tokens) the experts' second product
is summed over the model ranks before ``b2`` (``expert_ffn_tp`` under
``dispatch``, ``sharded_dense_ffn`` under ``dense`` in training), and the
experts' input takes the model ranks' summed gradient (``column_input``);
the gate reads the whole, replicated input.

With ``MOE_FUSED_KERNEL`` set to anything but ``0``, an eval-mode
``dense_fused`` layer whose widths are multiples of 128 runs the expert
chain through :func:`ops.moe.moe_dense_fused` (the fused kernel on the
card): the JAX package's own switch and condition (``moe.py:144-162``),
read at every forward; it changes nothing under ``dense`` or
``dispatch``. That form keeps the bias, gelu and combine weighting in f32
and rounds once, where the inline chain rounds to the compute dtype after
each step; in f32 the two agree.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu_torch.models.embeddings import StylizationBlock
from motiondiffusion_moe_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MoEBalance,
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


def switch_balance(probs: torch.Tensor, top1_idx: torch.Tensor,
                   num_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f, P): each expert's share of the tokens' first choices (no
    gradient) and its mean router probability."""
    return (F.one_hot(top1_idx, num_experts).to(probs.dtype).mean(0),
            probs.mean(0))


def switch_aux_loss(probs: torch.Tensor, top1_idx: torch.Tensor,
                    num_experts: int) -> torch.Tensor:
    """Differentiable Switch load-balancing loss: E * sum_i f_i * P_i."""
    f, mean_p = switch_balance(probs, top1_idx, num_experts)
    return num_experts * torch.sum(f * mean_p)


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


MOE_COMPUTES = ("dense_fused", "dense", "dispatch")


def expert_capacity(S: int, num_experts: int, capacity_factor: float) -> int:
    """Tokens an expert takes under ``dispatch``: ``max(1, ceil(S * cf /
    E))``, computed as the JAX package does (``int(-(-S * cf // E))``, a
    float ``cf``); not multiplied by k."""
    return max(1, int(-(-S * capacity_factor // num_experts)))


def capacity_slots(top_idx: torch.Tensor, num_experts: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slots of a capacity dispatch: ``top_idx`` [S, k] -> (slot [S,
    k], keep [S, k]) with ``slot = expert * C + position``. Positions fill
    choice by choice, tokens in row order within a choice, each expert's
    count carried from one choice to the next (``fill``,
    ``moe.py:218-226``); a (token, choice) pair past capacity is dropped
    (``keep`` False) from that expert only. Static shapes: no host sync."""
    S, k = top_idx.shape
    fill = torch.zeros(num_experts, dtype=torch.long, device=top_idx.device)
    slots, keeps = [], []
    for j in range(k):
        e = top_idx[:, j]
        mask = F.one_hot(e, num_experts)                        # [S, E]
        pos = (mask.cumsum(0) - 1 + fill).gather(1, e[:, None])[:, 0]
        keep = pos < capacity
        fill = fill + (mask * keep[:, None]).sum(0)
        slots.append(e * capacity + pos)
        keeps.append(keep)
    return torch.stack(slots, 1), torch.stack(keeps, 1)


def dispatch_rows(x: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """The experts' input buffer [rows, D]: each kept (token, choice) pair's
    row at its slot (an ``index_add``), empty slots zero. A dropped pair's
    row goes to a spare slot past the last that nothing reads."""
    S, D = x.shape
    k = slot.shape[1]
    spare = torch.full_like(slot, rows)
    src = x[:, None, :].expand(S, k, D).reshape(S * k, D)
    return x.new_zeros(rows + 1, D).index_add(
        0, torch.where(keep, slot, spare).reshape(-1), src)[:rows]


def expert_ffn(expert_in: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """Each expert's FFN on its slots: [E, C, D] -> [E, C, D], the biases
    added in the compute dtype (empty slots get them too; no token reads
    them back)."""
    h = gelu(torch.bmm(expert_in, w1) + b1[:, None, :])
    return torch.bmm(h, w2) + b2[:, None, :]


def combine_rows(y: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                 top_vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The combine: a token's kept slots of ``y`` [rows, D], weighted and
    summed in f32 (at most k terms), rounded once -> [S, D]."""
    S, k = slot.shape
    weight = torch.where(keep, top_vals, 0).float()[..., None]
    picked = y[torch.where(keep, slot, 0).reshape(-1)].view(S, k, -1)
    return (weight * picked.float()).sum(1).to(dtype)


def capacity_dispatch_ffn(x: torch.Tensor, top_idx: torch.Tensor,
                          top_vals: torch.Tensor, w1, b1, w2, b2, *,
                          capacity_factor: float, ffn=expert_ffn
                          ) -> torch.Tensor:
    """``_capacity_dispatch_ffn`` (``moe.py:201-234``) with index gathers in
    place of the one-hot [S, E, C] tensors: x [S, D] in the compute dtype,
    top_idx / top_vals [S, k] (the values in the compute dtype), ``ffn`` the
    experts' FFN -> [S, D]."""
    S, D = x.shape
    E = w1.shape[0]
    C = expert_capacity(S, E, capacity_factor)
    slot, keep = capacity_slots(top_idx, E, C)
    y = ffn(dispatch_rows(x, slot, keep, E * C).view(E, C, D),
                   w1, b1, w2, b2)
    return combine_rows(y.view(E * C, D), slot, keep, top_vals, x.dtype)


class SwitchMoELayer(nn.Module):
    """Top-k gated MoE over per-token FFN experts (Dense(hidden) -> GELU ->
    Dense(latent)); the gate starts at zero. ``compute`` is one of
    ``MOE_COMPUTES`` (see the module doc); ``capacity_factor`` sizes the
    experts under ``dispatch``."""

    def __init__(self, latent_dim: int, hidden_dim: int, num_experts: int = 8,
                 top_k: int = 2, dtype: torch.dtype = torch.float32,
                 compute: str = "dense_fused", capacity_factor: float = 2.0):
        super().__init__()
        if compute not in MOE_COMPUTES:
            raise ValueError(f"unknown moe compute mode: {compute}")
        E, D = num_experts, latent_dim
        self.num_experts = num_experts
        self.top_k = top_k
        self.dtype = dtype
        self.compute = compute
        self.capacity_factor = capacity_factor
        self.mesh = None  # the run's ExpertMesh (parallel/mesh.py)
        self.model_split = False  # hidden width cut over the model axis
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
        layer's :func:`switch_balance`, which makes its aux loss, is
        appended to ``ctx.moe_balance`` (a ``MoEBalance``)."""
        dt = self.dtype
        mesh = self.mesh
        seq_cut = (self.compute == "dispatch" and mesh is not None
                   and mesh.sp > 1)
        if seq_cut:  # JAX's chunks are of whole T: gather the frames
            sizes = mesh.frame_sizes(x.shape[1], x.device)
            lo = sum(sizes[:mesh.s])
            # backward: each frame's gradient summed over the seq ranks
            x = mesh.gather_frames(x, sizes, backward="sum")
        shape = x.shape
        x_flat = x.reshape(-1, shape[-1]).to(dt)
        S, D = x_flat.shape
        E = self.num_experts
        probs = torch.softmax(self._router_logits(x_flat), dim=-1)
        top_vals, top_idx = top_k_lowest_index(probs, self.top_k)
        if ctx is not None:  # whole-T statistics count on one seq rank
            ctx.moe_balance.append(MoEBalance(
                *switch_balance(probs, top_idx[:, 0], E), S,
                not seq_cut or mesh.s == 0))
        w1, b1, w2, b2 = (p.to(dt) for p in (self.w1, self.b1, self.w2,
                                              self.b2))
        ep = mesh.ep if mesh is not None else 1
        over_ranks = mesh is not None and mesh.world > 1
        ffn, gen = expert_ffn, False
        if over_ranks:  # not at import: moe_parallel imports this module
            from motiondiffusion_moe_tpu_torch.parallel import (
                moe_parallel as MP)
            gen = mesh.rows_replicated  # the generation layout
            if self.model_split:
                ffn = functools.partial(MP.expert_ffn_tp, mesh=mesh)
        if self.compute == "dispatch":
            if ep > 1 and gen:
                out = MP.replicated_ep_moe_ffn(
                    x_flat, self.ep_routing, w1, b1, w2, b2,
                    capacity_factor=self.capacity_factor, num_experts=E,
                    mesh=mesh, model_split=self.model_split)
            elif ep > 1:
                vals, idx = self.ep_routing(x_flat)
                out = MP.ep_moe_ffn(
                    x_flat, idx, vals.to(dt), w1, b1, w2, b2,
                    capacity_factor=self.capacity_factor, num_experts=E,
                    group=mesh.expert, ffn=ffn)
            elif over_ranks and mesh.dp > 1:
                out = MP.global_dispatch_ffn(
                    x_flat, top_idx, top_vals.to(dt), w1, b1, w2, b2,
                    capacity_factor=self.capacity_factor, group=mesh.data,
                    ffn=ffn)
            else:
                out = capacity_dispatch_ffn(
                    x_flat, top_idx, top_vals.to(dt), w1, b1, w2, b2,
                    capacity_factor=self.capacity_factor, ffn=ffn)
        else:
            combine = torch.zeros(S, E, dtype=dt, device=x.device
                                  ).scatter_add_(1, top_idx, top_vals.to(dt))
            if over_ranks and gen and (ep > 1 or self.model_split):
                out = MP.replicated_dense_ffn(
                    x_flat, combine, w1, b1, w2, b2, mesh=mesh,
                    model_split=self.model_split)
            elif ep > 1 or self.model_split:
                out = MP.sharded_dense_ffn(x_flat, combine, w1, b1, w2, b2,
                                           mesh=mesh,
                                           model_split=self.model_split)
            else:
                out = self._dense(x_flat, combine, w1, b1, w2, b2)
        out = out.reshape(shape)
        if seq_cut:
            out = out[:, lo:lo + sizes[mesh.s]]
        if with_metrics:
            return out, moe_metrics(probs, top_vals, top_idx)
        return out

    def ep_routing(self, x_flat: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(top_vals, top_idx) of the expert-parallel ``dispatch``: from the
        logits rounded to the compute dtype, as JAX's shard_map body routes
        (the same as the layer's routing in f32)."""
        probs = torch.softmax(self._router_logits(x_flat).to(self.dtype)
                              .float(), dim=-1)
        return top_k_lowest_index(probs, self.top_k)

    def _dense(self, x_flat, combine, w1, b1, w2, b2) -> torch.Tensor:
        """The two dense computes: [S, D] -> [S, D]."""
        S, D = x_flat.shape
        E, _, hid = w1.shape
        if (self.compute == "dense_fused" and not self.training
                and hid % 128 == 0 and D % 128 == 0
                and os.environ.get("MOE_FUSED_KERNEL", "0") != "0"):
            return moe_dense_fused(x_flat, combine, w1, b1, w2, b2)
        w1m = w1.permute(1, 0, 2).reshape(D, E * hid)
        # the bias add in the compute dtype, then gelu: one pass
        h = gelu(x_flat @ w1m, b1.reshape(E * hid)).view(S, E, hid)
        if self.compute == "dense":
            # per expert [E, S, D], its bias added in the compute dtype
            y = torch.bmm(h.transpose(0, 1), w2) + b2[:, None, :]
            return torch.einsum("esd,se->sd", y.float(),
                                combine.float()).to(x_flat.dtype)
        h = h * combine[:, :, None]
        return h.reshape(S, E * hid) @ w2.reshape(E * hid, D) + combine @ b2


class MoEMultiBranchFFN(nn.Module):
    """N parallel [LayerNorm -> SwitchMoE] branches, averaged, with a
    stylization residual."""

    def __init__(self, latent_dim: int, ffn_dim: int, num_experts: int = 8,
                 num_branches: int = 2, top_k: int = 2,
                 time_embed_dim: int = 512,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 moe_compute: str = "dense_fused",
                 capacity_factor: float = 2.0):
        super().__init__()
        self.num_branches = num_branches
        self.dropout = dropout
        for i in range(num_branches):
            self.add_module(f"branch_{i}_norm", LayerNorm(latent_dim, dtype))
            self.add_module(f"branch_{i}_moe", SwitchMoELayer(
                latent_dim, ffn_dim, num_experts, top_k, dtype, moe_compute,
                capacity_factor))
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
            fc1 = getattr(self, f"branch_{i}_fc1")
            h = dropout(fc1(h, "gelu"), self.dropout, self.training, ctx,
                        (fc1.mesh.m, fc1.mesh.tp) if fc1.split else None)
            out = out + getattr(self, f"branch_{i}_fc2")(h)
        return x + self.proj_out(out / self.num_branches, emb, ctx=ctx)
