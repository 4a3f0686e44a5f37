"""Expert-parallel MoE FFN over ``torch.distributed``: the port of
``motiondiffusion_moe_tpu/parallel/moe_parallel.py`` and of what XLA's SPMD
partitioner makes of the ``dense`` einsums on an ``expert`` axis.

- :func:`ep_moe_ffn` (``dispatch``, ``ep > 1``; JAX ``ep_moe_ffn`` :68-109,
  ``ep_moe_ffn_sharded`` :190-230): each rank routes its own token chunk
  and fills an ``[E, C, D]`` buffer with the capacity of that chunk, ``C =
  max(1, ceil(S_loc cf / E))`` (the slots of ``models/moe.py::
  capacity_slots``); an all-to-all over the expert group sends expert
  block j to rank j, which runs its ``E / ep`` experts on ``[E / ep, ep C,
  D]`` and sends the results back by the inverse all-to-all; the combine
  reads each token's kept slots. The all-to-all is an autograd Function
  whose backward is the same all-to-all (with equal blocks, its own
  transpose).
- :func:`ep_dense_ffn` (``dense``, ``ep > 1``): each rank runs its experts
  on every token of its expert group (an all-gather of the tokens and the
  combine weights), weights its experts' outputs in f32, and a
  reduce-scatter of those f32 partial sums gives each rank its tokens,
  rounded once, as the one-device ``_dense`` rounds (``models/moe.py``).
  The all-gather's backward is a reduce-scatter and the reduce-scatter's
  an all-gather.
- :func:`global_dispatch_ffn` (``dispatch``, ``ep = 1`` over data ranks):
  JAX runs ``_capacity_dispatch_ffn`` on the global token array (capacity
  ``ceil(S_global cf / E)``, the fill in global row order). Here a slot's
  global position is its rank-local cumsum plus the lower ranks' counts
  for the same choice (one all-gather of a ``[W, k, E]`` count a layer)
  plus the fill carried over from the earlier choices. The experts are
  replicated and a token's output reads only its own slots, so no token
  moves: each rank runs its kept pairs in a buffer of its own, and nothing
  crosses ranks in the backward.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from motiondiffusion_moe_tpu_torch.models.moe import (
    capacity_slots,
    combine_rows,
    dispatch_rows,
    expert_capacity,
    expert_ffn,
    top_k_lowest_index,
)
from motiondiffusion_moe_tpu_torch.ops.activations import gelu


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_to_all(g), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.reduce_scatter(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g), None


def ep_moe_ffn(x: torch.Tensor, top_idx: torch.Tensor,
               top_vals: torch.Tensor, w1, b1, w2, b2, *,
               capacity_factor: float, num_experts: int, group
               ) -> torch.Tensor:
    """x [S_loc, D] (this rank's tokens, compute dtype), top_idx / top_vals
    [S_loc, k] (the values in the compute dtype), ``w1`` ... the rank's
    ``E / ep`` experts; ``group`` the expert group (a ``DataGroup``) ->
    [S_loc, D]."""
    S, D = x.shape
    ep, E = group.world, num_experts
    e_local = w1.shape[0]
    if e_local * ep != E:
        raise ValueError(f"{e_local} experts a rank x {ep} ranks != {E}")
    C = expert_capacity(S, E, capacity_factor)
    slot, keep = capacity_slots(top_idx, E, C)
    expert_in = dispatch_rows(x, slot, keep, E * C)
    # block j (experts of rank j) to rank j; block i of the result holds
    # rank i's tokens for this rank's experts
    expert_in = _AllToAll.apply(expert_in, group)
    expert_in = expert_in.view(ep, e_local, C, D).transpose(0, 1).reshape(
        e_local, ep * C, D)
    y = expert_ffn(expert_in, w1, b1, w2, b2)
    y = y.view(e_local, ep, C, D).transpose(0, 1).reshape(E * C, D)
    y = _AllToAll.apply(y, group)  # this rank's slots of every expert
    return combine_rows(y, slot, keep, top_vals, x.dtype)


def ep_dense_ffn(x: torch.Tensor, combine: torch.Tensor, w1, b1, w2, b2,
                 *, group) -> torch.Tensor:
    """``dense`` with the experts cut over the expert group: x [S_loc, D],
    combine [S_loc, E] (compute dtype), the rank's experts -> [S_loc, D]."""
    e_local, D, hid = w1.shape
    xg = _AllGather.apply(x, group)
    cg = _AllGather.apply(combine, group)
    lo = group.rank * e_local
    S = xg.shape[0]
    w1m = w1.permute(1, 0, 2).reshape(D, e_local * hid)
    h = gelu(xg @ w1m, b1.reshape(e_local * hid)).view(S, e_local, hid)
    y = torch.bmm(h.transpose(0, 1), w2) + b2[:, None, :]
    part = torch.einsum("esd,se->sd", y.float(),
                        cg[:, lo:lo + e_local].float())
    return _ReduceScatter.apply(part, group).to(x.dtype)


def global_keep(top_idx: torch.Tensor, num_experts: int, capacity: int,
                group) -> torch.Tensor:
    """keep [S_loc, k] of ``_capacity_dispatch_ffn`` on the global token
    array that the ranks of ``group`` hold in rank order."""
    E = num_experts
    k = top_idx.shape[1]
    counts = F.one_hot(top_idx, E).sum(0)                       # [k, E]
    every = group.all_gather(counts[None])                      # [W, k, E]
    before = every[:group.rank].sum(0)
    total = every.sum(0)
    fill = torch.zeros(E, dtype=torch.long, device=top_idx.device)
    keeps = []
    for j in range(k):
        e = top_idx[:, j]
        mask = F.one_hot(e, E)
        pos = (mask.cumsum(0) - 1 + before[j] + fill).gather(1, e[:, None])
        keeps.append(pos[:, 0] < capacity)
        # positions fill..fill+total-1 go to expert e; those below C stay
        fill = fill + (capacity - fill).clamp(min=0).minimum(total[j])
    return torch.stack(keeps, 1)


def global_dispatch_ffn(x: torch.Tensor, top_idx: torch.Tensor,
                        top_vals: torch.Tensor, w1, b1, w2, b2, *,
                        capacity_factor: float, group) -> torch.Tensor:
    """``dispatch`` over data ranks with replicated experts: the global
    batch's capacity and fill order (see the module doc)."""
    S, D = x.shape
    E = w1.shape[0]
    C = expert_capacity(S * group.world, E, capacity_factor)
    keep = global_keep(top_idx, E, C, group)
    # this rank's kept pairs, each expert's in fill order: at most
    # min(C, S) an expert, since a token picks an expert once
    c_local = min(C, S)
    fill = torch.zeros(E, dtype=torch.long, device=x.device)
    slots = []
    for j in range(top_idx.shape[1]):
        e = top_idx[:, j]
        mask = F.one_hot(e, E) * keep[:, j, None]
        pos = (mask.cumsum(0) - 1 + fill).gather(1, e[:, None])[:, 0]
        fill = fill + mask.sum(0)
        slots.append(e * c_local + pos)
    slot = torch.stack(slots, 1)
    expert_in = dispatch_rows(x, slot, keep, E * c_local)
    y = expert_ffn(expert_in.view(E, c_local, D), w1, b1, w2, b2)
    return combine_rows(y.view(E * c_local, D), slot, keep, top_vals,
                        x.dtype)


def make_ep_moe_layer(mesh, num_experts: int, top_k: int = 2,
                      capacity_factor: float = 2.0
                      ) -> Callable[[torch.Tensor, Dict[str, torch.Tensor]],
                                    torch.Tensor]:
    """JAX ``make_ep_moe_layer`` (:112-141): ``(x, params) -> y`` on this
    rank's token chunk ``x`` [S_loc, D], with ``params`` the global
    ``gate_w`` [D, E], ``gate_b`` [E], ``w1`` [E, D, H], ``b1``, ``w2``,
    ``b2`` (the rank's experts are taken from them). Routing as JAX's
    ``_local_moe_math``: f32 softmax of ``x @ gate_w + gate_b``, top-k."""
    keep = mesh.expert_slice(num_experts)

    def layer(x, params):
        probs = torch.softmax((x @ params["gate_w"] + params["gate_b"]
                               ).float(), dim=-1)
        top_vals, top_idx = top_k_lowest_index(probs, top_k)
        w = [params[k][keep] for k in ("w1", "b1", "w2", "b2")]
        return ep_moe_ffn(x, top_idx, top_vals.to(x.dtype), *w,
                          capacity_factor=capacity_factor,
                          num_experts=num_experts, group=mesh.expert)

    return layer
