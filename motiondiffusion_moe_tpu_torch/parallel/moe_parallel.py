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
- :func:`sharded_dense_ffn` (``dense`` in training, ``ep > 1`` or a
  model split): each rank runs its experts (its hidden columns with a model
  split) on every token of its expert group (an all-gather of the tokens
  and the combine weights), weights its experts' outputs in f32, the model
  group's f32 sum closes a split hidden width (``combine . b2`` joining it
  once), and a reduce-scatter of those f32 partial sums gives each rank its
  tokens, rounded once, as the one-device ``_dense`` rounds
  (``models/moe.py``). The all-gather's backward is a reduce-scatter and
  the reduce-scatter's an all-gather.
- :func:`global_dispatch_ffn` (``dispatch``, ``ep = 1`` over data ranks):
  JAX runs ``_capacity_dispatch_ffn`` on the global token array (capacity
  ``ceil(S_global cf / E)``, the fill in global row order). Here a slot's
  global position is its rank-local cumsum plus the lower ranks' counts
  for the same choice (one all-gather of a ``[W, k, E]`` count a layer)
  plus the fill carried over from the earlier choices. The experts are
  replicated and a token's output reads only its own slots, so no token
  moves: each rank runs its kept pairs in a buffer of its own, and nothing
  crosses ranks in the backward.

With the model axis (JAX's Megatron split, ``parallel/mesh.py:113-133``)
the model ranks hold the same tokens, and two autograd Functions carry what
XLA's partitioner inserts around a split pair:

- :func:`column_input`, at the input of a column-parallel product (a split
  ``Dense``'s ``x``, the experts' input and the combine weights of a split
  hidden width): the identity forward; backward, the sum over the model
  group of the input's gradient, which each rank holds for its own columns
  only;
- :func:`row_parallel_sum`, the close of a row-parallel product: forward,
  the f32 sum over the model group with the replicated bias added once (on
  model rank 0, :func:`adds_bias`), rounded once; backward, the identity to
  each rank's partial product, and the bias's gradient on every model rank
  (the sum's gradient, as JAX's bias after its psum gets it), so that the
  replicated bias stays replicated.

In the generation layout (``ExpertMesh.rows_replicated``: the ranks of one
data index hold the same rows of the CFG-doubled batch, JAX's
``GenerationPipeline`` under a mesh, ``pipeline.py:228-242``):

- :func:`replicated_dense_ffn` (``dense``): each rank runs its experts'
  hidden columns on every token of its data index, weights its experts'
  partial outputs in f32, and one f32 all-reduce over the shard group (the
  ranks of the data index) sums them; ``combine . b2`` joins the sum once
  (:func:`row_parallel_sum`), rounded once.
- :func:`replicated_ep_moe_ffn` (``dispatch``, ``ep > 1``): expert rank e
  takes token chunk e of its data index's flat tokens, which is chunk ``d
  ep + e`` of JAX's ``P((data, expert))`` layout (``ep_moe_ffn_sharded``
  :220-230), so capacity and drops are JAX's per chunk; then the
  all-to-all of :func:`ep_moe_ffn`, its experts' second product closed by
  the sum over the model group before ``b2`` (JAX
  ``_ep_moe_body_from_logits`` :176-180, :func:`expert_ffn_tp`), and an
  all-gather over the expert group gives every rank the data index's
  tokens again.
- ``dispatch`` at ``ep = 1``: :func:`global_dispatch_ffn` over the data
  group (JAX's global capacity), or one rank's whole batch, each with the
  expert FFN of :func:`expert_ffn_tp` under a model split.

The partial products are rounded to the compute dtype (JAX's partitioner
gives each model rank a partial product in that dtype) and summed in f32.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

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
               capacity_factor: float, num_experts: int, group,
               ffn=expert_ffn) -> torch.Tensor:
    """x [S_loc, D] (this rank's tokens, compute dtype), top_idx / top_vals
    [S_loc, k] (the values in the compute dtype), ``w1`` ... the rank's
    ``E / ep`` experts; ``group`` the expert group (a ``DataGroup``);
    ``ffn`` the experts' FFN -> [S_loc, D]."""
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
    y = ffn(expert_in, w1, b1, w2, b2)
    y = y.view(e_local, ep, C, D).transpose(0, 1).reshape(E * C, D)
    y = _AllToAll.apply(y, group)  # this rank's slots of every expert
    return combine_rows(y, slot, keep, top_vals, x.dtype)


def sharded_dense_ffn(x: torch.Tensor, combine: torch.Tensor, w1, b1, w2,
                      b2, *, mesh, model_split: bool) -> torch.Tensor:
    """``dense`` in training with the experts cut over the expert group
    and, with ``model_split``, the hidden width over the model group: x
    [S_loc, D], combine [S_loc, E] (compute dtype), the rank's experts ->
    [S_loc, D] (see the module doc)."""
    e_local, D, hid = w1.shape
    ep = mesh.ep
    xg = _AllGather.apply(x, mesh.expert) if ep > 1 else x
    cg = _AllGather.apply(combine, mesh.expert) if ep > 1 else combine
    lo = mesh.e * e_local if ep > 1 else 0
    c = cg[:, lo:lo + e_local]
    S = xg.shape[0]
    w1m = w1.permute(1, 0, 2).reshape(D, e_local * hid)
    if model_split:
        xg = column_input(xg, mesh)
    h = gelu(xg @ w1m, b1.reshape(e_local * hid)).view(S, e_local, hid)
    y = torch.bmm(h.transpose(0, 1), w2)
    if model_split:  # y is a partial sum: b2 joins the model sum once
        part = torch.einsum("esd,se->sd", y.float(),
                            column_input(c, mesh).float())
        part = row_parallel_sum(part, c.float() @ b2.float(), mesh)
    else:
        part = torch.einsum("esd,se->sd", (y + b2[:, None, :]).float(),
                            c.float())
    if ep > 1:
        part = _ReduceScatter.apply(part, mesh.expert)
    return part.to(x.dtype)


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
                        capacity_factor: float, group,
                        ffn=expert_ffn) -> torch.Tensor:
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
    y = ffn(expert_in.view(E, c_local, D), w1, b1, w2, b2)
    return combine_rows(y.view(E * c_local, D), slot, keep, top_vals,
                        x.dtype)


def adds_bias(mesh) -> bool:
    """Whether this rank's partial sum carries a bias that is replicated
    over the model axis: on the first model rank only, so that the sum over
    the axis counts it once (JAX adds it after its psum)."""
    return mesh.m == 0


class _ColumnInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum_(g.clone()), None


def column_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as the input of a column-parallel product over the model group
    (see the module doc): its gradient summed over the group."""
    return _ColumnInput.apply(x, mesh.model)


class _RowClose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, bias, add_bias, group, dtype):
        ctx.dtypes = partial.dtype, None if bias is None else bias.dtype
        ctx.bias_shape = None if bias is None else bias.shape
        t = partial.to(torch.float32, copy=True)
        if add_bias:
            t += bias.float()
        if group is not None:
            group.sum_(t)
        return t.to(dtype)

    @staticmethod
    def backward(ctx, g):
        dp, db = ctx.dtypes
        grad_bias = (None if db is None
                     else g.sum_to_size(ctx.bias_shape).to(db))
        return g.to(dp), grad_bias, None, None, None


def row_parallel_sum(partial: torch.Tensor, bias: Optional[torch.Tensor],
                     mesh, model_split: bool = True, group=None,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The close of a row-parallel product: ``partial`` (this rank's part of
    a sum over the hidden width) summed over ``group`` (default the model
    group; None: this rank alone) with ``bias`` joining once, in f32,
    rounded once to ``dtype`` (default ``partial``'s). With
    ``model_split`` False the hidden width is whole on every model rank and
    each rank adds its own bias term (the sum then runs over the expert
    axis alone). The backward passes the output's gradient to ``partial``
    and to ``bias`` on every rank (see the module doc)."""
    group = mesh.model if group is None and model_split else group
    add = bias is not None and (not model_split or adds_bias(mesh))
    return _RowClose.apply(partial, bias, add, group, dtype or partial.dtype)


def expert_ffn_tp(expert_in: torch.Tensor, w1, b1, w2, b2, *, mesh
                  ) -> torch.Tensor:
    """``models/moe.py::expert_ffn`` with the hidden width cut over the
    model axis: the rank's columns of ``w1`` / ``b1`` and rows of ``w2``
    (the input's gradient summed over the model group), the second product
    summed over the model group, then ``b2``."""
    h = gelu(torch.bmm(column_input(expert_in, mesh), w1) + b1[:, None, :])
    return row_parallel_sum(torch.bmm(h, w2), b2[:, None, :], mesh)


def replicated_dense_ffn(x: torch.Tensor, combine: torch.Tensor, w1, b1, w2,
                         b2, *, mesh, model_split: bool) -> torch.Tensor:
    """``dense`` in the generation layout: x [S, D] and combine [S, E] (the
    data index's tokens, the same on the ranks of its shard group), the
    rank's experts (its hidden columns with ``model_split``) -> [S, D] (see
    the module doc)."""
    e_local, D, hid = w1.shape
    S = x.shape[0]
    lo = mesh.e * e_local if mesh.ep > 1 else 0
    w1m = w1.permute(1, 0, 2).reshape(D, e_local * hid)
    h = gelu(x @ w1m, b1.reshape(e_local * hid)).view(S, e_local, hid)
    y = torch.bmm(h.transpose(0, 1), w2)
    c = combine[:, lo:lo + e_local].float()
    if model_split:  # y is a partial sum: b2 joins the sum once
        bias = c @ b2.float()
    else:  # whole experts: b2 in the compute dtype, as one process adds it
        y, bias = y + b2[:, None, :], None
    part = torch.einsum("esd,se->sd", y.float(), c)
    return row_parallel_sum(part, bias, mesh, model_split,
                            mesh.shard if model_split else mesh.expert,
                            x.dtype)


def replicated_ep_moe_ffn(x: torch.Tensor, routing, w1, b1, w2, b2, *,
                          capacity_factor: float, num_experts: int, mesh,
                          model_split: bool) -> torch.Tensor:
    """``dispatch`` over the expert axis in the generation layout: x [S, D]
    (the data index's tokens), ``routing(x_chunk) -> (top_vals, top_idx)``
    -> [S, D] on every rank of the expert group (see the module doc)."""
    S, D = x.shape
    ep = mesh.ep
    if S % ep:
        raise ValueError(
            f"{S} tokens a data rank not divisible by {ep} expert "
            "partitions (JAX's ep_moe_ffn_sharded needs data x expert to "
            "divide the tokens): change micro_batch, the frame count or "
            "--expert_parallel")
    n = S // ep
    chunk = x[mesh.e * n:(mesh.e + 1) * n]
    vals, idx = routing(chunk)
    ffn = (functools.partial(expert_ffn_tp, mesh=mesh) if model_split
           else expert_ffn)
    y = ep_moe_ffn(chunk, idx, vals.to(x.dtype), w1, b1, w2, b2,
                   capacity_factor=capacity_factor, num_experts=num_experts,
                   group=mesh.expert, ffn=ffn)
    return mesh.expert.all_gather(y)


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
