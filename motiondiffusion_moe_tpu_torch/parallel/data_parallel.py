"""The data axis of the JAX package's ``parallel/mesh.py`` over
``torch.distributed``: data-parallel training and ZeRO-1.

JAX shards the global batch over the mesh's ``data`` axis and lets the SPMD
partitioner insert the gradient reduction (``shard_batch`` :176,
``make_sharded_train_step`` :204); with ``zero1`` it also shards the Adam
moments and the EMA weights over ``data`` (``_zero1_spec`` :141). Here each
process holds its own rows: the ranks' rows of a microbatch, in rank order,
are the global microbatch (JAX's ``shard_batch`` layout, chunk by chunk
under gradient accumulation). Then:

- ``training/train_state.py::TrainStep`` turns each rank's losses into its
  share of the global batch's: one all-reduce per microbatch carries every
  masked loss's denominator and every MoE layer's expert counts, so that
  the mean of the ranks' gradients is the gradient of the global batch's
  loss;
- the trainable parameters' gradients are views of one flat buffer per
  dtype (:class:`FlatParams`), so a parameter without a gradient enters
  the reduction as zeros on every rank, and the reduction runs in place:
  an all-reduce of the whole buffer, averaged, or under ZeRO-1 a
  reduce-scatter;
- under ZeRO-1 the tensors of one dtype are laid end to end (each on a
  256-byte boundary in :class:`FlatParams`, as ``cudaMalloc`` places an
  allocation, so that a kernel that reads a weight 16 bytes a lane can take
  it) and cut into W contiguous shards (:class:`FlatPartition`). Each rank
  runs Adam on its shard of the gradient and of the parameters, which are
  themselves views of one flat buffer, and an in-place all-gather brings
  every rank's updated shard into it. The EMA keeps the rank's shard of
  every parameter (:class:`Sharded`). JAX puts the ``data`` axis on each
  leaf's first dimension that W divides; the update is elementwise either
  way, and the flat cut gives every rank 1/W of the elements whatever the
  leaves' shapes. A save gathers the shards into the primary's host memory
  alone (:meth:`DataGroup.gather_to_primary`), in pieces, so no rank's card
  ever holds the whole of the moments or the EMA.

The model is not wrapped in ``DistributedDataParallel``: that renames every
``state_dict`` key under ``module.``, and the bridge, both checkpoint
formats and the exports read those names.

Under the gloo backend each collective on CUDA tensors goes through host
memory: gloo serves ranks that share one card, which NCCL refuses, and
its sends and receives (:meth:`DataGroup.isend`, :meth:`DataGroup.recv`)
take host tensors too. The seq, pipe, expert and model axes
(``parallel/mesh.py``, ``parallel/pipeline_parallel.py``,
``parallel/moe_parallel.py``) build on these groups and their subgroups,
in generation and in training.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# the names of the card's PyTorch, else the newer ones that supersede them
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)

ALIGN_BYTES = 256  # where each tensor of a FlatParams buffer starts
GATHER_PIECE = 1 << 26  # elements a rank sends at a time to the primary


class DataGroup:
    """Processes of a run that take part in a collective together (the
    default process group, or ``group``): its size ``world``, this
    process's ``rank`` in it and the collectives of the step. Exists only
    where a process group does, one process included."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.staged = dist.get_backend(group) == "gloo"

    def _run(self, op, out: torch.Tensor, *inputs: torch.Tensor
             ) -> torch.Tensor:
        """``op(out, *inputs)``. Under gloo on host copies of the inputs
        (CUDA tensors go through the host, and an input may be a view of
        ``out``, which NCCL takes in place)."""
        if not self.staged:
            op(out, *inputs)
            return out
        host = out.cpu()
        op(host, *(t.to("cpu", copy=True) for t in inputs))
        return out if host is out else out.copy_(host)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` in place (sum over the ranks)."""
        return self._run(lambda o: dist.all_reduce(o, group=self.group), t)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, as a new tensor without
        gradient."""
        return self.sum_(t.detach().clone())

    def reduce_scatter_(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum ``flat`` (W equal shards) over the ranks into this rank's
        shard of it, in place; returns that shard (a view). The other
        shards are left as they were."""
        n = flat.numel() // self.world
        out = flat[self.rank * n:(self.rank + 1) * n]
        return self._run(lambda o, i: _reduce_scatter(o, i,
                                                      group=self.group),
                         out, flat)

    def all_gather_(self, flat: torch.Tensor) -> torch.Tensor:
        """Fill ``flat`` (W equal shards) with every rank's own shard of
        it, in place."""
        n = flat.numel() // self.world
        return self._run(lambda o, i: _all_gather(o, i, group=self.group),
                         flat, flat[self.rank * n:(self.rank + 1) * n])

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` cut into W equal blocks on dim 0; block j goes to rank j,
        and block i of the result came from rank i."""
        x = x.contiguous()
        return self._run(lambda o, i: dist.all_to_all_single(
            o, i, group=self.group), torch.empty_like(x), x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` laid end to end on dim 0, in rank order."""
        x = x.contiguous()
        out = x.new_empty((self.world * x.shape[0],) + x.shape[1:])
        return self._run(lambda o, i: _all_gather(o, i, group=self.group),
                         out, x)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``x`` (W equal blocks on dim 0), this
        rank's block of it."""
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.world,) + x.shape[1:])
        return self._run(lambda o, i: _reduce_scatter(o, i,
                                                      group=self.group),
                         out, x)

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of the rank ``src`` (a global rank of the group) on every
        rank, in place."""
        return self._run(lambda o: dist.broadcast(o, src, group=self.group),
                         t)

    def isend(self, t: torch.Tensor, dst: int) -> "Sent":
        """Start sending ``t`` to the global rank ``dst`` of the group;
        :meth:`Sent.wait` ends it. Under gloo a host copy is sent (kept
        until then); under NCCL the tensor itself, on the card."""
        t = t.detach()
        t = t.to("cpu", copy=True) if self.staged else t.contiguous()
        return Sent(dist.isend(t, dst, group=self.group), t)

    def recv(self, out: torch.Tensor, src: int) -> torch.Tensor:
        """Fill ``out`` with the tensor the global rank ``src`` of the
        group sends (through host memory under gloo)."""
        if not self.staged:
            dist.recv(out, src, group=self.group)
            return out
        host = torch.empty(out.shape, dtype=out.dtype)
        dist.recv(host, src, group=self.group)
        return out.copy_(host)

    def gather_to_primary(self, shard: torch.Tensor
                          ) -> Optional[torch.Tensor]:
        """The ranks' ``shard`` laid end to end in rank order, in host
        memory on rank 0 and None on the others. Sent in pieces of at most
        :data:`GATHER_PIECE` elements, so rank 0's card holds W pieces at a
        time."""
        n = shard.numel()
        primary = self.rank == 0
        out = torch.empty(self.world * n, dtype=shard.dtype) if primary \
            else None
        where = torch.device("cpu") if self.staged else shard.device
        for a in range(0, n, GATHER_PIECE):
            piece = shard[a:a + GATHER_PIECE].to(where)
            parts = ([torch.empty_like(piece) for _ in range(self.world)]
                     if primary else None)
            dist.gather(piece, parts, dst=0, group=self.group)
            if primary:
                for r, p in enumerate(parts):
                    out[r * n + a:r * n + a + p.numel()].copy_(p)
        return out


class Sent:
    """A send in flight (:meth:`DataGroup.isend`): its work and the
    tensor it sends, which must live until :meth:`wait`."""

    def __init__(self, work, tensor: torch.Tensor):
        self.work, self.tensor = work, tensor

    def wait(self) -> None:
        self.work.wait()
        self.tensor = None


def by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """The indices of ``tensors``, grouped by dtype in first-seen order."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


class FlatPartition:
    """The ZeRO-1 cut of tensors with ``numels`` elements over ``world``
    ranks: laid in order in one flat buffer, each starting at a multiple of
    ``align`` elements, the buffer padded with zeros to ``size = world x
    shard`` (``shard`` the least multiple of ``align`` that covers it);
    rank r owns ``[r * shard, (r + 1) * shard)``. With ``align = 1``,
    ``shard = ceil(n / world)``."""

    def __init__(self, numels: Sequence[int], world: int, rank: int,
                 align: int = 1):
        self.numels = list(numels)
        self.total = sum(self.numels)
        self.offsets, end = [], 0
        for n in self.numels:
            self.offsets.append(end)
            end += -(-n // align) * align
        self.world = world
        self.shard = -(-end // (world * align)) * align
        self.size = world * self.shard
        lo, hi = rank * self.shard, (rank + 1) * self.shard
        self.lo = lo
        # (tensor index, start, stop) inside that tensor, and where in the
        # shard that piece starts
        self.pieces = []
        for i, (off, n) in enumerate(zip(self.offsets, self.numels)):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                self.pieces.append((i, a - off, b - off, a - lo))
        self.pad = self.shard - sum(b - a for _, a, b, _ in self.pieces)

    def flat(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """All ``size`` elements, gaps and padding zero, as a new
        tensor."""
        out = tensors[0].new_zeros(self.size)
        for v, t in zip(self.split(out), tensors):
            v.copy_(t.reshape(-1))
        return out

    def local(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's shard of ``tensors``, as a new tensor (on the first
        tensor's device)."""
        out = tensors[0].new_zeros(self.shard)
        for i, a, b, at in self.pieces:
            out[at:at + b - a].copy_(tensors[i].reshape(-1)[a:b])
        return out

    def own(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a flat buffer (a view)."""
        return flat[self.lo:self.lo + self.shard]

    def split(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """The tensors' 1-d views of ``flat`` (all shards in rank
        order)."""
        return [flat[o:o + n] for o, n in zip(self.offsets, self.numels)]


class Sharded:
    """The ZeRO-1 shards of a list of tensors over a :class:`DataGroup`:
    one :class:`FlatPartition` per dtype (``align`` bytes apart)."""

    def __init__(self, tensors: Sequence[torch.Tensor], dp: DataGroup,
                 align_bytes: int = 0):
        self.dp = dp
        self.shapes = [t.shape for t in tensors]
        self.groups = []
        for idx in by_dtype(tensors):
            align = max(1, align_bytes // tensors[idx[0]].element_size())
            self.groups.append((idx, FlatPartition(
                [tensors[i].numel() for i in idx], dp.world, dp.rank,
                align)))

    def local(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's shard of each dtype group of ``tensors``."""
        return [part.local([tensors[i] for i in idx])
                for idx, part in self.groups]

    def gather(self, shards: Sequence[torch.Tensor]
               ) -> Optional[List[torch.Tensor]]:
        """The whole tensors from every rank's ``shards``, in host memory
        on rank 0; None on the others (a collective)."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.shapes)
        for (idx, part), shard in zip(self.groups, shards):
            flat = self.dp.gather_to_primary(shard)
            if flat is not None:
                for i, v in zip(idx, part.split(flat)):
                    out[i] = v.view(self.shapes[i])
        return out if self.dp.rank == 0 else None


class FlatParams(Sharded):
    """The trainable parameters of a data-parallel run in flat buffers, one
    per dtype, each tensor :data:`ALIGN_BYTES` apart: their ``.grad`` are
    views of a gradient buffer and, under ZeRO-1 (``zero1``), their data
    views of a parameter buffer. The reduction and the gather then run in
    place on whole buffers. The reduction sums over ``dp`` and divides by
    ``denom`` (default ``dp.world``: the mean over the ranks)."""

    def __init__(self, params: Sequence[torch.Tensor], dp: DataGroup,
                 zero1: bool, denom: Optional[int] = None):
        super().__init__(params, dp, ALIGN_BYTES)
        self.params = list(params)
        self.zero1 = zero1
        self.denom = denom or dp.world
        self.grads, self.data = [], []
        for idx, part in self.groups:
            group = [self.params[i] for i in idx]
            self.grads.append(group[0].new_zeros(part.size))
            if zero1:
                flat = part.flat([p.detach() for p in group])
                for p, v in zip(group, part.split(flat)):
                    p.data = v.view_as(p)
                self.data.append(flat)
        self.attach_grads()

    def attach_grads(self) -> None:
        """Make each parameter's ``.grad`` its view of the gradient
        buffer (backward then accumulates into it in place)."""
        for (idx, part), flat in zip(self.groups, self.grads):
            for i, v in zip(idx, part.split(flat)):
                self.params[i].grad = v.view_as(self.params[i])

    def zero_grad(self) -> None:
        for flat in self.grads:
            flat.zero_()
        self.attach_grads()

    def mean_grads_(self) -> None:
        """Average the gradients over the ranks, in place."""
        for flat in self.grads:
            self.dp.sum_(flat).div_(self.denom)

    def reduce_scatter_grads_(self) -> List[torch.Tensor]:
        """This rank's shard of the gradients' mean over the ranks, one
        view of each gradient buffer."""
        return [self.dp.reduce_scatter_(flat).div_(self.denom)
                for flat in self.grads]

    def param_shards(self) -> List[torch.Tensor]:
        """This rank's shard of each parameter buffer (views; ZeRO-1)."""
        return [part.own(flat) for (_, part), flat in zip(self.groups,
                                                           self.data)]

    def gather_params_(self) -> None:
        """Every rank's shard into every parameter buffer (ZeRO-1)."""
        for flat in self.data:
            self.dp.all_gather_(flat)

