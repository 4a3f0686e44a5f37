"""The data, seq, expert and model axes of the JAX package's
``parallel/mesh.py`` over ``torch.distributed``: the rank layout, the process
subgroups, where the expert and FFN parameters live, and the frames a seq
rank holds.

JAX lays ``W = dp x ep x tp`` devices out as a ``(data, expert, model)``
mesh with the model axis minor (``make_mesh`` :45-76): device ``i = (d * ep
+ e) * tp + m``. The port runs one process per device with the same
numbering, rank ``r = (d * ep + e) * tp + m`` (``r = d * ep + e`` at ``tp =
1``), and:

- every rank makes every subgroup, in the same order: the expert groups
  (the ranks that share ``(d, m)``: the all-to-all of ``dispatch`` and the
  collectives of ``dense`` run among them), the data groups (the ranks that
  share ``(e, m)``), and with ``tp > 1`` the model groups (the ranks that
  share ``(d, e)``: the row-parallel sums and the column inputs' gradient
  sums) and the shard groups (the ranks that share ``d``); with both axes
  also the ranks that share ``m`` and those that share ``e``
  (:attr:`ExpertMesh.blocks`);
- an expert parameter (:func:`is_expert_param`: ``w1``, ``b1``, ``w2``,
  ``b2`` of a ``SwitchMoELayer``, JAX ``_is_expert_param`` :83) holds the
  rank's ``E / ep`` experts on dim 0, experts ``[e E / ep, (e + 1) E /
  ep)``; with ``tp > 1`` JAX's Megatron split (``_param_spec`` :89-139,
  :func:`model_dim`) cuts ``w1`` and ``b1`` on the hidden columns, ``w2`` on
  its hidden rows, a ``DenseFFN``'s ``branch_i_fc1`` and a
  ``CrossAttentionBlock``'s ``ffn_0`` on their output columns (weight and
  bias) and ``branch_i_fc2`` / ``ffn_1`` on their input columns (the
  weight; the bias stays whole and joins the sum once). A leaf whose dim
  ``tp`` does not divide stays whole, as JAX's ``div()`` leaves it;
  everything else is replicated. :class:`Cut` says how a rank holds a
  leaf, :func:`leaf_cuts` reads it off a model's modules;
- in training the ``tp`` ranks of a model group hold the same rows:
  row-holder ``q = d ep + e`` (:attr:`ExpertMesh.q`, ``dp ep`` of them)
  holds rows ``[q B / (dp ep), (q + 1) B / (dp ep))`` of each microbatch,
  which are token chunk q of JAX's ``P((data, expert))`` layout, so a
  capacity counted on the rank's own tokens is JAX's per-chunk capacity;
  in generation (``rows_replicated``, the layout of JAX's
  ``GenerationPipeline`` under a mesh, ``P('data')``) the ranks of one
  data index hold the same rows of the CFG-doubled batch, and ``dispatch``
  cuts their tokens into JAX's chunks itself (``parallel/moe_parallel.py``).

The seq axis (``generation_mesh(..., seq_parallel=sp)``, or
``num_seq_partitions`` in training) follows JAX's ``(data, seq, expert,
model)`` layout (``make_mesh`` :45-76), rank ``r = ((d sp + s) ep + e) tp +
m``; the numbering above is its ``sp = 1`` case. The seq ranks of one ``(d,
e, m)`` (the ``seq`` subgroup) hold the same rows, each its own frames of T
(:meth:`ExpertMesh.frames`: cut points on even frames, so that the stride-2
down / up convolutions cut cleanly); the expert, data, model and shard
groups are those of one ``s``. No leaf is cut over seq: in training the
seq ranks' gradients are partial sums over their frames, summed with the
rest of a leaf's holders (:attr:`ExpertMesh.blocks` take in every ``s``),
and the row-holder ``q = d ep + e`` stays the ranks' of every ``s`` and
``m``. :meth:`ExpertMesh.gather_frames` lays the seq ranks' frames end to
end, with no gradient or with one of two backward rules (``"sum"`` for a
computation every seq rank runs on the whole T and keeps its frames of,
``"keep"`` for a value every seq rank computes alike from the whole T).

The pipe axis (``generation_mesh(..., pipeline_parallel=pp)``, or
``num_pipeline_stages`` in training) follows JAX's ``(data, seq, pipe,
expert, model)`` numbering, rank ``r = (((d sp + s) pp + p) ep + e) tp +
m``, and composes with the data axis alone, as in JAX (``check_pipe_axes``):
rank ``d pp + p``. The pipe ranks of one ``d`` (the ``pipe`` subgroup) hold
the same rows, each its stage's blocks (``Cut.stage``,
``parallel/pipeline_parallel.py``); the data group is the ranks of one
stage, which hold its blocks (``blocks[STAGE]``); the row-holder is ``q =
d``. A stage's leaves are gathered from the stages' ranks of data index 0
and laid in the one-process order (:func:`expand_stages`), and a global
list is cut to a stage's (:func:`contract_stages`).

A leaf's gradient is summed over the ranks that hold the same block of it
(:attr:`ExpertMesh.blocks`): a replicated leaf over the world, a model-cut
one over the ranks that share ``m``, an expert over those that share ``e``
(and ``m`` when it is model-cut too), so every holder of a block gets the
same bits (a stage's blocks over its data ranks). A checkpoint holds JAX's
global layout: :func:`gather_whole` and :meth:`CutSharded.gather` bring
the blocks to rank 0's host, experts laid in order on dim 0, model blocks
on their model dim and the stages' blocks under their one-process names,
and :func:`local_state_dict` cuts a whole state for any ``(dp, pp, ep,
tp)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from motiondiffusion_moe_tpu_torch.parallel.data_parallel import (
    DataGroup,
    Sharded,
    by_dtype,
)
from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel import (
    DISPATCH_IN_RING,
    SCALES,
)

EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def is_expert_param(name: str) -> bool:
    """True for a ``SwitchMoELayer``'s expert tensors (a state-dict or
    parameter name: ``...branch_0_moe.w1``)."""
    module, _, leaf = name.rpartition(".")
    return leaf in EXPERT_LEAVES and module.endswith("_moe")


# the dims JAX's Megatron rule cuts, by the kind of FFN leaf: the experts'
# hidden width (b2 stays whole), a column-parallel Dense's output columns
# (weight and bias), a row-parallel Dense's input columns (the bias joins
# the sum once)
SPLIT_DIMS = {"expert": {"w1": 2, "b1": 1, "w2": 1},
              "column": {"weight": 0, "bias": 0}, "row": {"weight": 1}}


def model_dim(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dim of a (torch-layout) parameter that JAX's Megatron rule cuts
    over ``tp`` model ranks, or None (replicated over the model axis):
    ``_param_spec`` :89-139 on the port's names, flax's ``[in, out]``
    kernels being the transposes of the torch weights here. A dim that
    ``tp`` does not divide stays whole, as JAX's ``div()`` leaves it."""
    module, _, leaf = name.rpartition(".")
    kind = ("expert" if is_expert_param(name)
            else "column" if module.endswith(("_fc1", "ffn_0"))
            else "row" if module.endswith(("_fc2", "ffn_1")) else None)
    dim = SPLIT_DIMS[kind].get(leaf) if kind else None
    if dim is None or tp < 2 or dim >= len(shape) or shape[dim] % tp:
        return None
    return dim


# the key of a leaf only one pipe stage's ranks hold (a block's)
STAGE = (False, False, True)


class Cut(NamedTuple):
    """How a rank holds a leaf: only its ``E / ep`` experts on dim 0
    (``expert``) and/or its ``1 / tp`` of dim ``dim`` (the model axis); or,
    under a pipe axis, only on the ranks of one stage (``stage``: 1 for a
    ``blocks_low`` leaf, 2 for a ``blocks_high`` one; each stage holds its
    own blocks of the scale, whole)."""

    expert: bool = False
    dim: Optional[int] = None
    stage: int = 0

    @property
    def key(self) -> Tuple[bool, ...]:
        """(cut by expert, cut over the model axis), or :data:`STAGE`:
        which ranks hold the same block (:attr:`ExpertMesh.blocks`)."""
        return STAGE if self.stage else (self.expert, self.dim is not None)


def check_pipe_axes(sp: int, ep: int, tp: int) -> None:
    """JAX's rule (``transformer.py:268-273``): the pipe axis composes with
    the data axis alone."""
    for axis, n in (("seq", sp), ("expert", ep), ("model", tp)):
        if n > 1:
            raise ValueError(
                f"pipeline parallelism composes with 'data' only; mesh has "
                f"{axis}={n}")


class ExpertMesh(DataGroup):
    """The run's ``(data, [seq,] expert, model)`` mesh: the world's
    collectives (this class is the world's :class:`DataGroup`), the rank's
    indices ``d``, ``s``, ``e``, ``m``, its row-holder index ``q`` (of
    ``holders``) and its subgroups: ``expert`` (None at ``ep = 1``),
    ``data`` (the world itself at ``sp = ep = tp = 1``), ``model`` and
    ``shard`` (None at ``tp = 1``; ``shard`` is ``expert`` then), ``seq``
    (None at ``sp = 1``), and ``blocks[Cut.key]``, the ranks that hold the
    same block of a leaf cut so. ``rows_replicated`` marks the generation
    layout (see the module doc)."""

    def __init__(self, ep: int = 1, tp: int = 1,
                 rows_replicated: bool = False, sp: int = 1, pp: int = 1):
        super().__init__()
        if min(ep, tp, sp, pp) < 1 or self.world % (sp * pp * ep * tp):
            raise ValueError(
                f"{sp} seq x {pp} pipe x {ep} expert x {tp} model "
                f"partitions do not divide the {self.world} processes")
        if pp > 1:
            check_pipe_axes(sp, ep, tp)
        self.ep, self.tp, self.sp, self.pp = ep, tp, sp, pp
        self.dp = self.world // (sp * pp * ep * tp)
        self.rows_replicated = rows_replicated
        self.m = self.rank % tp
        self.e = self.rank // tp % ep
        self.p = self.rank // (tp * ep) % pp
        self.s = self.rank // (tp * ep * pp) % sp
        self.d = self.rank // (tp * ep * pp * sp)
        self.q, self.holders = self.d * ep + self.e, self.dp * ep

        rank = self.rank_of
        dsp = [(d, s) for d in range(self.dp) for s in range(sp)]
        mine = self.d * sp + self.s
        self.expert = self.model = self.shard = self.seq = None
        self.pipe = None
        self.data = self
        if ep > 1:
            self.expert = self._subgroup(
                [[rank(d, i, m, s) for i in range(ep)] for d, s in dsp
                 for m in range(tp)], mine * tp + self.m)
        if sp * pp * ep * tp > 1:
            self.data = self._subgroup(
                [[rank(d, e, m, s, p) for d in range(self.dp)]
                 for s in range(sp) for p in range(pp) for e in range(ep)
                 for m in range(tp)],
                ((self.s * pp + self.p) * ep + self.e) * tp + self.m)
        if tp > 1:
            self.model = self._subgroup(
                [[rank(d, e, i, s) for i in range(tp)] for d, s in dsp
                 for e in range(ep)], mine * ep + self.e)
            self.shard = self._subgroup(
                [list(range(i * ep * tp, (i + 1) * ep * tp))
                 for i in range(len(dsp))], mine) if ep > 1 else self.model
        else:
            self.shard = self.expert
        self.blocks = {(False, False): self}
        for key in ((True, False), (False, True), (True, True)):
            cut = (ep if key[0] else 1) * (tp if key[1] else 1)
            if cut == 1:  # nothing to share: every rank holds it
                self.blocks[key] = self
            elif cut * self.dp == self.world:  # only the data axis left
                self.blocks[key] = self.data
            else:  # the ranks that share e, or m, or both
                self.blocks[key] = self._subgroup(
                    [self.members(key, e, m) for e, m in self.blocks_of(key)],
                    self.blocks_of(key).index(
                        (self.e if key[0] else 0, self.m if key[1] else 0)))
        if sp > 1:
            self.seq = self._subgroup(
                [[rank(d, e, m, i) for i in range(sp)] for d in range(self.dp)
                 for e in range(ep) for m in range(tp)],
                (self.d * ep + self.e) * tp + self.m)
        if pp > 1:  # a stage's blocks: held by the data ranks of its stage
            self.blocks[STAGE] = self.data
            self.pipe = self._subgroup(
                [[rank(d, 0, 0, 0, i) for i in range(pp)]
                 for d in range(self.dp)], self.d)

    def _subgroup(self, families: List[List[int]], mine: int) -> DataGroup:
        if len(families) == 1:
            return self
        # every rank makes every group, in the same order
        groups = [dist.new_group(ranks) for ranks in families]
        return DataGroup(groups[mine])

    def __deepcopy__(self, memo):
        return self  # a copied module keeps the process groups

    def rank_of(self, d: int, e: int, m: int, s: int = 0, p: int = 0
                ) -> int:
        """JAX's device numbering on ``(data, seq, pipe, expert, model)``
        (read off any object with the degrees; ``pp`` 1 if it has none)."""
        pp = getattr(self, "pp", 1)
        return (((d * self.sp + s) * pp + p) * self.ep + e) * self.tp + m

    def copies(self, key) -> int:
        """The ranks of a row-holder whose gradients of a leaf cut as
        ``key`` are copies of one another, which the sum over
        ``blocks[key]`` takes: its model ranks unless the leaf is cut over
        the model axis, and its pipe ranks for a leaf every stage holds
        (each runs the same replicated work on the same rows)."""
        return ((1 if key[1] else self.tp)
                * (self.pp if key == (False, False) else 1))

    def frames(self, T: int, s: Optional[int] = None) -> Tuple[int, int]:
        """``[t0, t1)``, the frames of T that seq rank ``s`` (default this
        rank's) holds: the ``ceil(T / 2)`` frame pairs cut as evenly as
        they go, the lower ranks taking one more (T = 196 at ``sp = 4``:
        50 / 50 / 48 / 48; T = 14: 4 / 4 / 4 / 2). Cut points fall on even
        frames, so its frames at the half-rate scale are ``[t0 / 2,
        ceil(t1 / 2))``; an odd T leaves the last rank's last pair one
        frame short, the frame 'SAME' pads. Raises for T < 2 sp."""
        s = self.s if s is None else s
        if T < 2 * self.sp:
            raise ValueError(
                f"{T} frames over {self.sp} seq partitions: each needs at "
                f"least 2 frames (T >= {2 * self.sp})")
        pairs = -(-T // 2)
        n, extra = divmod(pairs, self.sp)
        p0 = s * n + min(s, extra)
        return 2 * p0, min(T, 2 * (p0 + n + (s < extra)))

    def frame_sizes(self, n: int, device) -> List[int]:
        """Every seq rank's ``n`` (its frames at some scale), in seq order:
        one small all-gather."""
        return self.seq.all_gather(torch.tensor([n], device=device)).tolist()

    def gather_frames(self, x: torch.Tensor, sizes: Sequence[int],
                      backward: Optional[str] = None) -> torch.Tensor:
        """The seq ranks' ``x`` [B, L_s, ...] (each its own frames, ``L_s =
        sizes[s]``) laid end to end on dim 1 in seq order: the whole T of
        their rows, the cuts uneven or not. ``backward``: None, no gradient;
        ``"sum"``, the rank's frames of the seq ranks' summed gradient (for
        a computation each seq rank runs on the whole T and keeps its own
        frames of, as ``dispatch`` does); ``"keep"``, the rank's frames of
        its own gradient (for a value every seq rank computes alike from
        the whole T, counted once: the losses on the whole T's x0)."""
        if backward is not None:
            return _GatherFrames.apply(x, self, tuple(sizes), backward)
        L = x.shape[1]
        top = max(sizes)
        if L < top:
            x = torch.cat([x, x.new_zeros((x.shape[0], top - L)
                                          + x.shape[2:])], 1)
        every = self.seq.all_gather(x.transpose(0, 1))   # [sp top, B, ...]
        return torch.cat([every[i * top:i * top + n]
                          for i, n in enumerate(sizes)]).transpose(0, 1
                                                                ).contiguous()

    @property
    def batch(self) -> DataGroup:
        """The row-holders at this model index (the ranks that share
        ``m``) and, under a pipe axis, at this stage: together they hold
        each row of the global batch once."""
        return self.data if self.pp > 1 else self.blocks[(False, True)]

    def blocks_of(self, key: Tuple[bool, bool]) -> List[Tuple[int, int]]:
        """The blocks ``(e, m)`` of a leaf cut as ``key`` (``Cut.key``)."""
        return [(e, m) for e in (range(self.ep) if key[0] else [0])
                for m in (range(self.tp) if key[1] else [0])]

    def members(self, key: Tuple[bool, bool], e: int, m: int) -> List[int]:
        """The ranks, in rank order, that hold block ``(e, m)`` of a leaf
        cut as ``key``: those that share its ``e`` (if cut by expert) and
        its ``m`` (if cut over the model axis)."""
        return [r for r in range(self.world)
                if (not key[0] or r // self.tp % self.ep == e)
                and (not key[1] or r % self.tp == m)]

    def expert_slice(self, num_experts: int) -> slice:
        """The experts this rank holds."""
        n = num_experts // self.ep
        return slice(self.e * n, (self.e + 1) * n)

    def rows(self, n: int) -> slice:
        """The rows of an ``n``-row batch that this rank's data index holds
        in the generation layout."""
        k = n // self.dp
        return slice(self.d * k, (self.d + 1) * k)

    def local_shape(self, name: str, shape: Sequence[int]) -> List[int]:
        """The shape the rank holds of the global parameter ``name``."""
        shape = list(shape)
        if self.ep > 1 and is_expert_param(name):
            shape[0] //= self.ep
        dim = model_dim(name, shape, self.tp)
        if dim is not None:
            shape[dim] //= self.tp
        return shape

    def local_leaf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The rank's cut (a view) of the global parameter ``name``."""
        return self.take(x, Cut(self.ep > 1 and is_expert_param(name),
                                model_dim(name, x.shape, self.tp)))

    def take(self, x: torch.Tensor, cut: Cut) -> torch.Tensor:
        """The rank's block (a view) of a global leaf cut as ``cut``."""
        if cut.expert:
            x = x[self.expert_slice(x.shape[0])]
        if cut.dim is not None:
            n = x.shape[cut.dim] // self.tp
            x = x.narrow(cut.dim, self.m * n, n)
        return x

    def assemble(self, block: Dict[Tuple[int, int], torch.Tensor],
                 cut: Cut) -> torch.Tensor:
        """A global leaf from its blocks ``{(e, m): tensor}``: the model
        blocks laid on ``cut.dim``, then the experts on dim 0."""
        rows = []
        for e in (range(self.ep) if cut.expert else [0]):
            parts = [block[(e, m)] for m in
                     (range(self.tp) if cut.dim is not None else [0])]
            rows.append(parts[0] if len(parts) == 1
                        else torch.cat(parts, cut.dim))
        return rows[0] if len(rows) == 1 else torch.cat(rows)

    def gather_blocks(self, tensors: Sequence[torch.Tensor],
                      cuts: Sequence[Cut]) -> Optional[List[torch.Tensor]]:
        """The global leaves of the ranks' blocks ``tensors`` (cut as
        ``cuts``), in host memory on rank 0 and None on the others: every
        rank sends its flat of each dtype through the world's gather in
        pieces, and rank 0 assembles each leaf from the ranks of data index
        0."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for idx in by_dtype(tensors):
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
            every = self.gather_to_primary(flat)
            if every is None:
                continue
            n = flat.numel()
            mine = [every[r * n:(r + 1) * n].split(
                [tensors[i].numel() for i in idx]) for r in range(self.world)]
            for j, i in enumerate(idx):
                out[i] = self.assemble(
                    {b: mine[self.rank_of(0, *b)][j].view(tensors[i].shape)
                     for b in self.blocks_of(cuts[i].key)}, cuts[i])
        return None if self.rank else out

    def stage_ranks(self, p: int) -> List[int]:
        """The ranks of stage ``p``, in data order (its data group)."""
        return [self.rank_of(d, 0, 0, 0, p) for d in range(self.dp)]

    def gather_stages(self, tensors: Sequence[torch.Tensor]
                      ) -> Optional[Dict[int, List[torch.Tensor]]]:
        """Every stage's ``tensors`` (the rank's leaves of its stage, of
        the same shapes on every stage), from the ranks of data index 0 (a
        gather over their pipe group, rank 0's), in host memory on rank 0
        as ``{p: tensors}``; None on the others."""
        if self.d:
            return None
        out = {p: [None] * len(tensors) for p in range(self.pp)}
        for idx in by_dtype(tensors):
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
            every = self.pipe.gather_to_primary(flat)
            if every is None:
                continue
            n = flat.numel()
            for p in range(self.pp):
                for i, v in zip(idx, every[p * n:(p + 1) * n].split(
                        [tensors[i].numel() for i in idx])):
                    out[p][i] = v.view(tensors[i].shape)
        return None if self.rank else out


def _stage_runs(cuts: Sequence[Cut]) -> List[Tuple[int, int]]:
    """``[i, j)`` of each run of consecutive leaves of one scale's stage."""
    runs, i = [], 0
    while i < len(cuts):
        j = i + 1
        if cuts[i].stage:
            while j < len(cuts) and cuts[j].stage == cuts[i].stage:
                j += 1
            runs.append((i, j))
        i = j
    return runs


def expand_stages(held: Sequence, cuts: Sequence[Cut],
                  stages: Dict[int, Sequence]) -> list:
    """The global list of a pipe rank's list ``held`` (cut as ``cuts``):
    each run of one scale's stage leaves becomes every stage's run, in
    stage order (the one-process order: every block of a scale in turn),
    ``stages[p]`` holding stage p's values of the stage leaves in the
    held order."""
    out, k, last = [], 0, 0
    for i, j in _stage_runs(cuts):
        out.extend(held[last:i])
        for p in sorted(stages):
            out.extend(stages[p][k:k + j - i])
        k, last = k + j - i, j
    out.extend(held[last:])
    return out


def contract_stages(whole: Sequence, cuts: Sequence[Cut], pp: int,
                    p: int) -> list:
    """Stage p's list, cut as ``cuts``, of a global list (the inverse of
    :func:`expand_stages`)."""
    out, g, last = [], 0, 0
    for i, j in _stage_runs(cuts):
        out.extend(whole[g:g + i - last])
        g += i - last
        out.extend(whole[g + p * (j - i):g + (p + 1) * (j - i)])
        g, last = g + pp * (j - i), j
    out.extend(whole[g:])
    if len(out) != len(cuts):
        raise ValueError(f"a global list of {len(whole)} leaves for "
                         f"{len(cuts)} held over {pp} pipe stages")
    return out


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, sizes, rule):
        if rule not in ("sum", "keep"):
            raise ValueError(f"gather_frames backward {rule!r}: 'sum' or "
                             "'keep'")
        ctx.mesh, ctx.sizes, ctx.rule = mesh, sizes, rule
        return mesh.gather_frames(x, sizes)

    @staticmethod
    def backward(ctx, g):
        mesh, sizes = ctx.mesh, ctx.sizes
        if ctx.rule == "sum":  # every frame's gradient from every seq rank
            g = mesh.seq.sum_(g.contiguous().clone())
        lo = sum(sizes[:mesh.s])
        return g[:, lo:lo + sizes[mesh.s]], None, None, None


class CutSharded:
    """:class:`Sharded`'s interface for a list of tensors cut as ``cuts``
    (the rank's blocks) over a mesh: the tensors of each ``Cut.key`` cut
    flat over the ranks that hold the same blocks (``mesh.blocks``), one
    :class:`Sharded` per key in the order of ``KEYS`` (or ``make(idx,
    key)``'s part for the indices ``idx`` cut as ``key``). :meth:`local`
    takes the tensors at the rank's shapes, one shard per dtype of each
    part; :meth:`gather` returns the global ones."""

    KEYS = ((False, False), (False, True), (True, False), (True, True),
            STAGE)

    def __init__(self, tensors: Sequence[torch.Tensor],
                 cuts: Sequence[Cut], mesh: ExpertMesh,
                 make: Optional[Callable[[List[int], Tuple[bool, bool]],
                                         Sharded]] = None):
        self.mesh, self.cuts = mesh, list(cuts)
        self.idx = [idx for idx in ([i for i, c in enumerate(cuts)
                                     if c.key == key] for key in self.KEYS)
                    if idx]
        make = make or (lambda idx, key: Sharded(
            [tensors[i] for i in idx], mesh.blocks[key]))
        self.parts = [make(idx, key) for idx, key in self.keyed()]

    def keyed(self) -> List[Tuple[List[int], Tuple[bool, bool]]]:
        """(indices, ``Cut.key``) of the tensors cut alike, in the order
        of ``KEYS``."""
        return [(idx, self.cuts[idx[0]].key) for idx in self.idx]

    def local(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [s for idx, part in zip(self.idx, self.parts)
                for s in part.local([tensors[i] for i in idx])]

    def gather(self, shards: Sequence[torch.Tensor]
               ) -> Optional[List[torch.Tensor]]:
        mesh = self.mesh
        out = [None] * len(self.cuts)
        shards = iter(shards)
        for idx, part in zip(self.idx, self.parts):
            key = self.cuts[idx[0]].key
            blocks: Dict[int, dict] = {i: {} for i in idx}
            # a stage's leaves: its block b = p, held by its data ranks
            owners = ([(p, mesh.stage_ranks(p)) for p in range(mesh.pp)]
                      if key == STAGE else
                      [(b, mesh.members(key, *b))
                       for b in mesh.blocks_of(key)])
            for group, part_flat in part.groups:
                shard = next(shards)
                every = mesh.gather_to_primary(shard)
                if every is None:
                    continue
                n = shard.numel()
                for b, ranks in owners:
                    # block b's flat: the shards of its ranks, in order
                    flat = torch.cat([every[r * n:(r + 1) * n]
                                      for r in ranks])
                    for j, v in zip(group, part_flat.split(flat)):
                        blocks[idx[j]][b] = v.view(part.shapes[j])
            if mesh.rank == 0:
                for i in idx:
                    out[i] = (blocks[i] if key == STAGE else
                              mesh.assemble(blocks[i], self.cuts[i]))
        if mesh.rank:
            return None
        if mesh.pp == 1:
            return out
        stage = [i for i, c in enumerate(self.cuts) if c.stage]
        return expand_stages(out, self.cuts, {
            p: [out[i][p] for i in stage] for p in range(mesh.pp)})


def gather_whole(tensors: Sequence[torch.Tensor], cuts: Sequence[Cut],
                 mesh: Optional[ExpertMesh]) -> Optional[list]:
    """The global form of ``tensors`` (the rank's blocks, cut as ``cuts``):
    on rank 0 the replicated ones as they are and the cut ones gathered to
    its host, None on the other ranks (a collective). Without a cut,
    ``tensors`` itself."""
    idx = [i for i, c in enumerate(cuts) if c.key != (False, False)]
    if mesh is None or not idx:
        return list(tensors)
    if mesh.pp > 1:  # each stage's blocks from its ranks of data index 0
        stages = mesh.gather_stages([tensors[i] for i in idx])
        return (None if stages is None
                else expand_stages(list(tensors), cuts, stages))
    whole = mesh.gather_blocks([tensors[i] for i in idx],
                               [cuts[i] for i in idx])
    if whole is None:
        return None
    out = list(tensors)
    for i, v in zip(idx, whole):
        out[i] = v
    return out


def local_leaves(tensors: Sequence[torch.Tensor], cuts: Sequence[Cut],
                 mesh: Optional[ExpertMesh]) -> List[torch.Tensor]:
    """The rank's blocks of the global ``tensors`` cut as ``cuts`` (under a
    pipe axis, its stage's leaves of them)."""
    if mesh is None:
        return list(tensors)
    if mesh.pp > 1:
        return contract_stages(tensors, cuts, mesh.pp, mesh.p)
    return [mesh.take(t, c) for t, c in zip(tensors, cuts)]


# ---------------------------------------------------------------------------
# the model's expert layers
# ---------------------------------------------------------------------------

def moe_layers(model: nn.Module):
    from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, SwitchMoELayer)]


def model_mesh(model: nn.Module) -> Optional[ExpertMesh]:
    """The mesh the model's parameters were cut over, or None (no mesh, or
    one that cuts nothing: ``ep = tp = pp = 1``)."""
    for m in model.modules():
        mesh = getattr(m, "mesh", None) or getattr(m, "pipe", None)
        if isinstance(mesh, ExpertMesh) and mesh.ep * mesh.tp * mesh.pp > 1:
            return mesh
    return None


def attach_mesh(model: nn.Module, mesh: Optional[ExpertMesh]) -> None:
    """Give every MoE layer the run's mesh (its collectives), and with a
    model axis every FFN pair its split (``Dense.split``, the MoE layer's
    ``model_split``: only where :func:`model_dim` cuts the hidden width);
    the weights stay whole until :func:`shard_params` or a pipeline's
    :meth:`~pipeline.GenerationPipeline.set_params`. Under an expert or a
    model axis a layer must compute ``dense`` or ``dispatch``:
    ``dense_fused`` merges the experts into one matmul, which cannot be
    cut (JAX ``trainer.py:71-89``). Under a seq axis the denoiser and its
    Performers get the seq group (their ``seq``: frames cut, kv closed
    across the ranks). Under a pipe axis the denoiser gets the mesh (its
    ``pipe``: each scale's blocks run as a GPipe ring over the stages,
    ``parallel/pipeline_parallel.py``), and a ``dispatch`` layer raises, as
    in JAX (``transformer.py:274-279``)."""
    from motiondiffusion_moe_tpu_torch.models.attention import (
        FastAttention, PerformerSelfAttention)
    from motiondiffusion_moe_tpu_torch.models.layers import Dense
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    tp = mesh.tp if mesh is not None else 1
    pipe = mesh if mesh is not None and mesh.pp > 1 else None
    for name, m in moe_layers(model):
        if pipe is not None and m.compute == "dispatch":
            raise ValueError(DISPATCH_IN_RING)
        if mesh is not None and mesh.ep * tp > 1:
            if m.compute == "dense_fused":
                raise ValueError(
                    f"{name} computes 'dense_fused' under {mesh.ep} expert "
                    f"x {tp} model partitions: the fused matmul cannot be "
                    "sharded. Build the model with moe_compute='dense' (or "
                    "'dispatch') for expert- or tensor-parallel runs.")
            if m.num_experts % mesh.ep:
                raise ValueError(f"{name}: {m.num_experts} experts over "
                                 f"{mesh.ep} expert partitions")
        m.mesh = mesh
        m.model_split = model_dim(f"{name}.w1", m.w1.shape, tp) is not None
    seq = mesh.seq if mesh is not None else None
    for name, m in model.named_modules():
        if isinstance(m, Dense):
            dim = model_dim(f"{name}.weight", m.weight.shape, tp)
            m.split = None if dim is None else ("row" if dim else "column")
            m.mesh = mesh if m.split else None
        elif isinstance(m, (MotionTransformer, PerformerSelfAttention,
                            FastAttention)):
            m.seq = seq
            if isinstance(m, MotionTransformer):
                m.pipe = pipe


def leaf_cuts(model: nn.Module) -> Dict[str, Cut]:
    """How the rank holds each parameter of ``model`` (by name) under the
    mesh :func:`attach_mesh` gave it: its experts under an expert axis, the
    dims of :data:`SPLIT_DIMS` of a split FFN pair's leaves (the modules'
    splits, which :func:`model_dim` set); under a pipe axis the blocks'
    leaves as its stage's (``Cut.stage``); every leaf whole without a
    mesh."""
    from motiondiffusion_moe_tpu_torch.models.layers import Dense
    from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer

    mesh = model_mesh(model)
    ep = mesh.ep if mesh is not None else 1
    pipe = mesh is not None and mesh.pp > 1
    cuts = {}
    for mname, mod in model.named_modules():
        moe = isinstance(mod, SwitchMoELayer)
        kind = ("expert" if moe and mod.model_split
                else mod.split if isinstance(mod, Dense) else None)
        dims = SPLIT_DIMS[kind] if kind else {}
        stage = (SCALES.index(mname.partition(".")[0]) + 1
                 if pipe and mname.partition(".")[0] in SCALES else 0)
        for leaf, _ in mod.named_parameters(recurse=False):
            cuts[f"{mname}.{leaf}" if mname else leaf] = Cut(
                ep > 1 and moe and leaf in EXPERT_LEAVES, dims.get(leaf),
                stage)
    return cuts


@torch.no_grad()
def shard_params(model: nn.Module) -> None:
    """Keep only the rank's block of every cut parameter
    (:func:`leaf_cuts`): its experts, and its ``1 / tp`` of each split FFN
    leaf; under a pipe axis, only its stage's blocks
    (``pipeline_parallel.keep_stage``). Once, on whole weights (after the
    whole seeded init, so that the weights are the one-process run's)."""
    mesh = model_mesh(model)
    if mesh is None:
        return
    if mesh.pp > 1:
        from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel import (
            keep_stage)
        keep_stage(model, mesh)
        return
    cuts = leaf_cuts(model)
    for mname, mod in model.named_modules():
        for leaf, p in list(mod.named_parameters(recurse=False)):
            cut = cuts[f"{mname}.{leaf}" if mname else leaf]
            if cut.key != (False, False):
                setattr(mod, leaf, nn.Parameter(
                    mesh.take(p, cut).clone(), requires_grad=p.requires_grad))


def whole_state_dict(model: nn.Module) -> Optional[Dict[str, torch.Tensor]]:
    """The model's ``state_dict`` in the global layout: on rank 0 with the
    cut leaves gathered (host memory), None on the other ranks (a
    collective); the state dict itself without a cut."""
    sd = model.state_dict()
    by_name = leaf_cuts(model)
    names = list(sd)
    cuts = [by_name.get(n, Cut()) for n in names]
    mesh = model_mesh(model)
    whole = gather_whole([sd[n] for n in names], cuts, mesh)
    if whole is None:
        return None
    if mesh is not None and mesh.pp > 1:  # every stage's block names
        from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel import (
            stage_name)
        k = model.config.num_layers // mesh.pp
        names = expand_stages(names, cuts, {
            p: [stage_name(n, (p - mesh.p) * k)
                for n, c in zip(names, cuts) if c.stage]
            for p in range(mesh.pp)})
    return dict(zip(names, whole))


def whole_model(model: nn.Module) -> nn.Module:
    """``model``, or for a pipe rank's denoiser (its stage's blocks alone)
    the whole model's structure on the meta device: the one-process
    parameters' names, order and modules, as a checkpoint in JAX's layout
    needs them."""
    mesh = model_mesh(model)
    if mesh is None or mesh.pp == 1:
        return model
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    with torch.device("meta"):
        return MotionTransformer(model.config, use_kernels=False)


def local_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A global state dict cut to the model's shapes: each tensor to the
    rank's part of it (:meth:`ExpertMesh.local_leaf`), under a pipe axis
    only the tensors of the rank's stage and the replicated ones."""
    mesh = model_mesh(model)
    if mesh is None:
        return dict(sd)
    if mesh.pp > 1:  # the blocks of its stage
        held = model.state_dict()
        return {n: v for n, v in sd.items() if n in held}
    return {n: mesh.local_leaf(n, v) for n, v in sd.items()}


def generation_mesh(data_parallel: int = 1, expert_parallel: int = 1,
                    tensor_parallel: int = 1, seq_parallel: int = 1,
                    pipeline_parallel: int = 1) -> Optional[ExpertMesh]:
    """The ``(data, [seq,] [pipe,] expert, model)`` mesh of
    ``GenerationPipeline`` and the serve / evaluate CLIs, in the generation
    layout: None when every degree is 1 and no process group exists.
    Raises unless the process group has ``dp x sp x pp x ep x tp`` ranks
    (``data_parallel`` 0 means the world over ``sp x pp x ep x tp``), with
    degrees above 1 unless it exists, and for a pipe axis beside a seq,
    expert or model axis (JAX's rule)."""
    dp, ep, tp, sp, pp = (data_parallel, expert_parallel, tensor_parallel,
                          seq_parallel, pipeline_parallel)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if min(ep, tp, sp, pp) < 1 or dp < 0:
        raise ValueError(f"parallel degrees data {dp}, seq {sp}, pipe {pp}, "
                         f"expert {ep}, model {tp}: each at least 1 (data 0 "
                         "= the rest)")
    if pp > 1:
        check_pipe_axes(sp, ep, tp)
    rest = sp * pp * ep * tp
    want = (dp or max(1, world // rest)) * rest
    seq = f" --seq_parallel {sp}" if sp > 1 else ""
    if want > 1 and not dist.is_initialized():
        raise ValueError(
            f"--data_parallel {dp}{seq} --expert_parallel {ep} "
            f"--tensor_parallel {tp}"
            + (f" and pipeline_parallel {pp}" if pp > 1 else "")
            + f" asks for {want} devices, but this is "
            f"one process: launch one process per device ({want}), with "
            "torchrun or --coordinator_address / --num_processes / "
            "--process_id")
    if world != want:
        raise ValueError(
            f"data {dp or world // rest}{f' x seq {sp}' if sp > 1 else ''}"
            f"{f' x pipe {pp}' if pp > 1 else ''} "
            f"x expert {ep} x model {tp} = {want} ranks, but the process "
            f"group has {world}: launch data x seq x pipe x expert x model "
            "processes, one per device")
    if not dist.is_initialized():
        return None
    return ExpertMesh(ep, tp, rows_replicated=True, sp=sp, pp=pp)


def make_mesh(cfg) -> Optional[ExpertMesh]:
    """The run's mesh (JAX ``Trainer._maybe_make_mesh``,
    ``trainer.py:127-169``): None without a process group, else the
    :class:`ExpertMesh` of ``num_expert_partitions``,
    ``num_model_partitions``, ``num_seq_partitions`` and
    ``num_pipeline_stages``, after :func:`check_mesh`."""
    check_mesh(cfg)
    par = cfg.parallel
    return (ExpertMesh(par.num_expert_partitions, par.num_model_partitions,
                       sp=par.num_seq_partitions,
                       pp=par.num_pipeline_stages)
            if dist.is_initialized() else None)


def check_mesh(cfg) -> None:
    """Raise unless the seq x pipe x expert x model partitions divide the
    world and the expert partitions the experts, ``num_data_partitions`` is
    0 (the world over ``sp x pp x ep x tp``) or that, the row-holders (``dp
    x ep``: the ranks of a model group, of a seq group and of a pipe group
    share their rows) divide each microbatch (JAX needs its data axis to
    divide it; the port gives each row-holder whole rows), every seq rank
    gets at least 2 frames of ``data.max_motion_length``, and, with a pipe
    axis, JAX's rules for it: data alone beside it, no ``dispatch``, and
    the GPipe layout of each microbatch (``validate_pp_layout``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ep = cfg.parallel.num_expert_partitions
    tp = cfg.parallel.num_model_partitions
    sp = cfg.parallel.num_seq_partitions
    pp = cfg.parallel.num_pipeline_stages
    procs = f"{world} process{'es' if world > 1 else ''}"
    if ep < 1 or world % ep:
        raise ValueError(
            f"num_expert_partitions (--expert_parallel) {ep}, but the run "
            f"has {procs}: launch a multiple of {ep} processes, one per "
            "device")
    if tp < 1 or world % (ep * tp):
        raise ValueError(
            f"num_model_partitions (--tensor_parallel) {tp} x "
            f"num_expert_partitions {ep}, but the run has {procs}: launch a "
            f"multiple of {ep * tp} processes, one per device")
    if sp < 1 or world % (sp * ep * tp):
        raise ValueError(
            f"num_seq_partitions (--seq_parallel) {sp} x "
            f"num_expert_partitions {ep} x num_model_partitions {tp}, but "
            f"the run has {procs}: launch a multiple of {sp * ep * tp} "
            "processes, one per device")
    if pp < 1 or world % (sp * pp * ep * tp):
        raise ValueError(
            f"num_pipeline_stages (--pipeline_parallel) {pp} x "
            f"num_seq_partitions {sp} x num_expert_partitions {ep} x "
            f"num_model_partitions {tp}, but the run has {procs}: launch a "
            f"multiple of {sp * pp * ep * tp} processes, one per device")
    if cfg.model.use_moe and cfg.model.num_experts % ep:
        raise ValueError(f"num_experts {cfg.model.num_experts} not "
                         f"divisible by {ep} expert partitions")
    n = cfg.parallel.num_data_partitions
    rest = sp * pp * ep * tp
    if n not in (0, world // rest):
        raise ValueError(
            f"num_data_partitions (--data_parallel) {n}, but the run has "
            f"{procs} over"
            + (f" {sp} seq partitions x" if sp > 1 else "")
            + (f" {pp} pipeline stages x" if pp > 1 else "")
            + f" {ep} expert partition{'s' if ep > 1 else ''}"
            + (f" x {tp} model partitions" if tp > 1 else "")
            + ": launch data x seq x pipe x expert x model processes, or "
            "pass 0")
    accum = max(1, cfg.train.grad_accum_steps)
    micro = cfg.train.batch_size // accum
    holders = world // rest * ep
    if micro % holders:
        share = " and ".join(w for w, k in (("model", tp), ("seq", sp),
                                            ("pipe", pp)) if k > 1)
        raise ValueError(
            f"microbatch {micro} (batch_size {cfg.train.batch_size} / "
            f"grad_accum_steps {accum}) not divisible by the {holders} data "
            "ranks" + (f" ({world} processes over {rest // ep} {share} "
                       "partitions, whose ranks share their rows)"
                       if share else "")
            + "; adjust --batch_size / --grad_accum / --data_parallel")
    T = cfg.data.max_motion_length
    if sp > 1 and T < 2 * sp:
        raise ValueError(
            f"data.max_motion_length {T} over {sp} seq partitions: each "
            f"needs at least 2 frames (max_motion_length >= {2 * sp})")
    if pp > 1:
        from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel import (
            validate_pp_layout)
        check_pipe_axes(sp, ep, tp)
        if cfg.model.use_moe and cfg.model.moe_compute == "dispatch":
            raise ValueError(DISPATCH_IN_RING)
        # under accumulation the ring sees one microbatch (B / A) at a time
        validate_pp_layout(
            pp, world // rest, cfg.model.num_layers, micro,
            cfg.model.pipeline_microbatches,
            fix_hint=("; adjust --batch_size / --grad_accum / "
                      "--pp_microbatches / --num_layers"))


def add_launch_flags(p) -> None:
    """The serve / evaluate CLIs' multi-device flags (an argparse parser):
    the JAX CLIs' three degrees and the launch of one process per device
    (``tools/train.py``'s flags, or torchrun's environment)."""
    p.add_argument("--data_parallel", type=int, default=1,
                   help="split each generation's batch over this many "
                        "ranks (micro_batch must divide by it)")
    p.add_argument("--expert_parallel", type=int, default=1,
                   help="cut the MoE experts over this many ranks")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="Megatron FFN split over this many ranks")
    p.add_argument("--coordinator_address", default="",
                   help="multi-process: HOST:PORT of rank 0 (or an init "
                        "URL, e.g. file:///shared/rendezvous)")
    p.add_argument("--num_processes", type=int, default=0,
                   help="multi-process: the number of processes")
    p.add_argument("--process_id", type=int, default=-1,
                   help="multi-process: this process's rank")


def launch_generation(args) -> Tuple[Optional[ExpertMesh], torch.device]:
    """(mesh, device) of a serve / evaluate process: joins the process group
    that :func:`add_launch_flags`' launch flags or torchrun's environment
    name, then :func:`generation_mesh` of the three degrees (which raises
    for degrees above 1 in one process) and the device: ``--device`` in
    one process, else this rank's (``cuda:LOCAL_RANK`` unless ``--device``
    names one)."""
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        initialize_distributed, rank_device)

    initialize_distributed(
        coordinator_address=args.coordinator_address or None,
        num_processes=args.num_processes or None,
        process_id=args.process_id if args.process_id >= 0 else None,
        device=args.device)
    mesh = generation_mesh(args.data_parallel, args.expert_parallel,
                           args.tensor_parallel)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu for the CPU)")
    if mesh is None:
        return None, torch.device(args.device)
    device = rank_device(args.device)
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the context now, not in turn
    return mesh, device
