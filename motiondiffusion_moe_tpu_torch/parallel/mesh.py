"""The data and expert axes of the JAX package's ``parallel/mesh.py`` over
``torch.distributed``: the rank layout, the process subgroups, and where
the expert parameters live.

JAX lays ``W = dp x ep`` devices out as a ``(data, expert)`` mesh with the
data axis major (``make_mesh`` :45-76): device ``i = d * ep + e``. The port
runs one process per device with the same numbering, rank ``r = d * ep +
e``, and:

- every rank makes every subgroup, in the same order: the expert groups
  (ranks ``d * ep .. d * ep + ep - 1``, which share a data index: the
  all-to-all of ``dispatch`` and the all-gather / reduce-scatter of
  ``dense`` run among them) and the data groups (ranks ``e, e + ep, ...``,
  which hold the same experts: their expert gradients are summed over it
  and, under ZeRO-1, their expert moments and EMA cut over it);
- an expert parameter (:func:`is_expert_param`: ``w1``, ``b1``, ``w2``,
  ``b2`` of a ``SwitchMoELayer``, JAX ``_is_expert_param`` :83) holds the
  rank's ``E / ep`` experts on dim 0, experts ``[e E / ep, (e + 1) E /
  ep)`` (``_param_spec`` :100-139); everything else is replicated;
- rank r holds rows ``[r B / W, (r + 1) B / W)`` of each microbatch, which
  are token chunk r of JAX's ``P((data, expert))`` layout, so a capacity
  counted on the rank's own tokens is JAX's per-chunk capacity.

A checkpoint holds JAX's global ``[E, ...]`` layout: :meth:`ExpertMesh.
gather_experts` and :meth:`ExpertMesh.gather_expert_shards` bring the
shards to rank 0's host in expert order, and :func:`local_state_dict`
slices a whole state for any ``(dp, ep)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from motiondiffusion_moe_tpu_torch.parallel.data_parallel import (
    DataGroup,
    Sharded,
)

EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def is_expert_param(name: str) -> bool:
    """True for a ``SwitchMoELayer``'s expert tensors (a state-dict or
    parameter name: ``...branch_0_moe.w1``)."""
    module, _, leaf = name.rpartition(".")
    return leaf in EXPERT_LEAVES and module.endswith("_moe")


class ExpertMesh(DataGroup):
    """The run's ``(data, expert)`` mesh: the world's collectives (this
    class is the world's :class:`DataGroup`), the rank's expert index
    ``e`` and data index ``d``, and its two subgroups, ``expert`` (None at
    ``ep = 1``) and ``data`` (the world itself at ``ep = 1``)."""

    def __init__(self, ep: int = 1):
        super().__init__()
        if ep < 1 or self.world % ep:
            raise ValueError(f"{ep} expert partitions do not divide the "
                             f"{self.world} processes")
        self.ep, self.dp = ep, self.world // ep
        self.e, self.d = self.rank % ep, self.rank // ep
        self.expert = self.data = None
        if ep > 1:
            self.expert = self._subgroup(
                [[d * ep + i for i in range(ep)] for d in range(self.dp)],
                self.d)
            self.data = self._subgroup(
                [[e + d * ep for d in range(self.dp)] for e in range(ep)],
                self.e)
        else:
            self.data = self

    def _subgroup(self, families: List[List[int]], mine: int) -> DataGroup:
        if len(families) == 1:
            return self
        # every rank makes every group, in the same order
        groups = [dist.new_group(ranks) for ranks in families]
        return DataGroup(groups[mine])

    def __deepcopy__(self, memo):
        return self  # a copied module keeps the process groups

    def expert_slice(self, num_experts: int) -> slice:
        """The experts this rank holds."""
        n = num_experts // self.ep
        return slice(self.e * n, (self.e + 1) * n)

    def gather_experts(self, tensors: Sequence[torch.Tensor]
                       ) -> Optional[List[torch.Tensor]]:
        """The global ``[E, ...]`` tensors of the ranks' expert shards
        ``tensors`` (one dtype), in host memory on rank 0 and None on the
        others: every rank sends its flat through the world's gather in
        pieces, and rank 0 keeps the expert group of data index 0."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        every = self.gather_to_primary(flat)
        if every is None:
            return None
        n = flat.numel()
        sizes = [t.numel() for t in tensors]
        per_e = [every[e * n:(e + 1) * n].split(sizes)
                 for e in range(self.ep)]
        return [torch.cat([p[i].view(t.shape) for p in per_e])
                for i, t in enumerate(tensors)]

    def gather_expert_shards(self, sharded: Sharded,
                             shards: Sequence[torch.Tensor]
                             ) -> Optional[List[torch.Tensor]]:
        """The global ``[E, ...]`` tensors from every rank's ZeRO-1
        ``shards`` of its expert tensors, cut by ``sharded`` over its data
        group: on rank 0's host, None on the others (a collective)."""
        out: List[Optional[List[torch.Tensor]]] = [None] * len(
            sharded.shapes)
        for (idx, part), shard in zip(sharded.groups, shards):
            every = self.gather_to_primary(shard)
            if every is None:
                continue
            n = shard.numel()
            for e in range(self.ep):
                # expert index e's flat: its data group's shards in order
                flat = torch.cat([every[(d * self.ep + e) * n:
                                        (d * self.ep + e + 1) * n]
                                  for d in range(self.dp)])
                for i, v in zip(idx, part.split(flat)):
                    out[i] = (out[i] or []) + [v.view(sharded.shapes[i])]
        if self.rank:
            return None
        return [torch.cat(parts) for parts in out]


class ExpertSharded:
    """:class:`Sharded`'s interface for a list of tensors of which some are
    expert shards (``expert[i]``): the rest cut over all W ranks (the flat
    cut of ``data_parallel.py``), the experts over the rank's data group,
    ``dp`` ways. Each dtype of each part has one shard; :meth:`local` takes
    the tensors at the rank's shapes and :meth:`gather` returns the global
    ones."""

    def __init__(self, tensors: Sequence[torch.Tensor],
                 expert: Sequence[bool], mesh: ExpertMesh,
                 rest: Optional[Sharded] = None,
                 experts: Optional[Sharded] = None):
        self.mesh = mesh
        self.rest_idx = [i for i, x in enumerate(expert) if not x]
        self.expert_idx = [i for i, x in enumerate(expert) if x]
        self.rest = rest or Sharded([tensors[i] for i in self.rest_idx],
                                    mesh)
        self.experts = experts or Sharded(
            [tensors[i] for i in self.expert_idx], mesh.data)

    def local(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return (self.rest.local([tensors[i] for i in self.rest_idx])
                + self.experts.local([tensors[i] for i in self.expert_idx]))

    def gather(self, shards: Sequence[torch.Tensor]
               ) -> Optional[List[torch.Tensor]]:
        n = len(self.rest.groups)
        rest = self.rest.gather(shards[:n])
        experts = self.mesh.gather_expert_shards(self.experts, shards[n:])
        if rest is None:
            return None
        return place(len(self.rest_idx) + len(self.expert_idx),
                     (self.rest_idx, rest), (self.expert_idx, experts))


def place(n: int, *parts) -> list:
    """A list of ``n`` from ``(indices, values)`` parts."""
    out = [None] * n
    for idx, values in parts:
        for i, v in zip(idx, values):
            out[i] = v
    return out


def gather_whole(tensors: Sequence[torch.Tensor], expert: Sequence[bool],
                 mesh: Optional[ExpertMesh]) -> Optional[list]:
    """The global form of ``tensors`` (the rank's shapes; ``expert[i]``
    marks a shard): on rank 0 the replicated ones as they are and the
    experts gathered to its host, None on the other ranks (a collective).
    Without an expert axis, ``tensors`` itself."""
    if mesh is None or mesh.ep == 1:
        return list(tensors)
    idx = [i for i, x in enumerate(expert) if x]
    experts = mesh.gather_experts([tensors[i] for i in idx]) if idx else []
    if mesh.rank:
        return None
    out = list(tensors)
    for i, v in zip(idx, experts):
        out[i] = v
    return out


def slice_experts(tensors: Sequence[torch.Tensor], expert: Sequence[bool],
                  mesh: Optional[ExpertMesh]) -> List[torch.Tensor]:
    """The rank's part of global ``tensors``: its experts of each expert
    tensor (``expert[i]``), the others as they are."""
    if mesh is None or mesh.ep == 1:
        return list(tensors)
    return [t[mesh.expert_slice(t.shape[0])] if x else t
            for t, x in zip(tensors, expert)]


# ---------------------------------------------------------------------------
# the model's expert layers
# ---------------------------------------------------------------------------

def moe_layers(model: nn.Module):
    from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, SwitchMoELayer)]


def model_mesh(model: nn.Module) -> Optional[ExpertMesh]:
    """The expert mesh the model's MoE layers were sharded over, or None
    (no MoE layer, no mesh, or ``ep = 1``)."""
    for _, m in moe_layers(model):
        if m.mesh is not None and m.mesh.ep > 1:
            return m.mesh
    return None


def attach_mesh(model: nn.Module, mesh: Optional[ExpertMesh]) -> None:
    """Give every MoE layer the run's mesh (its collectives); the weights
    stay whole until :func:`shard_experts`. Under an expert axis a layer
    must compute ``dense`` or ``dispatch``: ``dense_fused`` merges the
    experts into one matmul, which cannot be cut by expert (JAX
    ``trainer.py:71-89``)."""
    for name, m in moe_layers(model):
        if mesh is not None and mesh.ep > 1:
            if m.compute == "dense_fused":
                raise ValueError(
                    f"{name} computes 'dense_fused' under {mesh.ep} expert "
                    "partitions: the fused matmul cannot be expert-sharded. "
                    "Build the model with moe_compute='dense' (or "
                    "'dispatch') for expert-parallel runs.")
            if m.num_experts % mesh.ep:
                raise ValueError(f"{name}: {m.num_experts} experts over "
                                 f"{mesh.ep} expert partitions")
        m.mesh = mesh


@torch.no_grad()
def shard_experts(model: nn.Module) -> None:
    """Keep only the rank's experts of every expert parameter of the
    model's MoE layers (after a whole init, so that the weights are the
    one-process run's)."""
    for _, m in moe_layers(model):
        mesh = m.mesh
        if mesh is None or mesh.ep == 1 or m.w1.shape[0] != m.num_experts:
            continue
        keep = mesh.expert_slice(m.num_experts)
        for leaf in EXPERT_LEAVES:
            p = getattr(m, leaf)
            setattr(m, leaf, nn.Parameter(p[keep].clone(),
                                          requires_grad=p.requires_grad))


def expert_flags(names: Sequence[str], mesh: Optional[ExpertMesh]
                 ) -> List[bool]:
    """Which of ``names`` are expert shards under ``mesh`` (an
    :class:`ExpertMesh`, a plain ``DataGroup`` or None)."""
    sharded = getattr(mesh, "ep", 1) > 1
    return [sharded and is_expert_param(n) for n in names]


def whole_state_dict(model: nn.Module) -> Optional[Dict[str, torch.Tensor]]:
    """The model's ``state_dict`` in the global layout: on rank 0 with the
    experts gathered (host memory), None on the other ranks (a
    collective); the state dict itself without an expert axis."""
    sd = model.state_dict()
    mesh = model_mesh(model)
    names = list(sd)
    whole = gather_whole([sd[n] for n in names], expert_flags(names, mesh),
                         mesh)
    return None if whole is None else dict(zip(names, whole))


def local_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A global state dict cut to the model's shapes: each expert tensor
    to the rank's experts."""
    mesh = model_mesh(model)
    names = list(sd)
    return dict(zip(names, slice_experts([sd[n] for n in names],
                                         expert_flags(names, mesh), mesh)))


def make_mesh(cfg) -> Optional[ExpertMesh]:
    """The run's mesh (JAX ``Trainer._maybe_make_mesh``,
    ``trainer.py:127-169``): None without a process group, else the
    :class:`ExpertMesh` of ``num_expert_partitions``, after
    :func:`check_mesh`."""
    check_mesh(cfg)
    return (ExpertMesh(cfg.parallel.num_expert_partitions)
            if dist.is_initialized() else None)


def check_mesh(cfg) -> None:
    """Raise unless the expert partitions divide the world and the
    experts, ``num_data_partitions`` is 0 (the world over ``ep``) or that,
    and the world divides each microbatch (JAX needs ``W | B * T`` alone;
    the port gives each rank whole rows)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ep = cfg.parallel.num_expert_partitions
    procs = f"{world} process{'es' if world > 1 else ''}"
    if ep < 1 or world % ep:
        raise ValueError(
            f"num_expert_partitions (--expert_parallel) {ep}, but the run "
            f"has {procs}: launch a multiple of {ep} processes, one per "
            "device")
    if cfg.model.use_moe and cfg.model.num_experts % ep:
        raise ValueError(f"num_experts {cfg.model.num_experts} not "
                         f"divisible by {ep} expert partitions")
    n = cfg.parallel.num_data_partitions
    if n not in (0, world // ep):
        raise ValueError(
            f"num_data_partitions (--data_parallel) {n}, but the run has "
            f"{procs} over {ep} expert partition{'s' if ep > 1 else ''}: "
            "launch data x expert processes, or pass 0")
    accum = max(1, cfg.train.grad_accum_steps)
    micro = cfg.train.batch_size // accum
    if micro % world:
        raise ValueError(
            f"microbatch {micro} (batch_size {cfg.train.batch_size} / "
            f"grad_accum_steps {accum}) not divisible by the {world} data "
            "ranks; adjust --batch_size / --grad_accum / --data_parallel")
