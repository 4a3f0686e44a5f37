"""The data, expert and model axes of the JAX package's ``parallel/mesh.py``
over ``torch.distributed``: the rank layout, the process subgroups, and where
the expert and FFN parameters live.

JAX lays ``W = dp x ep x tp`` devices out as a ``(data, expert, model)``
mesh with the model axis minor (``make_mesh`` :45-76): device ``i = (d * ep
+ e) * tp + m``. The port runs one process per device with the same
numbering, rank ``r = (d * ep + e) * tp + m`` (``r = d * ep + e`` at ``tp =
1``), and:

- every rank makes every subgroup, in the same order: the expert groups
  (the ranks that share ``(d, m)``: the all-to-all of ``dispatch`` and the
  collectives of ``dense`` run among them), the data groups (the ranks that
  share ``(e, m)``, which hold the same parameters: their expert gradients
  are summed over it and, under ZeRO-1, their expert moments and EMA cut
  over it), and with ``tp > 1`` the model groups (the ranks that share
  ``(d, e)``: the row-parallel sums) and the shard groups (the ranks that
  share ``d``: the sum of ``dense``'s partial products);
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
  everything else is replicated;
- in training (``tp = 1``) rank r holds rows ``[r B / W, (r + 1) B / W)``
  of each microbatch, which are token chunk r of JAX's ``P((data,
  expert))`` layout, so a capacity counted on the rank's own tokens is
  JAX's per-chunk capacity; in generation (``rows_replicated``, the
  layout of JAX's ``GenerationPipeline`` under a mesh, ``P('data')``) the
  ranks of one data index hold the same rows of the CFG-doubled batch, and
  ``dispatch`` cuts their tokens into JAX's chunks itself
  (``parallel/moe_parallel.py``).

A checkpoint holds JAX's global ``[E, ...]`` layout: :meth:`ExpertMesh.
gather_experts` and :meth:`ExpertMesh.gather_expert_shards` bring the
shards to rank 0's host in expert order, and :func:`local_state_dict`
cuts a whole state for any ``(dp, ep, tp)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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


def model_dim(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dim of a (torch-layout) parameter that JAX's Megatron rule cuts
    over ``tp`` model ranks, or None (replicated over the model axis):
    ``_param_spec`` :89-139 on the port's names, flax's ``[in, out]``
    kernels being the transposes of the torch weights here."""
    module, _, leaf = name.rpartition(".")
    dim = None
    if is_expert_param(name):
        dim = {"w1": 2, "b1": 1, "w2": 1}.get(leaf)  # b2 stays whole
    elif module.endswith("_fc1") or module.endswith("ffn_0"):
        dim = 0  # column-parallel: the output columns, weight and bias
    elif (module.endswith("_fc2") or module.endswith("ffn_1")) \
            and leaf == "weight":
        dim = 1  # row-parallel: the input columns; the bias joins once
    if dim is None or tp < 2 or dim >= len(shape) or shape[dim] % tp:
        return None
    return dim


class ExpertMesh(DataGroup):
    """The run's ``(data, expert, model)`` mesh: the world's collectives
    (this class is the world's :class:`DataGroup`), the rank's indices ``d``,
    ``e``, ``m`` and its subgroups: ``expert`` (None at ``ep = 1``),
    ``data`` (the world itself at ``ep = tp = 1``), ``model`` and ``shard``
    (None at ``tp = 1``; ``shard`` is ``expert`` then). ``rows_replicated``
    marks the generation layout (see the module doc)."""

    def __init__(self, ep: int = 1, tp: int = 1,
                 rows_replicated: bool = False):
        super().__init__()
        if ep < 1 or tp < 1 or self.world % (ep * tp):
            raise ValueError(f"{ep} expert x {tp} model partitions do not "
                             f"divide the {self.world} processes")
        self.ep, self.tp, self.dp = ep, tp, self.world // (ep * tp)
        self.rows_replicated = rows_replicated
        self.m = self.rank % tp
        self.e = self.rank // tp % ep
        self.d = self.rank // (tp * ep)

        def rank(d, e, m):
            return (d * ep + e) * tp + m

        self.expert = self.model = self.shard = None
        self.data = self
        if ep > 1:
            self.expert = self._subgroup(
                [[rank(d, i, m) for i in range(ep)] for d in range(self.dp)
                 for m in range(tp)], self.d * tp + self.m)
        if ep * tp > 1:
            self.data = self._subgroup(
                [[rank(d, e, m) for d in range(self.dp)] for e in range(ep)
                 for m in range(tp)], self.e * tp + self.m)
        if tp > 1:
            self.model = self._subgroup(
                [[rank(d, e, i) for i in range(tp)] for d in range(self.dp)
                 for e in range(ep)], self.d * ep + self.e)
            self.shard = self._subgroup(
                [list(range(d * ep * tp, (d + 1) * ep * tp))
                 for d in range(self.dp)], self.d) if ep > 1 else self.model
        else:
            self.shard = self.expert

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
        if self.ep > 1 and is_expert_param(name):
            x = x[self.expert_slice(x.shape[0])]
        dim = model_dim(name, x.shape, self.tp)
        if dim is not None:
            n = x.shape[dim] // self.tp
            x = x.narrow(dim, self.m * n, n)
        return x

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
    """The mesh the model's parameters were cut over, or None (no mesh, or
    one that cuts nothing: ``ep = tp = 1``)."""
    for m in model.modules():
        mesh = getattr(m, "mesh", None)
        if isinstance(mesh, ExpertMesh) and mesh.ep * mesh.tp > 1:
            return mesh
    return None


def attach_mesh(model: nn.Module, mesh: Optional[ExpertMesh]) -> None:
    """Give every MoE layer the run's mesh (its collectives), and with a
    model axis every FFN pair its split (``Dense.split``, the MoE layer's
    ``model_split``: only where :func:`model_dim` cuts the hidden width);
    the weights stay whole until :func:`shard_experts` or a pipeline's
    :meth:`~pipeline.GenerationPipeline.set_params`. Under an expert or a
    model axis a layer must compute ``dense`` or ``dispatch``:
    ``dense_fused`` merges the experts into one matmul, which cannot be
    cut (JAX ``trainer.py:71-89``)."""
    from motiondiffusion_moe_tpu_torch.models.layers import Dense

    tp = mesh.tp if mesh is not None else 1
    for name, m in moe_layers(model):
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
    for name, m in model.named_modules():
        if isinstance(m, Dense):
            dim = model_dim(f"{name}.weight", m.weight.shape, tp)
            m.split = None if dim is None else ("row" if dim else "column")
            m.mesh = mesh if m.split else None


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
    """A global state dict cut to the model's shapes: each tensor to the
    rank's part of it (:meth:`ExpertMesh.local_leaf`)."""
    mesh = model_mesh(model)
    if mesh is None:
        return dict(sd)
    return {n: mesh.local_leaf(n, v) for n, v in sd.items()}


def generation_mesh(data_parallel: int = 1, expert_parallel: int = 1,
                    tensor_parallel: int = 1) -> Optional[ExpertMesh]:
    """The ``(data, expert, model)`` mesh of ``GenerationPipeline`` and the
    serve / evaluate CLIs, in the generation layout: None when every degree
    is 1 and no process group exists. Raises unless the process group has
    ``dp x ep x tp`` ranks (``data_parallel`` 0 means the world over ``ep x
    tp``), and, with degrees above 1, unless it exists."""
    dp, ep, tp = data_parallel, expert_parallel, tensor_parallel
    world = dist.get_world_size() if dist.is_initialized() else 1
    if min(ep, tp) < 1 or dp < 0:
        raise ValueError(f"parallel degrees data {dp}, expert {ep}, model "
                         f"{tp}: each at least 1 (data 0 = the rest)")
    want = (dp or max(1, world // (ep * tp))) * ep * tp
    if want > 1 and not dist.is_initialized():
        raise ValueError(
            f"--data_parallel {dp} --expert_parallel {ep} --tensor_parallel "
            f"{tp} asks for {want} devices, but this is one process: launch "
            f"one process per device ({want}), with torchrun or "
            "--coordinator_address / --num_processes / --process_id")
    if world != want:
        raise ValueError(
            f"data {dp or world // (ep * tp)} x expert {ep} x model {tp} = "
            f"{want} ranks, but the process group has {world}: launch "
            "data x expert x model processes, one per device")
    if not dist.is_initialized():
        return None
    return ExpertMesh(ep, tp, rows_replicated=True)


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
