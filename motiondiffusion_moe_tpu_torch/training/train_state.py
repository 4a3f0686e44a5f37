"""Optimizer, learning rate, EMA and the train step.

Port of ``motiondiffusion_moe_tpu/training/train_state.py``: global-norm
clipping at ``grad_clip_norm`` with the grouped norm (``:66-106``), Adam with
optax's semantics (``:109-156, :180-200``), ``make_lr`` (``:159-177``), the
EMA of the weights (``:368-374``), gradient accumulation as the mean of the
microbatch gradients (``:385-417``), and the train step, whose loss is the
JAX ``loss_fn`` (``:290-356``): masked eps-MSE (importance-weighted) plus
the MoE balance term and the optional losses on the predicted x0.

PyTorch runs eagerly, so the step is a Python function: forward in training
mode, ``backward``, then :meth:`Optimizer.step`. ``steps_per_call`` needs
no counterpart: the JAX package scans K steps in one compiled call to
amortise dispatch, with the same per-step semantics as K single steps,
which is what the eager loop runs. Random draws (the noise, dropout masks,
stochastic-depth coins) come from the ``torch.Generator`` the caller
passes, never from torch's global RNG.

Data parallelism (``parallel/data_parallel.py``): given the run's
``parallel.ExpertMesh`` (a ``DataGroup`` of all W ranks), each rank's step
takes its own rows, its losses are its shares of the global batch's, its
scalar metrics are averaged over the ranks, and :class:`Optimizer` averages
the gradients before the clip. Under ``ParallelConfig.zero1`` the
optimizer's moments and the EMA hold only the rank's shard, their
``state_dict`` gathers the whole into the primary's host memory (a
collective) and ``load_state_dict`` takes the whole and keeps the shard.

With an expert axis (``parallel/mesh.py``, ``ep > 1``) the rank's expert
tensors are its ``E / ep`` experts; with a model axis (``tp > 1``) the
rank's split FFN leaves are its ``1 / tp`` of JAX's Megatron cut, and the
``tp`` ranks of a model group hold the same rows (the row-holders, ``dp x
ep`` of them, are the ranks of :attr:`ExpertMesh.batch`). The losses are
shares of the global batch's over the row-holders. Each leaf's gradient is
summed over the ranks that hold the same block of it (``ExpertMesh.
blocks``): a replicated leaf over all W ranks (its tp copies of each
row-holder's gradient are the same), a model-cut one over the ranks that
share ``m``, an expert over the data group (its gradient already sums the
expert group's losses through the backward all-to-all or reduce-scatter)
and, when it is not model-cut (``b2``), the model ranks too; each is
divided by the number of row-holders times the copies it sums, so the mean
is the global batch's and every holder of a block gets the same bits. The
clip's norm counts each block once. Under ZeRO-1 each of these (up to
four) flat buffers is cut over the ranks that reduce it. ``state_dict`` (a
collective) gives rank 0 the global layout; ``load_state_dict`` takes it
and keeps the rank's blocks.

With a seq axis (``sp > 1``) the seq ranks of a row-holder hold its rows,
each its own frames of T (``ExpertMesh.frames``): the model runs on those
frames, their per-frame losses are partial sums of the row-holder's, and so
are their gradients. They are summed with the rest of a leaf's holders and
divided by the same row-holders x copies, never averaged over seq: the
ranks' losses add up to Q times the global batch's, Q the row-holders
(:meth:`TrainStep._global`). The losses on x0 read the whole T and are
computed alike on every seq rank from the gathered output, whose gradient
each rank takes for its own frames; their denominators, their metrics and
a ``dispatch`` layer's balance statistics count once.

With a pipe axis (``pp > 1``, composing with the data axis alone) the pipe
ranks of a row-holder hold its rows and each its stage's blocks
(``parallel/pipeline_parallel.py``): every pipe rank computes the same
losses on the ring's output, and the ring's backward leaves each the same
whole gradient of every replicated leaf (a copy) and of its own blocks. A
replicated leaf is then summed over the world and divided by Q x pp, a
block's over its stage's data ranks and divided by Q; the clip counts
each stage's blocks once (their squares summed over the pipe group). The
MoE balance term is JAX's PP approximation: the mean over the
(microbatch, data rank) chunks of the stages' Switch aux. Each rank's
loss takes its own stage's term (the mean over its microbatches), whose
gradient the ring's backward carries to the earlier stages; ``loss_moe``
and ``loss_total`` show the sum over the stages, as JAX sows
``pp_aux_*``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
    DiffusionSchedule,
    LossType,
    ModelMeanType,
    ModelVarType,
    pred_xstart_from_eps,
    q_sample,
    training_loss_terms,
)
from motiondiffusion_moe_tpu_torch.models.layers import TrainContext
from motiondiffusion_moe_tpu_torch.models.transformer import (
    generate_src_mask,
    sum_moe_aux_losses,
)
from motiondiffusion_moe_tpu_torch.parallel.data_parallel import (
    FlatParams,
    Sharded,
)
from motiondiffusion_moe_tpu_torch.parallel.mesh import (
    STAGE,
    Cut,
    CutSharded,
    ExpertMesh,
    gather_whole,
    leaf_cuts,
    local_leaves,
)
from motiondiffusion_moe_tpu_torch.training import losses as L

Batch = Dict[str, torch.Tensor]

# Leaves below this element count are concatenated into ONE vector for the
# global-norm reduction, as in the JAX package (fewer, larger reduces).
_NORM_GROUP_MAX_ELEMS = 262144


def grouped_global_norm(tensors: Sequence[torch.Tensor],
                        small_leaf_elems: int = _NORM_GROUP_MAX_ELEMS
                        ) -> torch.Tensor:
    """The global L2 norm of ``tensors``, in f32, with the small ones
    concatenated into one reduce (``grouped_global_norm``)."""
    leaves = [t for t in tensors if t.numel()]
    small = [t.float().reshape(-1) for t in leaves
             if t.numel() < small_leaf_elems]
    parts = [torch.cat(small).square().sum()] if small else []
    parts += [t.float().square().sum() for t in leaves
              if t.numel() >= small_leaf_elems]
    return torch.stack(parts).sum().sqrt()


def clip_by_norm_(grads: List[torch.Tensor], norm: torch.Tensor,
                  max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place, given the global ``norm``:
    every gradient becomes ``(g / norm) * max_norm`` unless ``norm <
    max_norm``. Decided on the device (no host sync); returns the norm."""
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def clip_by_grouped_global_norm_(grads: List[torch.Tensor],
                                 max_norm: float) -> torch.Tensor:
    """:func:`clip_by_norm_` at the grouped global norm of ``grads``."""
    return clip_by_norm_(grads, grouped_global_norm(grads), max_norm)


# ---------------------------------------------------------------------------
# learning rate
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule`` (called only for count < steps)."""
    return lambda count: (init - end) * (1 - min(max(count, 0), steps)
                                         / steps) + end


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax ``join_schedules``: each schedule counts from its boundary."""
    def lr(count: int) -> float:
        start = 0
        for fn, b in zip(schedules, boundaries):
            if count < b:
                return fn(count - start)
            start = b
        return schedules[-1](count - start)
    return lr


def make_lr(cfg: ExperimentConfig) -> Union[float, Callable[[int], float]]:
    """The learning rate: a float (the reference's fixed Adam lr) or a
    function of the update count when warmup or cosine decay is set
    (optax ``warmup_cosine_decay_schedule`` / a linear warmup joined to a
    constant)."""
    tc = cfg.train
    if tc.lr_schedule == "cosine":
        if tc.lr_decay_steps <= 0:
            raise ValueError("lr_schedule='cosine' needs lr_decay_steps "
                             "(total steps incl. warmup)")
        warm = tc.lr_warmup_steps
        decay = max(tc.lr_decay_steps - warm, 1)

        def cosine(count: int) -> float:
            c = min(count, decay)
            return tc.lr * 0.5 * (1 + math.cos(math.pi * c / decay))

        return _join([_linear(0.0, tc.lr, warm), cosine], [warm])
    if tc.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r} "
                         "(constant | cosine)")
    if tc.lr_warmup_steps > 0:
        return _join([_linear(0.0, tc.lr, tc.lr_warmup_steps),
                      lambda count: tc.lr], [tc.lr_warmup_steps])
    return tc.lr


# ---------------------------------------------------------------------------
# the optimizer: clip -> Adam, optax's chain
# ---------------------------------------------------------------------------

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class Optimizer:
    """``make_optimizer``: grouped global-norm clip, then Adam.

    Adam follows optax: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
    update = -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps), eps
    outside the sqrt. ``adam_mu_dtype="bfloat16"`` alone is ``optax.adam``
    with ``mu_dtype``: the update uses the f32 moment, which is stored
    rounded. ``adam_nu_dtype="bfloat16"`` is ``scale_by_adam_compact``: both
    moments accumulate in f32, are stored rounded, and the update reads the
    stored ones. Parameters without a gradient take a zero gradient, as in
    a JAX gradient tree.

    Over the data ranks ``dp`` the gradients are views of flat buffers
    (``parallel.FlatParams``), averaged over the ranks in place before the
    clip. With ``cfg.parallel.zero1`` as well, the parameters are views of
    flat buffers too and ``mu`` and ``nu`` hold one flat shard per
    parameter dtype: the gradient is reduce-scattered, the clip reads the
    global norm (the ranks' sums of squares added), Adam updates the rank's
    shard of the parameters, and the shards are all-gathered into them.
    Over an expert or a model axis (``dp`` a ``parallel.ExpertMesh``;
    ``cuts[i]`` how the rank holds parameter i, ``parallel.mesh.Cut``) the
    parameters cut alike share a flat buffer over the ranks that hold the
    same blocks (see the module doc)."""

    def __init__(self, params: Sequence[nn.Parameter], cfg: ExperimentConfig,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 dp=None, cuts: Optional[Sequence[Cut]] = None):
        tc = cfg.train
        self.params = list(params)
        self.max_norm = tc.grad_clip_norm
        self.lr = make_lr(cfg)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = _DTYPES[tc.adam_mu_dtype]
        self.nu_dtype = _DTYPES[tc.adam_nu_dtype]
        self.compact = self.nu_dtype is not None
        self.count = 0
        self.dp = dp
        zero1 = cfg.parallel.zero1
        self.cuts = list(cuts or [Cut()] * len(self.params))
        self.mesh = dp if isinstance(dp, ExpertMesh) else None
        if self.mesh is not None:
            # one buffer per way of cutting, over the ranks holding the
            # same blocks, divided by the row-holders times the copies of
            # each row-holder's gradient that the sum takes
            mesh = self.mesh
            self.layout = CutSharded(
                self.params, self.cuts, mesh,
                lambda idx, key: FlatParams(
                    [self.params[i] for i in idx], mesh.blocks[key], zero1,
                    denom=mesh.holders * mesh.copies(key)))
            self.flats = self.layout.parts
        elif dp is not None:
            self.flats = [FlatParams(self.params, dp, zero1)]
            self.layout = self.flats[0]
        else:
            self.flats, self.layout = [], None
        self.zero1 = zero1 and dp is not None
        like = ([s for f in self.flats for s in f.param_shards()]
                if self.zero1 else self.params)
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in like]
        self.nu = [torch.zeros_like(p, dtype=self.nu_dtype or p.dtype)
                   for p in like]

    def zero_grad(self) -> None:
        if self.flats:
            for f in self.flats:
                f.zero_grad()
            return
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the parameters' gradients and apply one Adam update;
        returns the gradient norm before clipping."""
        if self.zero1:
            grads = [g for f in self.flats for g in f.reduce_scatter_grads_()]
            sq = torch.stack([g.float().square().sum() for g in grads]).sum()
            norm = clip_by_norm_(grads, self.dp.total(sq).sqrt(),
                                 self.max_norm)
            self._adam_([s for f in self.flats for s in f.param_shards()],
                        grads)
            for f in self.flats:
                f.gather_params_()
            return norm
        for f in self.flats:
            f.mean_grads_()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        parts = self.layout.keyed() if self.mesh is not None else []
        if self.mesh is None or [key for _, key in parts] == [(False, False)]:
            norm = clip_by_grouped_global_norm_(grads, self.max_norm)
        else:  # each block once: its squares over the ranks of other blocks
            mesh = self.mesh
            across = {(False, True): mesh.model, (True, False): mesh.expert,
                      (True, True): mesh.shard, STAGE: mesh.pipe}
            sq = torch.zeros((), device=grads[0].device)
            for idx, key in parts:
                if key == (False, False):  # whole on every rank
                    sq = sq + grouped_global_norm(
                        [grads[i] for i in idx]).square()
                else:
                    sq = sq + across[key].total(sum(
                        (grads[i].float().square().sum() for i in idx),
                        torch.zeros((), device=grads[0].device)))
            norm = clip_by_norm_(grads, sq.sqrt(), self.max_norm)
        self._adam_(self.params, grads)
        return norm

    def _adam_(self, params: List[torch.Tensor],
               grads: List[torch.Tensor]) -> None:
        """One Adam update of ``params`` in place, from ``grads`` and the
        moments (each list in the order of ``self.mu``)."""
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        f32 = self.mu_dtype is None and self.nu_dtype is None
        mu = self.mu if f32 else [m.float() for m in self.mu]
        nu = self.nu if f32 else [v.float() for v in self.nu]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        if not f32:
            for dst, src in ((self.mu, mu), (self.nu, nu)):
                for d, s in zip(dst, src):
                    d.copy_(s)
            if self.compact:  # the update reads the stored moments
                mu = [m.float() for m in self.mu]
                nu = [v.float() for v in self.nu]
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)

    def state_dict(self) -> dict:
        """The whole state, one moment per parameter (the global layout).
        Under ZeRO-1 or an expert axis a collective that every rank calls:
        the primary's moments are then in host memory, the other ranks'
        None."""
        if self.zero1:
            return {"count": self.count, "mu": self.layout.gather(self.mu),
                    "nu": self.layout.gather(self.nu)}
        return {"count": self.count,
                "mu": gather_whole(self.mu, self.cuts, self.mesh),
                "nu": gather_whole(self.nu, self.cuts, self.mesh)}

    def load_state_dict(self, state: dict) -> None:
        """From the whole state (the rank keeps its blocks and, under
        ZeRO-1, its shard)."""
        self.count = int(state["count"])
        for dst, src in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            staged = self.mesh is not None and self.mesh.pp > 1
            if len(src) != len(self.params) and not staged:
                raise ValueError(f"optimizer state has {len(src)} moments, "
                                 f"the model {len(self.params)} parameters")
            # (a pipe rank's: its stage's, which raises unless they fit)
            src = local_leaves(src, self.cuts, self.mesh)
            if self.zero1:
                src = self.layout.local(src)
            for d, s in zip(dst, src):
                d.copy_(s)


class EMA:
    """Exponential moving average of every parameter (``:368-374``):
    ema = d * ema + (1 - d) * p after each update, starting from a copy of
    the weights (no bias correction). With ``shards`` (a
    ``parallel.Sharded`` of the model's parameters, or a ``CutSharded``
    over an expert or a model axis; ZeRO-1) it holds and updates the rank's
    shard alone. Over such an axis (``mesh``, ``cuts[i]`` how the rank
    holds parameter i) ``state_dict`` gathers the global layout into the
    primary's host memory (a collective; None on the other ranks), as it
    does under ZeRO-1, and ``load_state_dict`` keeps the rank's part."""

    def __init__(self, model: nn.Module, decay: float, shards=None,
                 mesh=None, cuts: Optional[Sequence[Cut]] = None):
        self.decay = decay
        self.shards = shards
        self.mesh = mesh if isinstance(mesh, ExpertMesh) else None
        self.cuts = list(cuts or [Cut()] * len(list(model.parameters())))
        self.params = self._own(model)

    def _own(self, model: nn.Module) -> List[torch.Tensor]:
        params = [p.detach() for p in model.parameters()]
        if self.shards is not None:
            return self.shards.local(params)
        return [p.clone() for p in params]

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        src = [p.detach() for p in model.parameters()]
        if self.shards is not None:
            src = self.shards.local(src)
        torch._foreach_mul_(self.params, self.decay)
        torch._foreach_add_(self.params, src, alpha=1.0 - self.decay)

    def reset(self, model: nn.Module) -> None:
        """Restart from the model's weights."""
        self.params = self._own(model)

    def state_dict(self) -> dict:
        if self.shards is None:
            return {"params": gather_whole(self.params, self.cuts,
                                           self.mesh)}
        return {"params": self.shards.gather(self.params)}

    def load_state_dict(self, state: dict) -> None:
        src = local_leaves(state["params"], self.cuts, self.mesh)
        if self.shards is not None:
            src = self.shards.local(src)
        for d, s in zip(self.params, src):
            d.copy_(s)


@dataclass
class TrainState:
    """The model (parameters live in it), the optimizer, the EMA (when
    ``ema_decay > 0``) and the update count."""

    model: nn.Module
    optimizer: Optimizer
    ema: Optional[EMA] = None
    step: int = 0


def create_train_state(model: nn.Module, cfg: ExperimentConfig,
                       dp=None) -> TrainState:
    """Optimizer over the trainable parameters (the frozen FAVOR
    projections carry ``requires_grad=False``; in JAX their gradient is an
    exact zero, so Adam leaves them unchanged either way) and the EMA, over
    the run's mesh ``dp`` (a ``parallel.ExpertMesh`` or ``DataGroup``) when
    given; the model's leaves already cut (``parallel.shard_params``)."""
    named = list(model.named_parameters())
    by_name = leaf_cuts(model)
    cuts = [by_name[n] for n, _ in named]
    train = [i for i, (_, p) in enumerate(named) if p.requires_grad]
    opt = Optimizer([named[i][1] for i in train], cfg, dp=dp,
                    cuts=[cuts[i] for i in train])
    ema = None
    if cfg.train.ema_decay > 0:
        params = [p for _, p in named]
        shards = None
        if dp is not None and cfg.parallel.zero1:
            shards = (CutSharded(params, cuts, dp)
                      if isinstance(dp, ExpertMesh) else Sharded(params, dp))
        ema = EMA(model, cfg.train.ema_decay, shards, mesh=dp, cuts=cuts)
    return TrainState(model=model, optimizer=opt, ema=ema)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

class TrainStep:
    """``make_train_step``: ``step(state, batch, generator)`` runs one
    optimizer update and returns the metrics (``loss_total``,
    ``loss_mot_rec``, ``loss_moe``, the optional losses, ``grad_norm`` as
    0-dim tensors; ``per_sample_mse`` [B]).

    Batch: ``motion`` [B, T, F] (normalized), ``length`` [B], ``text_ids``
    [B, N], ``t`` [B], ``t_weight`` [B], all on the model's device. With
    ``grad_accum_steps = A > 1`` the batch is split into A contiguous
    microbatches, each drawing its own noise, and the update uses the mean
    of their gradients.

    Over the data ranks ``dp`` (the run's ``parallel.ExpertMesh``) the
    batch is the rank's row-holder's rows, each microbatch's losses are its
    shares of the global microbatch's (:meth:`_global`: one collective a
    microbatch over the row-holders, ``ExpertMesh.batch``), and the scalar
    metrics are the global batch's (the ranks' shares summed over the
    row-holders and their seq ranks, divided by the row-holders: one
    collective a step); ``per_sample_mse`` stays the rank's rows (on a seq
    rank each row's over its whole T, the same on every seq rank)."""

    def __init__(self, sched: DiffusionSchedule, cfg: ExperimentConfig,
                 normalizer_stats: Optional[Tuple[np.ndarray,
                                                  np.ndarray]] = None,
                 dp=None):
        dc, tc = cfg.diffusion, cfg.train
        self.sched = sched
        self.cfg = cfg
        self.dp = dp
        self.mean_type = ModelMeanType(dc.model_mean_type)
        self.var_type = ModelVarType(dc.model_var_type)
        self.loss_type = LossType(dc.loss_type)
        self.accum = max(1, tc.grad_accum_steps)
        self.norm_stats = normalizer_stats
        if tc.w_structure > 0 and normalizer_stats is None:
            raise ValueError("the structure loss needs normalizer stats "
                             "(joint-space decode)")

    def loss(self, model: nn.Module, batch: Batch, noise: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, metrics) of one forward in training mode on the
        given noise: the JAX ``loss_fn``; over the data ranks, this rank's
        share of the global microbatch's (:meth:`_global`). On a seq rank
        the model runs on the rank's frames of ``motion`` and the noise
        (both drawn whole), the per-frame loss is the frames' share, and the
        losses on x0 are the whole T's: the output gathered over the seq
        ranks (its gradient the rank's frames of theirs, ``"keep"``),
        computed alike on every seq rank and counted once."""
        tc = self.cfg.train
        ctx = TrainContext(generator=generator)
        x_start, t = batch["motion"], batch["t"]
        x_t = q_sample(self.sched, x_start, t, noise)
        T = x_start.shape[1]
        mesh = self.dp if getattr(self.dp, "sp", 1) > 1 else None
        t0, t1 = mesh.frames(T) if mesh is not None else (0, T)
        first = 1.0 if mesh is None or mesh.s == 0 else 0.0
        out = model(x_t[:, t0:t1], t, batch["length"],
                    text_ids=batch["text_ids"], ctx=ctx,
                    frames=None if mesh is None else (t0, t1, T))
        terms = training_loss_terms(
            self.sched, out, x_start[:, t0:t1], x_t[:, t0:t1], t,
            noise[:, t0:t1], mean_type=self.mean_type,
            var_type=self.var_type, loss_type=self.loss_type)
        src_mask = generate_src_mask(t1 - t0, batch["length"], t0)
        # (name, weight, the masked sums of its mean or means, whether
        # every seq rank computes it whole)
        parts = [("loss_mot_rec", 1.0, L.frame_mse_sums(
            terms["pred"], terms["target"], src_mask, batch.get("t_weight")),
            False)]
        if (tc.w_velocity > 0 or tc.w_acceleration > 0 or tc.w_structure > 0
                or tc.w_progressive > 0):
            pred, whole_mask = terms["pred"], src_mask
            if mesh is not None:  # the whole T's, from the seq ranks
                pred = mesh.gather_frames(
                    pred, [b - a for a, b in (mesh.frames(T, s)
                                              for s in range(mesh.sp))],
                    backward="keep")
                whole_mask = generate_src_mask(T, batch["length"])
            pred_x0 = (pred_xstart_from_eps(self.sched, x_t, t, pred)
                       if self.mean_type == ModelMeanType.EPSILON else pred)
            whole = mesh is not None
            if tc.w_velocity > 0:
                parts.append(("loss_velocity", tc.w_velocity,
                              L.velocity_sums(pred_x0, x_start, whole_mask),
                              whole))
            if tc.w_acceleration > 0:
                parts.append(("loss_acceleration", tc.w_acceleration,
                              L.acceleration_sums(pred_x0, x_start,
                                                  whole_mask), whole))
            if tc.w_progressive > 0:
                parts.append(("loss_progressive", tc.w_progressive,
                              L.progressive_sums(pred_x0, x_start,
                                                 whole_mask), whole))
            if tc.w_structure > 0:
                mean, std = (torch.as_tensor(a, device=x_start.device)
                             for a in self.norm_stats)
                parts.append(("loss_structure", tc.w_structure,
                              L.structure_sums(pred_x0 * std + mean,
                                               x_start * std + mean,
                                               whole_mask,
                                               self.cfg.data.num_joints),
                              whole))
        # a whole-T term's denominators count on one seq rank
        dens, moe_aux, scale = self._global(
            [den * first if whole else den for _, _, sums, whole in parts
             for _, den in sums], ctx)
        dens = iter(dens)
        values = [L.mean_of([(num, next(dens)) for num, _ in sums], scale)
                  for _, _, sums, _ in parts]
        loss_rec = values[0]
        moe_loss = (moe_aux.to(loss_rec.device)
                    * self.cfg.model.moe_aux_loss_weight)
        total = loss_rec + moe_loss
        pipe = getattr(self.dp, "pipe", None)
        if pipe is not None:  # the stages' terms: the data rank's whole
            moe_loss = pipe.total(moe_loss)
        shown = loss_rec + moe_loss
        metrics = {"loss_mot_rec": loss_rec, "loss_moe": moe_loss}
        for (name, w, _, whole), value in zip(parts[1:], values[1:]):
            total = total + w * value
            # the metrics are summed over the ranks: a whole term once
            metrics[name] = value * first if whole else value
            shown = shown + w * metrics[name]
        metrics["loss_total"] = shown
        per_frame = ((terms["pred"] - terms["target"]) ** 2).mean(-1)
        num, den = (per_frame * src_mask).sum(1), src_mask.sum(1)
        if mesh is not None:  # each row's frames on every seq rank
            num, den = mesh.seq.total(torch.stack([num, den])).unbind()
        metrics["per_sample_mse"] = num / den.clamp(min=1.0)
        return total, {k: v.detach() for k, v in metrics.items()}

    def _global(self, dens: List[torch.Tensor], ctx: TrainContext):
        """(the masked means' denominators, the MoE aux loss, the scale of
        the means' numerators). In one process: ``dens``, the layers' aux
        losses, 1. Over the ranks of ``ExpertMesh.batch`` (the Q
        row-holders and their seq ranks, each holding distinct frames of
        distinct rows; the model ranks of a row-holder compute the same
        values), one all-reduce of ``dens``, of every MoE layer's expert
        shares f, each rank's weighted by the tokens it routed (under a
        seq axis, whose cuts may be uneven; else alike), and of those
        weights gives the global batch's: then a rank's numerator x Q over
        the global denominator, and E sum f P with the global f (which has
        no gradient) and the rank's P weighted by its share of the
        weights (times Q), add up over the ranks to Q times the global
        batch's losses; the optimizer's sum over the ranks, divided by Q,
        is then the global batch's gradient. A layer's statistics that
        every seq rank holds alike (``MoEBalance.once``) count once. Under
        a pipe axis the aux is JAX's PP estimate instead: the rank's
        stage's rings' terms (``ctx.stage_aux``), each the mean over its
        microbatches of its blocks' aux on the chunk."""
        if self.dp is None:
            return dens, sum_moe_aux_losses(ctx), 1
        holders = getattr(self.dp, "batch", self.dp)
        Q = getattr(self.dp, "holders", holders.world)
        if getattr(self.dp, "pp", 1) > 1:
            # JAX's PP aux: each stage's mean over its microbatches, the
            # rank's term of the data rank's whole (see the module doc)
            aux = torch.stack(ctx.stage_aux).sum()
            return list(holders.total(torch.stack(dens).float()).unbind()), \
                aux, Q
        k, bal = len(dens), ctx.moe_balance
        # each rank's weight in a layer's means: its tokens under a seq
        # axis (the cuts may be uneven), else 1 (every rank routes as
        # many); 0 where another seq rank counts the same statistics
        seq = getattr(self.dp, "sp", 1) > 1
        weights = [float(b.tokens if seq else 1) if b.once else 0.0
                   for b in bal]
        dev = dens[0].device
        flat = holders.total(torch.cat(
            [torch.stack(dens).float()]
            + [b.f.float() * w for b, w in zip(bal, weights)]
            + [torch.tensor(weights, dtype=torch.float32, device=dev)]))
        aux, off = [], k
        every = flat[flat.numel() - len(bal):]
        for b, w, total in zip(bal, weights, every):
            f_all = (flat[off:off + b.f.numel()] / total).to(b.f.dtype)
            aux.append(b.f.numel() * torch.sum(f_all * b.p)
                       * (Q * w / total))
            off += b.f.numel()
        aux = torch.stack(aux).sum() if aux else torch.zeros(())
        return list(flat[:k].unbind()), aux, Q

    def backward(self, state: TrainState, batch: Batch,
                 generator: Optional[torch.Generator],
                 noise: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """Forward and backward of one (possibly accumulated) batch; the
        gradients are left in the parameters' ``.grad``. ``noise`` (same
        shape as the motion) replaces the generator's draw."""
        model = state.model
        model.train()
        state.optimizer.zero_grad()
        B = batch["motion"].shape[0]
        A = self.accum if B % self.accum == 0 else 1
        parts = []
        for i in range(A):
            sl = slice(i * B // A, (i + 1) * B // A)
            chunk = {k: v[sl] for k, v in batch.items()}
            eps = (noise[sl] if noise is not None else torch.randn(
                chunk["motion"].shape, generator=generator,
                device=chunk["motion"].device))
            total, metrics = self.loss(model, chunk, eps, generator)
            (total / A).backward()
            parts.append(metrics)
        metrics = parts[0] if A == 1 else {
            k: (torch.cat([m[k] for m in parts]) if k == "per_sample_mse"
                else torch.stack([m[k] for m in parts]).mean())
            for k in parts[0]}
        if self.dp is not None:  # the global batch's: the ranks' shares
            holders = getattr(self.dp, "batch", self.dp)
            names = [k for k in metrics if k != "per_sample_mse"]
            mean = holders.total(torch.stack([metrics[k] for k in names]))
            Q = getattr(self.dp, "holders", holders.world)
            metrics.update(zip(names, (mean / Q).unbind()))
        return metrics

    def apply_update(self, state: TrainState,
                     metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Clip + Adam from the gradients in ``.grad``, then the EMA."""
        metrics["grad_norm"] = state.optimizer.step()
        if state.ema is not None:
            state.ema.update(state.model)
        state.step += 1
        return metrics

    def __call__(self, state: TrainState, batch: Batch,
                 generator: Optional[torch.Generator]
                 ) -> Dict[str, torch.Tensor]:
        return self.apply_update(state, self.backward(state, batch,
                                                      generator))
