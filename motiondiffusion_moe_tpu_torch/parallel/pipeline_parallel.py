"""The pipe axis of the JAX package's ``parallel/pipeline_parallel.py``
over ``torch.distributed``: a GPipe ring of microbatches through the pipe
stages, each stage holding only its own blocks.

JAX shards the stacked ``[L, ...]`` block leaves into S contiguous stages
and runs one SPMD program whose ``ppermute`` and its transpose give the
forward ring and the backward for free (``gpipe`` :86-177). Here each pipe
rank is a process (rank ``d * S + p`` of ``parallel/mesh.py::ExpertMesh``,
the pipe axis composing with the data axis alone, as in JAX), and the
schedule, the sends and the backward are written out:

- each rank keeps the whole seeded model but for the blocks of the other
  stages (:func:`keep_stage`): stage p holds blocks ``[p L / S, (p + 1) L /
  S)`` of each U-Net scale, under their one-process names
  (``blocks_low.i``), and a placeholder (:class:`Elsewhere`) in the place
  of each other block;
- everything before, between and after the two rings runs on every pipe
  rank alike, as in JAX;
- :func:`gpipe` cuts the rank's rows into M contiguous microbatches
  (:func:`pp_num_microbatches`: ``pipeline_microbatches``, or 2 S). Stage p
  receives each microbatch's hidden state from stage p - 1 (stage 0 takes
  its own rows), runs its blocks on it with that microbatch's context
  (``xf``, ``emb``, the mask, read locally, never sent) and sends the
  result on to p + 1; only real (stage, microbatch) pairs compute, so
  there is no bubble work and no hidden state of zeros (JAX's NaN hazard,
  :121-125). The last stage's outputs are broadcast over the pipe group,
  the counterpart of JAX's psum (:156-160). Sends are posted without
  waiting (:meth:`DataGroup.isend`) and waited for at the end of the
  schedule, so no stage blocks on a send while the ring moves;
- in training the ring is one ``torch.autograd.Function`` per scale
  (:class:`_GPipe`). Its forward keeps each microbatch's graph (the
  stage's blocks run under grad on a detached input); its backward runs
  the microbatches again in order: it receives d(output) from stage p + 1
  (the last stage takes its own copy of the output's gradient, which every
  pipe rank computes alike: not the sum), runs the microbatch's graph with
  the stage's aux term beside it, accumulates the stage's parameter
  gradients and sends d(input) to p - 1, releasing the graph. Then d(h) is
  broadcast from stage 0, since every pipe rank runs the same head on it,
  and d(xf), d(emb), which each stage's blocks read, are summed over the
  pipe group: every pipe rank then holds the same whole gradient of each
  replicated leaf, one copy of it (the optimizer divides by the copies,
  ``ExpertMesh.copies``);
- the MoE balance term is JAX's approximation (module doc :27-35): each
  (stage, microbatch, data rank) takes its own blocks' Switch aux on its
  chunk, and the ring returns the stage's sum over its microbatches
  divided by M; ``training/train_state.py`` weighs it in the rank's loss
  and sums it over the pipe and data ranks for the metric, the mean over
  the data ranks of the stages' sum that JAX sows as ``pp_aux_blocks_*``.
  JAX's chunk (m, d) is rows ``(m dp + d) c + [0, c)`` of the batch; data
  rank d here holds rows ``[d B / dp, (d + 1) B / dp)`` cut into M chunks
  of c: the same set of chunks, so the same mean;
- the draws (:func:`ring_draws`): before the rings, every pipe rank draws
  from its row-holder's generator, alike, one whole-batch stochastic-depth
  coin per block of both scales (2 L at once, JAX's per-forward coins
  shared by every microbatch) and, with dropout, one seed per (scale,
  layer, microbatch), from which that layer's dropout masks on that
  microbatch are drawn (JAX: one key per (layer, microbatch) folded with
  the data index; here the data ranks' generators differ already). At
  dropout 0 and survival 1 the step is JAX's PP step; with dropout it is
  another stream, as JAX's is another than its one-device step.

The kernels run whole inside a stage, on its microbatches: each stage
launches kernels 1-4 (and 5-7 where the model asks for them) for its own
blocks alone. :func:`pp_stage_memory_report` is JAX's stage memory
account on the port's named parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

# the denoiser's block lists (parallel/mesh.py reads the same names)
SCALES = ("blocks_low", "blocks_high")

# JAX's refusal (transformer.py:274-279), raised at the mesh and the model
DISPATCH_IN_RING = ("moe_compute='dispatch' (the all-to-all) cannot nest "
                    "inside the pipeline ring; use 'dense' or 'dense_fused'")

# stage_fn(x, context of the microbatch, m) -> (y, aux)
StageFn = Callable[[torch.Tensor, Dict[str, torch.Tensor], int],
                   Tuple[torch.Tensor, torch.Tensor]]


def pp_num_microbatches(pipeline_microbatches: int, pp: int) -> int:
    """The microbatch count M of the ring: the config value, or 2 S when
    it is 0 (``pp_num_microbatches`` :49-56)."""
    return pipeline_microbatches or 2 * pp


def validate_pp_layout(pp: int, dp: int, num_layers: int, batch: int,
                       pipeline_microbatches: int,
                       batch_desc: str = "global batch",
                       fix_hint: str = "") -> None:
    """JAX's ``validate_pp_layout`` (:59-83): raise unless L % S == 0, B %
    M == 0 and (B / M) % dp == 0 (each data rank then cuts its rows into M
    microbatches)."""
    if pp <= 1:
        return
    M = pp_num_microbatches(pipeline_microbatches, pp)
    if num_layers % pp != 0:
        raise ValueError(
            f"pipeline parallelism: num_layers={num_layers} must be "
            f"divisible by the 'pipe' mesh axis ({pp}) — each stage holds "
            f"num_layers / {pp} contiguous blocks of each scale{fix_hint}")
    if batch % M != 0 or (batch // M) % dp != 0:
        raise ValueError(
            f"pipeline parallelism: {batch_desc} ({batch}) must split "
            f"into pipeline_microbatches={M} microbatches whose size "
            f"divides the 'data' mesh axis ({dp}){fix_hint}")


# ---------------------------------------------------------------------------
# the stage's blocks
# ---------------------------------------------------------------------------

class Elsewhere(nn.Module):
    """The place of a block that another pipe stage holds: no parameters,
    so that the held blocks keep their one-process names."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"this block is held by pipe stage {self.stage}")


def stage_range(num_layers: int, pp: int, p: int) -> range:
    """The blocks of each scale that stage p holds."""
    k = num_layers // pp
    return range(p * k, (p + 1) * k)


def stage_name(name: str, shift: int) -> str:
    """``blocks_low.i.rest`` as ``blocks_low.{i + shift}.rest``: the name
    of the same leaf of another stage's block."""
    scale, i, rest = name.split(".", 2)
    return f"{scale}.{int(i) + shift}.{rest}"


def keep_stage(model: nn.Module, mesh) -> None:
    """Keep only the rank's stage's blocks of every denoiser in ``model``
    (the others become :class:`Elsewhere`): once, after the whole seeded
    init, so that the weights are the one-process run's."""
    for m in model.modules():
        if getattr(m, "pipe", None) is None:
            continue
        for scale in SCALES:
            blocks = getattr(m, scale)
            held = stage_range(len(blocks), mesh.pp, mesh.p)
            for i in range(len(blocks)):
                if i not in held:
                    blocks[i] = Elsewhere(i // len(held))


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _neighbours(mesh) -> Tuple[int, int, int, int]:
    """(previous stage's rank, next stage's rank, first, last) at this
    rank's data index."""
    at = lambda p: mesh.rank_of(mesh.d, 0, 0, 0, p)  # noqa: E731
    return at(mesh.p - 1), at(mesh.p + 1), at(0), at(mesh.pp - 1)


def _ring_forward(mesh, stage_fn: StageFn, h: torch.Tensor,
                  context: Dict[str, torch.Tensor], M: int, keep: bool):
    """The forward schedule (see the module doc): (the last stage's output
    on every pipe rank, the stage's aux summed over the microbatches / M,
    and with ``keep`` each microbatch's (input, context, output, aux) with
    their graphs)."""
    group, p, S = mesh.pipe, mesh.p, mesh.pp
    prev, nxt, _, last = _neighbours(mesh)
    B = h.shape[0]
    if B % M:
        raise ValueError(f"{B} rows of a pipe rank do not split into {M} "
                         "microbatches")
    c = B // M
    kept, outs, sends = [], [], []
    aux = torch.zeros((), device=h.device)
    for m in range(M):
        rows = slice(m * c, (m + 1) * c)
        x = (h[rows] if p == 0 else
             group.recv(h.new_empty((c,) + tuple(h.shape[1:])), prev))
        ctx_m = {k: v[rows] for k, v in context.items()}
        if keep:
            x = x.detach().requires_grad_()
            ctx_m = {k: v.detach().requires_grad_(v.requires_grad)
                     for k, v in ctx_m.items()}
            with torch.enable_grad():
                y, a = stage_fn(x, ctx_m, m)
            kept.append((x, ctx_m, y, a))
        else:
            y, a = stage_fn(x, ctx_m, m)
        aux = aux + a.detach().float()
        if p < S - 1:
            sends.append(group.isend(y, nxt))
        else:
            outs.append(y.detach())
    for s in sends:
        s.wait()
    out = torch.cat(outs) if p == S - 1 else h.new_empty(h.shape)
    group.broadcast_(out, last)
    return out, aux / M, kept


class _GPipe(torch.autograd.Function):
    """One ring with its backward schedule (see the module doc). ``grip``
    is an empty tensor that requires grad, so that the backward runs
    whatever the inputs need."""

    @staticmethod
    def forward(ctx, mesh, stage_fn, M, keys, grip, h, *context):
        out, aux, kept = _ring_forward(mesh, stage_fn, h,
                                       dict(zip(keys, context)), M, True)
        ctx.mesh, ctx.M, ctx.keys, ctx.kept = mesh, M, keys, kept
        ctx.h_like = (h.shape, h.dtype, h.device)
        ctx.needs = [t.requires_grad for t in context]
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        mesh, M, kept = ctx.mesh, ctx.M, ctx.kept
        group, p, S = mesh.pipe, mesh.p, mesh.pp
        prev, nxt, first, _ = _neighbours(mesh)
        shape, dtype, device = ctx.h_like
        c = shape[0] // M
        dh, sends = [], []
        dctx = {k: [] for k in ctx.keys}
        for m in range(M):
            x, cm, y, a = kept[m]
            if p == S - 1:  # every pipe rank's copy of it: take its own
                g = (g_out[m * c:(m + 1) * c] if g_out is not None
                     else torch.zeros_like(y))
            else:
                g = group.recv(torch.empty_like(y), nxt)
            outs, grads = [y], [g]
            if g_aux is not None and a.requires_grad:
                outs.append(a)
                grads.append((g_aux / M).to(a.dtype).reshape(a.shape))
            torch.autograd.backward(outs, grads)
            gx = x.grad if x.grad is not None else torch.zeros_like(x)
            if p > 0:
                sends.append(group.isend(gx, prev))
            else:
                dh.append(gx)
            for k in ctx.keys:
                dctx[k].append(cm[k].grad if cm[k].grad is not None
                               else torch.zeros_like(cm[k]))
            kept[m] = None  # the microbatch's graph goes
        for s in sends:
            s.wait()
        dh = (torch.cat(dh) if p == 0
              else torch.empty(shape, dtype=dtype, device=device))
        group.broadcast_(dh, first)
        dcontext = []
        for k, need in zip(ctx.keys, ctx.needs):
            dcontext.append(group.sum_(torch.cat(dctx[k])) if need
                            else None)
        ctx.kept = None
        return (None, None, None, None, None, dh, *dcontext)


def gpipe(mesh, stage_fn: StageFn, h: torch.Tensor,
          context: Dict[str, torch.Tensor], num_microbatches: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``stage_fn`` (this rank's stage) through the ring of
    ``mesh.pipe`` on the rank's rows ``h`` [B, ...], in ``num_microbatches``
    microbatches of contiguous rows, each with its rows of every
    ``context`` tensor (read here, never sent). Returns (the last stage's
    output on every pipe rank, the stage's aux over the microbatches / M).
    With grad enabled the backward is the reverse ring (see the module
    doc); the stage's parameters get their gradients in ``.grad``."""
    M = num_microbatches
    keys = tuple(context)
    if torch.is_grad_enabled():
        grip = torch.empty(0, device=h.device, requires_grad=True)
        return _GPipe.apply(mesh, stage_fn, M, keys, grip, h,
                            *(context[k] for k in keys))
    out, aux, _ = _ring_forward(mesh, stage_fn, h, context, M, False)
    return out, aux


def ring_draws(model, ctx, device) -> Tuple[Optional[torch.Tensor],
                                            Optional[List]]:
    """A training forward's draws for both rings, alike on every pipe rank
    (see the module doc): the coins ``[2, L]`` (True: the block runs; None
    when every survival probability is 1) and the dropout seeds ``[2][L][M]``
    (None without dropout)."""
    cfg = model.config
    L = cfg.num_layers
    g = ctx.generator if ctx is not None else None
    M = pp_num_microbatches(cfg.pipeline_microbatches, model.pipe.pp)
    need_coins = min(model.survival_probs) < 1.0
    if (need_coins or cfg.dropout > 0) and g is None:
        raise ValueError("a pipe rank's training forward needs a "
                         "TrainContext with a torch.Generator")
    coins = seeds = None
    if need_coins:
        p = torch.tensor(model.survival_probs, device=device)
        coins = torch.rand((2, L), generator=g, device=g.device).to(
            device) < p
    if cfg.dropout > 0:
        seeds = torch.randint(0, 2 ** 62, (2, L, M), generator=g,
                              device=g.device).tolist()
    return coins, seeds


def run_ring(model, scale: int, h: torch.Tensor, xf: torch.Tensor,
             emb: torch.Tensor, mask: torch.Tensor, ctx, draws
             ) -> torch.Tensor:
    """One scale of the denoiser ``model`` (``scale`` 0 low, 1 high) as a
    GPipe ring of its stage's blocks; in training the stage's aux joins
    ``ctx.stage_aux``."""
    from motiondiffusion_moe_tpu_torch.models.layers import TrainContext

    mesh = model.pipe
    blocks = getattr(model, SCALES[scale])
    held = stage_range(len(blocks), mesh.pp, mesh.p)
    train = model.training
    coins, seeds = draws if draws is not None else (None, None)
    stage = [(i, blocks[i], model.survival_probs[i]) for i in held]

    def stage_fn(x, c, m):
        aux = torch.zeros((), device=x.device)
        for i, block, p in stage:
            lctx = None
            if train:
                gen = (None if seeds is None else torch.Generator(
                    x.device).manual_seed(seeds[scale][i][m]))
                lctx = TrainContext(generator=gen)
            out = block(x, c["xf"], c["emb"], c["mask"], lctx)
            if coins is not None and p < 1.0:
                out = torch.where(coins[scale, i], out, x)
            x = out
            if lctx is not None and lctx.moe_balance:
                aux = aux + torch.stack(lctx.aux_losses).sum().float()
        return x, aux

    M = pp_num_microbatches(model.config.pipeline_microbatches, mesh.pp)
    out, aux = gpipe(mesh, stage_fn, h, {"xf": xf, "emb": emb,
                                         "mask": mask}, M)
    if train and ctx is not None:
        ctx.stage_aux.append(aux)
    return out


# ---------------------------------------------------------------------------
# the stage memory account
# ---------------------------------------------------------------------------

def pp_stage_memory_report(params: Sequence[Tuple[str, torch.Tensor]],
                           num_stages: int, *, train: bool = True,
                           ema: bool = False, batch: int = 0,
                           num_microbatches: int = 0, max_frames: int = 0,
                           latent_dim: int = 0,
                           hbm_bytes: Optional[int] = None) -> dict:
    """JAX's per-stage memory account (``pp_stage_memory_report``
    :258-344) on the port's named parameters (``model.named_parameters()``
    of the whole model, or meta tensors of its shapes): the leaves of
    ``blocks_low.i`` / ``blocks_high.i`` are cut into S stages, everything
    else is held by every pipe rank. The state a rank holds: each
    parameter, its EMA copy with ``ema``, and in training a gradient and
    Adam's two moments for each trainable one (the port's optimizer leaves
    the frozen FAVOR+ projections out). ``hbm_bytes``: the memory of a
    card; by default the current CUDA card's, and it must be given where
    there is none. ``min_stages_to_fit`` is the least S (1, 2, 4, ...)
    whose stage state fits it."""
    if hbm_bytes is None:
        if not torch.cuda.is_available():
            raise ValueError("pp_stage_memory_report: no CUDA card here; "
                             "give hbm_bytes, the memory of the card to "
                             "size for")
        hbm_bytes = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    per_param = (1 + int(ema)) if not train else None
    block_b = other_b = block_s = other_s = 0
    for name, p in params:
        n = p.numel() * p.element_size()
        mult = per_param or (1 + int(ema) + (3 if p.requires_grad else 0))
        if name.partition(".")[0] in SCALES:
            block_b, block_s = block_b + n, block_s + n * mult
        else:
            other_b, other_s = other_b + n, other_s + n * mult

    def stage_bytes(S):
        return block_s // S + other_s

    report = {
        "num_stages": num_stages,
        "param_bytes_total": block_b + other_b,
        "param_bytes_blocks": block_b,
        "param_bytes_replicated": other_b,
        "state_multiplier": (1 + int(ema) + 3) if train else 1 + int(ema),
        "stage_state_bytes": stage_bytes(num_stages),
        "single_device_state_bytes": stage_bytes(1),
        "hbm_bytes": hbm_bytes,
    }
    S = 1
    while stage_bytes(S) > hbm_bytes and S < 4096:
        S *= 2
    report["min_stages_to_fit"] = S
    if batch and num_microbatches and max_frames and latent_dim:
        mb = batch // num_microbatches
        # one microbatch's f32 hidden state a tick; the backward keeps
        # each of the stage's M microbatches' graphs until its turn
        ring = mb * max_frames * latent_dim * 4
        report["ring_bytes_per_tick"] = ring
        report["ring_bytes_backward"] = ring * (num_microbatches
                                                + num_stages - 1)
    return report


def format_pp_memory_report(report: dict) -> str:
    g = 2.0 ** 30
    lines = [
        f"PP-{report['num_stages']} stage memory accounting "
        f"(x{report['state_multiplier']} train-state multiplier):",
        f"  params total        {report['param_bytes_total'] / g:8.2f} GiB"
        f"  (blocks {report['param_bytes_blocks'] / g:.2f}, replicated "
        f"{report['param_bytes_replicated'] / g:.2f})",
        f"  train state / card  {report['single_device_state_bytes'] / g:8.2f}"
        f" GiB unsharded vs {report['stage_state_bytes'] / g:.2f} GiB/stage "
        f"at PP-{report['num_stages']}",
        f"  fits {report['hbm_bytes'] / g:.1f} GiB from S = "
        f"{report['min_stages_to_fit']}",
    ]
    if "ring_bytes_per_tick" in report:
        lines.append(
            f"  ring activation     {report['ring_bytes_per_tick'] / g:8.3f}"
            f" GiB/tick, ~{report['ring_bytes_backward'] / g:.3f} GiB held "
            "for backward")
    return "\n".join(lines)
