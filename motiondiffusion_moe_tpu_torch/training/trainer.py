"""Training orchestration on one device or over data, expert and model
ranks.

Port of ``motiondiffusion_moe_tpu/training/trainer.py``: the epoch loop, the
(cond, uncond) double step per batch (``ddpm_trainer.py:319-333``), caption
dropout, schedule-sampler updates (loss-aware samplers see every step's
per-sample losses), periodic logging, the rolling save cadence and the
end-of-epoch save with its ``epoch_meta.json`` marker, and auto-resume,
from a run dir of either package (``training/checkpoint.py``; a JAX step
carries no ``torch.Generator`` state, so the generator is then seeded with
``resume_seed(seed, step)``).
Steps run one by one whatever ``steps_per_call`` says (see
``train_state.py``), so the JAX trainer's rule for loss-aware samplers
(``trainer.py:326-337``: never draw t from weights a buffered step has not
updated yet) holds by construction.

Data, seq, pipe, expert and model parallelism (``parallel/``): where a
process group is initialised (``parallel.initialize_distributed``), each
process is one rank of the ``(data, seq, pipe, expert, model)`` mesh
(``parallel.make_mesh``, JAX ``_maybe_make_mesh``, ``trainer.py:127-169``):
``num_seq_partitions`` (sp) x ``num_pipeline_stages`` (pp) x
``num_expert_partitions`` (ep) x ``num_model_partitions`` (tp) must divide
the world size and ep the experts, ``num_data_partitions`` must be 0 (the
world size over sp x pp x ep x tp) or that, the row-holders (dp x ep: the
tp ranks of a model group, the sp ranks of a seq group and the pp ranks of
a pipe group hold the same rows) must divide each microbatch, and every seq
rank needs 2 frames of ``max_motion_length``; in one process, sp, pp, ep
or tp > 1 is a mismatch and raises. The pipe axis takes JAX's rules
besides (data alone beside it, no ``dispatch``, ``num_layers`` % pp and
each microbatch in ``pipeline_microbatches`` microbatches divisible by the
data ranks; ``dense_fused`` runs as it is). A seq rank trains on its
frames of its row-holder's rows, a pipe rank holds its stage's blocks and
runs them in the GPipe ring (``train_state.py``,
``parallel/pipeline_parallel.py``). The loader gives row-holder q = d ep + e rows
``[q B / (dp ep), (q + 1) B / (dp ep))`` of each batch, JAX's token chunk
q; the losses, gradients and metrics are the global batch's
(``train_state.py``); ``zero1`` shards the Adam moments and the EMA. The
model keeps the rank's ``E / ep`` experts and its ``1 / tp`` of each
Megatron-split FFN leaf (cut after the whole seeded init, so the weights
are the one-process run's); attention, norms, embeddings and the gate run
whole on every model rank, as in JAX. Under an expert or a model axis
``dense_fused`` becomes ``dense``, as in JAX (``trainer.py:71-91``; a
caller's ``dense_fused`` model raises). ``dispatch`` over data ranks alone
takes the global batch's capacity. Row-holder q's host RNG (t draws,
caption dropout) is ``default_rng(seed + 1_000_003 * q)``, the JAX process
q's. Its ``torch.Generator`` (noise, dropout) is seeded ``seed + 1 +
1_000_003 * q``: the port's own choice, since JAX draws the global batch's
noise from one key. The ranks of a model group, of a seq group and of a
pipe group thus draw the same noise and masks, and their replicated
activations stay the same (a dropout on a column-split hidden or on the
rank's frames draws the whole mask and keeps the rank's block of it; the
pipe ranks draw the rings' coins and seeds alike), and their samplers see
the same per-sample losses. Only the primary prints and logs; saves are
collective and write the global layout (every stage's blocks under their
one-process names) with one generator state a row-holder, from its ranks
with s = p = m = 0 (``training/checkpoint.py``), so a run resumes at any
other layout.

Host work per step: draw t from the schedule sampler, tokenize the
captions (with the tokenizer of the config's text encoder), copy the batch
to the device from pinned memory.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
from motiondiffusion_moe_tpu_torch.diffusion.gaussian import make_schedule
from motiondiffusion_moe_tpu_torch.diffusion.samplers import (
    LossAwareSampler,
    create_named_schedule_sampler,
)
from motiondiffusion_moe_tpu_torch.models.layers import init_weights
from motiondiffusion_moe_tpu_torch.models.text_encoder import get_tokenizer
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.parallel.distributed import primary_says
from motiondiffusion_moe_tpu_torch.parallel.mesh import (
    attach_mesh,
    make_mesh,
    shard_params,
)
from motiondiffusion_moe_tpu_torch.training.checkpoint import (
    CheckpointManager,
    resume_seed,
)
from motiondiffusion_moe_tpu_torch.training.train_state import (
    TrainState,
    TrainStep,
    create_train_state,
)
from motiondiffusion_moe_tpu_torch.utils.logging import MetricsLogger



class Trainer:
    def __init__(self, cfg: ExperimentConfig,
                 model: Optional[MotionTransformer] = None,
                 normalizer_stats=None,
                 logger: Optional[MetricsLogger] = None,
                 device="cuda"):
        self.dp = make_mesh(cfg)
        self.world = self.dp.world if self.dp is not None else 1
        self.rank = self.dp.rank if self.dp is not None else 0
        # the row-holder: the ranks of a model group share rows and draws
        self.q = self.dp.q if self.dp is not None else 0
        self.holders = self.dp.holders if self.dp is not None else 1
        self.primary = self.rank == 0
        self.device = torch.device(device)
        self.accum = max(1, cfg.train.grad_accum_steps)
        if cfg.train.batch_size % self.accum != 0:
            raise ValueError(
                f"batch_size {cfg.train.batch_size} not divisible by "
                f"grad_accum_steps {self.accum}")
        ep = cfg.parallel.num_expert_partitions
        tp = cfg.parallel.num_model_partitions
        if max(ep, tp) > 1 and cfg.model.moe_compute == "dense_fused":
            # the fused matmul merges the experts and the hidden widths:
            # cut by neither
            if model is not None:
                raise ValueError(
                    "caller-supplied model uses moe_compute='dense_fused' "
                    f"with {ep} expert x {tp} model partitions: the fused "
                    "matmul cannot be expert- or tensor-sharded. Build the "
                    "model with moe_compute='dense' (or 'dispatch') for "
                    "EP/TP runs.")
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, moe_compute="dense"))
        self.cfg = cfg
        self.model = model if model is not None else MotionTransformer(
            cfg.model)
        attach_mesh(self.model, self.dp)
        self.tokenize = get_tokenizer(cfg.model)
        self.sched = make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                                   num_timesteps=cfg.diffusion.num_timesteps,
                                   device=self.device)
        self.sampler = create_named_schedule_sampler(
            cfg.diffusion.schedule_sampler, cfg.diffusion.num_timesteps)
        self.train_step = TrainStep(self.sched, cfg, normalizer_stats,
                                    dp=self.dp)
        self.logger = logger or MetricsLogger(cfg.train.log_every)
        # host RNG: schedule-sampler t draws and caption dropout, JAX
        # process q's stream on row-holder q
        self._np_rng = np.random.default_rng(
            cfg.train.seed + 1_000_003 * self.q)

    def init_state(self) -> TrainState:
        """Seeded parameters (``init_weights``, the flax initialisers) on
        the device (over an expert or a model axis the rank's blocks), the
        optimizer and the EMA. A DeBERTa text encoder gets
        the checkpoint ``text_encoder_ckpt`` grafted in (or a warning and
        its random init), as the reference trains from
        ``AutoModel.from_pretrained``. The graft comes before the EMA is
        copied, so the EMA starts from the grafted weights too (the JAX
        trainer grafts after and refreshes its EMA: the same state)."""
        init_weights(self.model, self.cfg.train.seed)
        if self.cfg.model.text_encoder.startswith("deberta"):
            from motiondiffusion_moe_tpu_torch.models.deberta import (
                graft_pretrained_text_encoder)
            graft_pretrained_text_encoder(self.model, self.cfg.model)
        shard_params(self.model)  # the rank's blocks of the whole init
        self.model.to(self.device)
        return create_train_state(self.model, self.cfg, dp=self.dp)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _make_batch(self, captions, motions, lengths
                    ) -> Dict[str, torch.Tensor]:
        B = motions.shape[0]
        t, w = self.sampler.sample(B, self._np_rng)
        if self.cfg.train.caption_dropout > 0:
            drop = self._np_rng.random(B) < self.cfg.train.caption_dropout
            captions = ["" if d else c for c, d in zip(captions, drop)]
        return {"motion": self._to_device(motions),
                "length": self._to_device(np.asarray(lengths, np.int64)),
                "text_ids": self._to_device(self.tokenize(list(captions))),
                "t": self._to_device(t.astype(np.int64)),
                "t_weight": self._to_device(w)}

    def _update_sampler(self, batch, metrics) -> None:
        if isinstance(self.sampler, LossAwareSampler):
            ts = batch["t"].cpu().numpy()
            losses = metrics["per_sample_mse"].float().cpu().numpy()
            if self.dp is not None and (self.dp.s or self.dp.m
                                        or self.dp.p):
                # a row-holder's pairs count once, from its rank with s = m
                # = p = 0: the samplers gather the row-holders' in q order
                ts, losses = ts[:0], losses[:0]
            self.sampler.update_with_local_losses(ts, losses)

    @staticmethod
    def _scalars(metrics) -> "OrderedDict[str, float]":
        return OrderedDict((k, float(v)) for k, v in metrics.items()
                           if v.dim() == 0)

    def fit(self, state: TrainState, loader: Iterable,
            generator: Optional[torch.Generator] = None,
            checkpoints: Optional[CheckpointManager] = None,
            start_epoch: int = 0) -> TrainState:
        cfg = self.cfg
        say = print if self.primary else (lambda *a, **k: None)
        offset = 1_000_003 * self.q
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(
                cfg.train.seed + 1 + offset)
        if checkpoints is not None:
            restored = checkpoints.restore_with_rng(state)
            if restored is not None:
                state, start_epoch, rng_state = restored
                saved = (rng_state if isinstance(rng_state, list) else
                         [] if rng_state is None else [rng_state])
                if len(saved) == self.holders:
                    generator.set_state(saved[self.q])
                elif saved or checkpoints.format == "orbax":
                    seed = resume_seed(cfg.train.seed, state.step)
                    generator.manual_seed((seed + offset) % 2 ** 64)
                    why = (f"it holds {len(saved)} ranks' generator "
                           f"states, this run has {self.holders}" if saved
                           else "it holds no torch generator state (a JAX "
                           "run's key cannot become one)")
                    say(f"[trainer] step {state.step}: {why}; generator "
                        f"seeded with {seed} = resume_seed(seed="
                        f"{cfg.train.seed}, step={state.step}), plus "
                        "1_000_003 x row-holder")
                say(f"[trainer] resumed from step {state.step} "
                    f"(epoch {start_epoch})")

        start_time = time.time()
        every = cfg.train.save_latest_every
        for epoch in range(start_epoch, cfg.train.num_epochs):
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
            for captions, motions, lengths in loader:
                batch = self._make_batch(captions, motions, lengths)
                prev = state.step
                metrics = self.train_step(state, batch, generator)
                self._update_sampler(batch, metrics)
                logs = self._scalars(metrics)
                if cfg.train.uncond_step:
                    # second, unconditional forward + update: empty captions
                    uncond = self._make_batch([""] * len(captions), motions,
                                              lengths)
                    umetrics = self.train_step(state, uncond, generator)
                    self._update_sampler(uncond, umetrics)
                    logs.update((f"uncond_{k}", v) for k, v in
                                self._scalars(umetrics).items())
                if self.primary:
                    self.logger.log(state.step, epoch, logs, start_time)
                if (checkpoints is not None
                        and state.step // every > prev // every):
                    checkpoints.save(state.step, state, epoch, generator)
            if checkpoints is not None:
                # the end-of-epoch save records epoch + 1 so that a resume
                # starts the next epoch; when the cadence save already took
                # this step, the sidecar marker carries the epoch + 1
                if primary_says(checkpoints.latest_step() == state.step):
                    checkpoints.mark_epoch_complete(state.step, epoch + 1)
                else:
                    checkpoints.save(state.step, state, epoch + 1, generator)
        return state
