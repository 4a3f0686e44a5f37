"""Training orchestration on one device.

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

One device only: a ``ParallelConfig`` that asks for more than one raises
``NotImplementedError`` (the ``parallel/`` port is a later slice). Host
work per step: draw t from the schedule sampler, tokenize the captions
(with the tokenizer of the config's text encoder), copy the batch to the
device from pinned memory.
"""

from __future__ import annotations

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


def check_single_device(cfg: ExperimentConfig) -> None:
    """Raise for a ParallelConfig that needs more than one device."""
    pc = cfg.parallel
    asked = {"num_expert_partitions": pc.num_expert_partitions,
             "num_model_partitions": pc.num_model_partitions,
             "num_seq_partitions": pc.num_seq_partitions,
             "num_pipeline_stages": pc.num_pipeline_stages,
             "num_data_partitions": pc.num_data_partitions}
    multi = {k: v for k, v in asked.items() if v > 1}
    if multi or pc.zero1:
        raise NotImplementedError(
            f"the port trains on one device; {multi or 'zero1'} needs the "
            "parallel/ port")


class Trainer:
    def __init__(self, cfg: ExperimentConfig,
                 model: Optional[MotionTransformer] = None,
                 normalizer_stats=None,
                 logger: Optional[MetricsLogger] = None,
                 device="cuda"):
        check_single_device(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.accum = max(1, cfg.train.grad_accum_steps)
        if cfg.train.batch_size % self.accum != 0:
            raise ValueError(
                f"batch_size {cfg.train.batch_size} not divisible by "
                f"grad_accum_steps {self.accum}")
        self.model = model if model is not None else MotionTransformer(
            cfg.model)
        self.tokenize = get_tokenizer(cfg.model)
        self.sched = make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                                   num_timesteps=cfg.diffusion.num_timesteps,
                                   device=self.device)
        self.sampler = create_named_schedule_sampler(
            cfg.diffusion.schedule_sampler, cfg.diffusion.num_timesteps)
        self.train_step = TrainStep(self.sched, cfg, normalizer_stats)
        self.logger = logger or MetricsLogger(cfg.train.log_every)
        # host RNG: schedule-sampler t draws and caption dropout
        self._np_rng = np.random.default_rng(cfg.train.seed)

    def init_state(self) -> TrainState:
        """Seeded parameters (``init_weights``, the flax initialisers) on
        the device, the optimizer and the EMA. A DeBERTa text encoder gets
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
        self.model.to(self.device)
        return create_train_state(self.model, self.cfg)

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
            self.sampler.update_with_local_losses(
                batch["t"].cpu().numpy(),
                metrics["per_sample_mse"].float().cpu().numpy())

    @staticmethod
    def _scalars(metrics) -> "OrderedDict[str, float]":
        return OrderedDict((k, float(v)) for k, v in metrics.items()
                           if v.dim() == 0)

    def fit(self, state: TrainState, loader: Iterable,
            generator: Optional[torch.Generator] = None,
            checkpoints: Optional[CheckpointManager] = None,
            start_epoch: int = 0) -> TrainState:
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(
                cfg.train.seed + 1)
        if checkpoints is not None:
            restored = checkpoints.restore_with_rng(state)
            if restored is not None:
                state, start_epoch, rng_state = restored
                if rng_state is not None:
                    generator.set_state(rng_state)
                elif checkpoints.format == "orbax":
                    seed = resume_seed(cfg.train.seed, state.step)
                    generator.manual_seed(seed)
                    print(f"[trainer] step {state.step} holds no torch "
                          "generator state (a JAX run's key cannot become "
                          f"one): generator seeded with {seed} = "
                          f"resume_seed(seed={cfg.train.seed}, "
                          f"step={state.step})")
                print(f"[trainer] resumed from step {state.step} "
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
                self.logger.log(state.step, epoch, logs, start_time)
                if (checkpoints is not None
                        and state.step // every > prev // every):
                    checkpoints.save(state.step, state, epoch, generator)
            if checkpoints is not None:
                # the end-of-epoch save records epoch + 1 so that a resume
                # starts the next epoch; when the cadence save already took
                # this step, the sidecar marker carries the epoch + 1
                if checkpoints.latest_step() == state.step:
                    checkpoints.mark_epoch_complete(state.step, epoch + 1)
                else:
                    checkpoints.save(state.step, state, epoch + 1, generator)
        return state
