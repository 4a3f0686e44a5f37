"""Text-to-motion generation pipeline (the inference API).

Port of ``motiondiffusion_moe_tpu/pipeline.py`` (``GenerationPipeline``
without a mesh):

- text is encoded ONCE per prompt set; the unconditional (empty-string)
  embeddings once per micro-batch shape;
- every denoising step runs ONE forward of the CFG-doubled batch
  (conditional rows over unconditional rows);
- prompts are padded to a fixed micro-batch;
- ``param_dtype="bfloat16"`` stores the weights in bf16 except every FAVOR+
  ``projection`` (which defines the attention kernel's feature map), as the
  JAX pipeline does;
- the weights move to ``device`` once, at construction (the JAX pipeline
  without a mesh re-uploads host params on every call).

Randomness comes from ``torch.Generator``s on ``device``; the micro-batch
sampler :meth:`GenerationPipeline.sample` also takes injected ``noise`` (and
per-step ``step_noise`` for DDPM) so a test can hand the JAX package and the
port the same draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from motiondiffusion_moe_tpu.config import ExperimentConfig
from motiondiffusion_moe_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m
from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
    ModelMeanType,
    ModelVarType,
    make_schedule,
)
from motiondiffusion_moe_tpu_torch.diffusion.respace import (
    respace_schedule,
    space_timesteps,
)
from motiondiffusion_moe_tpu_torch.diffusion.sampling import (
    ddim_sample_loop,
    ddpm_sample_loop_cfg,
)
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer


def cast_params_(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Store every float32 parameter in ``dtype``, except the FAVOR+
    random-feature projections, which stay float32."""
    for name, p in model.named_parameters():
        if "projection" not in name and p.dtype == torch.float32:
            p.data = p.data.to(dtype)


class GenerationPipeline:
    """Text -> motion sampler around a :class:`MotionTransformer` that
    already holds its weights (seeded :func:`init_weights`, or a flax tree
    through :func:`bridge.jax_to_state_dict`)."""

    def __init__(self, cfg: ExperimentConfig, model: MotionTransformer, *,
                 sampler: str = "ddpm", num_inference_steps: Optional[int] = None,
                 eta: float = 0.0, micro_batch: int = 8,
                 param_dtype: Optional[str] = None, device="cpu"):
        if sampler not in ("ddpm", "ddim", "dpm"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if param_dtype not in (None, "bfloat16"):
            raise ValueError(f"param_dtype {param_dtype!r}: None or "
                             "'bfloat16'")
        self.cfg = cfg
        self.device = torch.device(device)
        if param_dtype == "bfloat16":
            cast_params_(model, torch.bfloat16)
        self.model = model.to(self.device).eval()
        self.micro_batch = micro_batch
        self.sampler = sampler
        self.eta = eta
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = cfg.diffusion.cfg_scale
        self.mean_type = ModelMeanType(cfg.diffusion.model_mean_type)
        self.var_type = ModelVarType(cfg.diffusion.model_var_type)
        self.clip_denoised = cfg.diffusion.clip_denoised
        self.normalizer = None

        T_diff = cfg.diffusion.num_timesteps
        base = make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                             num_timesteps=T_diff, device=self.device)
        self.timestep_map = None
        if sampler != "dpm" and num_inference_steps and \
                num_inference_steps < T_diff:
            self.sched, tmap = respace_schedule(
                base.betas.double().cpu().numpy(),
                space_timesteps(T_diff, f"ddim{num_inference_steps}"),
                device=self.device)
            self.timestep_map = torch.as_tensor(tmap, dtype=torch.long,
                                                device=self.device)
        else:
            # DPM-Solver++ picks its own timesteps on the full schedule
            self.sched = base

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        return hash_tokenize(list(texts), self.cfg.model.text_max_tokens)

    @property
    def forwards_per_sample(self) -> int:
        """Denoiser forwards (each on the CFG-doubled batch) per
        :meth:`sample` call."""
        if self.sampler == "dpm":
            return (self.num_inference_steps or 10) + 1
        return self.sched.num_timesteps

    @torch.inference_mode()
    def sample(self, ids_c: torch.Tensor, ids_u: torch.Tensor,
               lengths: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        """One micro-batch: token ids [B, N] (conditional and
        unconditional), lengths [B] -> motions [B, T, F] float32 on the
        device. ``noise`` (the initial x_T) and ``step_noise`` (DDPM's
        per-step draws) replace draws from ``generator``."""
        dev = self.device
        model = self.model
        B = ids_c.shape[0]
        T, F = self.cfg.model.max_frames, self.cfg.model.input_feats
        enc_c = model.encode_text(ids_c.to(dev))
        enc_u = model.encode_text(ids_u.to(dev))
        xf_proj = torch.cat([enc_c.pooled, enc_u.pooled])
        xf_out = torch.cat([enc_c.tokens, enc_u.tokens])
        length2 = torch.cat([lengths, lengths]).to(dev)

        def model_doubled(x2, t2):
            return model(x2, t2, length2, xf_proj=xf_proj, xf_out=xf_out)

        if noise is None:
            noise = torch.randn((B, T, F), generator=generator, device=dev)
        noise = noise.to(dev, torch.float32)
        kw = dict(guidance_scale=self.guidance_scale,
                  mean_type=self.mean_type, var_type=self.var_type,
                  clip_denoised=self.clip_denoised)
        if self.sampler == "dpm":
            return dpm_solver_pp_2m(self.sched, model_doubled, noise,
                                    num_steps=self.num_inference_steps or 10,
                                    **kw)
        if self.sampler == "ddim":
            return ddim_sample_loop(self.sched, model_doubled, noise,
                                    generator=generator, eta=self.eta,
                                    timestep_map=self.timestep_map, **kw)
        return ddpm_sample_loop_cfg(self.sched, model_doubled, noise,
                                    generator=generator,
                                    step_noise=step_noise,
                                    timestep_map=self.timestep_map, **kw)

    def generate(self, captions: Sequence[str], m_lens: Sequence[int],
                 generator: Optional[torch.Generator] = None
                 ) -> List[np.ndarray]:
        """One motion per caption: a list of [len_i, F] float32 arrays in
        the model's (normalized) feature space. ``generator`` (on the
        pipeline's device) defaults to one seeded with 0."""
        if len(captions) != len(m_lens):
            raise ValueError(
                f"{len(captions)} captions but {len(m_lens)} lengths")
        T = self.cfg.model.max_frames
        bad = [(i, l) for i, l in enumerate(m_lens) if not 1 <= l <= T]
        if bad:
            i, l = bad[0]
            raise ValueError(f"m_lens[{i}]={l} outside [1, max_frames={T}] "
                             f"({len(bad)} offending length(s))")
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        mb = self.micro_batch
        ids_u = torch.as_tensor(self.tokenize([""] * mb))
        outputs: List[np.ndarray] = []
        for start in range(0, len(captions), mb):
            chunk = list(captions[start:start + mb])
            lens = list(m_lens[start:start + mb])
            n = len(chunk)
            # pad the tail chunk to the fixed micro-batch
            chunk += [""] * (mb - n)
            lens += [T] * (mb - n)
            motions = self.sample(
                torch.as_tensor(self.tokenize(chunk)), ids_u,
                torch.as_tensor(lens, dtype=torch.long), generator=generator)
            motions = motions.cpu().numpy()
            outputs.extend(motions[i, :int(lens[i])] for i in range(n))
        return outputs
