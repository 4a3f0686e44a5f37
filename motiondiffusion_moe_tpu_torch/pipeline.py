"""Text-to-motion generation pipeline (the inference API).

Port of ``motiondiffusion_moe_tpu/pipeline.py`` (``GenerationPipeline``
without a mesh):

- text is encoded ONCE per prompt set; the unconditional (empty-string)
  embeddings once per micro-batch shape;
- every denoising step runs ONE forward of the CFG-doubled batch
  (conditional rows over unconditional rows);
- prompts are padded to a fixed micro-batch;
- the pipeline samples with its own copy of the model it is given, as the
  JAX pipeline casts a copy of its params (``_place_params``): the caller's
  module keeps its parameters' dtype, values and device;
- ``param_dtype="bfloat16"`` stores the copy's weights in bf16 except every
  FAVOR+ ``projection`` (which defines the attention kernel's feature map),
  as the JAX pipeline does;
- the tokenizer is the one the config's text encoder names
  (``get_tokenizer``), and ``graft_pretrained_text=True`` loads the
  DeBERTa checkpoint ``cfg.model.text_encoder_ckpt`` into the copy: for
  sampling from fresh weights with a pretrained backbone, never for a
  trained run's (its text encoder is already finetuned);
- the copy moves to ``device`` once, at construction (the JAX pipeline
  without a mesh re-uploads host params on every call); ``device`` is the
  card unless the caller asks for the CPU (``device="cpu"``);
- :meth:`GenerationPipeline.from_export` builds a pipeline from a serving
  artifact of either package (``tools/export.py``), and
  :meth:`GenerationPipeline.set_params` loads a flax ``params`` tree or a
  state_dict into the pipeline's copy, each leaf stored as the JAX pipeline
  holds it (a bf16 leaf of the file stays bf16, bit for bit);
- :meth:`GenerationPipeline.generate` samples micro-batch i + 1 while
  micro-batch i goes to the host (``fetch_window``, as the JAX pipeline
  bounds its dispatch-ahead): the copy goes through a pinned buffer behind
  a CUDA event, with at most ``fetch_window`` results waiting on the card;
  :meth:`GenerationPipeline.generate_motion_embeddings` samples the same
  way and fetches only the evaluator's co-embedding of each motion (with
  the length check and the wrapper-wide empty result the JAX version
  lacks).

Randomness comes from ``torch.Generator``s on ``device``; the micro-batch
sampler :meth:`GenerationPipeline.sample` also takes injected ``noise`` (and
per-step ``step_noise`` for DDPM) so a test can hand the JAX package and the
port the same draws.

Under a mesh (``mesh=``, a ``parallel.mesh.ExpertMesh`` in the generation
layout from ``parallel.mesh.generation_mesh``: one process per device, the
JAX pipeline's ``mesh``, ``pipeline.py:66-78, 143-173, 228-242``):

- ``micro_batch`` must divide by the data axis; under an expert or a model
  axis a ``dense_fused`` model computes ``dense`` (JAX's trainer makes the
  same swap; its pipeline lets XLA gather the experts: the same function);
- each rank keeps its cut of every parameter (``ExpertMesh.local_leaf``:
  its experts, its FFN columns), from a global state or one already cut;
- every rank runs every micro-batch and every forward (lockstep) and calls
  :meth:`GenerationPipeline.generate` with the same prompts and a generator
  in the same state: every rank draws the whole micro-batch's noise, so a
  motion does not depend on the layout. Data rank d runs the denoiser on
  rows ``[d 2B / dp, (d + 1) 2B / dp)`` of the CFG-doubled batch (its
  conditional rows over its unconditional ones, JAX's chunks of ``P('data')``
  and, for ``dispatch``, of ``P((data, expert))``), and an all-gather over
  the data group gives every rank the whole output for the guidance
  combine and the sampler step;
- with a seq axis (``generation_mesh(..., seq_parallel=sp)``, JAX's
  ``(data, seq, expert, model)`` mesh) seq rank s runs the denoiser on its
  frames ``ExpertMesh.frames(T)`` of those rows (cut points on even
  frames, as evenly as they go), and an all-gather over the seq group on T
  (the cuts may be uneven) comes before the one over the data group;
  ``micro_batch`` asks nothing of ``sp``, the frames at least 2 a rank;
- with a pipe axis (``generation_mesh(dp, pipeline_parallel=pp)``, JAX's
  ``(data, pipe)`` mesh, rank ``d * pp + p``) each rank holds its stage's
  blocks alone and the denoiser runs each scale as the GPipe ring of
  ``parallel/pipeline_parallel.py`` on the data rank's rows, every pipe
  rank getting the last stage's output; JAX's layout check on the
  CFG-doubled micro-batch runs at construction (``num_layers`` % pp, and
  ``2 micro_batch`` in ``pipeline_microbatches`` microbatches divisible by
  the data ranks);
- :class:`MeshLeader` lets rank 0 drive the others (the serve and evaluate
  CLIs): each ``generate`` goes to them as a job
  (``parallel/distributed.py::JobLeader``), and they run
  :meth:`GenerationPipeline.follow_jobs` until the stop.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import deque
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
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
from motiondiffusion_moe_tpu_torch.models.text_encoder import get_tokenizer
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer


def serving_dtype(name: str, dtype: torch.dtype,
                  param_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The dtype a parameter named ``name`` of ``dtype`` is stored in for
    serving: ``param_dtype`` for a float32 one, except the FAVOR+
    random-feature projections, which stay float32; any other as it is."""
    if param_dtype is None or "projection" in name or dtype != torch.float32:
        return dtype
    return param_dtype


def cast_params_(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Store every float32 parameter in ``dtype``, except the FAVOR+
    random-feature projections, which stay float32."""
    for name, p in model.named_parameters():
        p.data = p.data.to(serving_dtype(name, p.dtype, dtype))


class GenerationPipeline:
    """Text -> motion sampler around a :class:`MotionTransformer`: one that
    already holds its weights (seeded :func:`init_weights`, or a flax tree
    through :func:`bridge.jax_to_state_dict`), or ``params`` (a flax tree or
    a state_dict, loaded by :meth:`set_params`) for the given ``model`` or,
    without one, for a model built from ``cfg``. ``self.model`` is the
    pipeline's own copy (cast and moved); the caller's module is left as it
    was."""

    def __init__(self, cfg: ExperimentConfig,
                 model: Optional[MotionTransformer] = None, params=None, *,
                 sampler: str = "ddpm", num_inference_steps: Optional[int] = None,
                 eta: float = 0.0, micro_batch: int = 8,
                 param_dtype: Optional[str] = None, fetch_window: int = 2,
                 graft_pretrained_text: bool = False, device="cuda",
                 mesh=None):
        if param_dtype not in (None, "bfloat16"):
            raise ValueError(f"param_dtype {param_dtype!r}: None or "
                             "'bfloat16'")
        if model is None and params is None:
            raise ValueError("give a model that holds its weights, or params")
        self.mesh = mesh
        if mesh is not None:
            if micro_batch % mesh.dp:
                raise ValueError(
                    f"micro_batch {micro_batch} not divisible by the mesh "
                    f"data axis ({mesh.dp})")
            if mesh.sp > 1:
                mesh.frames(cfg.model.max_frames)  # raises if too few
            if mesh.pp > 1:
                from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel \
                    import validate_pp_layout
                # the ring cuts each data rank's rows of the CFG-doubled
                # batch into its microbatches (JAX pipeline.py:63-79)
                validate_pp_layout(
                    mesh.pp, mesh.dp, cfg.model.num_layers, 2 * micro_batch,
                    cfg.model.pipeline_microbatches,
                    batch_desc="CFG-doubled micro_batch",
                    fix_hint="; adjust micro_batch or pipeline_microbatches")
            if mesh.ep * mesh.tp > 1 and cfg.model.moe_compute == \
                    "dense_fused":
                # the fused matmul merges the experts: not shardable
                cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                    cfg.model, moe_compute="dense"))
        self.cfg = cfg
        self.device = torch.device(device)
        self.param_dtype = (torch.bfloat16 if param_dtype == "bfloat16"
                            else None)
        self.fetch_window = max(1, fetch_window)
        if model is None:
            with torch.device("meta"):  # set_params gives every parameter
                model = MotionTransformer(cfg.model)
        else:
            if mesh is not None and params is None:
                params = model.state_dict()  # cut by set_params below
            model = copy.deepcopy(model)
        if mesh is not None:
            self._shard_model(model)
        if params is None:
            if self.param_dtype is not None:
                cast_params_(model, self.param_dtype)
            self.model = model.to(self.device).eval()
        else:
            self.model = model.eval()
            self.set_params(params)
        if graft_pretrained_text:
            from motiondiffusion_moe_tpu_torch.models.deberta import (
                graft_pretrained_text_encoder)
            graft_pretrained_text_encoder(self.model, cfg.model)
        self._tokenize = get_tokenizer(cfg.model)
        self.micro_batch = micro_batch
        self.guidance_scale = cfg.diffusion.cfg_scale
        self.mean_type = ModelMeanType(cfg.diffusion.model_mean_type)
        self.var_type = ModelVarType(cfg.diffusion.model_var_type)
        self.clip_denoised = cfg.diffusion.clip_denoised
        self.normalizer = None
        self._set_sampler(sampler, num_inference_steps, eta)

    def _shard_model(self, model: MotionTransformer) -> None:
        """Give the model the mesh (``parallel.mesh.attach_mesh``) and
        parameters of the rank's shapes, on the meta device until
        :meth:`set_params` fills them; the global shapes stay in
        ``self._global_shapes``."""
        from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer
        from motiondiffusion_moe_tpu_torch.parallel.mesh import attach_mesh

        for m in model.modules():
            if isinstance(m, SwitchMoELayer):
                m.compute = self.cfg.model.moe_compute
        attach_mesh(model, self.mesh)
        if self.mesh.pp > 1:  # the rank's stage's blocks alone
            from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel \
                import keep_stage
            keep_stage(model, self.mesh)
        self._global_shapes = {}
        for name, p in list(model.named_parameters()):
            self._global_shapes[name] = tuple(p.shape)
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner)
            module._parameters[leaf] = torch.nn.Parameter(
                torch.empty(self.mesh.local_shape(name, p.shape),
                            dtype=p.dtype, device="meta"),
                requires_grad=p.requires_grad)

    def _set_sampler(self, sampler: str, num_inference_steps: Optional[int],
                     eta: float) -> None:
        """The sampler, its step count and its (respaced) schedule."""
        if sampler not in ("ddpm", "ddim", "dpm"):
            raise ValueError(f"unknown sampler {sampler!r}")
        cfg = self.cfg
        self.sampler = sampler
        self.eta = eta
        self.num_inference_steps = num_inference_steps
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

    def with_sampler(self, sampler: str,
                     num_inference_steps: Optional[int] = None,
                     eta: float = 0.0) -> "GenerationPipeline":
        """A pipeline with another sampler (and step count) that shares this
        one's model, weights and device: nothing is copied or placed
        again."""
        other = copy.copy(self)
        other._set_sampler(sampler, num_inference_steps, eta)
        return other

    @classmethod
    def from_export(cls, export_dir: str, **kwargs) -> "GenerationPipeline":
        """A pipeline from a serving artifact written by either package's
        ``tools/export.py``: config, weights and, as ``pipeline.normalizer``,
        the normalizer. Extra kwargs go to the constructor (sampler,
        micro_batch, param_dtype, device, ...)."""
        from motiondiffusion_moe_tpu_torch.tools.export import load_export

        cfg, params, normalizer = load_export(export_dir,
                                              mesh=kwargs.get("mesh"))
        pipe = cls(cfg, params=params, **kwargs)
        pipe.normalizer = normalizer
        return pipe

    def set_params(self, params) -> None:
        """Load weights into the pipeline's own model: a flax ``params``
        tree or variables dict (numpy leaves, ``torch.bfloat16`` tensors for
        bf16 ones, as ``tools/export.py::load_export`` reads them), or a
        state_dict of this model. Each parameter is stored as the
        constructor stores it (:func:`serving_dtype`): a bf16 source stays
        bf16 with its bits, an f32 one becomes ``param_dtype`` except the
        FAVOR+ projections."""
        from motiondiffusion_moe_tpu_torch.models.bridge import (
            jax_to_state_dict)

        if any(isinstance(v, Mapping) for v in params.values()):
            params = jax_to_state_dict(params)
        if self.mesh is not None and self.mesh.pp > 1:  # its stage's blocks
            params = {n: x for n, x in params.items()
                      if n in self._global_shapes}
        placed = {name: self._local(name, x).to(self.device, serving_dtype(
            name, x.dtype, self.param_dtype), copy=True).contiguous()
            for name, x in params.items()}
        # assign: the model's parameters become these copies, dtype and all
        # (strict: every parameter covered, every shape checked)
        self.model.load_state_dict(placed, strict=True, assign=True)

    def _local(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The rank's cut of parameter ``name`` given whole, or ``x`` as it
        is when it has the rank's shape already (or there is no mesh)."""
        if self.mesh is None or name not in self._global_shapes:
            return x
        want = list(self.mesh.local_shape(name, self._global_shapes[name]))
        if tuple(x.shape) == self._global_shapes[name]:
            x = self.mesh.local_leaf(name, x)
        if list(x.shape) != want:
            raise ValueError(f"{name}: shape {list(x.shape)}, neither the "
                             f"global {list(self._global_shapes[name])} nor "
                             f"this rank's {want}")
        return x

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        return self._tokenize(list(texts))

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
        mesh = self.mesh
        B = ids_c.shape[0]
        T, F = self.cfg.model.max_frames, self.cfg.model.input_feats
        # the rows of the doubled batch this rank runs: all, or its data
        # index's (see the module doc)
        rows = mesh.rows(2 * B) if mesh is not None else slice(0, 2 * B)
        encs = []
        if rows.start < B:
            encs.append(model.encode_text(
                ids_c[rows.start:min(rows.stop, B)].to(dev)))
        if rows.stop > B:
            encs.append(model.encode_text(
                ids_u[max(rows.start - B, 0):rows.stop - B].to(dev)))
        xf_proj = torch.cat([e.pooled for e in encs])
        xf_out = torch.cat([e.tokens for e in encs])
        length2 = torch.cat([lengths, lengths]).to(dev)[rows]
        # a seq rank's frames of T, and every seq rank's count of them
        frames, cols = None, slice(None)
        if mesh is not None and mesh.sp > 1:
            frames, cols = mesh.frames(T), slice(*mesh.frames(T))
            sizes = [b - a for a, b in (mesh.frames(T, s)
                                        for s in range(mesh.sp))]

        def model_doubled(x2, t2):
            out = model(x2[rows, cols], t2[rows], length2, xf_proj=xf_proj,
                        xf_out=xf_out, frames=frames)
            if frames:
                out = mesh.gather_frames(out, sizes)
            if mesh is not None and mesh.dp > 1:
                out = mesh.data.all_gather(out)
            return out

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

    def _check_lengths(self, captions: Sequence[str],
                       m_lens: Sequence[int]) -> None:
        if len(captions) != len(m_lens):
            raise ValueError(
                f"{len(captions)} captions but {len(m_lens)} lengths")
        T = self.cfg.model.max_frames
        bad = [(i, l) for i, l in enumerate(m_lens) if not 1 <= l <= T]
        if bad:
            i, l = bad[0]
            raise ValueError(f"m_lens[{i}]={l} outside [1, max_frames={T}] "
                             f"({len(bad)} offending length(s))")

    def _micro_batches(self, captions: Sequence[str], m_lens: Sequence[int],
                       generator: Optional[torch.Generator], reduce):
        """Sample the prompts micro-batch by micro-batch (the tail padded
        with empty prompts at ``max_frames``); ``reduce(motions [mb, T, F]
        on the device, lens)`` gives the tensor that goes to the host.
        Yields (host array, lens, n real rows) in order; micro-batch i + 1
        is sampled while micro-batch i is copied, through a pinned buffer
        behind a CUDA event, with at most ``fetch_window`` waiting."""
        self._check_lengths(captions, m_lens)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        T = self.cfg.model.max_frames
        mb = self.micro_batch
        ids_u = torch.as_tensor(self.tokenize([""] * mb))
        pending: deque = deque()  # (host tensor, copy event, lengths, n)

        def drain():
            host, done, lens, n = pending.popleft()
            if done is not None:
                done.synchronize()
            return host.numpy(), lens, n

        for start in range(0, len(captions), mb):
            chunk = list(captions[start:start + mb])
            lens = list(m_lens[start:start + mb])
            n = len(chunk)
            # pad the tail chunk to the fixed micro-batch
            chunk += [""] * (mb - n)
            lens += [T] * (mb - n)
            out = reduce(self.sample(
                torch.as_tensor(self.tokenize(chunk)), ids_u,
                torch.as_tensor(lens, dtype=torch.long),
                generator=generator), lens)
            done = None
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = out
            pending.append((host, done, lens, n))
            if len(pending) > self.fetch_window:
                yield drain()
        while pending:
            yield drain()

    def generate(self, captions: Sequence[str], m_lens: Sequence[int],
                 generator: Optional[torch.Generator] = None
                 ) -> List[np.ndarray]:
        """One motion per caption: a list of [len_i, F] float32 arrays in
        the model's (normalized) feature space. ``generator`` (on the
        pipeline's device) defaults to one seeded with 0. Micro-batch i + 1
        is sampled while micro-batch i is copied to the host; the results
        are those of one micro-batch at a time, bit for bit."""
        outputs: List[np.ndarray] = []
        for motions, lens, n in self._micro_batches(
                captions, m_lens, generator, lambda m, lens: m):
            outputs.extend(motions[i, :int(lens[i])] for i in range(n))
        return outputs

    def generate_motion_embeddings(self, captions: Sequence[str],
                                   m_lens: Sequence[int], wrapper,
                                   generator: Optional[torch.Generator] = None
                                   ) -> np.ndarray:
        """Sample each micro-batch and embed it with the evaluator's motion
        encoder on the device; returns [N, E] co-embedding rows. Only the
        rows go to the host (~2 KB a motion instead of ~206 KB of
        features), behind the same ``fetch_window`` as :meth:`generate`.

        ``wrapper`` is an ``eval.EvaluatorModelWrapper`` on the pipeline's
        device. Frames at or past each length are zeroed before the
        embedding, as the host protocol pads them. The generator is
        consumed micro-batch for micro-batch as :meth:`generate` consumes
        it, so the same generator state embeds the motions ``generate``
        returns. Lengths are checked as :meth:`generate` checks them, and
        an empty prompt list gives [0, E] with E the wrapper's width."""
        if wrapper.device.type != self.device.type:
            raise ValueError(f"the evaluator is on {wrapper.device}, the "
                             f"pipeline on {self.device}: embed where the "
                             "motions are sampled")
        T = self.cfg.model.max_frames

        @torch.inference_mode()
        def embed(motions, lens):
            lt = torch.as_tensor(lens, device=motions.device)
            keep = (torch.arange(T, device=motions.device)[None, :, None]
                    < lt[:, None, None])
            return wrapper.motion_embeddings(
                torch.where(keep, motions, 0.0), lens)

        rows = [embs[:n] for embs, _, n in self._micro_batches(
            captions, m_lens, generator, embed)]
        return (np.concatenate(rows, axis=0) if rows
                else np.zeros((0, wrapper.embed_dim), np.float32))

    def follow_jobs(self) -> int:
        """The ranks other than 0 under a :class:`MeshLeader`: run each
        ``generate`` that rank 0 sends, with the prompts, lengths and
        generator state it sends, until the stop; returns the number run
        (``parallel/distributed.py::follow_jobs``)."""
        from motiondiffusion_moe_tpu_torch.parallel.distributed import (
            follow_jobs)

        def handle(job):
            generator = torch.Generator(self.device)
            generator.set_state(job["state"])
            self.generate(job["captions"], job["m_lens"], generator)

        return follow_jobs(handle)


class MeshLeader:
    """Rank 0's handle on a pipeline under a mesh, for a front end that
    runs on rank 0 alone (``tools/serve.py``, ``tools/evaluate.py``):
    :meth:`generate` sends the call (prompts, lengths, the generator's
    state) to the other ranks, which run it in
    :meth:`GenerationPipeline.follow_jobs`, and runs rank 0's part; the
    lengths are checked before anything is sent. Every other attribute is
    the pipeline's. :meth:`stop` releases the other ranks."""

    def __init__(self, pipe: GenerationPipeline):
        from motiondiffusion_moe_tpu_torch.parallel.distributed import (
            JobLeader)

        self.pipe = pipe
        self.leader = JobLeader()

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def generate(self, captions: Sequence[str], m_lens: Sequence[int],
                 generator: Optional[torch.Generator] = None
                 ) -> List[np.ndarray]:
        self.pipe._check_lengths(captions, m_lens)
        if generator is None:
            generator = torch.Generator(self.pipe.device).manual_seed(0)
        job = {"captions": list(captions),
               "m_lens": [int(n) for n in m_lens],
               "state": generator.get_state()}
        return self.leader.run(job, lambda: self.pipe.generate(
            captions, m_lens, generator))

    def stop(self) -> None:
        self.leader.stop()
