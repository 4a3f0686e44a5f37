"""The MoE motion-diffusion denoiser: a 2-scale U-Net transformer.

Port of ``motiondiffusion_moe_tpu/models/transformer.py`` (``MoEDecoderLayer``
and ``MotionTransformer``, named layout), without the JAX-only machinery
(``scan_blocks``, remat policies, sequence-parallel constraints). Block
``i`` of a scale is ``blocks_low[i]`` / ``blocks_high[i]`` (flax
``block_low_i`` / ``block_high_i``).

On a rank of a pipe mesh (``pipe``, set by ``parallel/mesh.py::
attach_mesh``) each scale's blocks run as the GPipe ring of
``parallel/pipeline_parallel.py`` (JAX's ``_run_blocks_pp``,
``transformer.py:337-376``): the rank holds only its stage's blocks, the
rest of the forward runs alike on every pipe rank, and a training forward
draws the rings' coins and dropout seeds before the first
(``pipeline_parallel.ring_draws``) and leaves each ring's aux in
``ctx.stage_aux``.

Training: ``model.train()`` is the JAX ``deterministic=False``. A training
forward takes a :class:`TrainContext` whose generator drives every dropout
mask and the per-block stochastic-depth coin (survival probabilities
``linspace(1, stochastic_depth_min, L)``, ``transformer.py:316-317,
392-406``), and collects the MoE aux losses: ``forward(..., ctx=ctx)``
leaves each MoE layer's balance statistics in ``ctx.moe_balance``, whose
terms ``ctx.aux_losses`` :func:`sum_moe_aux_losses` adds up.

On a rank of a seq mesh (``seq``, set by ``parallel/mesh.py::attach_mesh``)
``forward`` takes x cut to the rank's frames ``[t0, t1)`` of T
(``frames``, ``ExpertMesh.frames``: t0 even) and the global lengths, and
returns those frames: the sequence embedding and both source masks are
taken at the rank's offsets, the down-sampling's 'SAME' pad of an odd T
falls on the last rank's odd share alone, and the up-sampling's crop is to
the rank's own frames (JAX's seq axis, ``transformer.py:326-335``, with the
Performers' kv closed over the ranks, ``models/attention.py``). Nothing
gathers T here; ``dispatch`` gathers it for its chunks (``models/moe.py``).
A training forward takes ``frames=(t0, t1, T)``: ``ctx.frames`` then holds
each scale's frames (``[t0 / 2, ceil(t1 / 2))`` of ``ceil(T / 2)`` at the
low one), from which a dropout on the rank's frames draws the whole T's
mask and keeps its own (``models/layers.py::dropout``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu_torch.config import ModelConfig
from motiondiffusion_moe_tpu_torch.models.attention import (
    CrossAttentionBlock,
    DualSelfAttentionBlock,
    FastAttention,
    GatedCrossAttention,
    PerformerSelfAttention,
)
from motiondiffusion_moe_tpu_torch.models.embeddings import (
    GatedFusion,
    TimestepEmbedding,
    stochastic_depth,
)
from motiondiffusion_moe_tpu_torch.models.layers import (
    Dense,
    TrainContext,
    lecun_normal_,
    round_keeping_f32,
)
from motiondiffusion_moe_tpu_torch.models.moe import DenseFFN, MoEMultiBranchFFN
from motiondiffusion_moe_tpu_torch.models.text_encoder import (
    TextEncoding,
    make_text_encoder,
)
from motiondiffusion_moe_tpu_torch.parallel import pipeline_parallel


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def sum_moe_aux_losses(ctx: TrainContext) -> torch.Tensor:
    """Sum of the MoE aux losses a training forward collected (the
    counterpart of ``sum_moe_aux_losses``, ``transformer.py:498-506``);
    0 when it collected none."""
    losses = ctx.aux_losses
    if not losses:
        return torch.zeros(())
    return torch.stack(losses).sum()


def generate_src_mask(T: int, length: torch.Tensor,
                      start: int = 0) -> torch.Tensor:
    """[B, T] float mask of frames ``start .. start + T - 1``, 1 where the
    frame index < length."""
    return (torch.arange(start, start + T, device=length.device)[None, :]
            < length[:, None]).float()


class MoEDecoderLayer(nn.Module):
    """One decoder block: dual Performer self-attn -> gated linear cross-attn
    -> MoE (or dense) multi-branch FFN -> exact cross-attn."""

    def __init__(self, cfg: ModelConfig, time_embed_dim: int,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        D, tl, H = cfg.latent_dim, cfg.text_latent_dim, cfg.num_heads
        p = cfg.dropout
        self.dual_self_attn = DualSelfAttentionBlock(
            D, H, time_embed_dim, cfg.num_random_features, use_kernels, dtype,
            p)
        self.cross_attn = GatedCrossAttention(D, tl, H, time_embed_dim, dtype,
                                              p)
        if cfg.use_moe:
            self.ffn = MoEMultiBranchFFN(
                D, cfg.ff_size, cfg.num_experts, cfg.moe_num_branches,
                cfg.moe_top_k, time_embed_dim, dtype, p, cfg.moe_compute,
                cfg.moe_capacity_factor)
        else:
            self.ffn = DenseFFN(D, cfg.ff_size, cfg.moe_num_branches,
                                time_embed_dim, dtype, p)
        # the fast-layout kernel goes on and off with the Performer kernels,
        # as in JAX (transformer.py:71)
        self.sd_cross_attn = CrossAttentionBlock(
            D, tl, H, dtype, p, cfg.use_fast_xattn and use_kernels)

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        x = self.dual_self_attn(x, emb, src_mask, ctx)
        x = self.cross_attn(x, xf, emb, ctx)
        x = self.ffn(x, emb, ctx)
        return self.sd_cross_attn(x, xf, ctx)


class MotionTransformer(nn.Module):
    """2-scale U-Net denoiser. ``forward`` takes the JAX layouts: x
    [B, T, F] f32, timesteps [B] int, length [B] int, and either text ids
    [B, N] or the precomputed (xf_proj [B, C], xf_out [B, N, C]); returns
    [B, T, F] f32."""

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True):
        super().__init__()
        self.config = cfg
        D = cfg.latent_dim
        ted = D * cfg.time_embed_mult
        dtype = compute_dtype(cfg)
        self.dtype = dtype
        self.sequence_embedding = nn.Parameter(torch.zeros(cfg.max_frames, D))
        self.learnable_time_embed = TimestepEmbedding(D, dtype)
        self.gated_fusion = GatedFusion(D, dtype)
        self.text_encoder = make_text_encoder(cfg)
        self.time_embed_0 = Dense(D, ted, dtype)
        self.time_embed_1 = Dense(ted, ted, dtype)
        self.time_proj = Dense(ted, D, dtype)
        self.text_proj = Dense(cfg.text_latent_dim, D, dtype)
        self.joint_embed = Dense(cfg.input_feats, D, dtype)
        # flax nn.Conv / nn.ConvTranspose (k=2, s=2, 'SAME'); the bridge
        # reorders (and, for the transpose, flips) the flax kernels
        self.downsample = nn.Conv1d(D, D, 2, stride=2)
        self.upsample = nn.ConvTranspose1d(D, D, 2, stride=2)
        self.blocks_low = nn.ModuleList(
            MoEDecoderLayer(cfg, ted, use_kernels, dtype)
            for _ in range(cfg.num_layers))
        self.blocks_high = nn.ModuleList(
            MoEDecoderLayer(cfg, ted, use_kernels, dtype)
            for _ in range(cfg.num_layers))
        self.out = Dense(D, cfg.input_feats, dtype, init="zeros")
        self.survival_probs = [float(p) for p in np.linspace(
            1.0, cfg.stochastic_depth_min, cfg.num_layers)]
        self.seq = None  # the seq ranks' group under a seq mesh
        self.pipe = None  # the run's mesh under a pipe axis

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        nn.init.normal_(self.sequence_embedding, 0.0, 1.0, generator=g)
        D = self.config.latent_dim
        for conv in (self.downsample, self.upsample):
            # flax lecun_normal over the (k=2, in, out) kernel: fan_in = 2*in
            lecun_normal_(conv.weight, 2 * D, g)
            conv.bias.zero_()

    def set_use_kernels(self, flag: bool) -> None:
        """Route every Performer (``use_kernels``, and the FAVOR+ core of
        an unfused one, ``use_pallas``), and with ``use_fast_xattn`` every
        exact cross-attention, through the CUDA kernels (True) or their
        plain PyTorch forms (False); parameters are unchanged. The MoE
        kernel follows ``MOE_FUSED_KERNEL`` alone, as in JAX, and a
        ``StylizationBlock`` its ``fused`` attribute alone."""
        for m in self.modules():
            if isinstance(m, PerformerSelfAttention):
                m.use_kernels = flag
            elif isinstance(m, FastAttention):
                m.use_pallas = flag
            elif isinstance(m, CrossAttentionBlock):
                m.use_fast_xattn = flag and self.config.use_fast_xattn

    def encode_text(self, text_ids: torch.Tensor,
                    ctx: Optional[TrainContext] = None) -> TextEncoding:
        return self.text_encoder(text_ids, ctx)

    def _conv(self, conv: nn.Module, h: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> conv over T (channels-last in, channels-last out).
        In bf16, as flax does, the convolution is rounded before its bias
        is added."""
        dt = self.dtype
        y = h.transpose(1, 2)
        fused_bias = conv.bias.to(dt) if dt == torch.float32 else None
        if isinstance(conv, nn.Conv1d):
            if y.shape[-1] % 2:  # 'SAME' pads the odd tail on the right
                y = F.pad(y, (0, 1))
            y = F.conv1d(y, conv.weight.to(dt), fused_bias, stride=2)
        else:
            y = F.conv_transpose1d(y, conv.weight.to(dt), fused_bias,
                                   stride=2)
        y = y.transpose(1, 2)
        if fused_bias is not None:
            return y
        # the first block's LayerNorm reads the bias add unrounded
        return round_keeping_f32(y.float() + conv.bias.to(dt), dt)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                length: torch.Tensor, text_ids: Optional[torch.Tensor] = None,
                xf_proj: Optional[torch.Tensor] = None,
                xf_out: Optional[torch.Tensor] = None,
                ctx: Optional[TrainContext] = None,
                frames: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """In training mode ``ctx`` supplies the generator of every random
        draw and collects the MoE aux losses; on a rank of a seq mesh x
        holds the global ``frames`` ``[t0, t1)`` (``(t0, t1, T)`` in
        training; see the module doc)."""
        dt = self.dtype
        B, T, _ = x.shape
        t0 = self._frame_offset(T, frames)
        if xf_proj is None or xf_out is None:
            xf_proj, xf_out = self.encode_text(text_ids, ctx)
        xf_proj = self.text_proj(xf_proj.to(dt))
        xf_out = xf_out.to(dt)

        time_emb = self.learnable_time_embed(timesteps)
        t_h = self.time_embed_1(self.time_embed_0(time_emb, "silu"))
        fused_emb = self.gated_fusion(self.time_proj(t_h), xf_proj)

        h = (self.joint_embed(x.to(dt))
             + self.sequence_embedding[None, t0:t0 + T].to(dt))
        src_mask = generate_src_mask(T, length, t0)

        h_low = self._conv(self.downsample, h)
        mask_low = generate_src_mask(h_low.shape[1], length // 2, t0 // 2)
        whole = self._scale_frames(ctx, frames)
        if whole is not None:  # the low scale's frames of ceil(T / 2)
            ctx.frames = (t0 // 2, t0 // 2 + h_low.shape[1], -(-whole // 2))
        draws = None
        if self.pipe is not None and self.training:  # before the rings
            draws = pipeline_parallel.ring_draws(self, ctx, h.device)
        h_low = self._run_blocks(self.blocks_low, h_low, xf_out, fused_emb,
                                 mask_low, ctx, draws)
        up = self._conv(self.upsample, h_low)[:, :T]
        h = round_keeping_f32(up.float() + h, dt)
        if whole is not None:
            ctx.frames = (t0, t0 + T, whole)
        h = self._run_blocks(self.blocks_high, h, xf_out, fused_emb, src_mask,
                             ctx, draws)
        if whole is not None:
            ctx.frames = None
        return self.out(h).float()

    def _scale_frames(self, ctx: Optional[TrainContext],
                      frames) -> Optional[int]:
        """The whole T of a seq rank's training forward (None otherwise):
        its dropout masks are the whole T's, so it needs ``frames=(t0, t1,
        T)``."""
        if frames is None or ctx is None or not self.training:
            return None
        if len(frames) != 3:
            raise ValueError(
                f"frames={tuple(frames)}: a seq rank's training forward "
                "takes frames=(t0, t1, T), T the whole sequence's frames")
        return frames[2]

    def _frame_offset(self, T: int, frames) -> int:
        """t0 of the frames x holds (0 without a seq mesh); raises unless
        ``frames`` comes with a seq mesh and fits x."""
        if (frames is None) != (self.seq is None):
            raise ValueError(
                "a seq rank's forward takes frames=(t0, t1), the frames x "
                "holds (ExpertMesh.frames); without a seq mesh, none"
                if frames is None else
                f"frames={frames}, but the model has no seq mesh")
        if frames is None:
            return 0
        t0, t1 = frames[:2]
        if t0 % 2 or t1 - t0 != T or (len(frames) == 3 and t1 > frames[2]):
            raise ValueError(f"frames {frames} for x of {T} frames: t0 must "
                             "be even and t1 - t0 the frames of x")
        return t0

    def _run_blocks(self, blocks, h, xf, emb, mask, ctx, draws=None):
        if self.pipe is not None:  # the scale's GPipe ring
            return pipeline_parallel.run_ring(
                self, int(blocks is self.blocks_high), h, xf, emb, mask, ctx,
                draws)
        for block, p in zip(blocks, self.survival_probs):
            h = stochastic_depth(
                lambda x, block=block: block(x, xf, emb, mask, ctx), h, p,
                self.training, ctx)
        return h
