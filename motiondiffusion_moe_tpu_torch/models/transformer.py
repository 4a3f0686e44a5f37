"""The MoE motion-diffusion denoiser: a 2-scale U-Net transformer.

Port of ``motiondiffusion_moe_tpu/models/transformer.py`` (``MoEDecoderLayer``
and ``MotionTransformer``, named layout) for sampling: no dropout and no
stochastic depth (both are training-only), and none of the JAX-only
machinery (``scan_blocks``, remat policies, the GPipe runner, sequence-
parallel constraints). Block ``i`` of a scale is ``blocks_low[i]`` /
``blocks_high[i]`` (flax ``block_low_i`` / ``block_high_i``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu.config import ModelConfig
from motiondiffusion_moe_tpu_torch.models.attention import (
    CrossAttentionBlock,
    DualSelfAttentionBlock,
    GatedCrossAttention,
    PerformerSelfAttention,
)
from motiondiffusion_moe_tpu_torch.models.embeddings import (
    GatedFusion,
    TimestepEmbedding,
)
from motiondiffusion_moe_tpu_torch.models.layers import Dense, lecun_normal_
from motiondiffusion_moe_tpu_torch.models.moe import DenseFFN, MoEMultiBranchFFN
from motiondiffusion_moe_tpu_torch.models.text_encoder import (
    HashTextEncoder,
    TextEncoding,
)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def generate_src_mask(T: int, length: torch.Tensor) -> torch.Tensor:
    """[B, T] float mask, 1 where frame index < length."""
    return (torch.arange(T, device=length.device)[None, :]
            < length[:, None]).float()


class MoEDecoderLayer(nn.Module):
    """One decoder block: dual Performer self-attn -> gated linear cross-attn
    -> MoE (or dense) multi-branch FFN -> exact cross-attn."""

    def __init__(self, cfg: ModelConfig, time_embed_dim: int,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        D, tl, H = cfg.latent_dim, cfg.text_latent_dim, cfg.num_heads
        self.dual_self_attn = DualSelfAttentionBlock(
            D, H, time_embed_dim, cfg.num_random_features, use_kernels, dtype)
        self.cross_attn = GatedCrossAttention(D, tl, H, time_embed_dim, dtype)
        if cfg.use_moe:
            self.ffn = MoEMultiBranchFFN(
                D, cfg.ff_size, cfg.num_experts, cfg.moe_num_branches,
                cfg.moe_top_k, time_embed_dim, dtype)
        else:
            self.ffn = DenseFFN(D, cfg.ff_size, cfg.moe_num_branches,
                                time_embed_dim, dtype)
        self.sd_cross_attn = CrossAttentionBlock(D, tl, H, dtype)

    def forward(self, x: torch.Tensor, xf: torch.Tensor, emb: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.dual_self_attn(x, emb, src_mask)
        x = self.cross_attn(x, xf, emb)
        x = self.ffn(x, emb)
        return self.sd_cross_attn(x, xf)


class MotionTransformer(nn.Module):
    """2-scale U-Net denoiser. ``forward`` takes the JAX layouts: x
    [B, T, F] f32, timesteps [B] int, length [B] int, and either text ids
    [B, N] or the precomputed (xf_proj [B, C], xf_out [B, N, C]); returns
    [B, T, F] f32."""

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True):
        super().__init__()
        if cfg.text_encoder != "hash":
            raise NotImplementedError(
                f"text encoder {cfg.text_encoder!r}: only the hash encoder "
                "is ported so far")
        if cfg.moe_compute != "dense_fused":
            raise NotImplementedError(
                f"moe_compute={cfg.moe_compute!r}: only 'dense_fused' is "
                "ported so far")
        self.config = cfg
        D = cfg.latent_dim
        ted = D * cfg.time_embed_mult
        dtype = compute_dtype(cfg)
        self.dtype = dtype
        self.sequence_embedding = nn.Parameter(torch.zeros(cfg.max_frames, D))
        self.learnable_time_embed = TimestepEmbedding(D, dtype)
        self.gated_fusion = GatedFusion(D, dtype)
        self.text_encoder = HashTextEncoder(cfg.text_latent_dim,
                                            cfg.text_max_tokens,
                                            num_prompt_tokens=
                                            cfg.text_num_prompt_tokens)
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

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        nn.init.normal_(self.sequence_embedding, 0.0, 1.0, generator=g)
        D = self.config.latent_dim
        for conv in (self.downsample, self.upsample):
            # flax lecun_normal over the (k=2, in, out) kernel: fan_in = 2*in
            lecun_normal_(conv.weight, 2 * D, g)
            conv.bias.zero_()

    def set_use_kernels(self, flag: bool) -> None:
        """Route every Performer through the CUDA kernels (True) or their
        plain PyTorch versions (False); parameters are unchanged."""
        for m in self.modules():
            if isinstance(m, PerformerSelfAttention):
                m.use_kernels = flag

    def encode_text(self, text_ids: torch.Tensor) -> TextEncoding:
        return self.text_encoder(text_ids)

    def _conv(self, conv: nn.Module, h: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> conv over T (channels-last in, channels-last out)."""
        dt = self.dtype
        y = h.transpose(1, 2)
        if isinstance(conv, nn.Conv1d):
            if y.shape[-1] % 2:  # 'SAME' pads the odd tail on the right
                y = F.pad(y, (0, 1))
            y = F.conv1d(y, conv.weight.to(dt), conv.bias.to(dt), stride=2)
        else:
            y = F.conv_transpose1d(y, conv.weight.to(dt), conv.bias.to(dt),
                                   stride=2)
        return y.transpose(1, 2)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                length: torch.Tensor, text_ids: Optional[torch.Tensor] = None,
                xf_proj: Optional[torch.Tensor] = None,
                xf_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        B, T, _ = x.shape
        if xf_proj is None or xf_out is None:
            xf_proj, xf_out = self.encode_text(text_ids)
        xf_proj = self.text_proj(xf_proj.to(dt))
        xf_out = xf_out.to(dt)

        time_emb = self.learnable_time_embed(timesteps)
        t_h = self.time_embed_1(F.silu(self.time_embed_0(time_emb)))
        fused_emb = self.gated_fusion(self.time_proj(t_h), xf_proj)

        h = self.joint_embed(x.to(dt)) + self.sequence_embedding[None, :T].to(dt)
        src_mask = generate_src_mask(T, length)

        h_low = self._conv(self.downsample, h)
        mask_low = generate_src_mask(h_low.shape[1], length // 2)
        for block in self.blocks_low:
            h_low = block(h_low, xf_out, fused_emb, mask_low)

        h = self._conv(self.upsample, h_low)[:, :T] + h
        for block in self.blocks_high:
            h = block(h, xf_out, fused_emb, src_mask)
        return self.out(h).float()
