"""Hash text encoder.

Port of ``motiondiffusion_moe_tpu/models/text_encoder.py``:
:func:`hash_tokenize` is a copy (importing the JAX module would pull in
flax), :class:`HashTextEncoder` mirrors the flax module, including three
quirks: the attention mask covers keys only, the sentence embedding is the
mean over all ``prompt + N`` positions (pads included), and every GELU is the
tanh form. The encoder always runs in f32, as in the JAX package.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
from torch import nn

from motiondiffusion_moe_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    gelu,
)


class TextEncoding(NamedTuple):
    """(pooled sentence embedding [B, C], per-token embeddings [B, N, C])."""

    pooled: torch.Tensor
    tokens: torch.Tensor


def hash_tokenize(texts: List[str], max_tokens: int = 77,
                  vocab_size: int = 8192) -> np.ndarray:
    """Deterministic host-side tokenizer: lowercase whitespace split,
    FNV-1a hash into [2, vocab) buckets. 0 = pad, 1 = BOS. Empty strings
    (the CFG unconditional branch) produce BOS-only rows."""
    ids = np.zeros((len(texts), max_tokens), dtype=np.int32)
    for b, text in enumerate(texts):
        ids[b, 0] = 1
        for i, word in enumerate(text.lower().split()[: max_tokens - 1]):
            h = np.uint64(14695981039346656037)
            for ch in word.encode("utf-8"):
                h = np.uint64((int(h) ^ ch) * 1099511628211 % (1 << 64))
            ids[b, i + 1] = 2 + int(h) % (vocab_size - 2)
    return ids


class MultiHeadDotProductAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` self-attention with a
    key mask. The flax ``DenseGeneral`` kernels ([D, H, dh] and
    [H, dh, D]) are stored flattened as torch Linear weights; flax draws
    them with fan_in D and H*dh, which is the Dense default here."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(dim, dim)
        self.key = Dense(dim, dim)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        q = self.query(x).view(B, N, H, -1)
        k = self.key(x).view(B, N, H, -1)
        v = self.value(x).view(B, N, H, -1)
        q = q / (q.shape[-1] ** 0.5)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = logits.masked_fill(~key_mask[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, N, D))


class HashTextEncoder(nn.Module):
    """Hash-embedding text encoder: embed + positions -> 2 pre-LN
    transformer layers -> 8 learned prompt tokens prepended -> LN -> Dense
    -> GELU; pooled = mean over all positions."""

    def __init__(self, output_dim: int, max_tokens: int,
                 hidden_size: int = 256, vocab_size: int = 8192,
                 num_prompt_tokens: int = 8, num_layers: int = 2,
                 num_heads: int = 4):
        super().__init__()
        C = hidden_size
        self.num_layers = num_layers
        self.embed = nn.Embedding(vocab_size, C)
        self.pos_embed = nn.Parameter(torch.zeros(max_tokens, C))
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", LayerNorm(C))
            self.add_module(f"attn_{i}",
                            MultiHeadDotProductAttention(C, num_heads))
            self.add_module(f"ln2_{i}", LayerNorm(C))
            self.add_module(f"mlp_{i}_0", Dense(C, 4 * C))
            self.add_module(f"mlp_{i}_1", Dense(4 * C, C))
        self.prompt_tokens = nn.Parameter(torch.zeros(1, num_prompt_tokens, C))
        self.proj_norm = LayerNorm(C)
        self.proj_dense = Dense(C, output_dim)

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        # flax Embed default: variance_scaling(1, fan_in, normal, out_axis=0)
        # over [vocab, C] -> std 1/sqrt(C)
        C = self.embed.weight.shape[1]
        nn.init.normal_(self.embed.weight, 0.0, C ** -0.5, generator=g)
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=g)
        nn.init.normal_(self.prompt_tokens, 0.0, 1.0, generator=g)

    def forward(self, ids: torch.Tensor) -> TextEncoding:
        B, N = ids.shape
        ids = ids.long()
        h = self.embed(ids) + self.pos_embed[None, :N]
        key_mask = ids != 0
        for i in range(self.num_layers):
            h = h + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(h),
                                               key_mask)
            f = getattr(self, f"mlp_{i}_0")(getattr(self, f"ln2_{i}")(h))
            h = h + getattr(self, f"mlp_{i}_1")(gelu(f))
        h = torch.cat([self.prompt_tokens.expand(B, -1, -1), h], dim=1)
        p = gelu(self.proj_dense(self.proj_norm(h)))
        return TextEncoding(pooled=p.mean(dim=1), tokens=p)
