"""DeBERTa-v2/v3 text encoder (disentangled attention).

Port of ``motiondiffusion_moe_tpu/models/deberta.py``: the reference's text
backbone, ``microsoft/deberta-v3-large`` with 8 learned prompt tokens
prepended to its hidden states and a LayerNorm -> Dense -> Dropout -> GELU
projection head, trained jointly. Attribute names are the flax submodule
names, so the state_dict keys are the flax paths (``bert.layer_3.attention.
query_proj.weight``) and ``models/bridge.py`` maps them both ways with its
general rules.

What the port copies from the JAX module, quirks included:

- the key mask only, added as ``(1 - mask) * -1e9`` (HF masks the query
  rows too); pad embeddings are zeroed after the embedding LayerNorm, and
  the pooled embedding is the mean over all ``prompt + N`` positions, pads
  included;
- content-content, c2p and p2c scores, each scaled by
  ``1 / sqrt(3 * head_dim)``; the c2p / p2c gathers clamp the index into
  ``[0, 2 * buckets)``; with ``share_att_key`` (v3) the position
  projections reuse the content query / key Dense layers;
- two GELUs: the exact erf form in the FFN, flax's tanh form in the head;
- the backbone's norms take eps 1e-7, the head's flax's 1e-6;
- f32 compute whatever the denoiser's dtype: every weight, bf16-stored ones
  included, is widened before use (the embedding after its gather);
- dropout 0.1 at four backbone sites (``DebertaConfig.dropout``, HF's
  default, whatever ``ModelConfig.dropout`` says: the attention
  probabilities, the attention output, the FFN output, the embeddings) and
  ``ModelConfig.dropout`` in the head, every mask drawn from the
  :class:`TrainContext` generator.

The bucketed relative positions are computed in f32 on the host, once per
sequence length, and moved to the device; the JAX package computes the same
table (``tests/test_torch_deberta.py`` holds them equal, bit for bit).

The JAX module has no Pallas kernel, so neither has the port: it is plain
PyTorch ops (``torch.matmul`` through :class:`Dense`, ``torch.gather``,
``torch.softmax``).

The tokenizer is the local HF SentencePiece tokenizer when ``transformers``
and its files are there (imported inside :func:`get_deberta_tokenizer`,
as the JAX package does), else :func:`hash_tokenize` into
``min(vocab, 8192)`` buckets: the JAX package's own fallback.
"""

from __future__ import annotations

import functools
import math
import os
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motiondiffusion_moe_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    TrainContext,
    dropout,
)
from motiondiffusion_moe_tpu_torch.models.text_encoder import (
    TextEncoding,
    get_tokenizer,
    hash_tokenize,
    make_text_encoder,
)
from motiondiffusion_moe_tpu_torch.ops.activations import gelu


@dataclass(frozen=True)
class DebertaConfig:
    """deberta-v3-large dimensions (HF config defaults)."""

    vocab_size: int = 128100
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    position_buckets: int = 256
    layer_norm_eps: float = 1e-7
    dropout: float = 0.1
    # v3 checkpoints share the content query / key projections with the
    # position embeddings (HF ``share_att_key``); v2 has pos_key_proj /
    # pos_query_proj of its own when False
    share_att_key: bool = True

    @staticmethod
    def large() -> "DebertaConfig":
        return DebertaConfig()

    @staticmethod
    def tiny() -> "DebertaConfig":
        """For tests."""
        return DebertaConfig(vocab_size=256, hidden_size=32,
                             num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=64,
                             max_position_embeddings=64, position_buckets=16)


def deberta_config(text_encoder: str) -> DebertaConfig:
    """The backbone of a ``ModelConfig.text_encoder`` name."""
    return (DebertaConfig.large() if "large" in text_encoder
            else DebertaConfig.tiny())


def make_log_bucket_position(relative_pos: torch.Tensor, bucket_size: int,
                             max_position: int) -> torch.Tensor:
    """HF's log-bucketed relative positions (transformers deberta_v2
    ``make_log_bucket_position``), in f32 as the JAX package computes
    them; integer in, the same integer dtype out."""
    sign = torch.sign(relative_pos)
    mid = bucket_size // 2
    near = (relative_pos < mid) & (relative_pos > -mid)
    abs_pos = torch.where(near, torch.full_like(relative_pos, mid - 1),
                          relative_pos.abs())
    log_pos = (torch.ceil(torch.log(abs_pos / mid)
                          / math.log((max_position - 1) / mid) * (mid - 1))
               + mid)
    return torch.where(near, relative_pos,
                       (log_pos * sign).to(relative_pos.dtype))


def build_relative_position(query_len: int, key_len: int, bucket_size: int,
                            max_position: int) -> torch.Tensor:
    """[1, Q, K] bucketed relative position ids (int64, on the CPU)."""
    rel = (torch.arange(query_len)[:, None]
           - torch.arange(key_len)[None, :])
    return make_log_bucket_position(rel, bucket_size, max_position)[None]


@functools.lru_cache(maxsize=None)
def _gather_indices(T: int, bucket_size: int, max_position: int,
                    device: torch.device):
    """(c2p, p2c) gather indices [T, T] on ``device``: the bucketed
    relative positions shifted by the span and clamped into its
    ``[0, 2 * span)`` rows, for keys and (negated) for queries. Computed
    once per length and device."""
    rel = build_relative_position(T, T, bucket_size, max_position)[0]
    span = bucket_size
    c2p = torch.clamp(rel + span, 0, 2 * span - 1)
    p2c = torch.clamp(-rel + span, 0, 2 * span - 1)
    return c2p.to(device), p2c.to(device)


class DisentangledSelfAttention(nn.Module):
    """Content-content + content-to-position + position-to-content
    attention over the key mask; f32."""

    def __init__(self, cfg: DebertaConfig):
        super().__init__()
        C = cfg.hidden_size
        self.cfg = cfg
        self.query_proj = Dense(C, C)
        self.key_proj = Dense(C, C)
        self.value_proj = Dense(C, C)
        if not cfg.share_att_key:
            self.pos_key_proj = Dense(C, C)
            self.pos_query_proj = Dense(C, C)

    def forward(self, hidden: torch.Tensor, attn_mask: torch.Tensor,
                rel_embeddings: torch.Tensor,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        c = self.cfg
        B, T, C = hidden.shape
        H = c.num_attention_heads
        span = c.position_buckets

        def heads(x):
            return x.view(x.shape[0], -1, H, C // H).transpose(1, 2)

        q = heads(self.query_proj(hidden))       # [B, H, T, d]
        k = heads(self.key_proj(hidden))
        v = heads(self.value_proj(hidden))
        if c.share_att_key:
            pos_key = self.key_proj(rel_embeddings)
            pos_query = self.query_proj(rel_embeddings)
        else:
            pos_key = self.pos_key_proj(rel_embeddings)
            pos_query = self.pos_query_proj(rel_embeddings)
        pos_key = heads(pos_key[None])[0]        # [H, 2 * span, d]
        pos_query = heads(pos_query[None])[0]

        scale = 1.0 / math.sqrt(3 * (C // H))
        c2p_idx, p2c_idx = _gather_indices(T, span, c.max_position_embeddings,
                                           hidden.device)
        scores = torch.matmul(q, k.transpose(-1, -2)) * scale
        c2p = torch.matmul(q, pos_key.transpose(-1, -2)) * scale
        scores = scores + torch.gather(c2p, -1, c2p_idx.expand(B, H, T, T))
        p2c = torch.matmul(k, pos_query.transpose(-1, -2)) * scale
        scores = scores + torch.gather(
            p2c, -1, p2c_idx.expand(B, H, T, T)).transpose(-1, -2)
        scores = scores + (1.0 - attn_mask[:, None, None, :]) * -1e9
        probs = dropout(torch.softmax(scores.float(), -1), c.dropout,
                        self.training, ctx)
        return torch.matmul(probs, v).transpose(1, 2).reshape(B, T, C)


class DebertaLayer(nn.Module):
    """Attention -> Dense -> dropout -> post-LN; FFN (exact GELU) ->
    dropout -> post-LN."""

    def __init__(self, cfg: DebertaConfig):
        super().__init__()
        C, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.attention = DisentangledSelfAttention(cfg)
        self.attention_output = Dense(C, C)
        self.attention_norm = LayerNorm(C, eps=eps)
        self.intermediate = Dense(C, cfg.intermediate_size)
        self.output = Dense(cfg.intermediate_size, C)
        self.output_norm = LayerNorm(C, eps=eps)

    def forward(self, hidden: torch.Tensor, attn_mask: torch.Tensor,
                rel_embeddings: torch.Tensor,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        p = self.cfg.dropout
        attn = self.attention(hidden, attn_mask, rel_embeddings, ctx)
        attn = dropout(self.attention_output(attn), p, self.training, ctx)
        hidden = self.attention_norm(hidden + attn)
        inter = F.gelu(self.intermediate(hidden))
        out = dropout(self.output(inter), p, self.training, ctx)
        return self.output_norm(hidden + out)


class DebertaEncoder(nn.Module):
    """Embeddings + N disentangled-attention layers: ids [B, T] and the
    key mask [B, T] (1 = token) -> hidden states [B, T, hidden] f32."""

    def __init__(self, cfg: DebertaConfig):
        super().__init__()
        C, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, C)
        self.embeddings_norm = LayerNorm(C, eps=eps)
        self.rel_embeddings = nn.Parameter(
            torch.zeros(2 * cfg.position_buckets, C))
        self.rel_embeddings_norm = LayerNorm(C, eps=eps)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", DebertaLayer(cfg))

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        # flax Embed default: variance_scaling(1, fan_in, normal, out_axis=0)
        # over [vocab, C] -> std 1/sqrt(C)
        C = self.cfg.hidden_size
        nn.init.normal_(self.word_embeddings.weight, 0.0, C ** -0.5,
                        generator=g)
        nn.init.normal_(self.rel_embeddings, 0.0, 0.02, generator=g)

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                ctx: Optional[TrainContext] = None) -> torch.Tensor:
        attn_mask = attn_mask.float()
        # gathered in the stored dtype, then widened (exact)
        h = self.embeddings_norm(self.word_embeddings(input_ids.long())
                                 .float())
        # HF order: LayerNorm -> mask multiply -> dropout
        h = dropout(h * attn_mask[..., None], self.cfg.dropout, self.training,
                    ctx)
        rel = self.rel_embeddings_norm(self.rel_embeddings.float())
        for i in range(self.cfg.num_hidden_layers):
            h = getattr(self, f"layer_{i}")(h, attn_mask, rel, ctx)
        return h


class DebertaTextEncoder(nn.Module):
    """The reference's EnhancedTextEncoder head on a DeBERTa backbone:
    ``num_prompt_tokens`` learned tokens prepended to the hidden states,
    LN -> Dense -> Dropout -> GELU (tanh form), pooled = the mean over all
    positions."""

    def __init__(self, output_dim: int, cfg: DebertaConfig,
                 num_prompt_tokens: int = 8, dropout: float = 0.1):
        super().__init__()
        C = cfg.hidden_size
        self.dropout = dropout
        self.bert = DebertaEncoder(cfg)
        self.prompt_tokens = nn.Parameter(torch.zeros(1, num_prompt_tokens, C))
        self.proj_norm = LayerNorm(C)
        self.proj_dense = Dense(C, output_dim)

    @torch.no_grad()
    def _init_own(self, g: torch.Generator) -> None:
        nn.init.normal_(self.prompt_tokens, 0.0, 1.0, generator=g)

    def forward(self, ids: torch.Tensor,
                ctx: Optional[TrainContext] = None) -> TextEncoding:
        B = ids.shape[0]
        hidden = self.bert(ids, ids != 0, ctx)
        hidden = torch.cat([self.prompt_tokens.float().expand(B, -1, -1),
                            hidden], dim=1)
        p = self.proj_dense(self.proj_norm(hidden))
        p = gelu(dropout(p, self.dropout, self.training, ctx))
        return TextEncoding(pooled=p.mean(dim=1), tokens=p)


# ---------------------------------------------------------------------------
# tokenizer and weight conversion
# ---------------------------------------------------------------------------

def get_deberta_tokenizer(max_tokens: int = 77, vocab_size: int = 128100
                          ) -> Callable[[List[str]], np.ndarray]:
    """The HF SentencePiece tokenizer when it is there locally, else the
    hash fallback into the ENCODER's vocab (a small test encoder never sees
    an id out of its range)."""
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained("microsoft/deberta-v3-large",
                                            local_files_only=True)
        if getattr(tok, "vocab_size", 0) > vocab_size:
            # a small-vocab encoder (deberta-tiny) cannot take the real
            # tokenizer's ids
            raise ValueError("tokenizer vocab exceeds encoder vocab")

        def tokenize(texts: List[str]) -> np.ndarray:
            out = tok(texts, padding="max_length", truncation=True,
                      max_length=max_tokens, return_tensors="np")
            return out["input_ids"].astype(np.int32)

        return tokenize
    except Exception:
        return lambda texts: hash_tokenize(texts, max_tokens,
                                           vocab_size=min(vocab_size, 8192))


def get_deberta_encoder(cfg):
    """(tokenizer, module) for ``text_encoder='deberta-v3-large'`` (or
    ``'deberta-tiny'``) of a ``ModelConfig``."""
    return get_tokenizer(cfg), make_text_encoder(cfg)


def hf_deberta_names(cfg: DebertaConfig) -> Dict[str, str]:
    """{key of :class:`DebertaEncoder`'s state_dict: key of an HF
    ``deberta-v2`` state_dict}. Both store Linear weights ``[out, in]``,
    so the conversion is a renaming."""
    names = {"word_embeddings.weight": "embeddings.word_embeddings.weight",
             "rel_embeddings": "encoder.rel_embeddings.weight"}
    for ours, theirs in (("embeddings_norm", "embeddings.LayerNorm"),
                         ("rel_embeddings_norm", "encoder.LayerNorm")):
        for p in ("weight", "bias"):
            names[f"{ours}.{p}"] = f"{theirs}.{p}"
    projs = ["query_proj", "key_proj", "value_proj"]
    if not cfg.share_att_key:
        # v2 layout: dedicated position projections; v3 has no such keys
        projs += ["pos_key_proj", "pos_query_proj"]
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layer.{i}"
        mods = {f"attention.{p}": f"{pre}.attention.self.{p}" for p in projs}
        mods.update({
            "attention_output": f"{pre}.attention.output.dense",
            "attention_norm": f"{pre}.attention.output.LayerNorm",
            "intermediate": f"{pre}.intermediate.dense",
            "output": f"{pre}.output.dense",
            "output_norm": f"{pre}.output.LayerNorm"})
        for ours, theirs in mods.items():
            for p in ("weight", "bias"):
                names[f"layer_{i}.{ours}.{p}"] = f"{theirs}.{p}"
    return names


def convert_hf_deberta_checkpoint(state_dict: Mapping,
                                  cfg: DebertaConfig) -> Dict[str,
                                                              torch.Tensor]:
    """The state_dict of :class:`DebertaEncoder` (the ``bert`` submodule)
    for an HF torch ``deberta-v2`` state_dict (tensors or numpy arrays, in
    the file's dtype). Only the keys the encoder needs are read; a missing
    one raises ``KeyError``."""
    return {ours: torch.as_tensor(state_dict[theirs])
            for ours, theirs in hf_deberta_names(cfg).items()}


# ---------------------------------------------------------------------------
# pretrained-weight grafting (the reference's ``AutoModel.from_pretrained``,
# trained jointly from the pretrained init)
# ---------------------------------------------------------------------------

def load_hf_deberta_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A LOCAL HF DeBERTa torch state_dict: ``path`` is a directory holding
    ``pytorch_model.bin`` (the HF save layout), ``model.bin`` or
    ``model.pt``, or such a file. A leading ``deberta.`` prefix (a
    full-model checkpoint) is stripped to the bare encoder layout."""
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.bin", "model.pt"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no pytorch_model.bin / model.bin / model.pt in {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if any(k.startswith("deberta.") for k in sd):
        sd = {k[len("deberta."):]: v for k, v in sd.items()
              if k.startswith("deberta.")}
    return sd


def graft_pretrained_text_encoder(model: nn.Module, cfg) -> nn.Module:
    """Load the HF checkpoint ``cfg.text_encoder_ckpt`` (a ``ModelConfig``)
    into ``model.text_encoder.bert`` of a ``MotionTransformer``, in place,
    each tensor cast to its parameter's dtype and moved to its device;
    returns ``model``.

    A non-DeBERTa config leaves the model as it is. A DeBERTa config with
    no checkpoint WARNS and keeps the random init (never silently). A
    model without the ``bert`` submodule, a key set that differs or a
    shape that differs raises ``ValueError`` with the first mismatches."""
    if not cfg.text_encoder.startswith("deberta"):
        return model
    if not cfg.text_encoder_ckpt:
        warnings.warn(
            f"text_encoder='{cfg.text_encoder}' with no text_encoder_ckpt: "
            "the DeBERTa backbone is RANDOM-INIT. Pass --deberta_ckpt (a "
            "local HF checkpoint dir) to train from pretrained weights as "
            "the reference does.", stacklevel=2)
        return model
    bert = getattr(getattr(model, "text_encoder", None), "bert", None)
    if not isinstance(bert, DebertaEncoder):
        raise ValueError("the model has no text_encoder.bert submodule — is "
                         "it built with a DeBERTa text encoder?")
    new = convert_hf_deberta_checkpoint(
        load_hf_deberta_state_dict(cfg.text_encoder_ckpt),
        deberta_config(cfg.text_encoder))
    old = bert.state_dict()
    if set(old) != set(new):
        missing, extra = set(old) - set(new), set(new) - set(old)
        raise ValueError(
            f"checkpoint/model tree mismatch: missing {sorted(missing)[:5]} "
            f"extra {sorted(extra)[:5]}")
    for k, p in old.items():
        if tuple(p.shape) != tuple(new[k].shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(p.shape)} vs "
                             f"{tuple(new[k].shape)}")
    # copies into the existing parameters: their dtype and device are kept
    bert.load_state_dict(new, strict=True)
    return model
