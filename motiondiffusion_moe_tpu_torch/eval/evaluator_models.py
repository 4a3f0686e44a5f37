"""The contrastive evaluator networks (the FID / R-precision backbone).

Port of ``motiondiffusion_moe_tpu/eval/evaluator_models.py`` (the Guo et
al. text-to-motion protocol) as ``nn.Module``s: the Conv1d movement encoder
(two stride-2 convolutions, T / 4), the bidirectional-GRU text and motion
encoders into a 512-d co-embedding space, the BiGRU motion-length
estimator, and the decoders and attention layer of the same family.

- :class:`MaskedBiGRU` is a ``torch.nn.GRU`` run over
  ``pack_padded_sequence`` with ``enforce_sorted=False``: rows keep their
  input order (the JAX wrapper never sorts, unlike the reference), ``seq``
  is zero at ``t >= length`` (``pad_packed_sequence(total_length=T)``) and
  ``last`` is the forward state at ``length - 1`` beside the backward state
  after frame 0. Every length must lie in [1, T].
- Module and parameter names follow the reference's torch modules, so a
  released ``finest.tar`` loads straight into them
  (:func:`convert_torch_evaluator_checkpoint`);
  ``models/evaluator_bridge.py`` carries the JAX package's flax params
  across.
- LayerNorm epsilon: 1e-5 in the co-encoders and the length estimator (as
  the JAX modules set it), flax's default 1e-6 in :class:`TextVAEDecoder`
  and :class:`TextDecoder`.
- Randomness (:func:`reparameterize`, the wrapper's random init) comes from
  an explicit ``torch.Generator`` or a seed; ``eps`` may be injected.

:class:`EvaluatorModelWrapper` holds the frozen movement, text and motion
encoders on ``device`` (the card unless the caller asks for the CPU) and
returns numpy co-embeddings in input order; :meth:`motion_embeddings`
keeps them on the device for the fused sample-and-embed path
(``GenerationPipeline.generate_motion_embeddings``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


def _lengths_cpu(lengths, T: int) -> torch.Tensor:
    """Lengths as the CPU int64 tensor ``pack_padded_sequence`` wants; each
    must lie in [1, T]."""
    lengths = torch.as_tensor(np.asarray(
        lengths.cpu() if isinstance(lengths, torch.Tensor) else lengths),
        dtype=torch.int64)
    if lengths.numel() and not (lengths.min() >= 1 and lengths.max() <= T):
        raise ValueError(f"lengths {lengths.tolist()} outside [1, {T}]")
    return lengths


class MaskedBiGRU(nn.GRU):
    """Bidirectional GRU over a padded [B, T, D] batch with per-row
    lengths -> (seq [B, T, 2H], zero at t >= length; last [B, 2H])."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=True)

    def forward(self, x: torch.Tensor, lengths,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        T = x.shape[1]
        packed = pack_padded_sequence(x, _lengths_cpu(lengths, T),
                                      batch_first=True, enforce_sorted=False)
        # with enforce_sorted=False the GRU takes h0 and returns h_n in the
        # input's row order (it permutes them with the packing's indices)
        out, h_n = super().forward(packed, h0)
        seq, _ = pad_packed_sequence(out, batch_first=True, total_length=T)
        return seq, torch.cat([h_n[0], h_n[1]], dim=-1)


class MovementConvEncoder(nn.Module):
    """Two stride-2, k = 4, p = 1 convolutions with LeakyReLU(0.2) (T / 4),
    then a Linear; [B, T, D] -> [B, T / 4, output_size]."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Dropout(0.2),
            nn.LeakyReLU(0.2), nn.Conv1d(hidden_size, output_size, 4, 2, 1),
            nn.Dropout(0.2), nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_net(self.main(x.transpose(1, 2)).transpose(1, 2))


class MovementConvDecoder(nn.Module):
    """Two stride-2, k = 4, p = 1 transposed convolutions with LeakyReLU
    (T x 4), then a Linear: the inverse shape of the encoder."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.main = nn.Sequential(
            nn.ConvTranspose1d(input_size, hidden_size, 4, 2, 1),
            nn.LeakyReLU(0.2),
            nn.ConvTranspose1d(hidden_size, output_size, 4, 2, 1),
            nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_net(self.main(x.transpose(1, 2)).transpose(1, 2))


def _co_output_net(hidden_size: int, output_size: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(hidden_size * 2, hidden_size),
                         nn.LayerNorm(hidden_size, eps=1e-5),
                         nn.LeakyReLU(0.2),
                         nn.Linear(hidden_size, output_size))


class _BiGRUEncoder(nn.Module):
    """input_emb -> MaskedBiGRU from the learned initial state ``hidden``;
    with ``pos_size``, a ``pos_emb`` of the POS one-hots is added to the
    word vectors first."""

    def __init__(self, input_size: int, hidden_size: int,
                 pos_size: Optional[int] = None):
        super().__init__()
        if pos_size is not None:
            self.pos_emb = nn.Linear(pos_size, input_size)
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = MaskedBiGRU(hidden_size, hidden_size)
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def _run(self, inputs: torch.Tensor, lengths,
             pos_onehot: Optional[torch.Tensor] = None):
        if pos_onehot is not None:
            inputs = inputs + self.pos_emb(pos_onehot)
        h0 = self.hidden.expand(2, inputs.shape[0], -1).contiguous()
        return self.gru(self.input_emb(inputs), lengths, h0)


class TextEncoderBiGRUCo(_BiGRUEncoder):
    """BiGRU text encoder into the co-embedding space: word vectors
    [B, L, word_size], POS one-hots [B, L, pos_size], lengths -> [B, out]."""

    def __init__(self, word_size: int = 300, pos_size: int = 15,
                 hidden_size: int = 512, output_size: int = 512):
        super().__init__(word_size, hidden_size, pos_size)
        self.output_net = _co_output_net(hidden_size, output_size)

    def forward(self, word_embs: torch.Tensor, pos_onehot: torch.Tensor,
                cap_lens) -> torch.Tensor:
        _, last = self._run(word_embs, cap_lens, pos_onehot)
        return self.output_net(last)


class MotionEncoderBiGRUCo(_BiGRUEncoder):
    """BiGRU motion encoder over movement features [B, T', input_size] ->
    [B, out]."""

    def __init__(self, input_size: int = 512, hidden_size: int = 1024,
                 output_size: int = 512):
        super().__init__(input_size, hidden_size)
        self.output_net = _co_output_net(hidden_size, output_size)

    def forward(self, inputs: torch.Tensor, m_lens) -> torch.Tensor:
        _, last = self._run(inputs, m_lens)
        return self.output_net(last)


class MotionLenEstimatorBiGRU(_BiGRUEncoder):
    """BiGRU motion-length classifier over captions -> [B, output_size]
    logits (length buckets)."""

    def __init__(self, word_size: int = 300, pos_size: int = 15,
                 hidden_size: int = 512, output_size: int = 50):
        super().__init__(word_size, hidden_size, pos_size)
        nd = 512
        layers: List[nn.Module] = []
        for fan_in, fan_out in ((hidden_size * 2, nd), (nd, nd // 2),
                                (nd // 2, nd // 4)):
            layers += [nn.Linear(fan_in, fan_out),
                       nn.LayerNorm(fan_out, eps=1e-5), nn.LeakyReLU(0.2)]
        self.output = nn.Sequential(*layers, nn.Linear(nd // 4, output_size))

    def forward(self, word_embs: torch.Tensor, pos_onehot: torch.Tensor,
                cap_lens) -> torch.Tensor:
        _, last = self._run(word_embs, cap_lens, pos_onehot)
        return self.output(last)


class TextEncoderBiGRU(_BiGRUEncoder):
    """Sequence-output BiGRU text encoder: (per-token states [B, L, 2H]
    with the backward stream aligned to token order, final hidden
    [B, 2H])."""

    def __init__(self, word_size: int = 300, pos_size: int = 15,
                 hidden_size: int = 512):
        super().__init__(word_size, hidden_size, pos_size)

    def forward(self, word_embs: torch.Tensor, pos_onehot: torch.Tensor,
                cap_lens) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._run(word_embs, cap_lens, pos_onehot)


def positional_encoding_table(max_len: int, d_model: int) -> torch.Tensor:
    """Fixed sinusoidal table [max_len, d_model] (sin on even columns, cos
    on odd), built in numpy float32 as the JAX package builds it."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """VAE reparameterization mu + exp(logvar / 2) * eps, with eps drawn
    from ``generator`` (on mu's device) unless given."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
    return mu + torch.exp(0.5 * logvar) * eps


class _GRUCellStack(nn.Module):
    """The decoders' common part: an embedding of each frame's input plus
    its positional encoding, a stack of ``n_layers`` GRU cells seeded from
    the text latent by ``z2init`` (flax LayerNorm epsilon 1e-6)."""

    def __init__(self, text_size: int, input_size: int, hidden_size: int,
                 n_layers: int, max_len: int):
        super().__init__()
        self.n_layers = n_layers
        self.emb = nn.Sequential(nn.Linear(input_size, hidden_size),
                                 nn.LayerNorm(hidden_size, eps=1e-6),
                                 nn.LeakyReLU(0.2))
        self.z2init = nn.Linear(text_size, hidden_size * n_layers)
        self.gru = nn.ModuleList([nn.GRUCell(hidden_size, hidden_size)
                                  for _ in range(n_layers)])
        self.register_buffer("pe", positional_encoding_table(
            max_len, hidden_size), persistent=False)

    def get_init_hidden(self, latent: torch.Tensor) -> List[torch.Tensor]:
        return list(torch.chunk(self.z2init(latent), self.n_layers, dim=-1))

    def _cells(self, inputs: torch.Tensor, hidden: Sequence[torch.Tensor],
               p) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = self.emb(inputs) + self.pe[p]
        new_hidden = []
        for i, cell in enumerate(self.gru):
            h = cell(h, hidden[i])
            new_hidden.append(h)
        return h, new_hidden


class TextVAEDecoder(_GRUCellStack):
    """Autoregressive pose decoder cell: (inputs [B, input_size], hidden
    list, position p) -> (pose [B, output_size], new hidden list)."""

    def __init__(self, text_size: int, input_size: int, output_size: int,
                 hidden_size: int, n_layers: int, max_len: int = 300):
        super().__init__(text_size, input_size, hidden_size, n_layers,
                         max_len)
        self.output = nn.Sequential(nn.Linear(hidden_size, hidden_size),
                                    nn.LayerNorm(hidden_size, eps=1e-6),
                                    nn.LeakyReLU(0.2),
                                    nn.Linear(hidden_size, output_size))

    def forward(self, inputs: torch.Tensor, hidden: Sequence[torch.Tensor],
                p) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h, new_hidden = self._cells(inputs, hidden, p)
        return self.output(h), new_hidden


class TextDecoder(_GRUCellStack):
    """Text-conditioned latent sampler cell: (inputs, hidden list, p) ->
    (z, mu, logvar, new hidden list), z drawn by :func:`reparameterize`."""

    def __init__(self, text_size: int, input_size: int, output_size: int,
                 hidden_size: int, n_layers: int, max_len: int = 300):
        super().__init__(text_size, input_size, hidden_size, n_layers,
                         max_len)
        self.mu_net = nn.Linear(hidden_size, output_size)
        self.logvar_net = nn.Linear(hidden_size, output_size)

    def forward(self, inputs: torch.Tensor, hidden: Sequence[torch.Tensor],
                p, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        h, new_hidden = self._cells(inputs, hidden, p)
        mu, logvar = self.mu_net(h), self.logvar_net(h)
        return (reparameterize(mu, logvar, generator, eps), mu, logvar,
                new_hidden)


class AttLayer(nn.Module):
    """Single-query additive attention: (query [B, query_dim], keys
    [B, S, key_dim]) -> (pred [B, value_dim], weights [B, S, 1])."""

    def __init__(self, query_dim: int, key_dim: int, value_dim: int):
        super().__init__()
        self.value_dim = value_dim
        self.W_q = nn.Linear(query_dim, value_dim)
        self.W_k = nn.Linear(key_dim, value_dim, bias=False)
        self.W_v = nn.Linear(key_dim, value_dim)

    def forward(self, query: torch.Tensor, key_mat: torch.Tensor):
        q = self.W_q(query).unsqueeze(-1)                    # [B, V, 1]
        weights = torch.matmul(self.W_k(key_mat), q) / float(
            self.value_dim) ** 0.5                          # [B, S, 1]
        co_weights = torch.softmax(weights, dim=1)
        return (self.W_v(key_mat) * co_weights).sum(dim=1), co_weights


def contrastive_loss(output1: torch.Tensor, output2: torch.Tensor,
                     label: torch.Tensor, margin: float = 3.0
                     ) -> torch.Tensor:
    """Hadsell-Chopra-LeCun contrastive loss (the JAX package's
    broadcasting: ``label`` against the [B, 1] distances)."""
    d = torch.linalg.vector_norm(output1 - output2 + 1e-12, dim=-1,
                                 keepdim=True)
    return torch.mean((1 - label) * d ** 2
                      + label * torch.clamp(margin - d, min=0.0) ** 2)


# ---------------------------------------------------------------------------
# the released checkpoint and the frozen wrapper
# ---------------------------------------------------------------------------

def convert_torch_evaluator_checkpoint(path: str
                                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A released ``finest.tar`` -> {"movement", "text", "motion"}
    state_dicts of this module's encoders. The file already holds torch's
    layout under the keys ``movement_encoder``, ``text_encoder`` and
    ``motion_encoder``; it is read with ``weights_only=True`` (tensors and
    plain containers, no code) on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {"movement": dict(ckpt["movement_encoder"]),
            "text": dict(ckpt["text_encoder"]),
            "motion": dict(ckpt["motion_encoder"])}


class EvaluatorModelWrapper:
    """The frozen evaluator stack: protocol constants dim_word 300,
    dim_pos_ohot 15, text hidden 512, motion hidden 1024, co-embedding 512,
    movement latent 512, unit_length 4. ``state_dicts`` ({"movement",
    "text", "motion"}, as :func:`convert_torch_evaluator_checkpoint` or
    ``models/evaluator_bridge.py`` give them) or, without them, a random
    init drawn from ``seed``. The modules live on ``device``; embeddings
    come back in input order."""

    def __init__(self, dim_pose: int = 263, unit_length: int = 4,
                 dim_word: int = 300, dim_pos_ohot: int = 15,
                 dim_movement_latent: int = 512,
                 state_dicts: Optional[Mapping[str, Mapping]] = None,
                 seed: int = 0, device="cuda"):
        self.unit_length = unit_length
        self.device = torch.device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.movement_enc = MovementConvEncoder(
                dim_pose - 4, 512, dim_movement_latent)
            self.text_enc = TextEncoderBiGRUCo(dim_word, dim_pos_ohot, 512,
                                               512)
            self.motion_enc = MotionEncoderBiGRUCo(dim_movement_latent,
                                                   1024, 512)
        if state_dicts is not None:
            for key, module in self.encoders().items():
                module.load_state_dict(state_dicts[key], strict=True)
        for module in self.encoders().values():
            module.to(self.device).eval().requires_grad_(False)
        # cuDNN runs each GRU from one contiguous weight buffer
        self.text_enc.gru.flatten_parameters()
        self.motion_enc.gru.flatten_parameters()

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kw) -> "EvaluatorModelWrapper":
        return cls(state_dicts=convert_torch_evaluator_checkpoint(path), **kw)

    def encoders(self) -> Dict[str, nn.Module]:
        return {"movement": self.movement_enc, "text": self.text_enc,
                "motion": self.motion_enc}

    @property
    def embed_dim(self) -> int:
        """Width of a co-embedding row."""
        return self.motion_enc.output_net[-1].out_features

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, dtype=torch.float32).to(self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def motion_embeddings(self, motions: torch.Tensor, m_lens
                          ) -> torch.Tensor:
        """Motion co-embeddings [B, 512] on the device: motions [B, T, D]
        (a tensor on the device, or an array), lengths in frames."""
        lens = np.asarray(m_lens.cpu() if isinstance(m_lens, torch.Tensor)
                          else m_lens, dtype=np.int64)
        movements = self.movement_enc(self._tensor(motions)[..., :-4])
        return self.motion_enc(movements, lens // self.unit_length)

    @torch.inference_mode()
    def text_embeddings(self, word_embs, pos_ohot, cap_lens) -> torch.Tensor:
        return self.text_enc(self._tensor(word_embs),
                             self._tensor(pos_ohot), np.asarray(cap_lens))

    def get_co_embeddings(self, word_embs, pos_ohot, cap_lens, motions,
                          m_lens) -> Tuple[np.ndarray, np.ndarray]:
        """(text, motion) co-embeddings as numpy, rows aligned and in input
        order (the reference sorts by length and returns them sorted)."""
        me = self.motion_embeddings(motions, m_lens)
        te = self.text_embeddings(word_embs, pos_ohot, cap_lens)
        return te.cpu().numpy(), me.cpu().numpy()

    def get_motion_embeddings(self, motions, m_lens) -> np.ndarray:
        return self.motion_embeddings(motions, m_lens).cpu().numpy()

    def get_text_embeddings(self, word_embs, pos_ohot, cap_lens
                            ) -> np.ndarray:
        """Text co-embeddings alone: the motion side may come from the
        fused sample-and-embed path."""
        return self.text_embeddings(word_embs, pos_ohot, cap_lens
                                    ).cpu().numpy()
