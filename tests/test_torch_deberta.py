"""The port's DeBERTa text encoder against the JAX package's, module by module.

Parameters: a flax tree of seeded numpy draws (every leaf nonzero), bridged
into the port (``models/bridge.py``'s general rules: the port's attribute
names are the flax paths). Inputs: numpy from a seed, ragged token ids with
pads (one row holding only its first token). JAX runs on the CPU, jitted.

Tolerances:
- the bucketed relative positions: equal, bit for bit (integers computed
  through an f32 ``log`` and ``ceil``: one ulp of ``log`` at a ``ceil``
  boundary would move a bucket);
- f32 modules, the same math in another summation order: max abs error
  <= 1e-5 x the output's largest value, at every position, pads included
  (the key-only mask lets padded query rows reach the output, and the
  pooled embedding averages over them);
- bf16-stored weights, widened to f32 before use on both sides: the same
  rule;
- deterministic gradients (``jax.grad`` against ``backward``): each
  parameter's max abs error <= 1e-5 x the largest gradient of any
  parameter (some gradients, e.g. a key bias's through a softmax over
  keys, are zero up to rounding, so a per-leaf relative bound would read
  rounding noise);
- against HF ``DebertaV2Model`` (random weights, both layouts) through
  :func:`convert_hf_deberta_checkpoint`: atol = rtol = 1e-4 at the valid
  positions, the JAX package's own rule (HF masks the query rows too, so
  its padded rows differ by design);
- the converter and the tokenizer: equal, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.models import deberta as JD
from motiondiffusion_moe_tpu_torch.models import deberta as TD
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from motiondiffusion_moe_tpu_torch.models.layers import TrainContext
from motiondiffusion_moe_tpu_torch.pipeline import cast_params_

from tests._torch_parity import load_into, random_params, t

# the tokenizer lookup reads local files only; keep the hub offline anyway
os.environ.setdefault("HF_HUB_OFFLINE", "1")

REL = 1e-5
OUT = 16           # text_latent_dim of the head
LENGTHS = [12, 7, 1]


def _configs(share: bool):
    jc = JD.DebertaConfig(**{**vars(JD.DebertaConfig.tiny()),
                             "share_att_key": share})
    return jc, TD.DebertaConfig(**vars(jc))


def _ids(lengths=LENGTHS, T=12, seed=0, vocab=256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), T), np.int32)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(1, vocab, n)
    return ids


def _n(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------- positions

@pytest.mark.parametrize("preset", ["tiny", "large"])
def test_bucket_table_is_jaxs_bit_for_bit(preset):
    """Every relative position in [-(P-1), P-1]: the log branch is live at
    tiny (mid 8, max 64) and, over this range, at large (mid 128, 512)."""
    c = getattr(JD.DebertaConfig, preset)()
    P, k = c.max_position_embeddings, c.position_buckets
    rel = np.arange(-(P - 1), P, dtype=np.int32)
    ours = TD.make_log_bucket_position(torch.from_numpy(rel), k, P)
    assert ours.dtype == torch.int32
    eager = np.asarray(JD.make_log_bucket_position(jnp.asarray(rel), k, P))
    jitted = np.asarray(jax.jit(
        lambda r: JD.make_log_bucket_position(r, k, P))(jnp.asarray(rel)))
    np.testing.assert_array_equal(ours.numpy(), eager)
    np.testing.assert_array_equal(ours.numpy(), jitted)
    assert (np.abs(eager) < k).all() and (eager != rel).any()


@pytest.mark.parametrize("preset", ["tiny", "large"])
@pytest.mark.parametrize("T", [6, 77])
def test_relative_position_table_is_jaxs(preset, T):
    c = getattr(JD.DebertaConfig, preset)()
    args = (T, T, c.position_buckets, c.max_position_embeddings)
    ours = TD.build_relative_position(*args)
    ref = np.asarray(JD.build_relative_position(*args))
    assert tuple(ours.shape) == ref.shape == (1, T, T)
    np.testing.assert_array_equal(ours.numpy(), ref)


# ---------------------------------------------------------------- modules

def _module_case(name, share):
    """(JAX module, port module, JAX args, port args) at tiny width."""
    jc, tc = _configs(share)
    ids = _ids()
    mask = (ids != 0).astype(np.float32)
    B, T = ids.shape
    C = jc.hidden_size
    hidden = _n(B, T, C, seed=1)
    rel_emb = _n(2 * jc.position_buckets, C, seed=2)
    rel_pos = np.asarray(JD.build_relative_position(
        T, T, jc.position_buckets, jc.max_position_embeddings))
    if name == "attention":
        return (JD.DisentangledSelfAttention(cfg=jc),
                TD.DisentangledSelfAttention(tc),
                [hidden, mask, rel_emb, rel_pos],
                [t(hidden), t(mask), t(rel_emb)])
    if name == "layer":
        return (JD.DebertaLayer(cfg=jc), TD.DebertaLayer(tc),
                [hidden, mask, rel_emb, rel_pos],
                [t(hidden), t(mask), t(rel_emb)])
    if name == "encoder":
        return (JD.DebertaEncoder(cfg=jc), TD.DebertaEncoder(tc),
                [ids, mask], [t(ids), t(mask)])
    return (JD.DebertaTextEncoder(output_dim=OUT, cfg=jc, dropout=0.1),
            TD.DebertaTextEncoder(OUT, tc, dropout=0.1), [ids], [t(ids)])


def _outputs(out):
    return ([out.pooled, out.tokens] if isinstance(out, tuple) else [out])


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("name", ["attention", "layer", "encoder",
                                  "text_encoder"])
def test_module_matches_jax_f32(name, share):
    jmod, tmod, jargs, targs = _module_case(name, share)
    params = random_params(jmod, *jargs, seed=3)
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params,
                                                                *jargs)
    load_into(tmod, params)
    with torch.no_grad():
        out = tmod(*targs)
    for o, r in zip(_outputs(out), _outputs(ref)):
        assert o.dtype == torch.float32
        _close(o.numpy(), r)
    if name == "text_encoder":
        assert out.tokens.shape == (3, 8 + 12, OUT)
        assert out.pooled.shape == (3, OUT)


@pytest.mark.parametrize("share", [True, False])
def test_bf16_stored_weights_are_widened_as_jax_does(share):
    """The JAX pipeline's cast (every f32 leaf to bf16) against the port's
    ``cast_params_``: both compute in f32 on the widened weights, the
    embedding table and ``rel_embeddings`` included."""
    jmod, tmod, jargs, targs = _module_case("text_encoder", share)
    params = random_params(jmod, *jargs, seed=4)
    p16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                 params)
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(p16, *jargs)
    load_into(tmod, params)
    with torch.no_grad():
        f32 = tmod(*targs)
    cast_params_(tmod, torch.bfloat16)
    assert {p.dtype for p in tmod.parameters()} == {torch.bfloat16}
    with torch.no_grad():
        out = tmod(*targs)
    for o, r in zip(_outputs(out), _outputs(ref)):
        assert o.dtype == torch.float32
        _close(o.numpy(), r)
    # the bf16 storage is a different model (not a vacuous comparison)
    assert not torch.allclose(out.pooled, f32.pooled, rtol=0, atol=1e-6)


@pytest.mark.parametrize("share", [True, False])
def test_gradients_match_jax_grad(share):
    jmod, tmod, jargs, targs = _module_case("text_encoder", share)
    params = random_params(jmod, *jargs, seed=5)
    wp, wt = _n(3, OUT, seed=6), _n(3, 8 + 12, OUT, seed=7)

    def loss(p):
        enc = jmod.apply({"params": p}, *jargs)
        return jnp.sum(enc.pooled * wp) + jnp.sum(enc.tokens * wt)

    ref = jax_to_state_dict(jax.jit(jax.grad(loss))(params))
    load_into(tmod, params)
    enc = tmod(*targs)
    ((enc.pooled * t(wp)).sum() + (enc.tokens * t(wt)).sum()).backward()
    got = {n: p.grad for n, p in tmod.named_parameters()}
    assert set(got) == set(ref)
    top = max(float(g.abs().max()) for g in ref.values())
    for n, g in got.items():
        assert g is not None, n
        err = float((g - ref[n]).abs().max())
        assert err <= REL * top, (n, err, top)


def test_dropout_sites_draw_from_the_context(monkeypatch):
    """Training mode: the four backbone sites (probabilities, attention
    output, FFN output, embeddings) at ``DebertaConfig.dropout`` = 0.1 and
    the head's at its own rate, every mask from ``ctx.generator``."""
    _, tc = _configs(True)
    tmod = TD.DebertaTextEncoder(OUT, tc, dropout=0.25)
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    init_weights(tmod, 0).train()
    ids = t(_ids([12] * 6 + [5, 1], seed=8))
    calls = []
    real = TD.dropout

    def recording(x, rate, training, ctx):
        y = real(x, rate, training, ctx)
        calls.append((x.detach(), y.detach(), rate))
        return y

    monkeypatch.setattr(TD, "dropout", recording)

    def run(seed):
        calls.clear()
        with torch.no_grad():
            return tmod(ids, TrainContext(torch.Generator().manual_seed(seed)))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.tokens, c.tokens)
    L = tc.num_hidden_layers
    assert len(calls) == 1 + 3 * L + 1
    assert [r for _, _, r in calls] == [0.1] * (1 + 3 * L) + [0.25]
    for x, y, rate in calls:
        live = x != 0
        kept = (y != 0) & live
        keep = float(kept.sum()) / float(live.sum())
        assert abs(keep - (1 - rate)) < 0.03, (rate, keep)
        torch.testing.assert_close(y[kept], x[kept] / (1 - rate))
    with pytest.raises(ValueError, match="TrainContext"):
        tmod(ids)
    tmod.eval()
    calls.clear()
    with torch.no_grad():
        tmod(ids)
    assert all(torch.equal(x, y) for x, y, _ in calls)


# ---------------------------------------------------------------- HF


def _hf_layout(tc: TD.DebertaConfig, seed: int = 0, dtype=torch.float32,
               extra: bool = True):
    """An HF ``deberta-v2`` state_dict of seeded tensors (no
    ``transformers`` needed), with the heads a full checkpoint carries."""
    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = TD.DebertaEncoder(tc).state_dict()
    sd = {hf: (0.1 * torch.randn(shapes[ours].shape, generator=g)).to(dtype)
          for ours, hf in TD.hf_deberta_names(tc).items()}
    if extra:
        sd["pooler.dense.weight"] = torch.randn(4, 4, generator=g)
        sd["lm_predictions.lm_head.bias"] = torch.randn(7, generator=g)
    return sd


@pytest.mark.parametrize("share", [True, False])
def test_hf_model_parity_through_the_converter(share):
    transformers = pytest.importorskip("transformers")
    jc, tc = _configs(share)
    hf_cfg = transformers.DebertaV2Config(
        vocab_size=tc.vocab_size, hidden_size=tc.hidden_size,
        num_hidden_layers=tc.num_hidden_layers,
        num_attention_heads=tc.num_attention_heads,
        intermediate_size=tc.intermediate_size,
        max_position_embeddings=tc.max_position_embeddings,
        position_buckets=tc.position_buckets, relative_attention=True,
        norm_rel_ebd="layer_norm", share_att_key=share,
        pos_att_type="p2c|c2p", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, position_biased_input=False,
        layer_norm_eps=tc.layer_norm_eps, pad_token_id=0, type_vocab_size=0,
        hidden_act="gelu", conv_kernel_size=0)
    torch.manual_seed(0)
    hf = transformers.DebertaV2Model(hf_cfg).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # HF starts biases at 0 and norms at 1: move them
        for p in hf.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    ids = _ids([12, 7, 3], seed=9).astype(np.int64)
    mask = ids != 0
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask.astype(np.int64))
                 ).last_hidden_state.numpy()
        enc = TD.DebertaEncoder(tc).eval()
        enc.load_state_dict(TD.convert_hf_deberta_checkpoint(
            hf.state_dict(), tc), strict=True)
        out = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out[mask], ref[mask], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_converter_is_jaxs_bit_for_bit(share, dtype):
    """The port's converted state_dict against ``jax_to_state_dict`` of
    the JAX converter's flax tree; half-precision tensors (the published
    checkpoint's) stay half until the graft casts them."""
    jc, tc = _configs(share)
    sd = _hf_layout(tc, seed=2, dtype=dtype)
    ours = TD.convert_hf_deberta_checkpoint(sd, tc)
    ref = jax_to_state_dict(JD.convert_hf_deberta_checkpoint(sd, jc))
    assert set(ours) == set(ref)
    for k, v in ours.items():
        assert v.dtype == dtype
        assert torch.equal(v.float(), ref[k]), k
    with torch.device("meta"):
        want = TD.DebertaEncoder(tc).state_dict()
    assert set(ours) == set(want)
    assert all(ours[k].shape == want[k].shape for k in want)
    with pytest.raises(KeyError):  # a key the encoder needs is missing
        TD.convert_hf_deberta_checkpoint(
            {k: v for k, v in sd.items() if "layer.1.output" not in k}, tc)


def test_load_hf_state_dict_reads_the_local_layouts(tmp_path):
    a, b = torch.arange(4.0), torch.ones(2)
    full = {"deberta.embeddings.x": a, "deberta.encoder.y": b,
            "lm_predictions.z": torch.zeros(3)}
    d = tmp_path / "hf"
    d.mkdir()
    torch.save(full, d / "pytorch_model.bin")
    for path in (str(d), str(d / "pytorch_model.bin")):
        sd = TD.load_hf_deberta_state_dict(path)
        assert set(sd) == {"embeddings.x", "encoder.y"}
        assert torch.equal(sd["embeddings.x"], a)
    bare = tmp_path / "bare"
    bare.mkdir()
    torch.save({"embeddings.x": a}, bare / "model.pt")
    assert set(TD.load_hf_deberta_state_dict(str(bare))) == {"embeddings.x"}
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        TD.load_hf_deberta_state_dict(str(empty))
    with pytest.raises(FileNotFoundError):
        TD.load_hf_deberta_state_dict(str(tmp_path / "missing.bin"))


@pytest.mark.parametrize("preset", ["tiny", "large"])
def test_tokenizer_ids_are_jaxs(preset):
    """Whatever this environment has (the local HF tokenizer or the hash
    fallback), both packages give the same ids."""
    V = getattr(JD.DebertaConfig, preset)().vocab_size
    texts = ["A person walks forward", "", "jump twice then sit",
             " ".join(["w"] * 90)]
    ours = TD.get_deberta_tokenizer(77, V)(texts)
    ref = JD.get_deberta_tokenizer(77, V)(texts)
    assert ours.dtype == ref.dtype and ours.shape == (4, 77)
    np.testing.assert_array_equal(ours, ref)
    assert ours.max() < V
