"""Each module of the port's denoiser against its flax counterpart.

Parameters: a flax tree filled with seeded numpy draws (every leaf nonzero,
so zero-init kernels, gates and the head are exercised), bridged into the
port. Inputs: numpy from a seed. JAX runs on the CPU.

Tolerances: f32 modules, the same math in another summation order ->
atol 1e-5 (1e-4 for a decoder layer and the whole denoiser). bf16 compute:
both frameworks round to bf16 at (nearly) the same places but accumulate
differently -> relative RMS <= 3e-2 over the whole denoiser.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.models import attention as JA
from motiondiffusion_moe_tpu.models import embeddings as JE
from motiondiffusion_moe_tpu.models import moe as JM
from motiondiffusion_moe_tpu.models.text_encoder import (
    HashTextEncoder as JaxHashTextEncoder,
    hash_tokenize as jax_hash_tokenize,
)
from motiondiffusion_moe_tpu.models.transformer import (
    MoEDecoderLayer as JaxMoEDecoderLayer,
    MotionTransformer as JaxMotionTransformer,
    _block_kwargs,
)
from motiondiffusion_moe_tpu_torch.models import attention as TA
from motiondiffusion_moe_tpu_torch.models import embeddings as TE
from motiondiffusion_moe_tpu_torch.models import moe as TM
from motiondiffusion_moe_tpu_torch.models.layers import init_weights
from motiondiffusion_moe_tpu_torch.models.text_encoder import (
    HashTextEncoder,
    hash_tokenize,
)
from motiondiffusion_moe_tpu_torch.models.transformer import (
    MoEDecoderLayer,
    MotionTransformer,
)

from tests._torch_parity import (
    load_into,
    random_params,
    rel_rms,
    t,
    tiny_model_config,
)

ATOL = 1e-5
B, T, D, TED, N, TL = 2, 10, 64, 256, 7, 16


def _n(*shape, seed=0, s=1.0):
    return (s * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _mask(Tn=T):
    return (np.arange(Tn)[None] < np.array([Tn, 6])[:, None]).astype(
        np.float32)


def _compare(jax_mod, port_mod, jax_args, port_args=None, jax_kw=None,
             port_kw=None, atol=ATOL, seed=0, mutable=False):
    """Same seeded params and inputs through both; returns the params and
    both outputs (numpy)."""
    jax_kw = jax_kw or {}
    params = random_params(jax_mod, *jax_args, seed=seed, **jax_kw)

    def apply(p, *a):
        if mutable:
            return jax_mod.apply({"params": p}, *a, **jax_kw,
                                 mutable=["moe_metrics", "moe_losses"])
        return jax_mod.apply({"params": p}, *a, **jax_kw)

    ref = jax.jit(apply)(params, *jax_args)
    if mutable:
        ref = ref[0]
    load_into(port_mod, params)
    args = port_args if port_args is not None else [t(a) for a in jax_args]
    with torch.no_grad():
        out = port_mod(*args, **(port_kw or {}))
    if atol is not None:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)
    return params, ref, out


# ---------------------------------------------------------------- embeddings

def test_timestep_sinusoidal_cos_first():
    ts = np.array([0, 1, 57, 999], np.int32)
    for dim in (64, 65):
        np.testing.assert_allclose(
            TE.timestep_sinusoidal(t(ts), dim).numpy(),
            np.asarray(JE.timestep_sinusoidal(jnp.asarray(ts), dim)),
            atol=2e-5)  # cos/sin of f32 arguments up to ~1e3


def test_timestep_embedding_and_gated_fusion():
    ts = np.array([3, 700], np.int32)
    _compare(JE.TimestepEmbedding(embed_dim=D), TE.TimestepEmbedding(D),
             [ts], atol=2e-5)
    _compare(JE.GatedFusion(embed_dim=D), TE.GatedFusion(D),
             [_n(B, D), _n(B, D, seed=1)])


@pytest.mark.parametrize("pre_ln", [False, True])
def test_stylization_block(pre_ln):
    h, emb = _n(B, T, D), _n(B, D, seed=1)
    ps, pb = 1 + _n(D, seed=2, s=0.1), _n(D, seed=3, s=0.1)
    kw = {"pre_ln": (ps, pb)} if pre_ln else {}
    _compare(JE.StylizationBlock(latent_dim=D, time_embed_dim=TED,
                                 dropout=0.0),
             TE.StylizationBlock(D, TED, D), [h, emb], jax_kw=kw,
             port_kw={"pre_ln": (t(ps), t(pb))} if pre_ln else None)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("use_kernels", [True, False])
def test_performer_self_attention(use_kernels):
    x, emb, mask = _n(B, T, D), _n(B, D, seed=1), _mask()
    _compare(JA.PerformerSelfAttention(latent_dim=D, num_heads=2,
                                       dropout=0.0, time_embed_dim=TED,
                                       num_features=32,
                                       use_kernels=use_kernels),
             TA.PerformerSelfAttention(D, 2, TED, 32, use_kernels),
             [x, emb, mask[..., None]],
             port_args=[t(x), t(emb), t(mask)])


def test_dual_self_attention_block():
    x, emb, mask = _n(B, T, D), _n(B, D, seed=1), _mask()
    _compare(JA.DualSelfAttentionBlock(latent_dim=D, num_heads=2, dropout=0.0,
                                       time_embed_dim=TED, num_features=32),
             TA.DualSelfAttentionBlock(D, 2, TED, 32),
             [x, emb, mask[..., None]], port_args=[t(x), t(emb), t(mask)])


def test_linear_and_gated_cross_attention():
    x, xf, emb = _n(B, T, D), _n(B, N, TL, seed=1), _n(B, D, seed=2)
    kw = dict(latent_dim=D, text_latent_dim=TL, num_heads=2, dropout=0.0,
              time_embed_dim=TED)
    # the JAX deterministic path is the per-head-slice form; the port's
    # batched-head form is the same math
    _compare(JA.LinearTemporalCrossAttention(**kw),
             TA.LinearTemporalCrossAttention(D, TL, 2, TED), [x, xf, emb])
    _compare(JA.GatedCrossAttention(**kw),
             TA.GatedCrossAttention(D, TL, 2, TED), [x, xf, emb])


def test_exact_cross_attention_block():
    x, xf = _n(B, T, D), _n(B, N, TL, seed=1)
    _compare(JA.CrossAttentionBlock(latent_dim=D, text_latent_dim=TL,
                                    num_heads=2, dropout=0.0),
             TA.CrossAttentionBlock(D, TL, 2), [x, xf])


# ---------------------------------------------------------------- MoE

@pytest.mark.parametrize("zero_gate", [True, False])
def test_switch_moe_top2_and_metrics(zero_gate):
    """zero gate: every router probability ties, jax.lax.top_k takes the
    lowest indices and so must the port; nonzero gate: real routing."""
    x = _n(B, T, D)
    jmod = JM.SwitchMoELayer(latent_dim=D, hidden_dim=32, num_experts=4,
                             top_k=2)
    params = random_params(jmod, x)
    if zero_gate:
        params["gate"] = jax.tree_util.tree_map(np.zeros_like,
                                                params["gate"])
    ref, sown = jax.jit(lambda p, a: jmod.apply(
        {"params": p}, a, mutable=["moe_metrics", "moe_losses"]))(params, x)
    port = load_into(TM.SwitchMoELayer(D, 32, 4, 2), params)
    with torch.no_grad():
        out, metrics = port(t(x), with_metrics=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    for name in ("expert_usage", "expert_importance"):
        np.testing.assert_allclose(metrics[name].numpy(),
                                   np.asarray(sown["moe_metrics"][name]),
                                   atol=1e-5)
    np.testing.assert_allclose(metrics["aux"].numpy(),
                               np.asarray(sown["moe_losses"]["aux"]),
                               atol=1e-6)
    if zero_gate:  # ties: experts 0 and 1 for every token
        assert metrics["expert_usage"].tolist() == [B * T, 0, 0, 0]


def test_top_k_ties_break_to_the_lowest_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.5, 0.2, 0.2, 0.1]])
    vals, idx = TM.top_k_lowest_index(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 3],
                                                       [0, 1]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_multi_branch_ffn():
    _compare(JM.MoEMultiBranchFFN(latent_dim=D, ffn_dim=32, num_experts=4,
                                  num_branches=2, top_k=2, dropout=0.0,
                                  time_embed_dim=TED),
             TM.MoEMultiBranchFFN(D, 32, 4, 2, 2, TED),
             [_n(B, T, D), _n(B, D, seed=1)], mutable=True)


def test_dense_ffn():
    _compare(JM.DenseFFN(latent_dim=D, ffn_dim=32, num_branches=2,
                         dropout=0.0, time_embed_dim=TED),
             TM.DenseFFN(D, 32, 2, TED), [_n(B, T, D), _n(B, D, seed=1)])


# ---------------------------------------------------------------- text

def test_hash_tokenize_is_the_same_function():
    texts = ["A person walks forward", "", "jump jump JUMP", "é ü 中文",
             " ".join(["w"] * 40)]
    np.testing.assert_array_equal(hash_tokenize(texts, 12),
                                  jax_hash_tokenize(texts, 12))


def test_hash_text_encoder_masks_keys_and_pools_all_positions():
    ids = hash_tokenize(["a person walks", "", "a b c d e f g h i j k l"], 12)
    _, ref, enc = _compare(JaxHashTextEncoder(output_dim=TL),
                           HashTextEncoder(TL, 12), [ids], atol=None)
    np.testing.assert_allclose(enc.pooled.numpy(), np.asarray(ref.pooled),
                               atol=ATOL)
    np.testing.assert_allclose(enc.tokens.numpy(), np.asarray(ref.tokens),
                               atol=ATOL)
    assert enc.tokens.shape == (3, 8 + 12, TL)


# ---------------------------------------------------------------- denoiser

def test_decoder_layer():
    cfg = tiny_model_config()
    x, xf, emb, mask = (_n(B, T, D), _n(B, N, TL, seed=1), _n(B, D, seed=2),
                        _mask())
    jmod = JaxMoEDecoderLayer(**_block_kwargs(cfg, TED, None, True,
                                              jnp.float32))
    _compare(jmod, MoEDecoderLayer(cfg, TED), [x, xf, emb, mask[..., None]],
             port_args=[t(x), t(xf), t(emb), t(mask)], mutable=True,
             atol=1e-4)


def _denoiser_inputs(Tn):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, Tn, 26)).astype(np.float32)
    ts = np.array([5, 500, 999], np.int32)
    lengths = np.array([Tn, 9, 1], np.int32)
    ids = hash_tokenize(["a person walks", "turn left", ""], 12)
    return x, ts, lengths, ids


@pytest.fixture(scope="module")
def denoiser_params():
    """One seeded flax tree for the denoiser tests (the parameter shapes
    depend on neither the compute dtype nor the frame count)."""
    x, ts, lengths, ids = _denoiser_inputs(16)
    return random_params(JaxMotionTransformer(tiny_model_config(num_layers=1)),
                         x, ts, lengths, text_ids=ids)


def _denoise_both(dtype, Tn, params):
    cfg = tiny_model_config(dtype, num_layers=1)
    x, ts, lengths, ids = _denoiser_inputs(Tn)
    jm = JaxMotionTransformer(cfg)
    ref = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:3], text_ids=a[3],
        mutable=["moe_losses", "moe_metrics"])[0])(params, x, ts, lengths, ids)
    port = load_into(MotionTransformer(cfg), params)
    with torch.no_grad():
        out = port(t(x), t(ts), t(lengths), text_ids=t(ids))
    assert out.dtype == torch.float32 and out.shape == (3, Tn, 26)
    return port, (x, ts, lengths, ids), np.asarray(ref), out


@pytest.mark.parametrize("Tn", [16, 15])
def test_motion_transformer_f32(Tn, denoiser_params):
    port, (x, ts, lengths, ids), ref, out = _denoise_both(
        "float32", Tn, denoiser_params)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    with torch.no_grad():  # precomputed text embeddings: the same result
        enc = port.encode_text(t(ids))
        out2 = port(t(x), t(ts), t(lengths), xf_proj=enc.pooled,
                    xf_out=enc.tokens)
    assert torch.equal(out, out2)


def test_motion_transformer_bf16(denoiser_params):
    _, _, ref, out = _denoise_both("bfloat16", 16, denoiser_params)
    assert rel_rms(out.numpy(), ref) < 3e-2


# ---------------------------------------------------------------- init

def test_seeded_init_mirrors_the_flax_initialisers():
    cfg = tiny_model_config(num_layers=1)
    a = init_weights(MotionTransformer(cfg), 3)
    b = init_weights(MotionTransformer(cfg), 3)
    c = init_weights(MotionTransformer(cfg), 4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["sequence_embedding"], sc["sequence_embedding"])
    # zero-inits: the head, the MoE gates, non-Performer style outputs
    assert not sa["out.weight"].any() and not sa["out.bias"].any()
    blk = "blocks_low.0."
    assert not sa[blk + "ffn.branch_0_moe.gate.weight"].any()
    assert not sa[blk + "ffn.proj_out.out_kernel"].any()
    assert not sa[blk + "cross_attn.gate"].any()
    # the Performer's style output is xavier(0.1), not zero
    perf = blk + "dual_self_attn.local_attn."
    assert sa[perf + "style_block.out_kernel"].std() > 0
    # merged qkv: std 0.1 * sqrt(1 / D)
    std = sa[perf + "qkv.weight"].std().item()
    assert abs(std - 0.1 * D ** -0.5) < 0.1 * 0.1 * D ** -0.5
    # orthogonal features: unit-norm orthogonal columns scaled by d**-0.25
    p = sa[perf + "fa_projection"].double()
    d = p.shape[0]
    gram = p.T @ p * d ** 0.5
    torch.testing.assert_close(gram, torch.eye(p.shape[1],
                                               dtype=torch.float64),
                               atol=1e-5, rtol=0)
    assert sa[perf + "pre_norm.weight"].eq(1).all()
