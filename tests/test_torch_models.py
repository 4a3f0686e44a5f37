"""Each module of the port's denoiser against its flax counterpart.

Parameters: a flax tree filled with seeded numpy draws (every leaf nonzero,
so zero-init kernels, gates and the head are exercised), bridged into the
port. Inputs: numpy from a seed. JAX runs on the CPU.

Tolerances: f32 modules, the same math in another summation order ->
atol 1e-5 (1e-4 for a decoder layer and the whole denoiser). bf16 compute:
the port rounds where the JAX package's modules round (its Dense adds the
bias after rounding the product; silu, gelu and sigmoid round after each
step; weakly typed scalars are rounded first; ``ops/activations.py``), and
the two accumulate in another order. What is left comes from roundings that
XLA's compiled program leaves out where a bf16 value is widened to f32 next
(LayerNorm inputs, the router logits, softmax sums) and from near-tied MoE
routings -> relative RMS <= 1.2e-2 over the whole denoiser (2.07e-2 with
PyTorch's own bf16 silu, gelu, sigmoid and fused Dense bias; 1.11e-2 now).
"""

import math

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
    to_port,
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
    """Both packages compute ``cos | sin`` of ``t * exp(-log(1e4) i / half)``
    in f32. Their ``exp`` (torch's and XLA's CPU one) may differ by one ulp
    at some frequencies, which ``t = 999`` turns into ~3e-5 at the output,
    with each side as far from the float64 value as the other. So: the
    frequencies agree within 1 ulp; each embedding lies within the f32
    rounding of its own arguments of the float64 value; and the two agree
    at 2e-5 where the argument is small enough that one ulp of a frequency
    cannot matter."""
    ts = np.array([0, 1, 57, 999], np.int32)
    u = 2.0 ** -24  # f32 unit roundoff
    for dim in (64, 65):
        half = dim // 2
        port = TE.timestep_sinusoidal(t(ts), dim).numpy()
        ref = np.asarray(JE.timestep_sinusoidal(jnp.asarray(ts), dim))
        assert port.shape == ref.shape == (len(ts), dim)
        # 1. the frequencies, each package's own f32 exp of the same f32
        # exponents (as the two functions compute them)
        e = -math.log(10000) * np.arange(half, dtype=np.float32) / half
        f_port = torch.exp(-math.log(10000) * torch.arange(
            half, dtype=torch.float32) / half).numpy()
        f_jax = np.asarray(jnp.exp(-math.log(10000) * jnp.arange(
            half, dtype=jnp.float32) / half))
        np.testing.assert_array_max_ulp(f_port, f_jax, maxulp=1)
        # 2. each side against float64 cos / sin of the exact arguments.
        # The f32 argument t * f is off by t * |f - f64| (the frequency's
        # own rounding) plus the product's rounding, u * t * f; cos and sin
        # are 1-Lipschitz, and their f32 results add a few ulps (4 u). At
        # t = 999 that is about max(t) * u * max|f| + 4 u = 6e-5, plus the
        # frequencies' roundings: the bound is derived per element below.
        f64 = np.exp(e.astype(np.float64))
        a64 = ts[:, None].astype(np.float64) * f64[None]
        exact = np.concatenate([np.cos(a64), np.sin(a64)], axis=-1)
        for emb, f32 in ((port, f_port), (ref, f_jax)):
            tf = ts[:, None].astype(np.float64) * f32.astype(np.float64)
            arg_err = (ts[:, None] * np.abs(f32.astype(np.float64) - f64)
                       + u * tf)
            bound = np.concatenate([arg_err, arg_err], axis=-1) + 4 * u
            assert np.all(np.abs(emb[:, :2 * half] - exact) <= bound)
            assert np.all(emb[:, 2 * half:] == 0.0)
        # 3. port and JAX at 2e-5 wherever t * f < 64 (one ulp of the
        # argument there is <= 2^-18)
        small = np.concatenate([a64 < 64] * 2, axis=-1)
        np.testing.assert_allclose(port[:, :2 * half][small],
                                   ref[:, :2 * half][small], atol=2e-5)
        assert small.sum() > small.size // 2
        np.testing.assert_array_equal(port[:, 2 * half:], ref[:, 2 * half:])


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
    _compare(jmod, MoEDecoderLayer(to_port(cfg), TED), [x, xf, emb, mask[..., None]],
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
    port = load_into(MotionTransformer(to_port(cfg)), params)
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
    dist = rel_rms(out.numpy(), ref)
    print(f"tiny bf16 denoiser: relative RMS to the JAX bf16 output {dist:.3e}"
          " (2.07e-2 before the port rounded where JAX rounds, 1.11e-2 before"
          " it left out the roundings that XLA's compiled program leaves"
          " out)")
    # measured 7.43e-3; the bound leaves ~15% for MoE routings near a tie
    assert dist < 8.5e-3


def test_each_left_out_rounding_of_the_bf16_denoiser(denoiser_params,
                                                     monkeypatch):
    """The three roundings that XLA's compiled program leaves out, each
    alone (the other two put back), against all three: only together do
    they bring the tiny bf16 denoiser closest to jitted JAX (MoE routings
    near a tie move the distance in steps, so a point alone can land
    further away)."""
    import torch.nn.functional as F

    from motiondiffusion_moe_tpu_torch.models import layers as TL

    port, (x, ts, lengths, ids), ref, out = _denoise_both(
        "bfloat16", 16, denoiser_params)
    together = rel_rms(out.numpy(), ref)

    def ln_rounded(self, v):
        v = getattr(v, "unrounded", v).to(self.dtype)
        return F.layer_norm(v.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), TL.LN_EPS).to(self.dtype)

    put_back = {
        "router": (TM.SwitchMoELayer, "_router_logits",
                   lambda self, v: self.gate(v).float()),
        "layer_norm": (TL.LayerNorm, "forward", ln_rounded),
        "softmax": (TA, "softmax", lambda v, dim: torch.softmax(v, dim)),
    }
    alone = {}
    for point in put_back:
        with monkeypatch.context() as mp:
            for other, (owner, name, old) in put_back.items():
                if other != point:
                    mp.setattr(owner, name, old)
            with torch.no_grad():
                o = port(t(x), t(ts), t(lengths), text_ids=t(ids))
        alone[point] = rel_rms(o.numpy(), ref)
    print(f"tiny bf16 denoiser, relative RMS to jitted JAX: all three "
          f"{together:.3e}; each alone {alone}")
    assert all(together < d for d in alone.values())


# ---------------------------------------------------------------- init

def test_seeded_init_mirrors_the_flax_initialisers():
    cfg = tiny_model_config(num_layers=1)
    cfg = to_port(cfg)
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


# ---------------------------------------------------------------- fast paths

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_motion_transformer_with_both_fused_paths(dtype, monkeypatch):
    """``use_fast_xattn=True`` and ``MOE_FUSED_KERNEL=1`` (widths that are
    multiples of 128, as the MoE condition asks) in both packages: the
    tiny denoiser through the fused forms, against the JAX one. The port
    must take both fused ops in every block.

    bf16: at this width bf16 compute alone moves the JAX denoiser ~4e-2
    (relative RMS) from its f32 result, and a near-tied top-2 routing can
    flip in either package. The port rounds where the JAX modules round,
    so its bf16 output is held to the JAX bf16 output: no further from it
    than 1.5x the distance bf16 compute alone puts between the JAX bf16 and
    f32 outputs (4.30e-2 against 3.62e-2 here; 5.53e-2 with PyTorch's own
    bf16 roundings of the activations, the Dense bias and the scalars)."""
    monkeypatch.setenv("MOE_FUSED_KERNEL", "1")
    x, ts, lengths, ids = _denoiser_inputs(16)

    def jax_out(dt):
        jm = JaxMotionTransformer(tiny_model_config(
            dt, num_layers=1, latent_dim=128, ff_size=128,
            use_fast_xattn=True))
        return np.asarray(jax.jit(lambda p, *a: jm.apply(
            {"params": p}, *a[:3], text_ids=a[3],
            mutable=["moe_losses", "moe_metrics"])[0])(params, x, ts,
                                                       lengths, ids))

    cfg = tiny_model_config(dtype, num_layers=1, latent_dim=128,
                            ff_size=128, use_fast_xattn=True)
    params = random_params(JaxMotionTransformer(cfg), x, ts, lengths,
                           text_ids=ids, seed=4)
    ref = jax_out(dtype)
    calls = {"moe": 0, "xattn": 0}

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TM, "moe_dense_fused",
                        counted("moe", TM.moe_dense_fused))
    monkeypatch.setattr(TA, "xattn_fastlayout",
                        counted("xattn", TA.xattn_fastlayout))
    port = load_into(MotionTransformer(to_port(cfg)), params)
    with torch.no_grad():
        out = port(t(x), t(ts), t(lengths), text_ids=t(ids))
    # 2 blocks x 2 MoE branches; one exact cross-attention per block
    assert calls == {"moe": 4, "xattn": 2}
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    else:
        ref32 = jax_out("float32")
        assert rel_rms(out.numpy(), ref) <= 1.5 * rel_rms(ref, ref32)
