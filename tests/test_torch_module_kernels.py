"""Kernels 7-10 of the port and the module forms that carry kernels 7 and 8,
against the JAX package on the CPU.

On the CPU the port's wrappers run their plain versions, so these tests pin
the math that the CUDA kernels are held to on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase F):

- ``adaln_dense`` (kernel 7), ``favor_attention`` (8),
  ``flash_cross_attention`` (9) and ``favor_attention_full`` (10) against
  the JAX public op (on the CPU its pure-JAX reference) and against the
  Pallas TPU kernel run in interpret mode (``force_tpu_interpret_mode``);
- each op's gradients against ``jax.grad`` of the JAX op;
- ``StylizationBlock(fused=True)``, ``FastAttention`` and
  ``PerformerSelfAttention(fused=False)`` against the JAX modules through
  the bridge, masked, in f32 and bf16;
- the fused -> unfused graft of ``models/bridge.py`` (as
  ``tests/test_ops.py`` grafts in the JAX package), and a tiny denoiser with
  every style block fused and every Performer unfused against the standard
  JAX denoiser with the same weights.

Tolerances. f32: the same f32 math in another summation order -> 1e-5
(absolute and relative). bf16 ops: the port, the CUDA kernels and the TPU
kernels round the same f32-summed values once; a value whose f32 sums land
on either side of a rounding boundary differs by one bf16 ulp -> one ulp of
the reference plus 2^-12 of its largest magnitude. The JAX CPU references of
kernels 7 and 9 round one more time than the TPU kernels (the product before
``+ b``; the probabilities before ``probs @ v``), so in bf16 those two are
held to an f32 computation of the TPU kernel's function on the same bf16
inputs, rounded once. bf16 ``FastAttention``: both sides round at the same
points (the L2 of ``attention.py:83-84`` in the compute dtype, the output
before the last LayerNorm, ``:104``), so the outputs agree bit for bit but
for flips from the f32 order of the LayerNorm and norm sums, each moving a
row by up to two ulps: at most 1% of the outputs may differ (without the
rounding at ``:104`` ~30% do; with the L2 in f32 ~5%), and the L2 alone is
held to JAX's row by row. bf16 style
block and Performer with every leaf drawn, nonzero biases included: the
port rounds where the JAX modules round (``tests/test_torch_rounding.py``),
so each is held to the JAX f32 result (no farther from it than 1.5x the
JAX bf16 module is) and to the JAX bf16 module itself. The fused style
block, whose JAX CPU reference rounds once more than its TPU kernel (the
product before ``+ b``), is compared with the JAX module running that
Pallas kernel in interpret mode: at most 1% of the values one ulp apart,
none further (all equal here), given h in bf16; given h in f32 the output
is f32, the same sums at 1e-5. The unfused
Performer: its attention output, the input of ``proj_out_0``, as bf16
``FastAttention`` above (the port's equals JAX's but for the rare flips of
the f32 sums, while running the unfused form through the fused one, kernel 1
on the three weights concatenated, changes 38-54% of those values, and
scaling the heads by 0.1 unrounded, where JAX multiplies by the weakly
typed 0.1 in bf16, 58%); past it those flips feed the next products and
spread to ~13% of the block's output, so the whole block is held to JAX's
bf16 result by relative RMS (6.5e-3 here; 9.8e-3 with PyTorch's own bf16
activations, Dense bias and scalars). That RMS margin lets one wrong
rounding past the attention through (F.silu or F.gelu alone pass it), so
the part past it is held by flips: fed the JAX module's attention output,
with x in bf16, the port's block gives JAX's bf16 output under the rule of
the other modules (all equal here), and fails it with PyTorch's silu (8.7%
of the values, up to 16 ulp), gelu (8.0%) or fused Dense bias.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.nn.functional import linear as F_linear

from motiondiffusion_moe_tpu.models import attention as JA
from motiondiffusion_moe_tpu.models import embeddings as JE
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu.ops import adaln_pallas
from motiondiffusion_moe_tpu.ops.adaln_pallas import (
    _adaln_pallas,
    adaln_dense as jax_adaln,
)
from motiondiffusion_moe_tpu.ops.flash_attention import (
    _flash_pallas,
    flash_cross_attention as jax_flash,
)
from motiondiffusion_moe_tpu.ops.performer_pallas import (
    _favor_full_pallas,
    _favor_pallas,
    favor_attention as jax_favor,
    favor_attention_full as jax_favor_full,
)
from motiondiffusion_moe_tpu_torch import ops as port_ops
from motiondiffusion_moe_tpu_torch.models import attention as TA
from motiondiffusion_moe_tpu_torch.models import embeddings as TE
from motiondiffusion_moe_tpu_torch.models.bridge import (
    jax_to_state_dict,
    unfuse_performers,
)
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.ops.adaln import (
    adaln_dense,
    adaln_dense_plain,
)
from motiondiffusion_moe_tpu_torch.ops.flash_attention import (
    flash_cross_attention,
    flash_cross_attention_plain,
)
from motiondiffusion_moe_tpu_torch.ops.performer import (
    favor_attention,
    favor_attention_full,
    favor_attention_plain,
    favor_full_plain,
)

from tests._torch_parity import (
    adaln_as_the_tpu_kernel,
    assert_bf16_close,
    assert_bf16_flips,
    bf16_flips,
    load_into,
    perturb_zero_leaves,
    random_params,
    rel_rms,
    t,
    tiny_model_config,
    to_port,
)

F32_TOL = 1e-5
BF16_FLIP_SHARE = 0.01
BF16_L2_ROW_SHARE = 0.01
BF16_MODULE_FACTOR = 1.5
BF16_MODULE_REL_RMS = 5e-4
BF16_PERFORMER_REL_RMS = 7.5e-3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _n(*shape, seed=0, s=1.0, off=0.0):
    return (off + s * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a) -> np.ndarray:
    """numpy f32 values rounded to bf16 (round to nearest even)."""
    return _f32(jnp.asarray(a).astype(jnp.bfloat16))


def _close(out, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert_bf16_close(out, ref)


def _interpret(fn, *args):
    """A Pallas TPU kernel run on the CPU in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        return _f32(fn(*args))


def test_ops_package_exports_the_jax_packages_names():
    from motiondiffusion_moe_tpu import ops as jax_ops

    assert port_ops.favor_attention is favor_attention
    assert port_ops.flash_cross_attention is flash_cross_attention
    assert port_ops.favor_attention_plain is favor_attention_plain
    assert port_ops.flash_cross_attention_plain is (
        flash_cross_attention_plain)
    for name in ("favor_attention", "flash_cross_attention"):
        assert hasattr(jax_ops, name)


# ---------------------------------------------------------------- kernel 7

def _adaln_inputs(B=2, T=9, D=128, Dout=64):
    return [_n(B, T, D, seed=1), _n(B, D, seed=2, s=0.3),
            _n(B, D, seed=3, s=0.3), _n(D, seed=4, s=0.1, off=1.0),
            _n(D, seed=5, s=0.1), _n(D, Dout, seed=6, s=D ** -0.5),
            _n(Dout, seed=7, s=0.1)]


def _adaln_args(args, dtype, framework):
    """The LayerNorm vectors stay f32, as the modules pass them."""
    if framework == "jax":
        jdt = DTYPES[dtype][0]
        return [jnp.asarray(a) if i in (3, 4) else jnp.asarray(a).astype(jdt)
                for i, a in enumerate(args)]
    tdt = DTYPES[dtype][1]
    return [t(a) if i in (3, 4) else t(a).to(tdt) for i, a in enumerate(args)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adaln_dense_matches_jax(dtype):
    args = _adaln_inputs()
    out = adaln_dense_plain(*_adaln_args(args, dtype, "torch"))
    assert out.dtype == DTYPES[dtype][1] and out.shape == (2, 9, 64)
    assert torch.equal(out, adaln_dense(*_adaln_args(args, dtype, "torch")))
    out = out.float().numpy()
    jargs = _adaln_args(args, dtype, "jax")
    _close(out, _interpret(_adaln_pallas, *jargs), dtype)
    if dtype == "float32":
        _close(out, _f32(jax_adaln(*jargs)), dtype)
        return
    # the reference rounds twice in bf16: hold the op to the TPU kernel's
    # function computed in f32 on the same bf16 inputs, rounded once
    h, sc, sh, lns, lnb, w, b = [a if i in (3, 4) else _bf16(a)
                                 for i, a in enumerate(args)]
    mu = h.mean(-1, keepdims=True)
    var = ((h - mu) ** 2).mean(-1, keepdims=True)
    mod = ((h - mu) / np.sqrt(var + 1e-6) * lns + lnb) * (
        1 + sc[:, None]) + sh[:, None]
    act = _bf16(mod / (1 + np.exp(-mod)))
    assert_bf16_close(out, _bf16(act.astype(np.float64) @ w + b))


def test_adaln_dense_grad_matches_jax():
    args = _adaln_inputs(T=5, D=64, Dout=32)
    w = _n(2, 5, 32, seed=8)
    expect = jax.grad(lambda *a: jnp.sum(jax_adaln(*a) * w),
                      argnums=tuple(range(7)))(*map(jnp.asarray, args))
    xs = [t(a).requires_grad_() for a in args]
    (adaln_dense(*xs) * t(w)).sum().backward()
    for x, e in zip(xs, expect):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(e),
                                   atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------- kernel 8

def _heads(B=2, H=2, T=10, D=16, seed=10):
    """q, k, v [B, H, T, D] as FastAttention hands them to the core: q and k
    rows L2-normalised."""
    q, k, v = (_n(B, H, T, D, seed=seed + i) for i in range(3))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    return q, k, v


def _head_mask(B=2, T=10):
    return (np.arange(T)[None] < np.array([T, 6])[:, None]).astype(
        np.float32)[:, None, :]


@pytest.mark.parametrize("masked", [True, False])
def test_favor_attention_matches_jax(masked):
    q, k, v = _heads()
    proj = _n(16, 32, seed=13, s=16 ** -0.25)
    mask = _head_mask() if masked else None
    out = favor_attention_plain(t(q), t(k), t(v), t(proj),
                                None if mask is None else t(mask))
    assert out.dtype == torch.float32 and out.shape == q.shape
    via = favor_attention(t(q), t(k), t(v), t(proj),
                          None if mask is None else t(mask))
    assert torch.equal(out, via)
    out = out.numpy()
    _close(out, _f32(jax_favor(q, k, v, proj, mask)), "float32")
    jmask = jnp.ones((2, 1, 10)) if mask is None else jnp.asarray(mask)
    _close(out, _interpret(_favor_pallas, q, k, v, proj, jmask, 1e-6),
           "float32")


def test_favor_attention_grad_matches_jax():
    q, k, v = _heads(T=7, seed=20)
    proj = _n(16, 32, seed=23, s=16 ** -0.25)
    mask = _head_mask(T=7)
    w = _n(*q.shape, seed=24)
    expect = jax.grad(lambda *a: jnp.sum(jax_favor(*a, mask) * w),
                      argnums=(0, 1, 2, 3))(q, k, v, proj)
    xs = [t(a).requires_grad_() for a in (q, k, v, proj)]
    (favor_attention(*xs, t(mask)) * t(w)).sum().backward()
    for x, e in zip(xs, expect):
        # the masked rows' small denominators make gradients of ~1e4:
        # f32 order differences scale with the largest
        e = np.asarray(e)
        np.testing.assert_allclose(x.grad.numpy(), e,
                                   atol=F32_TOL * np.abs(e).max())


# ---------------------------------------------------------------- kernel 10

def _full_inputs(B=2, T=10, H=2, D=16, m=32):
    mask = (np.arange(T)[None] < np.array([T, 6])[:, None]).astype(
        np.float32)
    return ([_n(B, T, H * D, seed=30 + i) for i in range(3)]
            + [_n(D, seed=33, s=0.1, off=1.0), _n(D, seed=34, s=0.1),
               _n(D, m, seed=35, s=D ** -0.25), mask])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_favor_attention_full_matches_jax(dtype):
    """The JAX reference rounds once, at the end, as the kernels do."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, s, b, proj, mask = _full_inputs()
    port_args = [t(a).to(tdt) for a in (q, k, v)] + [
        t(a) for a in (s, b, proj, mask)]
    out = favor_full_plain(*port_args)
    assert out.dtype == tdt and out.shape == q.shape
    assert torch.equal(out, favor_attention_full(*port_args))
    out = out.float().numpy()
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [
        jnp.asarray(a) for a in (s, b, proj, mask)]
    _close(out, _f32(jax_favor_full(*jargs)), dtype)
    _close(out, _interpret(_favor_full_pallas, *jargs, 1e-6, 0.1), dtype)


def test_favor_attention_full_grad_matches_jax():
    args = _full_inputs(T=6)
    w = _n(2, 6, 32, seed=36)
    expect = jax.grad(
        lambda *a: jnp.sum(jax_favor_full(*a, args[6]) * w),
        argnums=tuple(range(6)))(*map(jnp.asarray, args[:6]))
    xs = [t(a).requires_grad_() for a in args[:6]]
    (favor_attention_full(*xs, t(args[6])) * t(w)).sum().backward()
    for x, e in zip(xs, expect):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(e),
                                   atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------- kernel 9

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cross_attention_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _n(2, 2, 24, 16, seed=40), _n(2, 2, 16, 16, seed=41), _n(
        2, 2, 16, 16, seed=42)
    out = flash_cross_attention_plain(*(t(a).to(tdt) for a in (q, k, v)))
    assert out.dtype == tdt and out.shape == q.shape
    assert torch.equal(out, flash_cross_attention(
        *(t(a).to(tdt) for a in (q, k, v)), block_n=8))
    out = out.float().numpy()
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    # the TPU kernel: queries in tiles of 8, keys in blocks of 8
    _close(out, _interpret(_flash_pallas, *jargs, 16 ** -0.5, 8, 8), dtype)
    if dtype == "float32":
        _close(out, _f32(jax_flash(*jargs)), dtype)
        return
    # the reference rounds the probabilities in bf16: hold the op to the
    # TPU kernel's function in f32 on the same bf16 inputs, rounded once
    qb, kb, vb = _bf16(q), _bf16(k), _bf16(v)
    s = np.einsum("bhtd,bhnd->bhtn", qb * 16 ** -0.5, kb)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    assert_bf16_close(out, _bf16(np.einsum("bhtn,bhnd->bhtd", p, vb)))


def test_flash_cross_attention_any_number_of_keys():
    """A ragged tail of keys and a scale: the plain version against the
    JAX op (on the CPU its reference)."""
    q, k, v = _n(1, 3, 11, 32, seed=43), _n(1, 3, 37, 32, seed=44), _n(
        1, 3, 37, 32, seed=45)
    out = flash_cross_attention(t(q), t(k), t(v), scale=0.3, block_n=16)
    _close(out.numpy(), _f32(jax_flash(q, k, v, 0.3, 128, 16)), "float32")


def test_flash_cross_attention_grad_matches_jax():
    q, k, v = _n(2, 2, 6, 8, seed=46), _n(2, 2, 5, 8, seed=47), _n(
        2, 2, 5, 8, seed=48)
    w = _n(2, 2, 6, 8, seed=49)
    expect = jax.grad(lambda *a: jnp.sum(jax_flash(*a) * w),
                      argnums=(0, 1, 2))(q, k, v)
    xs = [t(a).requires_grad_() for a in (q, k, v)]
    (flash_cross_attention(*xs) * t(w)).sum().backward()
    for x, e in zip(xs, expect):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(e),
                                   atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------- modules

B, T, D, H, M, TED = 2, 10, 64, 2, 32, 256


def _mask():
    return (np.arange(T)[None] < np.array([T, 6])[:, None]).astype(
        np.float32)


def _both(jmod, port_cls, jax_args, port_args, dtype, adjust=None,
          **port_kw):
    """The JAX module in f32 and in ``dtype``, and the port's in ``dtype``,
    with one seeded flax tree (changed by ``adjust`` if given); returns
    (jax f32, jax dtype, port dtype)."""
    params = random_params(jmod(jnp.float32), *jax_args)
    if adjust is not None:
        params = adjust(jax.tree_util.tree_map(np.asarray, params))
    outs = []
    for jdt in (jnp.float32, DTYPES[dtype][0]):
        mod = jmod(jdt)
        outs.append(_f32(jax.jit(lambda p, *a: mod.apply({"params": p}, *a))(
            params, *jax_args)))
    port = load_into(port_cls(DTYPES[dtype][1], **port_kw), params)
    with torch.no_grad():
        outs.append(port(*port_args).float().numpy())
    return outs


def _check_module(ref32, ref, out, dtype, residual=0.0, held="bits"):
    """f32: the JAX f32 output at 1e-5. bf16 compute: no farther from the
    JAX f32 result than 1.5x the JAX bf16 module is, and held to the JAX
    bf16 module's output itself (see the module doc): "bits", a bf16 output,
    at most 1% of the values one ulp apart and none further; "f32", an f32
    output of the same bf16 operands, at 1e-5; "rel_rms", the residual
    branch by relative RMS."""
    if dtype == "float32":
        np.testing.assert_allclose(out, ref32, atol=F32_TOL)
        return
    far = rel_rms(ref - residual, ref32 - residual)
    assert rel_rms(out - residual, ref32 - residual) <= (
        BF16_MODULE_FACTOR * far)
    if held == "bits":
        assert_bf16_flips(out, ref)
    elif held == "f32":
        np.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert rel_rms(out - residual, ref - residual) <= (
            BF16_PERFORMER_REL_RMS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stylization_block_fused(dtype, monkeypatch):
    monkeypatch.setattr(adaln_pallas, "adaln_dense", adaln_as_the_tpu_kernel)
    h, emb = _n(B, T, D), _n(B, D, seed=1)
    ref32, ref, out = _both(
        lambda dt: JE.StylizationBlock(latent_dim=D, time_embed_dim=TED,
                                       dropout=0.0, dtype=dt, fused=True),
        lambda dt: TE.StylizationBlock(D, TED, D, dt, fused=True),
        [h, emb], [t(h), t(emb)], dtype)
    _check_module(ref32, ref, out, dtype, held="f32")  # out in h's dtype
    if dtype == "float32":
        return
    # h in bf16, as a bf16 denoiser hands it over
    _, ref, out = _both(
        lambda dt: JE.StylizationBlock(latent_dim=D, time_embed_dim=TED,
                                       dropout=0.0, dtype=dt, fused=True),
        lambda dt: TE.StylizationBlock(D, TED, D, dt, fused=True),
        [jnp.asarray(h).astype(jnp.bfloat16), emb],
        [t(h).bfloat16(), t(emb)], dtype)
    assert_bf16_flips(out, ref)


def test_stylization_block_fused_takes_the_kernel_only_without_dropout(
        monkeypatch):
    calls = []
    real = TE.adaln_dense
    monkeypatch.setattr(TE, "adaln_dense",
                        lambda *a: calls.append(1) or real(*a))
    block = TE.StylizationBlock(D, TED, D, fused=True, dropout=0.1)
    h, emb = t(_n(B, T, D)), t(_n(B, D, seed=1))
    block.eval()
    block(h, emb)
    block.fused = False
    block(h, emb)
    block.fused = True
    block.train()
    gen = torch.Generator().manual_seed(0)
    from motiondiffusion_moe_tpu_torch.models.layers import TrainContext
    block(h, emb, ctx=TrainContext(gen))
    # pre_ln (the Performer epilogue) comes first, as in JAX
    block.eval()
    block(h, emb, pre_ln=(torch.ones(D), torch.zeros(D)))
    assert calls == [1]


@pytest.mark.parametrize("mask_shape", ["[B, T, 1]", "[B, T]"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_attention(dtype, mask_shape):
    hd = D // H
    q, k, v = (_n(B, H, T, hd, seed=50 + i) for i in range(3))
    mask = _mask()
    port_mask = t(mask[..., None] if mask_shape == "[B, T, 1]" else mask)
    jdt, tdt = DTYPES[dtype]
    params = random_params(JA.FastAttention(head_dim=hd, num_features=M),
                           q, k, v, mask=mask[..., None])
    jmod = JA.FastAttention(head_dim=hd, num_features=M, dtype=jdt)
    ref = _f32(jmod.apply({"params": params},
                          *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                          mask=mask[..., None]))
    port = load_into(TA.FastAttention(hd, M, dtype=tdt), params)
    with torch.no_grad():
        out = port(*(t(a).to(tdt) for a in (q, k, v)), port_mask)
        port.use_pallas = False
        plain = port(*(t(a).to(tdt) for a in (q, k, v)), port_mask)
    assert out.dtype == tdt and torch.equal(out, plain)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=F32_TOL)
    else:
        assert_bf16_close(out, ref, ulps=2)
        assert (out != ref).mean() <= BF16_FLIP_SHARE


def test_fast_attention_l2_rounds_like_jax():
    """``attention.py:83-84`` in bf16, as XLA computes it: the squares
    and their sum in f32, the sum rounded to bf16 before the square root.
    Only a row whose f32 sums land on either side of a rounding boundary
    may differ (none here); rounding the squares to bf16 first changes 5%
    of the rows, ``torch.linalg.vector_norm`` 13%, an f32 L2 93%."""
    x = _n(8, 50, 32, seed=55)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = _f32(xj / jnp.maximum(jnp.linalg.norm(xj, axis=-1, keepdims=True),
                                1e-12))
    out = TA._l2_compute_dtype(t(x).bfloat16()).float().numpy()
    assert (out != ref).any(-1).mean() <= BF16_L2_ROW_SHARE


def _performer_kw():
    return dict(latent_dim=D, num_heads=H, dropout=0.0, time_embed_dim=TED,
                num_features=M, fused=False)


def _performer_params(x, emb, mask, qkv_scale):
    """A seeded flax tree of the unfused Performer, every leaf drawn, the
    query, key and value kernels and biases scaled by ``qkv_scale``."""
    params = jax.tree_util.tree_map(np.asarray, random_params(
        JA.PerformerSelfAttention(**_performer_kw()), x, emb,
        mask[..., None]))
    for name in ("query", "key", "value"):
        params[name]["kernel"] = params[name]["kernel"] * qkv_scale
        params[name]["bias"] = params[name]["bias"] * qkv_scale
    return params


def _jax_attention_output(state) -> np.ndarray:
    """proj_out_0's input, [B, T, D], from captured JAX intermediates."""
    return _f32(state["intermediates"]["fast_attention"]["__call__"][0]
                .transpose(0, 2, 1, 3).reshape(B, T, D))


def _performer_tail(qkv_scale):
    """The bf16 unfused Performer past its attention output, x in bf16 (as
    a bf16 denoiser hands it over): (the port's output with the JAX
    module's attention output fed to proj_out_0, the JAX module's
    output)."""
    x, emb, mask = _n(B, T, D), _n(B, D, seed=1), _mask()
    params = _performer_params(x, emb, mask, qkv_scale)
    jmod = JA.PerformerSelfAttention(**_performer_kw(), dtype=jnp.bfloat16)
    ref, state = jmod.apply({"params": params}, jnp.asarray(x, jnp.bfloat16),
                            emb, mask[..., None], capture_intermediates=True)
    attn = t(_jax_attention_output(state)).bfloat16()
    port = load_into(TA.PerformerSelfAttention(
        D, H, TED, M, dtype=torch.bfloat16, fused=False), params)
    port.proj_out_0.register_forward_pre_hook(
        lambda mod, args: (attn,) + args[1:])
    with torch.no_grad():
        out = port(t(x).bfloat16(), t(emb), t(mask))
    assert out.dtype == torch.bfloat16
    return out.float().numpy(), _f32(ref)


@pytest.mark.parametrize("qkv_scale", [1.0, 1e-3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_performer_unfused(dtype, qkv_scale):
    """``qkv_scale`` 1e-3 shrinks the query, key and value kernels until
    the head scaling by 0.1 (``attention.py:190``) meets FastAttention's
    LayerNorm eps: at larger scales the LayerNorm and L2 that follow cancel
    it."""
    x, emb, mask = _n(B, T, D), _n(B, D, seed=1), _mask()

    def adjust(params):
        for name in ("query", "key", "value"):
            params[name]["kernel"] = params[name]["kernel"] * qkv_scale
            params[name]["bias"] = params[name]["bias"] * qkv_scale
        return params

    ref32, ref, out = _both(
        lambda dt: JA.PerformerSelfAttention(**_performer_kw(), dtype=dt),
        lambda dt: TA.PerformerSelfAttention(D, H, TED, M, dtype=dt,
                                             fused=False),
        [x, emb, mask[..., None]], [t(x), t(emb), t(mask)], dtype, adjust)
    _check_module(ref32, ref, out, dtype, residual=x, held="rel_rms")
    if dtype == "float32":
        return

    # the attention output (proj_out_0's input) against the JAX bf16
    # module's, every leaf drawn (see the module doc)
    params = _performer_params(x, emb, mask, qkv_scale)
    jmod = JA.PerformerSelfAttention(**_performer_kw(), dtype=jnp.bfloat16)
    _, state = jmod.apply({"params": params}, x, emb, mask[..., None],
                          capture_intermediates=True)
    ref = _jax_attention_output(state)
    port = load_into(TA.PerformerSelfAttention(
        D, H, TED, M, dtype=torch.bfloat16, fused=False), params)
    seen = []
    port.proj_out_0.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0]))
    with torch.no_grad():
        port(t(x), t(emb), t(mask))
    out = seen[0].float().numpy()
    assert_bf16_close(out, ref, ulps=2)
    assert (out != ref).mean() <= BF16_FLIP_SHARE
    assert rel_rms(out, ref) <= BF16_MODULE_REL_RMS
    # past it, given JAX's attention output: the rule of the other modules
    assert_bf16_flips(*_performer_tail(qkv_scale))


@pytest.mark.parametrize("mutation", ["F.silu", "F.gelu", "fused Dense bias"])
def test_performer_tail_fails_with_pytorchs_roundings(mutation, monkeypatch):
    """The mutations the Performer's bf16 check must catch past the
    attention output (the relative RMS of the whole block lets F.silu and
    F.gelu through): the style block's silu, proj_out_0's gelu and the
    Dense bias, each as PyTorch rounds it."""
    from motiondiffusion_moe_tpu_torch.models import layers as TL
    from motiondiffusion_moe_tpu_torch.ops import activations as ACT

    def plus(x, bias):
        return x if bias is None else x + bias.to(x.dtype)

    if mutation == "F.silu":
        silu = lambda x, bias=None: torch.nn.functional.silu(  # noqa: E731
            plus(x, bias))
        monkeypatch.setattr(ACT, "silu", silu)
        monkeypatch.setattr(TE, "silu", silu)
    elif mutation == "F.gelu":
        monkeypatch.setattr(ACT, "gelu", lambda x, bias=None: (
            torch.nn.functional.gelu(plus(x, bias), approximate="tanh")))
    else:
        monkeypatch.setattr(TL.Dense, "forward", lambda self, x, act=None: (
            lambda y: y if act is None else getattr(ACT, act)(y))(F_linear(
                x.to(self.dtype), self.weight.to(self.dtype),
                self.bias.to(self.dtype))))
    out, ref = _performer_tail(1.0)
    flipped, worst = bf16_flips(out, ref)
    assert flipped > BF16_FLIP_SHARE or worst > 1.0


def test_port_graft_fused_equals_unfused():
    """The port's own graft (``unfuse_performers``), as ``tests/test_ops.py``
    grafts the JAX forms: the same outputs at atol 1e-5, with the style
    block fused as well."""
    x, emb, mask = t(_n(B, T, D)), t(_n(B, D, seed=1)), t(_mask())

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = TA.PerformerSelfAttention(D, H, TED, M)

    holder = Holder()
    params = perturb_zero_leaves(random_params(
        JA.PerformerSelfAttention(latent_dim=D, num_heads=H, dropout=0.0,
                                  time_embed_dim=TED, num_features=M),
        _n(B, T, D), _n(B, D, seed=1), _mask()[..., None]))
    load_into(holder.attn, params)
    with torch.no_grad():
        fused = holder.attn(x, emb, mask)
        unfuse_performers(holder)
        assert not holder.attn.fused
        unfused = holder.attn(x, emb, mask)
        holder.attn.style_block.fused = True
        both = holder.attn(x, emb, mask)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), atol=1e-5)
    np.testing.assert_allclose(both.numpy(), fused.numpy(), atol=1e-5)


@pytest.mark.parametrize("form", ["style fused", "performers unfused",
                                  "both"])
def test_tiny_denoiser_with_the_module_forms(form):
    """The standard JAX denoiser's weights in the port's denoiser with its
    style blocks fused and / or its Performers unfused (grafted): f32
    outputs equal the JAX denoiser's."""
    cfg = tiny_model_config()
    x = _n(B, 16, 26, seed=60)
    ts = np.array([3, 77], np.int32)
    length = np.array([16, 9], np.int32)
    ids = np.random.default_rng(61).integers(1, 500, (B, 12)).astype(
        np.int32)
    jmod = JaxMotionTransformer(cfg)
    params = perturb_zero_leaves(random_params(
        jmod, jnp.zeros((1, 16, 26)), jnp.zeros((1,), jnp.int32),
        jnp.asarray([16]), text_ids=jnp.ones((1, 12), jnp.int32)))
    ref = _f32(jmod.apply({"params": params}, x, ts, length, text_ids=ids))
    model = MotionTransformer(to_port(cfg))
    model.load_state_dict(jax_to_state_dict(params), strict=True)
    model.eval()
    if form != "style fused":
        unfuse_performers(model)
        assert not any(isinstance(m, TA.PerformerSelfAttention) and m.fused
                       for m in model.modules())
    if form != "performers unfused":
        for m in model.modules():
            if isinstance(m, TE.StylizationBlock):
                m.fused = True
    with torch.no_grad():
        out = model(t(x), t(ts).long(), t(length).long(),
                    text_ids=t(ids).long()).numpy()
        model.set_use_kernels(False)
        plain = model(t(x), t(ts).long(), t(length).long(),
                      text_ids=t(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(plain, ref, atol=F32_TOL, rtol=F32_TOL)
