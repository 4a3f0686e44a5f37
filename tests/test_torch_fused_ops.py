"""The fused-MoE and fast cross-attention ops of the port, and the modules
that route through them, against the JAX package on the CPU.

On the CPU the port's wrappers run their plain versions, so these tests pin
the math that the CUDA kernels are held to on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase E):

- ``moe_dense_fused_plain`` against the Pallas kernel in interpret mode and
  ``moe_dense_fused_reference``; ``xattn_fastlayout_plain`` against the JAX
  ``xattn_fastlayout`` (on the CPU its reference);
- the autograd of each wrapper against ``jax.grad`` of the JAX wrapper;
- ``CrossAttentionBlock(use_fast_xattn=True)`` and ``SwitchMoELayer`` under
  ``MOE_FUSED_KERNEL=1`` through the bridge, in f32 and bf16.

Tolerances. f32: the same f32 math in another summation order -> 1e-5
(absolute and relative). bf16 ops: both sides round the same f32-summed
values once; a value whose f32 sums land on either side of a rounding
boundary differs by one bf16 ulp, and in the MoE such a flip of one rounded
hidden activation moves the output by one ulp of that term (~2e-4 of the
largest output) -> one ulp of the JAX value plus 2^-12 of its largest
magnitude. bf16 modules: the forms that round the probabilities (einsum
path) or the hidden chain (inline MoE) to bf16 before the second product
differ from the fused forms by 3.5e-3 / 4.8e-3 relative RMS here, so the
modules are held to 5e-4 relative RMS of the residual branch. The port's
Dense adds its bias after rounding the product, as flax does, so the biases
feeding the fused ops are drawn, the MoE router's too: XLA's compiled
program widens the gate's output to f32 for the softmax straight after the
bias add and leaves that add's bf16 rounding out, and so does the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.models import attention as JA
from motiondiffusion_moe_tpu.models import moe as JM
from motiondiffusion_moe_tpu.ops.flash_attention import (
    xattn_fastlayout as jax_xattn,
)
from motiondiffusion_moe_tpu.ops.moe_pallas import (
    _moe_pallas,
    moe_dense_fused as jax_moe,
    moe_dense_fused_reference,
)
from motiondiffusion_moe_tpu_torch.models import attention as TA
from motiondiffusion_moe_tpu_torch.models import moe as TM
from motiondiffusion_moe_tpu_torch.ops.flash_attention import (
    xattn_fastlayout,
    xattn_fastlayout_plain,
)
from motiondiffusion_moe_tpu_torch.ops.moe import (
    moe_dense_fused,
    moe_dense_fused_plain,
)

from tests._torch_parity import (
    assert_bf16_close,
    assert_bf16_flips,
    load_into,
    random_params,
    rel_rms,
    t,
)

F32_TOL = 1e-5
MODULE_BF16_REL_RMS = 5e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------- MoE op

def _moe_inputs(S, D=128, E=4, hid=128, seed=0):
    """x, top-2 combine weights, and the experts' weights as the port
    stores them (w1 [E, D, hid], b1 [E, hid], w2 [E, hid, D], b2 [E, D])."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, D)).astype(np.float32)
    p = np.exp(rng.standard_normal((S, E)))
    p /= p.sum(-1, keepdims=True)
    idx = np.argsort(-p, -1, kind="stable")[:, :2]
    combine = np.zeros((S, E), np.float32)
    np.put_along_axis(combine, idx, np.take_along_axis(p, idx, -1), -1)
    w1 = 0.05 * rng.standard_normal((E, D, hid))
    b1 = 0.1 * rng.standard_normal((E, hid))
    w2 = 0.05 * rng.standard_normal((E, hid, D))
    b2 = 0.1 * rng.standard_normal((E, D))
    return [a.astype(np.float32) for a in (x, combine, w1, b1, w2, b2)]


def _jax_moe_args(args, dtype):
    """The JAX op's merged layout: w1m [D, E*hid], b1r [1, E*hid],
    w2m [E*hid, D]."""
    x, combine, w1, b1, w2, b2 = args
    E, D, hid = w1.shape
    merged = (x, combine, np.transpose(w1, (1, 0, 2)).reshape(D, E * hid),
              b1.reshape(1, E * hid), w2.reshape(E * hid, D), b2)
    return [jnp.asarray(a).astype(dtype) for a in merged]


@pytest.mark.parametrize("S", [96, 600])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense_fused_plain_matches_jax(S, dtype):
    jdt, tdt = DTYPES[dtype]
    args = _moe_inputs(S)
    jargs = _jax_moe_args(args, jdt)
    ref = _f32(moe_dense_fused_reference(*jargs))
    kernel = _f32(_moe_pallas(*jargs, interpret=True))
    out = moe_dense_fused_plain(*[t(a).to(tdt) for a in args])
    assert out.dtype == tdt and out.shape == (S, 128)
    via_wrapper = moe_dense_fused(*[t(a).to(tdt) for a in args])
    assert torch.equal(out, via_wrapper)  # CPU tensors: the plain version
    out = out.float().numpy()
    for r in (ref, kernel):
        if dtype == "float32":
            np.testing.assert_allclose(out, r, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert_bf16_close(out, r)


def test_moe_dense_fused_grad_matches_jax():
    args = _moe_inputs(48)
    w = np.random.default_rng(9).standard_normal((48, 128)).astype(
        np.float32)
    grads = jax.grad(lambda *a: jnp.sum(jax_moe(*a) * w),
                     argnums=tuple(range(6)))(*_jax_moe_args(args,
                                                             jnp.float32))
    E, D, hid = args[2].shape
    # back from the merged layout to the stored one
    expect = [np.asarray(grads[0]), np.asarray(grads[1]),
              np.asarray(grads[2]).reshape(D, E, hid).transpose(1, 0, 2),
              np.asarray(grads[3]).reshape(E, hid),
              np.asarray(grads[4]).reshape(E, hid, D), np.asarray(grads[5])]
    xs = [t(a).requires_grad_() for a in args]
    (moe_dense_fused(*xs) * t(w)).sum().backward()
    for x, e in zip(xs, expect):
        np.testing.assert_allclose(x.grad.numpy(), e, atol=F32_TOL,
                                   rtol=F32_TOL)


# ---------------------------------------------------------------- xattn op

def _xattn_inputs(B=2, T=24, N=11, H=2, D=64, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H * D), (B, N, H * D), (B, N, H * D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xattn_fastlayout_plain_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    H, D = 2, 64
    q, k, v = _xattn_inputs(H=H, D=D)
    ref = _f32(jax_xattn(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                         H, D ** -0.5))
    out = xattn_fastlayout_plain(*(t(a).to(tdt) for a in (q, k, v)), H)
    assert out.dtype == tdt and out.shape == q.shape
    assert torch.equal(out, xattn_fastlayout(
        *(t(a).to(tdt) for a in (q, k, v)), H))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL)
    else:
        assert_bf16_close(out.float().numpy(), ref)


def _split_p_attention(q, k, v, num_heads, scale, terms):
    """The arithmetic of the bf16 kernel (``csrc/cross_attention_mma.cu``)
    in torch: per head, scores as f32 sums of bf16 products, times the
    scale after the sum; an online softmax over blocks of 32 keys; p split
    into ``terms`` bf16 terms (2: p_hi + p_lo; 1: p rounded to bf16, as
    ``scaled_dot_product_attention`` does) before ``p @ v`` in f32; one
    rounding of the output. (The kernel's exp2 of log2(e)-scaled scores
    and its reciprocal of the row sum differ from this by f32 roundings.)"""
    B, T, HD = q.shape
    D = HD // num_heads
    qh, kh, vh = (x.view(B, -1, num_heads, D).transpose(1, 2).float()
                  for x in (q, k, v))
    m = torch.full((B, num_heads, T, 1), -torch.inf)
    l = torch.zeros(B, num_heads, T, 1)
    o = torch.zeros(B, num_heads, T, D)
    for n0 in range(0, k.shape[1], 32):
        s = qh @ kh[:, :, n0:n0 + 32].transpose(-1, -2) * scale
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - mn), torch.exp(s - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vh[:, :, n0:n0 + 32]
        if terms == 2:
            pv = pv + (p - hi).bfloat16().float() @ vh[:, :, n0:n0 + 32]
        o, m = o * alpha + pv, mn
    return (o / l).transpose(1, 2).reshape(B, T, HD).bfloat16()


def test_xattn_bf16_error_budget_of_the_split_probabilities():
    """The bf16 kernel's error budget at the flagship shape (B = 32,
    T = 196, N = 85, H = 4, D = 128), without the kernel: with p in two
    bf16 terms at most 1% of the outputs differ from the plain version
    (f32 throughout, one rounding), each by one ulp (0.20% here); with p
    rounded to one bf16 term 36% differ, by up to 36 ulps (near zero)."""
    B, T, N, H, D = 32, 196, 85, 4, 128
    q, k, v = (t(a).bfloat16() for a in _xattn_inputs(B, T, N, H, D,
                                                       seed=5))
    ref = xattn_fastlayout_plain(q, k, v, H, D ** -0.5).float().numpy()
    out = _split_p_attention(q, k, v, H, D ** -0.5, terms=2)
    assert_bf16_flips(out.float().numpy(), ref)
    one_term = _split_p_attention(q, k, v, H, D ** -0.5, terms=1)
    with pytest.raises(AssertionError):
        assert_bf16_flips(one_term.float().numpy(), ref)


def test_xattn_fastlayout_grad_matches_jax():
    H, D = 2, 32
    q, k, v = _xattn_inputs(B=1, T=8, N=5, H=H, D=D, seed=2)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    expect = jax.grad(lambda a, b, c: jnp.sum(
        jax_xattn(a, b, c, H, D ** -0.5) * w), argnums=(0, 1, 2))(q, k, v)
    xs = [t(a).requires_grad_() for a in (q, k, v)]
    (xattn_fastlayout(*xs, H) * t(w)).sum().backward()
    for x, e in zip(xs, expect):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(e),
                                   atol=F32_TOL)


# ---------------------------------------------------------------- modules

B, T, D, N, TL, H = 2, 10, 128, 20, 16, 2


def _n(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _zero_biases(params, names):
    params = jax.tree_util.tree_map(np.asarray, params)
    for n in names:
        params[n]["bias"] = np.zeros_like(params[n]["bias"])
    return params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_block_fast_path(dtype):
    """f32: all leaves drawn. bf16: the attention's output Dense the
    identity and the FFN's last Dense zero, so the block's residual branch
    is the attention itself (see the module doc)."""
    jdt, tdt = DTYPES[dtype]
    x, xf = _n(B, T, D), _n(B, N, TL, seed=1)
    jmod = JA.CrossAttentionBlock(latent_dim=D, text_latent_dim=TL,
                                  num_heads=H, dropout=0.0,
                                  use_fast_xattn=True, dtype=jdt)
    params = random_params(jmod, x, xf)
    if dtype == "bfloat16":
        params = _zero_biases(params, ("out", "ffn_1"))
        params["out"]["kernel"] = np.eye(D, dtype=np.float32)
        params["ffn_1"]["kernel"] = np.zeros_like(params["ffn_1"]["kernel"])
    ref = np.asarray(jax.jit(lambda p, a, b: jmod.apply(
        {"params": p}, a, b))(params, x, xf)).astype(np.float32)
    port = load_into(TA.CrossAttentionBlock(D, TL, H, tdt, 0.0,
                                            use_fast_xattn=True), params)
    with torch.no_grad():
        out = port(t(x), t(xf)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=F32_TOL)
    else:
        assert rel_rms(out - x, ref - x) <= MODULE_BF16_REL_RMS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_switch_moe_under_moe_fused_kernel(dtype, monkeypatch):
    """The JAX layer and the port's under MOE_FUSED_KERNEL=1, deterministic
    (eval): both take the fused form, every leaf drawn (the router's bias
    too, see the module doc)."""
    monkeypatch.setenv("MOE_FUSED_KERNEL", "1")
    jdt, tdt = DTYPES[dtype]
    x = _n(B, T, D, seed=2)
    jmod = JM.SwitchMoELayer(latent_dim=D, hidden_dim=128, num_experts=4,
                             top_k=2, dtype=jdt)
    params = random_params(jmod, x)
    assert np.abs(np.asarray(params["gate"]["bias"])).max() > 0
    ref = np.asarray(jax.jit(lambda p, a: jmod.apply(
        {"params": p}, a, mutable=["moe_metrics", "moe_losses"])[0])(
            params, x)).astype(np.float32)
    port = load_into(TM.SwitchMoELayer(D, 128, 4, 2, tdt), params)
    with torch.no_grad():
        out = port(t(x)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert rel_rms(out, ref) <= MODULE_BF16_REL_RMS
    # the routing condition: a training forward takes the inline chain
    port.train()
    calls = []
    fused = TM.moe_dense_fused
    monkeypatch.setattr(TM, "moe_dense_fused",
                        lambda *a: calls.append(1) or fused(*a))
    with torch.no_grad():
        port(t(x))
    port.eval()
    with torch.no_grad():
        port(t(x))
    monkeypatch.setenv("MOE_FUSED_KERNEL", "0")
    with torch.no_grad():
        port(t(x))
    assert calls == [1]
