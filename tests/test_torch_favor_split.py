"""The arithmetic of the tensor-core FAVOR+ kernels (``csrc/favor_qkv.cu``,
``csrc/favor_qkv_bwd.cu``) on the CPU, against the JAX package.

The kernels run every product on the tensor cores: 3xTF32 by default (each
operand split into hi = tf32(x) and lo = tf32(x - hi), the products
a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in f32), or one bf16 pass
under ``FAVOR_MXU_BF16=1``. No CUDA kernel runs here, so:

- the 3xTF32 products are emulated in torch (operands rounded to TF32 by
  masking the mantissa, as ``cvt.rna.tf32.f32`` rounds: to nearest, ties
  away from zero) and the plain versions run with them, forward and
  backward; they are held to the JAX kernel's f32 output (Pallas interpret
  mode) and the JAX VJP at the card's tolerances (``chip_smoke.py``: 1e-4
  of the largest output forward, 1e-3 of each gradient's largest value
  backward), and a single TF32 pass is shown to miss them;
- ``FAVOR_MXU_BF16=1`` is the JAX kernels' own switch: the port's plain
  versions with bf16 operands against the Pallas kernels with
  ``mxu_bf16=True`` in interpret mode, at the JAX tests' tolerance (2e-2
  of each output's largest value, ``tests/test_ops.py``,
  ``tests/test_ops_bwd.py``), and the wrappers read the switch per call,
  the backward following its forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from motiondiffusion_moe_tpu.ops.performer_pallas import (
    _favor_qkv_kernel_v2,
    favor_qkv_reference,
)
from motiondiffusion_moe_tpu.ops.performer_pallas_bwd import (
    favor_qkv_bwd_pallas,
)
from motiondiffusion_moe_tpu_torch.ops import performer as P

from tests._torch_parity import t

F32_REL = 1e-4    # chip_smoke.py F32_REL: forward, of max |output|
BWD_FLOOR = 1e-3  # chip_smoke.py BWD_FLOOR: backward, of max |gradient|
JAX_MXU_TOL = 2e-2  # tests/test_ops.py, tests/test_ops_bwd.py


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split3_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def _inputs(B, T, H, D, m, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, T, 3 * H * D)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    proj = (rng.standard_normal((D, m)) * D ** -0.25).astype(np.float32)
    lengths = np.array([T] + list(rng.integers(1, T + 1, size=B - 1)))
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    g = rng.standard_normal((B, T, H * D)).astype(np.float32)
    return qkv, scale, bias, proj, mask, g


def _favor_v2_interpret(qkv, scale, bias, proj, mask, mxu_bf16):
    """The production Pallas kernel (v2) in interpreter mode, as
    tests/test_ops.py builds it."""
    B, T, HD3 = qkv.shape
    D, m = proj.shape
    H = HD3 // (3 * D)
    projbd = jnp.kron(jnp.eye(H, dtype=proj.dtype), proj)
    return pl.pallas_call(
        functools.partial(_favor_qkv_kernel_v2, eps=1e-6, pre_scale=0.1,
                          num_heads=H, mxu_bf16=mxu_bf16),
        out_shape=jax.ShapeDtypeStruct((B, T, H * D), qkv.dtype),
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, T, HD3), lambda b: (b, 0, 0)),
            pl.BlockSpec((1, D), lambda b: (0, 0)),
            pl.BlockSpec((1, D), lambda b: (0, 0)),
            pl.BlockSpec((H * D, H * m), lambda b: (0, 0)),
            pl.BlockSpec((1, T, 1), lambda b: (b, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, T, H * D), lambda b: (b, 0, 0)),
        interpret=True,
    )(qkv, scale.reshape(1, D), bias.reshape(1, D), projbd,
      mask.reshape(B, T, 1))


def _jax_vjp(qkv, scale, bias, proj, mask, g):
    _, vjp = jax.vjp(lambda x, s, b, p: favor_qkv_reference(
        x, s, b, p, jnp.asarray(mask)), *map(jnp.asarray,
                                             (qkv, scale, bias, proj)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _worst(outs, refs):
    """max |out - ref| / max |ref| over a list of outputs."""
    return max(float(np.abs(o - r).max() / np.abs(r).max())
               for o, r in zip(outs, refs))


@pytest.fixture(scope="module", params=[37, 196], ids=["T37", "T196"])
def case(request):
    """B = 2, H = 2, D = m = 64; the JAX kernel's f32 output and the JAX
    VJP (d qkv, d ln_scale, d ln_bias, d projection)."""
    args = _inputs(2, request.param, 2, 64, 64, seed=request.param)
    qkv, scale, bias, proj, mask, g = args
    fwd = np.asarray(_favor_v2_interpret(*map(jnp.asarray, args[:5]),
                                         mxu_bf16=False))
    return args, fwd, _jax_vjp(*args)


def _port(args, product):
    qkv, scale, bias, proj, mask, g = (t(x) for x in args)
    out = P.favor_qkv_plain(qkv, scale, bias, proj, mask, product=product)
    grads = P.favor_qkv_bwd_plain(qkv, scale, bias, proj, mask, g,
                                  product=product)
    return out.numpy(), [x.numpy() for x in grads]


def test_split_tf32_products_hold_the_card_tolerances(case):
    args, fwd, vjp = case
    out, grads = _port(args, split3_product)
    assert _worst([out], [fwd]) <= F32_REL
    for name, o, r in zip(("dqkv", "dscale", "dbias", "dproj"), grads, vjp):
        assert np.abs(o - r).max() <= BWD_FLOOR * np.abs(r).max(), name


def test_one_tf32_pass_misses_them(case):
    """Why the split: one TF32 pass (~3 decimal digits in front of the
    exp) misses the forward tolerance (measured 1.7e-4 of the largest
    output against 1e-4; the backward's 1e-3 it meets), while the split
    lands at f32's own distance from the JAX kernel (3.7e-7 and 6.1e-7,
    against 2.4e-7 and 3.7e-7 for f32 products)."""
    args, fwd, _ = case
    one, _ = _port(args, tf32_product)
    three, _ = _port(args, split3_product)
    f32, _ = _port(args, None)
    assert _worst([one], [fwd]) > F32_REL
    assert _worst([three], [fwd]) < 0.01 * _worst([one], [fwd])
    assert _worst([three], [fwd]) < 4 * _worst([f32], [fwd])


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_mxu_bf16_plain_matches_the_pallas_kernels(masked):
    qkv, scale, bias, proj, mask, g = _inputs(2, 12, 2, 8, 16, seed=7)
    mask = mask if masked else np.ones_like(mask)
    j = [jnp.asarray(x) for x in (qkv, scale, bias, proj, mask, g)]
    ref = np.asarray(_favor_v2_interpret(*j[:5], mxu_bf16=True))
    product = P.bf16_operand_product
    out = P.favor_qkv_plain(t(qkv), t(scale), t(bias), t(proj), t(mask),
                            product=product).numpy()
    tol = JAX_MXU_TOL * max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(out, ref, atol=tol)
    f32 = np.asarray(_favor_v2_interpret(*j[:5], mxu_bf16=False))
    # the same roundings as the JAX kernel: far closer than to its f32 form
    assert np.abs(out - ref).max() < 0.1 * np.abs(out - f32).max()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FAVOR_MXU_BF16", "1")
        pallas = favor_qkv_bwd_pallas(*j[:5], j[5], interpret=True)
    grads = P.favor_qkv_bwd_plain(t(qkv), t(scale), t(bias), t(proj),
                                  t(mask), t(g), product=product)
    for name, o, r in zip(("dqkv", "dscale", "dbias", "dproj"), grads,
                          pallas):
        r = np.asarray(r, np.float32)
        tol = JAX_MXU_TOL * max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(o.numpy(), r, atol=tol, err_msg=name)


def test_favor_qkv_reads_the_switch_per_call_and_backward_follows(
        monkeypatch):
    """The wrapper reads FAVOR_MXU_BF16 at each call, as the JAX package
    reads it for kernel 1; the autograd backward takes the forward's
    setting, as favor_qkv_bwd_pallas takes it only when the forward did."""
    qkv, scale, bias, proj, mask, g = (t(x) for x in _inputs(2, 12, 2, 8, 16,
                                                             seed=8))
    product = P.bf16_operand_product
    monkeypatch.setenv("FAVOR_MXU_BF16", "1")
    x = qkv.clone().requires_grad_()
    out = P.favor_qkv(x, scale, bias, proj, mask)
    assert torch.equal(out, P.favor_qkv_plain(qkv, scale, bias, proj, mask,
                                              product=product))
    assert not torch.equal(out, P.favor_qkv_plain(qkv, scale, bias, proj,
                                                  mask))
    monkeypatch.setenv("FAVOR_MXU_BF16", "0")
    (dx,) = torch.autograd.grad(out, x, g)
    ref = P.favor_qkv_bwd_plain(qkv, scale, bias, proj, mask, g,
                                product=product)[0]
    assert torch.equal(dx, ref)
    assert torch.equal(P.favor_qkv(qkv, scale, bias, proj, mask),
                       P.favor_qkv_plain(qkv, scale, bias, proj, mask))
    monkeypatch.setenv("FAVOR_MXU_BF16", "1")
    assert torch.equal(P.favor_qkv_bwd(qkv, scale, bias, proj, mask, g)[0],
                       ref)
