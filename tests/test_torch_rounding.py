"""The port's bf16 modules round where the JAX package's modules round.

In bf16 compute XLA evaluates flax's ``nn.silu``, ``nn.gelu`` and
``nn.sigmoid`` step by step with a rounding to bf16 after every step, adds a
``Dense`` bias after rounding the product, and multiplies by a weakly typed
Python scalar rounded to bf16 first (0.1 -> 0.10009765625). PyTorch's
``F.silu``, ``F.gelu``, ``torch.sigmoid`` and ``F.linear(x, w, b)`` round
once, and ``0.1 * x`` multiplies by the unrounded 0.1: one ulp apart from
JAX in 27-44% of the values. The port takes JAX's steps
(``ops/activations.py``, ``models/layers.py::Dense`` and ``weak_scalar``).

Against the JAX package on the CPU (jitted, as the other parity tests run
it), seeded numpy inputs, every parameter drawn (nonzero biases):

- the activations and a weak-scalar product give JAX's bf16 bits;
- the activations' gradients (``ACT.activation_grad``, the backward of the
  bf16 wrappers): dx gives the bits of ``jax.grad`` of the flax function;
  the bias gradient is the f32 sum of dx rounded once (at most 1% of its
  values one ulp from that sum of JAX's dx, none further), where XLA's CPU
  reduction inside the gradient program rounds every partial sum to bf16:
  JAX's own bias gradient lies within 2^-5 of its largest value of it
  (at most 1.3% measured here). f32: ``jax.grad`` at 1e-5;
- ``Dense``, ``StylizationBlock`` (unfused, and fused against the JAX module
  with its Pallas kernel in interpret mode: the JAX CPU reference of that
  kernel rounds once more than the TPU kernel), ``TimestepEmbedding`` and
  ``GatedFusion``: at most 1% of the values one ulp apart (their products
  are summed in another order), none further (``bf16_flips``); here all
  agree bit for bit;
- the same checks fail when a module runs PyTorch's ``F.silu`` or the fused
  Dense bias.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from motiondiffusion_moe_tpu.models import embeddings as JE
from motiondiffusion_moe_tpu.ops import adaln_pallas
from motiondiffusion_moe_tpu_torch.models import embeddings as TE
from motiondiffusion_moe_tpu_torch.models import layers as TL
from motiondiffusion_moe_tpu_torch.ops import activations as ACT

from tests._torch_parity import (
    adaln_as_the_tpu_kernel,
    assert_bf16_flips,
    bf16_flips,
    load_into,
    random_params,
    t,
)

B, T, D, TED = 2, 10, 64, 256
ACTIVATIONS = {"silu": nn.silu, "gelu": nn.gelu, "sigmoid": nn.sigmoid}


def _n(*shape, seed=0, s=1.0):
    return (s * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("op", sorted(ACTIVATIONS))
def test_activations_give_jax_bits(op):
    """65,536 values of standard deviation 8 and a Dense bias: the plain
    versions (what the CPU runs) against the jitted flax function, bit for
    bit; PyTorch's own function differs in over 20% of the values."""
    x, bias = _n(256, 256, seed=1, s=8.0), _n(256, seed=2)
    jfn = jax.jit(lambda a, b: ACTIVATIONS[op](a + b))
    ref = _f32(jfn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(bias,
                                                             jnp.bfloat16)))
    xt, bt = t(x).bfloat16(), t(bias).bfloat16()
    out = getattr(ACT, op)(xt, bt).float().numpy()
    np.testing.assert_array_equal(out, ref)
    torch_fn = {"silu": F.silu, "sigmoid": torch.sigmoid,
                "gelu": lambda y: F.gelu(y, approximate="tanh")}[op]
    assert (torch_fn(xt + bt).float().numpy() != ref).mean() > 0.2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("op", sorted(ACTIVATIONS))
def test_activation_gradients_match_jax(op, dtype):
    """dx and d(bias) of ``op(x + bias)`` for a seeded cotangent against
    ``jax.grad`` of the flax function at the same inputs (see the module
    doc); in bf16, PyTorch's own derivative differs in over 20% of dx."""
    x, bias, g = _n(256, 256, seed=11, s=8.0), _n(256, seed=12), _n(
        256, 256, seed=13)
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float32": (jnp.float32, torch.float32)}[dtype]
    fn = ACTIVATIONS[op]
    dxj, dbj = (_f32(v) for v in jax.jit(jax.grad(
        lambda a, c, w: jnp.sum((fn(a + c) * w).astype(jnp.float32)),
        argnums=(0, 1)))(*(jnp.asarray(v, jdt) for v in (x, bias, g))))
    xt, bt = (t(v).to(tdt).requires_grad_() for v in (x, bias))
    getattr(ACT, op)(xt, bt).backward(t(g).to(tdt))
    dx, db = xt.grad.float().numpy(), bt.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(dx, dxj, rtol=1e-5,
                                   atol=1e-5 * np.abs(dxj).max())
        np.testing.assert_allclose(db, dbj, rtol=1e-5,
                                   atol=1e-5 * np.abs(dbj).max())
        return
    np.testing.assert_array_equal(dx, dxj)
    summed = _f32(jnp.asarray(dxj.sum(0, dtype=np.float64), jnp.bfloat16))
    assert_bf16_flips(db, summed)
    assert np.abs(db - dbj).max() <= 2.0 ** -5 * np.abs(dbj).max()
    xs = t(x).bfloat16().requires_grad_()
    torch_fn = {"silu": F.silu, "sigmoid": torch.sigmoid,
                "gelu": lambda y: F.gelu(y, approximate="tanh")}[op]
    torch_fn(xs + t(bias).bfloat16()).backward(t(g).bfloat16())
    assert (xs.grad.float().numpy() != dxj).mean() > 0.2


def test_weak_scalar_product_gives_jax_bits():
    x = _n(4096, seed=3)
    ref = _f32(jax.jit(lambda a: 0.1 * a)(jnp.asarray(x, jnp.bfloat16)))
    xt = t(x).bfloat16()
    tenth = TL.weak_scalar(0.1, torch.bfloat16)
    assert tenth == 0.10009765625
    np.testing.assert_array_equal((tenth * xt).float().numpy(), ref)
    assert ((0.1 * xt).float().numpy() != ref).mean() > 0.1
    assert TL.weak_scalar(0.1, torch.float32) == np.float32(0.1)


def _modules():
    """(name, JAX module factory, port module factory, JAX inputs, port
    inputs) of each module under test."""
    h, emb = _n(B, T, D, seed=4), _n(B, D, seed=5)
    hb = jnp.asarray(h, jnp.bfloat16)
    te, xe = _n(3, D, seed=6), _n(3, D, seed=7)
    ts = np.array([3, 500, 999], np.int32)
    style = dict(latent_dim=D, time_embed_dim=TED, dropout=0.0)
    return [
        ("Dense", lambda dt: nn.Dense(48, dtype=dt),
         lambda dt: TL.Dense(D, 48, dt), [h], [t(h)]),
        ("StylizationBlock", lambda dt: JE.StylizationBlock(**style, dtype=dt),
         lambda dt: TE.StylizationBlock(D, TED, D, dt), [hb, emb],
         [t(h).bfloat16(), t(emb)]),
        ("StylizationBlock(fused=True)",
         lambda dt: JE.StylizationBlock(**style, dtype=dt, fused=True),
         lambda dt: TE.StylizationBlock(D, TED, D, dt, fused=True),
         [hb, emb], [t(h).bfloat16(), t(emb)]),
        ("TimestepEmbedding", lambda dt: JE.TimestepEmbedding(
            embed_dim=D, dtype=dt), lambda dt: TE.TimestepEmbedding(D, dt),
         [ts], [t(ts)]),
        ("GatedFusion", lambda dt: JE.GatedFusion(embed_dim=D, dtype=dt),
         lambda dt: TE.GatedFusion(D, dt),
         [jnp.asarray(te, jnp.bfloat16), jnp.asarray(xe, jnp.bfloat16)],
         [t(te).bfloat16(), t(xe).bfloat16()]),
    ]


def _jax_and_port(jmod, pmod, jax_args, port_args, monkeypatch):
    """The bf16 JAX module (jitted) and the port's, with one seeded flax
    tree; the fused style block's kernel runs as the TPU runs it."""
    monkeypatch.setattr(adaln_pallas, "adaln_dense", adaln_as_the_tpu_kernel)
    params = random_params(jmod(jnp.float32), *jax_args)
    jm = jmod(jnp.bfloat16)
    ref = _f32(jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, *jax_args))
    port = load_into(pmod(torch.bfloat16), params)
    with torch.no_grad():
        out = port(*port_args).float().numpy()
    return out, ref


@pytest.mark.parametrize("case", range(5), ids=[
    "Dense", "StylizationBlock", "StylizationBlock-fused", "TimestepEmbedding",
    "GatedFusion"])
def test_modules_round_where_jax_rounds(case, monkeypatch):
    name, jmod, pmod, jax_args, port_args = _modules()[case]
    out, ref = _jax_and_port(jmod, pmod, jax_args, port_args, monkeypatch)
    assert out.shape == ref.shape, name
    assert_bf16_flips(out, ref)


@pytest.mark.parametrize("case", range(1, 5), ids=[
    "StylizationBlock", "StylizationBlock-fused", "TimestepEmbedding",
    "GatedFusion"])
def test_a_module_with_pytorchs_silu_fails(case, monkeypatch):
    """The mutation the checks above must catch: every module that runs a
    bf16 silu, run with ``F.silu`` instead."""
    def torch_silu(x, bias=None):
        return F.silu(x if bias is None else x + bias.to(x.dtype))

    monkeypatch.setattr(ACT, "silu", torch_silu)  # Dense(..., "silu")
    monkeypatch.setattr(TE, "silu", torch_silu)
    _, jmod, pmod, jax_args, port_args = _modules()[case]
    out, ref = _jax_and_port(jmod, pmod, jax_args, port_args, monkeypatch)
    flipped, worst = bf16_flips(out, ref)
    assert flipped > 0.01 or worst > 1.0


def test_dense_with_the_fused_bias_fails(monkeypatch):
    """The other mutation: ``F.linear(x, w, b)`` in bf16, one rounding."""
    monkeypatch.setattr(TL.Dense, "forward", lambda self, x, activation=None:
                        F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                                 self.bias.to(self.dtype)))
    _, jmod, pmod, jax_args, port_args = _modules()[0]
    out, ref = _jax_and_port(jmod, pmod, jax_args, port_args, monkeypatch)
    assert bf16_flips(out, ref)[0] > 0.01


def test_residual_steps_multiply_by_the_weak_scalar():
    """``x + 0.1 * style_out`` of the Performer (``attention.py:238``) and
    ``skip + 0.1 * global_out`` of the dual block (``:275``) in bf16 give
    the bits of the same expressions in jitted JAX, on the port's own
    intermediate values (captured with hooks). A LayerNorm reads each sum
    unrounded, as XLA's compiled program of the whole block does: rounded,
    that f32 sum is the jitted expression's bf16 result."""
    from motiondiffusion_moe_tpu_torch.models import attention as TA

    block = TA.DualSelfAttentionBlock(D, 2, TED, 32, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(8))
    seen = {}

    def keep(name):
        def hook(mod, args, out):
            seen[name] = (args, out)
        return hook

    block.local_attn.register_forward_hook(keep("local"))
    block.local_attn.style_block.register_forward_hook(keep("style"))
    block.global_attn.register_forward_hook(keep("global"))
    block.skip_proj.register_forward_hook(keep("skip"))
    block.post_norm.register_forward_hook(keep("post"))
    x, emb = t(_n(B, T, D, seed=9)).bfloat16(), t(_n(B, D, seed=10))
    with torch.no_grad():
        block(x, emb)
    residual = jax.jit(lambda a, s: a + 0.1 * s)
    j = {k: [jnp.asarray(v.float().numpy(), jnp.bfloat16) for v in vs]
         for k, vs in (("local", (seen["local"][0][0], seen["style"][1])),
                       ("dual", (seen["skip"][1], seen["global"][1])))}
    local = seen["local"][1]
    np.testing.assert_array_equal(local.float().numpy(),
                                  _f32(residual(*j["local"])))
    assert local.unrounded.dtype == torch.float32
    assert torch.equal(local.unrounded.bfloat16(), local)
    post_in = seen["post"][0][0]
    assert post_in.dtype == torch.float32
    np.testing.assert_array_equal(post_in.bfloat16().float().numpy(),
                                  _f32(residual(*j["dual"])))
