"""The port's Performer backward ops against the JAX package's.

``favor_qkv_bwd_plain`` / ``performer_epilogue_bwd_plain`` (what the port's
autograd Functions run on the CPU, and what the CUDA backward kernels are
held to on the card) against the Pallas backward kernels in interpret mode
and against ``jax.vjp`` of the JAX references, on the same seeded inputs.

Tolerances: f32 gradients are sums over T (and over heads and batch rows
for the shared parameters) taken in another order -> 2e-4 absolute and
relative, as the JAX package's own backward tests. bf16 activation
gradients are that f32 result rounded once to bf16 -> one bf16 ulp (2**-7
relative) plus 1e-3 of the largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.ops.performer_pallas import (
    _epilogue_bwd_reference,
    _favor_qkv_bwd_reference,
)
from motiondiffusion_moe_tpu.ops.performer_pallas_bwd import (
    epilogue_bwd_pallas,
    favor_qkv_bwd_pallas,
)
from motiondiffusion_moe_tpu_torch.ops import performer as P

from tests._torch_parity import t

BF16 = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(out, ref, bf16: bool, name: str):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(out).all(), name
    if bf16:
        tol = 2 ** -7 * np.abs(ref) + 1e-3 * np.abs(ref).max()
        assert (np.abs(out - ref) <= tol).all(), name
    else:
        np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4,
                                   err_msg=name)


def _to_np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


def _favor_inputs(B, H, T, D, m, masked, seed=11):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, T, 3 * H * D)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    proj = (rng.standard_normal((D, m)) * D ** -0.25).astype(np.float32)
    g = rng.standard_normal((B, T, H * D)).astype(np.float32)
    mask = None
    if masked:
        lengths = np.array([T] + [max(1, T // 2 + 1)] * (B - 1))
        mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return qkv, scale, bias, proj, mask, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_favor_qkv_bwd_plain_matches_pallas_and_reference(masked, H, dtype):
    jdt, tdt = BF16[dtype]
    qkv, scale, bias, proj, mask, g = _favor_inputs(2, H, 12, 8, 16, masked)
    jm = None if mask is None else jnp.asarray(mask)
    jq, jg = jnp.asarray(qkv, jdt), jnp.asarray(g, jdt)
    pallas = favor_qkv_bwd_pallas(jq, jnp.asarray(scale), jnp.asarray(bias),
                                  jnp.asarray(proj), jm, jg, interpret=True)
    ref = _favor_qkv_bwd_reference(jq, jnp.asarray(scale), jnp.asarray(bias),
                                   jnp.asarray(proj), jm, jg, 1e-6, 0.1)
    out = P.favor_qkv_bwd_plain(t(qkv).to(tdt), t(scale), t(bias), t(proj),
                                None if mask is None else t(mask),
                                t(g).to(tdt))
    assert out[0].dtype == tdt and out[0].shape == qkv.shape
    for name, o, pa, r in zip(("dqkv", "dscale", "dbias", "dproj"), out,
                              pallas, ref):
        bf16 = dtype == "bfloat16" and name == "dqkv"
        _close(_to_np(o), pa, bf16, f"{name} vs pallas")
        _close(_to_np(o), r, bf16, f"{name} vs reference")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_bwd_plain_matches_pallas_and_reference(dtype):
    jdt, tdt = BF16[dtype]
    rng = np.random.default_rng(3)
    B, T, D = 2, 10, 64

    def n(*shape, s=1.0, off=0.0):
        return (off + s * rng.standard_normal(shape)).astype(np.float32)

    y, g = n(B, T, D), n(B, T, D)
    scale, shift = n(B, D, s=0.3), n(B, D, s=0.3)
    vecs = [n(D, s=0.1, off=1.0), n(D, s=0.1), n(D, s=0.1, off=1.0),
            n(D, s=0.1)]
    jargs = ([jnp.asarray(a, jdt) for a in (y, scale, shift)]
             + [jnp.asarray(v) for v in vecs])
    pallas = epilogue_bwd_pallas(*jargs, jnp.asarray(g, jdt), interpret=True)
    ref = _epilogue_bwd_reference(*jargs, jnp.asarray(g, jdt))
    out = P.performer_epilogue_bwd_plain(
        *[t(a).to(tdt) for a in (y, scale, shift)], *[t(v) for v in vecs],
        t(g).to(tdt))
    names = ("dy", "dscale", "dshift", "dpost_s", "dpost_b", "dstyle_s",
             "dstyle_b")
    for i, (name, o, pa, r) in enumerate(zip(names, out, pallas, ref)):
        bf16 = dtype == "bfloat16" and i < 3
        _close(_to_np(o), pa, bf16, f"{name} vs pallas")
        _close(_to_np(o), r, bf16, f"{name} vs reference")


@pytest.mark.parametrize("need_dproj", [True, False])
def test_favor_qkv_autograd_function_uses_the_plain_backward_on_cpu(
        need_dproj):
    qkv, scale, bias, proj, mask, g = _favor_inputs(2, 2, 9, 8, 16, True)
    leaves = [t(a).requires_grad_() for a in (qkv, scale, bias)]
    tp = t(proj).requires_grad_(need_dproj)
    out = P.favor_qkv(*leaves, tp, t(mask))
    torch.testing.assert_close(
        out, P.favor_qkv_plain(t(qkv), t(scale), t(bias), t(proj), t(mask)),
        rtol=0, atol=0)
    out.backward(t(g))
    ref = P.favor_qkv_bwd_plain(t(qkv), t(scale), t(bias), t(proj), t(mask),
                                t(g), need_dproj=need_dproj)
    for leaf, r in zip(leaves + [tp], ref):
        if r is None:
            assert leaf.grad is None
        else:
            torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)


def test_epilogue_autograd_function_uses_the_plain_backward_on_cpu():
    rng = np.random.default_rng(4)
    args = [rng.standard_normal(s).astype(np.float32) for s in
            ((2, 5, 32), (2, 32), (2, 32), (32,), (32,), (32,), (32,))]
    g = t(rng.standard_normal((2, 5, 32)).astype(np.float32))
    leaves = [t(a).requires_grad_() for a in args]
    P.performer_epilogue(*leaves).backward(g)
    ref = P.performer_epilogue_bwd_plain(*[t(a) for a in args], g)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)


def test_backward_wrappers_take_the_plain_version_on_cpu_only():
    qkv, scale, bias, proj, mask, g = _favor_inputs(1, 2, 4, 8, 16, False)
    n0 = P.favor_qkv_bwd.launches
    P.favor_qkv_bwd(t(qkv), t(scale), t(bias), t(proj), None, t(g))
    assert P.favor_qkv_bwd.launches == n0  # the plain version launches none
    meta = torch.empty(1, 4, 48, device="meta")
    with pytest.raises(ValueError):
        P.favor_qkv_bwd(meta, t(scale), t(bias), t(proj), None,
                        torch.empty(1, 4, 16, device="meta"))
