"""The two Performer ops of the port (ops/performer.py) against the JAX ones.

The JAX side runs as its own tests run it on the CPU: the public entries
(``favor_attention_qkv``, ``performer_epilogue``), which take the pure-JAX
reference through ``platform_dependent``, and the Pallas kernels themselves
in interpret mode. The port side is the plain PyTorch version, which is
what the wrappers run for CPU tensors. The CUDA kernels are compared with
these plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: f32, the same math in another summation order -> atol 1e-5 on
O(1) LayerNorm outputs. bf16 inputs: both sides compute in f32 and round
once to bf16 -> one bf16 ulp (2**-7 relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from motiondiffusion_moe_tpu.ops.performer_pallas import (
    _epilogue_kernel,
    _favor_qkv_kernel_v2,
    favor_attention_qkv,
    performer_epilogue as jax_performer_epilogue,
)
from motiondiffusion_moe_tpu_torch.ops import _build
from motiondiffusion_moe_tpu_torch.ops import performer as P

from tests._torch_parity import t

ATOL = 1e-5


def _favor_inputs(B=3, T=13, H=2, D=32, m=32, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, T, 3 * H * D)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    proj = (rng.standard_normal((D, m)) * D ** -0.25).astype(np.float32)
    lengths = np.array([T] + list(rng.integers(1, T + 1, size=B - 1)))
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return qkv, scale, bias, proj, mask


def _favor_v2_interpret(qkv, scale, bias, proj, mask):
    """The production Pallas kernel (v2) in interpreter mode, as
    tests/test_ops.py builds it."""
    B, T, HD3 = qkv.shape
    HD = HD3 // 3
    D, m = proj.shape
    H = HD // D
    projbd = jnp.kron(jnp.eye(H, dtype=proj.dtype), proj)
    return pl.pallas_call(
        functools.partial(_favor_qkv_kernel_v2, eps=1e-6, pre_scale=0.1,
                          num_heads=H),
        out_shape=jax.ShapeDtypeStruct((B, T, HD), qkv.dtype),
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, T, HD3), lambda b: (b, 0, 0)),
            pl.BlockSpec((1, D), lambda b: (0, 0)),
            pl.BlockSpec((1, D), lambda b: (0, 0)),
            pl.BlockSpec((H * D, H * m), lambda b: (0, 0)),
            pl.BlockSpec((1, T, 1), lambda b: (b, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, T, HD), lambda b: (b, 0, 0)),
        interpret=True,
    )(qkv, scale.reshape(1, D), bias.reshape(1, D), projbd,
      mask.reshape(B, T, 1))


class TestFavorQKV:
    def test_plain_matches_jax_public_entry_ragged_mask(self):
        qkv, scale, bias, proj, mask = _favor_inputs()
        ref = np.asarray(favor_attention_qkv(qkv, scale, bias, proj, mask))
        out = P.favor_qkv_plain(t(qkv), t(scale), t(bias), t(proj), t(mask))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)

    def test_plain_matches_pallas_v2_kernel_interpret(self):
        qkv, scale, bias, proj, mask = _favor_inputs(B=2, T=12, D=16, m=16,
                                                     seed=1)
        ref = np.asarray(_favor_v2_interpret(
            jnp.asarray(qkv), jnp.asarray(scale), jnp.asarray(bias),
            jnp.asarray(proj), jnp.asarray(mask)))
        out = P.favor_qkv_plain(t(qkv), t(scale), t(bias), t(proj), t(mask))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)

    def test_plain_without_mask(self):
        qkv, scale, bias, proj, _ = _favor_inputs(seed=2)
        ref = np.asarray(favor_attention_qkv(qkv, scale, bias, proj, None))
        out = P.favor_qkv_plain(t(qkv), t(scale), t(bias), t(proj), None)
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)

    def test_plain_bf16_rounds_once(self):
        qkv, scale, bias, proj, mask = _favor_inputs(seed=3)
        qkv16 = jnp.asarray(qkv).astype(jnp.bfloat16)
        ref = np.asarray(favor_attention_qkv(qkv16, scale, bias, proj, mask)
                         .astype(jnp.float32))
        out = P.favor_qkv_plain(t(qkv).bfloat16(), t(scale), t(bias),
                                t(proj), t(mask))
        assert out.dtype == torch.bfloat16
        err = np.abs(out.float().numpy() - ref)
        assert (err <= 2.0 ** -7 * np.abs(ref) + 1e-6).all()

    def test_masked_frames_follow_the_reference_denominator(self):
        """A masked frame's phi(k) row is zero, so its same-position
        denominator is eps: the output is still the LayerNorm of
        phi(q) kv / eps, finite and O(1)."""
        qkv, scale, bias, proj, mask = _favor_inputs(seed=4)
        mask[1, 5:] = 0.0
        out = P.favor_qkv_plain(t(qkv), t(scale), t(bias), t(proj),
                                t(mask)).numpy()
        ref = np.asarray(favor_attention_qkv(qkv, scale, bias, proj, mask))
        assert np.isfinite(out).all() and np.abs(out[1, 5:]).max() < 10
        np.testing.assert_allclose(out, ref, atol=ATOL)


class TestPerformerEpilogue:
    def _inputs(self, B=3, T=10, D=64, seed=5):
        rng = np.random.default_rng(seed)

        def n(*shape, s=1.0, off=0.0):
            return (off + s * rng.standard_normal(shape)).astype(np.float32)

        return (n(B, T, D), n(B, D, s=0.3), n(B, D, s=0.3),
                n(D, s=0.1, off=1.0), n(D, s=0.1), n(D, s=0.1, off=1.0),
                n(D, s=0.1))

    def test_plain_matches_jax_public_entry(self):
        args = self._inputs()
        ref = np.asarray(jax_performer_epilogue(*args))
        out = P.performer_epilogue_plain(*[t(a) for a in args])
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)

    def test_plain_matches_pallas_kernel_interpret(self):
        y, scale, shift, ps, pb, ss, sb = self._inputs(seed=6)
        B, T, D = y.shape
        vec = pl.BlockSpec((1, D), lambda b: (0, 0))
        ref = np.asarray(pl.pallas_call(
            _epilogue_kernel,
            out_shape=jax.ShapeDtypeStruct((B, T, D), jnp.float32),
            grid=(B,),
            in_specs=[pl.BlockSpec((1, T, D), lambda b: (b, 0, 0)),
                      pl.BlockSpec((1, 1, D), lambda b: (b, 0, 0)),
                      pl.BlockSpec((1, 1, D), lambda b: (b, 0, 0)),
                      vec, vec, vec, vec],
            out_specs=pl.BlockSpec((1, T, D), lambda b: (b, 0, 0)),
            interpret=True,
        )(y, scale.reshape(B, 1, D), shift.reshape(B, 1, D),
          ps.reshape(1, D), pb.reshape(1, D), ss.reshape(1, D),
          sb.reshape(1, D)))
        out = P.performer_epilogue_plain(t(y), t(scale), t(shift), t(ps),
                                         t(pb), t(ss), t(sb))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)

    def test_plain_bf16_rounds_once(self):
        y, scale, shift, *vecs = self._inputs(seed=7)
        y16, sc16, sh16 = (jnp.asarray(a).astype(jnp.bfloat16)
                           for a in (y, scale, shift))
        ref = np.asarray(jax_performer_epilogue(y16, sc16, sh16, *vecs)
                         .astype(jnp.float32))
        out = P.performer_epilogue_plain(
            t(y).bfloat16(), t(scale).bfloat16(), t(shift).bfloat16(),
            *[t(v) for v in vecs])
        assert out.dtype == torch.bfloat16
        err = np.abs(out.float().numpy() - ref)
        assert (err <= 2.0 ** -7 * np.abs(ref) + 1e-6).all()


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        qkv, scale, bias, proj, mask = _favor_inputs()
        n0 = P.favor_qkv.launches
        out = P.favor_qkv(t(qkv), t(scale), t(bias), t(proj), t(mask))
        ref = P.favor_qkv_plain(t(qkv), t(scale), t(bias), t(proj), t(mask))
        assert torch.equal(out, ref) and P.favor_qkv.launches == n0
        args = [t(a) for a in TestPerformerEpilogue()._inputs()]
        n1 = P.performer_epilogue.launches
        assert torch.equal(P.performer_epilogue(*args),
                           P.performer_epilogue_plain(*args))
        assert P.performer_epilogue.launches == n1

    @pytest.mark.parametrize("op", ["favor_qkv", "performer_epilogue"])
    def test_other_devices_raise(self, op):
        x = torch.empty(2, 4, 3 * 2 * 64, device="meta")
        v = torch.empty(64, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            if op == "favor_qkv":
                P.favor_qkv(x, v, v, torch.empty(64, 64, device="meta"))
            else:
                P.performer_epilogue(x, x[:, 0], x[:, 0], v, v, v, v)

    def test_build_is_keyed_by_sources_and_flags(self, monkeypatch):
        path = _build.library_path()
        assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
        assert path == _build.library_path()
        assert {"favor_qkv.cu", "performer_epilogue.cu", "common.cuh"} <= {
            p.rsplit("/", 1)[-1] for p in _build.sources()}
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
        assert _build.library_path() != path

    def test_missing_nvcc_is_an_error_not_a_fallback(self, monkeypatch,
                                                     tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(_build.os.path, "isfile",
                            lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
