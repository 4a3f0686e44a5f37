"""The arithmetic of the fused Performer epilogue's kernel (kernel 2),
emulated in torch on the CPU and held to the JAX package.

``csrc/performer_epilogue.cu`` cannot run here, so this file pins how its
design computes a row: lane l of a warp holds the columns
32 E j + E l .. + E - 1 (E = 8 in bf16, 4 in f32); each of the row's sums
is a lane's partial over its values in that order, then ``warp_sum``'s
butterfly (xor 16, 8, 4, 2, 1); the post LayerNorm takes the mean, then
the sum of squares of x - mu1, and one reciprocal square root; the sum and
the sum of squares of h1 are taken in one pass, and the L2 step is one
factor per row, rmx = sqrt(D) min(rsqrt(|h1|^2), 1e12) = sqrt(D) /
max(|h1|, 1e-12), with the style LayerNorm's mean the mean of h1 times
rmx; the style LayerNorm is folded
into the modulation, h4 = z3 ma + mb with ma = ss (1 + scale[b]) and
mb = sb (1 + scale[b]) + shift[b]; scale and shift are read as the kernel
reads them, row b at ``base + b * row_stride`` of their storage. The rows
of batch row b go to C chunk blocks of ceil(T / C) rows, warp w of a
block taking rows t0 + w, t0 + w + 8, ...: the emulation walks that
assignment and shows every row is written once, whatever C. Fused
multiply-adds are emulated exactly (the f32 product is exact in f64,
rounded once to f32); the reciprocal square roots, the exp and the divide
are torch's, as the kernel takes them in f32 (in bf16 it takes the fast
ones, a few f32 ulps apart, which the one rounding to bf16 hides). The
emulation runs in f32 at T = 37 and 50 (no multiples of 8), D = 256 and
512, in both lane layouts and for several C, and is held to
``_epilogue_kernel`` through ``pl.pallas_call(..., interpret=True)`` and
to the port's ``performer_epilogue_plain`` at ``tests/test_torch_ops.py``'s
f32 tolerance, 1e-5 absolute (plus 1e-5 relative for the few outputs
above 1 in magnitude): the same f32 math, summed and factored in another
order. The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase A).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from motiondiffusion_moe_tpu.ops.performer_pallas import _epilogue_kernel
from motiondiffusion_moe_tpu_torch.models import embeddings as TE
from motiondiffusion_moe_tpu_torch.ops import performer as P

from tests._torch_parity import t

WARPS = 8  # warps of a block, one row each at a time
ATOL = RTOL = 1e-5


def fma(a, b, c):
    """fmaf: the product exact in f64, one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def lane_columns(D, E):
    """[32, V]: the column of each lane's value v = E j + e."""
    V = D // 32
    v = torch.arange(V)
    j, e = v // E, v % E
    return 32 * E * j[None, :] + E * torch.arange(32)[:, None] + e[None, :]


def warp_sum(p):
    """[R, 32] lane partials -> [R] after the xor butterfly."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        p = p + p[:, lane ^ o]
    assert (p == p[:, :1]).all()  # every lane holds the same sum
    return p[:, 0]


def lane_sum(terms):
    """[R, 32, V] -> [R]: each lane's values in order, then the butterfly."""
    s = torch.zeros(terms.shape[:2])
    for v in range(terms.shape[2]):
        s = s + terms[:, :, v]
    return warp_sum(s)


def lane_sum_fma(a, b):
    """[R, 32, V] x2 -> [R]: fmaf(a, b, s) along each lane, then the
    butterfly."""
    s = torch.zeros(a.shape[:2])
    for v in range(a.shape[2]):
        s = fma(a[:, :, v], b[:, :, v], s)
    return warp_sum(s)


def rows(y, sc, sh, ps, pb, ss, sb, E):
    """The kernel's arithmetic on rows y [R, D] f32 of one batch row, whose
    scale and shift rows are sc, sh [D]: the output [R, D] in f32."""
    R, D = y.shape
    inv_d, sqrt_d = 1.0 / D, math.sqrt(D)
    cols = lane_columns(D, E)
    x = y[:, cols]                                    # [R, 32, V]
    m = 1.0 + sc[cols]
    lps, lpb = ps[cols], pb[cols]
    ma = ss[cols] * m
    mb = fma(sb[cols], m, sh[cols])
    mu1 = (lane_sum(x) * inv_d)[:, None, None]
    x = x - mu1
    i1 = torch.rsqrt(lane_sum_fma(x, x) * inv_d + P.LN_EPS)[:, None, None]
    x = fma(x * i1, lps, lpb)                         # h1
    s1, q1 = lane_sum(x), lane_sum_fma(x, x)
    rmx = (sqrt_d * torch.rsqrt(q1).clamp_max(1e12))[:, None, None]
    mu3 = s1[:, None, None] * inv_d * rmx
    x = fma(x, rmx, -mu3)                             # h2 - mu3
    i3 = torch.rsqrt(lane_sum_fma(x, x) * inv_d + P.LN_EPS)[:, None, None]
    h4 = fma(x * i3, ma, mb)
    o = h4 / (1.0 + torch.exp(-h4))
    out = torch.empty(R, D)
    out[:, cols] = o
    return out


def strided_rows(storage, offset, row_stride, B, D):
    """The [B, D] rows the kernel reads at ``offset + b * row_stride`` of a
    flat storage."""
    return torch.stack([storage[offset + b * row_stride:][:D]
                        for b in range(B)])


def ordered_epilogue(y, scale, shift, ps, pb, ss, sb, C, E,
                     views=None):
    """The kernel's split over blocks and warps with C blocks per batch row
    and its arithmetic per row, in f32. ``views``: (storage, scale offset,
    shift offset, row stride) to read scale and shift from, as the kernel
    reads strided views; else the [B, D] tensors."""
    B, T, D = y.shape
    if views is not None:
        storage, o_sc, o_sh, stride = views
        scale = strided_rows(storage, o_sc, stride, B, D)
        shift = strided_rows(storage, o_sh, stride, B, D)
    out = torch.full((B, T, D), float("nan"))
    per = -(-T // C)
    for b in range(B):
        done = []
        for chunk in range(C):
            t0, t1 = chunk * per, min(T, chunk * per + per)
            for w in range(WARPS):
                done += range(t0 + w, t1, WARPS)
        assert sorted(done) == list(range(T))  # every row once
        out[b] = rows(y[b], scale[b], shift[b], ps, pb, ss, sb, E)
    return out


def pallas_interpret(y, scale, shift, ps, pb, ss, sb):
    """``_epilogue_kernel`` in interpret mode, as tests/test_torch_ops.py
    builds it."""
    B, T, D = y.shape
    vec = pl.BlockSpec((1, D), lambda b: (0, 0))
    return np.asarray(pl.pallas_call(
        _epilogue_kernel,
        out_shape=jax.ShapeDtypeStruct((B, T, D), jnp.float32),
        grid=(B,),
        in_specs=[pl.BlockSpec((1, T, D), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, 1, D), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, 1, D), lambda b: (b, 0, 0)),
                  vec, vec, vec, vec],
        out_specs=pl.BlockSpec((1, T, D), lambda b: (b, 0, 0)),
        interpret=True,
    )(y, scale.reshape(B, 1, D), shift.reshape(B, 1, D), ps.reshape(1, D),
      pb.reshape(1, D), ss.reshape(1, D), sb.reshape(1, D)))


def _inputs(B, T, D, seed):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, off=0.0):
        return (off + s * rng.standard_normal(shape)).astype(np.float32)

    return (n(B, T, D, s=2.0, off=0.5), n(B, D, s=0.3), n(B, D, s=0.3),
            n(D, s=0.1, off=1.0), n(D, s=0.1), n(D, s=0.1, off=1.0),
            n(D, s=0.1))


def _close(out, ref, name):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("E", [4, 8], ids=["f32-layout", "bf16-layout"])
@pytest.mark.parametrize("B,T,D,C", [(3, 37, 256, 1), (3, 37, 256, 4),
                                     (2, 50, 512, 3), (2, 50, 512, 7)])
def test_emulated_kernel_matches_jax(B, T, D, C, E):
    arrays = _inputs(B, T, D, seed=B + T + C + E)
    out = ordered_epilogue(*[t(a) for a in arrays], C, E)
    assert torch.isfinite(out).all()
    _close(out, pallas_interpret(*arrays), "vs pallas")
    _close(out, P.performer_epilogue_plain(*[t(a) for a in arrays]),
           "vs plain")


def test_emulated_kernel_on_rows_whose_l2_norm_is_zero():
    """post_scale = post_bias = 0 make h1 = 0: the L2 step's factor is
    sqrt(D) min(rsqrt(0), 1e12), h2 = 0 as max(|h1|, 1e-12) gives it, and
    the output is SiLU(mb) in every column, as in JAX."""
    y, sc, sh, _, _, ss, sb = _inputs(2, 9, 256, seed=4)
    zero = np.zeros(256, np.float32)
    arrays = (y, sc, sh, zero, zero, ss, sb)
    out = ordered_epilogue(*[t(a) for a in arrays], 2, 8)
    assert torch.isfinite(out).all()
    _close(out, pallas_interpret(*arrays), "vs pallas")
    _close(out, P.performer_epilogue_plain(*[t(a) for a in arrays]),
           "vs plain")


def test_emulation_is_the_same_for_every_chunking():
    """C decides only which block computes a row: the same bits for any
    C, including C with empty chunks (T = 37, C = 8: chunks of 5, the last
    of 2) and one row a warp or none (C = ceil(T / 8) and beyond)."""
    arrays = [t(a) for a in _inputs(2, 37, 256, seed=3)]
    ref = ordered_epilogue(*arrays, 1, 8)
    for C in (2, 5, 8, 37):
        assert torch.equal(ordered_epilogue(*arrays, C, 8), ref)


@pytest.mark.parametrize("D", [256, 512])
def test_emulated_bf16_rounds_once(D):
    """bf16 y, scale and shift: the kernel widens them, computes in f32
    and rounds once; the Pallas kernel on the same bf16 inputs does the
    same, so the two agree to one bf16 ulp."""
    y, sc, sh, *vecs = _inputs(2, 37, D, seed=D)
    y16, sc16, sh16 = (t(a).bfloat16() for a in (y, sc, sh))
    out = ordered_epilogue(y16.float(), sc16.float(), sh16.float(),
                           *[t(v) for v in vecs], 4, 8).bfloat16().float()
    ref = pallas_interpret(*[a.float().numpy() for a in (y16, sc16, sh16)],
                           *vecs)
    err = np.abs(out.numpy() - ref)
    assert (err <= 2.0 ** -7 * np.abs(ref) + 1e-6).all()


def _chunk_views(B, D, seed, dtype=torch.float32):
    """scale and shift as the two ``chunk`` halves of a [B, 2D] tensor, as
    the style block's Dense gives them."""
    rng = np.random.default_rng(seed)
    both = t((0.3 * rng.standard_normal((B, 2 * D))).astype(np.float32))
    scale, shift = both.to(dtype).chunk(2, dim=-1)
    return scale, shift


def test_strided_views_read_as_the_kernel_reads_them():
    B, T, D = 3, 37, 256
    y, _, _, *vecs = [t(a) for a in _inputs(B, T, D, seed=11)]
    scale, shift = _chunk_views(B, D, seed=12)
    assert scale.stride() == (2 * D, 1) and not scale.is_contiguous()
    storage = scale.untyped_storage()
    flat = torch.empty(0).set_(storage)  # the [B, 2D] storage, flat
    off_sc = scale.storage_offset()
    off_sh = shift.storage_offset()
    assert off_sh - off_sc == D
    out = ordered_epilogue(y, None, None, *vecs, 4, 8,
                           views=(flat, off_sc, off_sh, scale.stride(0)))
    ref = ordered_epilogue(y, scale.contiguous(), shift.contiguous(), *vecs,
                           4, 8)
    assert torch.equal(out, ref)
    _close(out, pallas_interpret(y.numpy(), scale.contiguous().numpy(),
                                 shift.contiguous().numpy(),
                                 *[v.numpy() for v in vecs]), "vs pallas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_takes_views_unchanged(dtype):
    """The wrapper on CPU tensors, with and without grad, fed the chunk
    views: the same bits as with contiguous copies."""
    B, T, D = 2, 50, 512
    y, _, _, *vecs = [t(a) for a in _inputs(B, T, D, seed=21)]
    y = y.to(dtype)
    scale, shift = _chunk_views(B, D, seed=22, dtype=dtype)
    ref = P.performer_epilogue_plain(y, scale.contiguous(),
                                     shift.contiguous(), *vecs)
    assert torch.equal(P.performer_epilogue(y, scale, shift, *vecs), ref)
    with torch.inference_mode():
        assert torch.equal(P.performer_epilogue(y, scale, shift, *vecs), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_style_block_passes_the_chunk_views(monkeypatch, dtype):
    """``StylizationBlock(..., pre_ln=...)`` hands the epilogue the chunk
    halves of its Dense's output, uncopied; its result is the same bits as
    the epilogue fed contiguous copies, and its gradients flow."""
    D, TED = 256, 64
    block = TE.StylizationBlock(D, TED, TED, dtype)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.1, generator=g)
    seen = []
    real = TE.performer_epilogue

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(TE, "performer_epilogue", spy)
    rng = np.random.default_rng(6)
    h = t(rng.standard_normal((2, 37, D)).astype(np.float32)).to(dtype)
    emb = t(rng.standard_normal((2, TED)).astype(np.float32)).to(dtype)
    pre_ln = (t((1 + 0.1 * rng.standard_normal(D)).astype(np.float32)),
              t((0.1 * rng.standard_normal(D)).astype(np.float32)))
    h.requires_grad_()
    out = block(h, emb, pre_ln=pre_ln)
    (_, scale, shift, *vecs), = seen
    assert scale.stride() == (2 * D, 1) and shift.stride() == (2 * D, 1)
    assert shift.data_ptr() - scale.data_ptr() == D * scale.element_size()
    w, b = block.out_kernel.to(dtype), block.out_bias.to(dtype)
    ref = real(h, scale.detach().contiguous(), shift.detach().contiguous(),
               *vecs) @ w + b
    assert torch.equal(out, ref)
    out.float().sum().backward()
    assert h.grad is not None and torch.isfinite(h.grad.float()).all()
    assert all(p.grad is not None for p in block.emb_layers.parameters())


def test_chunks_fill_the_card():
    """Blocks per batch row: 8 at the flagship (B = 32, T = 196) on a card
    that holds 2 x 132 blocks at once, 4 at one block per SM; at least 1;
    never more than leave each warp of a block a row."""
    assert P.epilogue_chunks(32, 196, 264) == 8
    assert P.epilogue_chunks(32, 196, 132) == 4
    assert P.epilogue_chunks(2, 196, 264) == 25      # ceil(196 / 8)
    assert P.epilogue_chunks(200, 196, 264) == 1
    assert P.epilogue_chunks(5, 1, 264) == 1
    for B, T in ((1, 1), (3, 37), (32, 98), (16, 196)):
        C = P.epilogue_chunks(B, T, 264)
        assert 1 <= C <= -(-T // 8)


@pytest.mark.parametrize("case,ok", [
    ("chunk", True), ("contiguous", True), ("column stride 2", False),
    ("row stride < D", False), ("misaligned base", False),
    ("misaligned rows", False)])
def test_row_views_the_kernel_takes(case, ok):
    """The strides and alignment the forward kernel takes for scale and
    shift, as the wrapper's check sees them (the device is checked apart:
    the card tests hold the wrapper to a ValueError for each refusal)."""
    B, D = 4, 256
    base = torch.zeros(B, 2 * D + 8)
    x = {"chunk": lambda: torch.zeros(B, 2 * D).chunk(2, dim=-1)[1],
         "contiguous": lambda: torch.zeros(B, D),
         "column stride 2": lambda: base[:, :2 * D:2],
         "row stride < D": lambda: base.view(-1).as_strided((B, D), (D - 4,
                                                                    1)),
         "misaligned base": lambda: base[:, 1:D + 1],
         "misaligned rows": lambda: base.view(-1).as_strided((B, D),
                                                             (D + 1, 1))}[
        case]()
    assert x.shape == (B, D)
    assert P._row_view_ok(x, D) is ok


def test_pallas_interpret_runs_as_in_the_ops_tests():
    """The interpret-mode helper is the kernel the ops tests hold the
    plain version to (a guard on the harness itself)."""
    arrays = _inputs(2, 9, 256, seed=1)
    ref = P.performer_epilogue_plain(*[t(a) for a in arrays]).numpy()
    np.testing.assert_allclose(pallas_interpret(*arrays), ref, atol=ATOL)

