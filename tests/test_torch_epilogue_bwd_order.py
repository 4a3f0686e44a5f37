"""The order of sums of the Performer epilogue's backward kernel (kernel 4),
emulated in torch on the CPU and held to the JAX package.

``csrc/performer_epilogue_bwd.cu`` cannot run here, so this file pins how
its design splits and orders the sums of the six parameter gradients: the
rows of batch row b go to C chunk blocks of ceil(T / C) rows each (the
blocks of one thread-block cluster); in a block, warp w takes rows
t0 + w, t0 + w + 8, ... and adds each row's four per-column terms (dh4 z3,
dh4, d(h1) z1, d(h1)) in row order; the block adds its 8 warps' sums in
warp order and forms the six partials from them (d(scale) = ss sum dh4 z3
+ sb sum dh4, d(shift) = sum dh4, the post LayerNorm's two sums,
d(style_scale) = (1 + scale[b]) sum dh4 z3, d(style_bias) =
(1 + scale[b]) sum dh4); the cluster adds its blocks' partials in rank
order, which gives d(scale)[b] and d(shift)[b]; the four LayerNorm
gradients of each batch row then go to a second pass, where 8 threads each
add a fixed range of batch rows [s B / 8, (s + 1) B / 8) in order and the 8
sums are added in order. Each row's terms, and dy, follow the kernel's
arithmetic (h2 as h1 times sqrt(D) / max(|h1|, 1e-12); the style LayerNorm
folded into the modulation, h4 = z3 ma + mb with ma = ss (1 + scale[b]),
mb = sb (1 + scale[b]) + shift[b]). The emulation runs in f32 at T = 37
and 50, which are no multiples of 32, for several C, and is held to
``epilogue_bwd_pallas(..., interpret=True)`` and to the port's
``performer_epilogue_bwd_plain`` at ``tests/test_torch_ops_bwd.py``'s f32
tolerance, 2e-4 absolute and relative: the same f32 math, summed and
factored in another order. The kernel itself is held to the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase D1).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.ops.performer_pallas_bwd import (
    epilogue_bwd_pallas,
)
from motiondiffusion_moe_tpu_torch.ops.performer import (
    LN_EPS,
    performer_epilogue_bwd_plain,
)

from tests._torch_parity import t

WARPS = 8  # warps of a block, one row each at a time
SPLIT = 8  # threads per output of the second pass


def row_terms(y, g, s1, sh, ps, pb, ss, sb):
    """Per row of one batch row (y, g: [R, D] f32; s1 = 1 + scale[b], sh =
    shift[b]): (the four per-column terms [R, 4, D] a lane sums, dh4 z3,
    dh4, d(h1) z1 and d(h1); dy [R, D])."""
    D = y.shape[-1]
    inv_d, sqrt_d = 1.0 / D, math.sqrt(D)
    ma, mb = ss * s1, sb * s1 + sh

    def ln(x):
        mu = x.sum(-1, keepdim=True) * inv_d
        var = ((x - mu) ** 2).sum(-1, keepdim=True) * inv_d
        inv = 1.0 / torch.sqrt(var + LN_EPS)
        return (x - mu) * inv, inv

    z1, i1 = ln(y)
    h1 = z1 * ps + pb
    n = torch.sqrt((h1 * h1).sum(-1, keepdim=True))
    mx = n.clamp_min(1e-12)
    rmx = sqrt_d / mx
    z3, i3 = ln(h1 * rmx)
    h4 = z3 * ma + mb
    sig = 1.0 / (1.0 + torch.exp(-h4))
    dh4 = g * sig * (1.0 + h4 * (1.0 - sig))
    d3 = dh4 * ma  # ss d(h3)
    a1 = d3.sum(-1, keepdim=True) * inv_d
    a2 = (d3 * z3).sum(-1, keepdim=True) * inv_d
    d2 = i3 * (d3 - a1 - z3 * a2)
    t_dot = (d2 * h1).sum(-1, keepdim=True)
    inv_n = torch.where(n > 0, 1.0 / n, torch.zeros_like(n))
    live = (n >= 1e-12).float()
    kl2 = sqrt_d * t_dot / (mx * mx) * live * inv_n
    d1 = d2 * rmx - h1 * kl2
    a1 = (ps * d1).sum(-1, keepdim=True) * inv_d
    a2 = (ps * d1 * z1).sum(-1, keepdim=True) * inv_d
    dy = i1 * (ps * d1 - a1 - z1 * a2)
    return torch.stack([dh4 * z3, dh4, d1 * z1, d1], dim=1), dy


def in_order(parts):
    """Sum a sequence of [..] tensors one after another, from zero."""
    s = torch.zeros_like(parts[0])
    for p in parts:
        s = s + p
    return s


def ordered_bwd(y, scale, shift, ps, pb, ss, sb, g, C):
    """The kernel's split and order of sums with C blocks per batch row, in
    f32: (dy, dscale, dshift, dpost_s, dpost_b, dstyle_s, dstyle_b)."""
    B, T, D = y.shape
    per = -(-T // C)
    dy = torch.empty(B, T, D)
    dscale, dshift = torch.empty(B, D), torch.empty(B, D)
    ln_part = torch.empty(B, 4, D)
    for b in range(B):
        s1 = 1 + scale[b]
        terms, dy[b] = row_terms(y[b], g[b], s1, shift[b], ps, pb, ss, sb)
        blocks = []
        for rank in range(C):
            t0, t1 = rank * per, min(T, rank * per + per)
            warps = [in_order([terms[r] for r in range(t0 + w, t1, WARPS)]
                              or [torch.zeros(4, D)]) for w in range(WARPS)]
            a, dh4, p2, p3 = in_order(warps)
            blocks.append(torch.stack([ss * a + sb * dh4, dh4, p2, p3,
                                       s1 * a, s1 * dh4]))
        total = in_order(blocks)
        dscale[b], dshift[b], ln_part[b] = total[0], total[1], total[2:]
    splits = [in_order([ln_part[b] for b in range(s * B // SPLIT,
                                                  (s + 1) * B // SPLIT)]
                       or [torch.zeros(4, D)]) for s in range(SPLIT)]
    ln = in_order(splits)
    return (dy, dscale, dshift, ln[0], ln[1], ln[2], ln[3])


def _inputs(B, T, D, seed):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, off=0.0):
        return (off + s * rng.standard_normal(shape)).astype(np.float32)

    return (n(B, T, D), n(B, D, s=0.3), n(B, D, s=0.3), n(D, s=0.1, off=1.0),
            n(D, s=0.1), n(D, s=0.1, off=1.0), n(D, s=0.1), n(B, T, D))


def _close(out, ref, name):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32), atol=2e-4,
                               rtol=2e-4, err_msg=name)


NAMES = ("dy", "dscale", "dshift", "dpost_s", "dpost_b", "dstyle_s",
         "dstyle_b")


@pytest.mark.parametrize("B,T,C", [(3, 37, 1), (3, 37, 3), (3, 37, 4),
                                   (9, 50, 8)])
def test_ordered_sums_match_jax(B, T, C):
    arrays = _inputs(B, T, 256, seed=B + T + C)
    out = ordered_bwd(*[t(a) for a in arrays], C)
    pallas = epilogue_bwd_pallas(*[jnp.asarray(a) for a in arrays],
                                 interpret=True)
    plain = performer_epilogue_bwd_plain(*[t(a) for a in arrays])
    for name, o, pa, pl in zip(NAMES, out, pallas, plain):
        o = o.numpy()
        _close(o, np.asarray(pa).reshape(o.shape), f"{name} vs pallas")
        _close(o, pl.numpy(), f"{name} vs plain")


def test_every_row_lands_in_one_block():
    """ceil(T / C) rows a block: the chunks cover every row once, the last
    ones possibly short or empty (T = 9, C = 8: chunks of 2, the last
    empty)."""
    for T, C in ((9, 8), (37, 4), (196, 4), (196, 7), (1, 1)):
        per = -(-T // C)
        rows = [r for rank in range(C)
                for r in range(rank * per, min(T, rank * per + per))]
        assert rows == list(range(T))
