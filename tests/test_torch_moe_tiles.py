"""The order of arithmetic of the bf16 fused-MoE kernel, emulated in torch on
the CPU and held to the JAX package.

``csrc/moe_dense_fused.cu`` cannot run here, so this file pins what its
bf16 design changes about the sums: the tokens go in tiles of 48 (a ragged
last tile padded with zero rows and zero routing weights), the hidden
columns in chunks of 256 (128 where D > 512 or E*hid is no multiple of
256; a chunk of 256 may span two experts), each chunk's product with W1
summed in f32, biased, passed through the tanh gelu and weighted by its
expert's routing weight in f32, rounded to bf16 once, and its product with
W2 added to an f32 output accumulator chunk after chunk; combine . b2 joins
at the end, and the output is rounded once. The emulation is held to the
Pallas kernel in interpret mode and to ``moe_dense_fused_reference`` at
``tests/test_torch_fused_ops.py``'s bf16 tolerance (one ulp plus 2^-12 of
the largest value: both sides round the same f32-summed values once, and a
hidden activation whose sums land on either side of a rounding boundary
moves the output by one ulp of that term). The kernel itself is held to
the port's plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase E1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from motiondiffusion_moe_tpu.ops.moe_pallas import (
    _moe_pallas,
    moe_dense_fused_reference,
)
from motiondiffusion_moe_tpu_torch.ops.moe import (
    MOE_DIMS,
    moe_dense_fused_plain,
)

from tests._torch_parity import assert_bf16_close, t

TILE = 48  # tokens per block (MoeBf16Plan)


def chunk_width(D: int, E: int, hid: int) -> int:
    """Hidden columns per chunk of the bf16 kernel (dispatch_moe)."""
    return 256 if D <= 512 and E * hid % 256 == 0 else 128


def _inputs(S, D, E, hid, seed):
    """bf16 x, top-2 routing weights and stored expert weights (w1
    [E, D, hid], b1 [E, hid], w2 [E, hid, D], b2 [E, D]) at the scales of
    ``tests/test_torch_fused_ops.py``, for which its tolerance is set."""
    rng = np.random.default_rng(seed)
    p = np.exp(rng.standard_normal((S, E)))
    p /= p.sum(-1, keepdims=True)
    idx = np.argsort(-p, -1, kind="stable")[:, :2]
    combine = np.zeros((S, E), np.float32)
    np.put_along_axis(combine, idx, np.take_along_axis(p, idx, -1), -1)
    arrays = (rng.standard_normal((S, D)), combine,
              0.05 * rng.standard_normal((E, D, hid)),
              0.1 * rng.standard_normal((E, hid)),
              0.05 * rng.standard_normal((E, hid, D)),
              0.1 * rng.standard_normal((E, D)))
    return [t(np.asarray(a, np.float32)).bfloat16() for a in arrays]


def tiled_moe(x, combine, w1, b1, w2, b2):
    """The kernel's order of arithmetic on bf16 inputs; returns (out, the
    largest |h| of the padded rows), out [S, D] in bf16."""
    S, D = x.shape
    E, _, hid = w1.shape
    C = chunk_width(D, E, hid)
    assert E * hid % C == 0
    w1m = w1.permute(1, 0, 2).reshape(D, E * hid).float()
    w2m = w2.reshape(E * hid, D).float()
    b1m = b1.reshape(E * hid).float()
    expert = torch.arange(E * hid) // hid  # of each merged column
    out = torch.empty(S, D, dtype=torch.bfloat16)
    pad_h = 0.0
    for s0 in range(0, S, TILE):
        valid = min(TILE, S - s0)
        xt = torch.zeros(TILE, D)
        ct = torch.zeros(TILE, E)
        xt[:valid] = x[s0:s0 + valid].float()
        ct[:valid] = combine[s0:s0 + valid].float()
        acc = torch.zeros(TILE, D)
        for col0 in range(0, E * hid, C):
            cols = slice(col0, col0 + C)
            h = F.gelu(xt @ w1m[:, cols] + b1m[cols], approximate="tanh")
            h = (h * ct[:, expert[cols]]).bfloat16().float()
            pad_h = max(pad_h, h[valid:].abs().max().item() if valid < TILE
                        else 0.0)
            acc = acc + h @ w2m[cols]
        out[s0:s0 + valid] = (acc + ct @ b2.float())[:valid].bfloat16()
    return out, pad_h


def _jax(args):
    """The JAX op's merged layout, in bf16."""
    x, combine, w1, b1, w2, b2 = (a.float().numpy() for a in args)
    E, D, hid = w1.shape
    merged = (x, combine, np.transpose(w1, (1, 0, 2)).reshape(D, E * hid),
              b1.reshape(1, E * hid), w2.reshape(E * hid, D), b2)
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in merged]


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("E,hid", [(3, 128), (3, 256), (4, 128), (4, 256)])
@pytest.mark.parametrize("D", [128, 256, 512])
def test_tiled_order_matches_jax(D, E, hid):
    assert D in MOE_DIMS
    S = 2 * TILE + 7  # a ragged last tile
    args = _inputs(S, D, E, hid, seed=D + 10 * E + hid)
    out, pad_h = tiled_moe(*args)
    assert pad_h == 0.0  # zero rows and weights past S stay zero
    out = out.float().numpy()
    jargs = _jax(args)
    for ref in (_f32(_moe_pallas(*jargs, interpret=True)),
                _f32(moe_dense_fused_reference(*jargs)),
                moe_dense_fused_plain(*args).float().numpy()):
        assert_bf16_close(out, ref)
