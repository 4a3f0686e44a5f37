"""The order of arithmetic of the bf16 fused-AdaLN kernel (kernel 7),
emulated in torch on the CPU and held to the JAX package.

``csrc/adaln_dense.cu`` cannot run here, so this file pins what its bf16
design changes about the arithmetic: the rows of ``[B*T, D]`` go in tiles of
96 (a ragged last tile padded with zero rows, which are neither normalised
nor stored) and the output columns in slices of 256 (64 where Dout is no
multiple of 256); each row's LayerNorm, modulation with its own batch row's
scale and shift, and SiLU run in f32 and are rounded once to bf16 in
place of the raw row (the kernel's SiLU takes the fast exp and divide, a
few f32 ulps that the emulation leaves out); the product with w is summed
in f32 over panels of 32 k-rows, ``+ b`` is added to the f32 sum, and the
result is rounded once.
The emulation is held to the Pallas kernel ``_adaln_pallas`` in interpret
mode (``pltpu.force_tpu_interpret_mode()``, as
``tests/test_torch_module_kernels.py`` runs it) and to the port's
``adaln_dense_plain``, at the tolerance ``tests/test_torch_module_kernels.py``
states for ``adaln_dense`` in bf16: one bf16 ulp of the reference plus 2^-12
of its largest magnitude (both sides round the same f32-summed values once;
a value whose sums land on either side of a rounding boundary moves by one
ulp, and an activation rounded the other way moves the output by one ulp
of one term). The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase F1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from motiondiffusion_moe_tpu.ops.adaln_pallas import _adaln_pallas
from motiondiffusion_moe_tpu_torch.ops.adaln import (
    ADALN_DIMS,
    adaln_dense_plain,
)
from motiondiffusion_moe_tpu_torch.ops.performer import LN_EPS

from tests._torch_parity import assert_bf16_close, t

ROWS = 96     # rows per block (kAbRows)
PANEL_K = 32  # k-rows of a w panel (kAbPanelK)


def column_slice(dout: int) -> int:
    """Output columns per block of the bf16 kernel (dispatch_adaln)."""
    return 256 if dout % 256 == 0 else 64


def _inputs(B, T, D, Dout, seed):
    """bf16 h, scale, shift, w, b and f32 LayerNorm vectors at the scales
    of ``tests/test_torch_module_kernels.py``."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, T, D)),
              0.3 * rng.standard_normal((B, D)),
              0.3 * rng.standard_normal((B, D)),
              1 + 0.1 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
              rng.standard_normal((D, Dout)) * D ** -0.5,
              0.1 * rng.standard_normal(Dout))
    ts = [t(np.asarray(a, np.float32)) for a in arrays]
    return [x if i in (3, 4) else x.bfloat16() for i, x in enumerate(ts)]


def tiled_adaln(h, scale, shift, ln_scale, ln_bias, w, b):
    """The kernel's order of arithmetic on bf16 inputs; returns (out, the
    largest |activation| of the padded rows), out [B, T, Dout] in bf16."""
    B, T, D = h.shape
    Dout = w.shape[1]
    rows, NC = B * T, column_slice(Dout)
    assert Dout % NC == 0 and D % PANEL_K == 0
    hf = h.reshape(rows, D).float()
    batch = torch.arange(rows) // T
    wf, bf = w.float(), b.float()
    out = torch.empty(rows, Dout, dtype=torch.bfloat16)
    pad_act = 0.0
    for r0 in range(0, rows, ROWS):
        valid = min(ROWS, rows - r0)
        tile = torch.zeros(ROWS, D)  # the raw h tile, zeros past the end
        tile[:valid] = hf[r0:r0 + valid]
        x = tile[:valid]
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        n = (x - mu) * (1.0 / torch.sqrt(var + LN_EPS)) * ln_scale + ln_bias
        bt = batch[r0:r0 + valid]
        m = n * (1 + scale.float()[bt]) + shift.float()[bt]
        tile[:valid] = (m * (1 / (1 + torch.exp(-m)))).bfloat16().float()
        pad_act = max(pad_act, tile[valid:].abs().max().item()
                      if valid < ROWS else 0.0)
        for n0 in range(0, Dout, NC):
            acc = torch.zeros(ROWS, NC)
            for k0 in range(0, D, PANEL_K):
                acc = acc + (tile[:, k0:k0 + PANEL_K]
                             @ wf[k0:k0 + PANEL_K, n0:n0 + NC])
            res = acc + bf[n0:n0 + NC]
            out[r0:r0 + valid, n0:n0 + NC] = res[:valid].bfloat16()
    return out.reshape(B, T, Dout), pad_act


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax(args):
    """The same inputs for the JAX op: the LayerNorm vectors in f32."""
    return [jnp.asarray(a.float().numpy()) if i in (3, 4)
            else jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
            for i, a in enumerate(args)]


@pytest.mark.parametrize("D,Dout", [(256, 256), (256, 192), (512, 512),
                                    (512, 320)])
def test_tiled_order_matches_jax(D, Dout):
    assert D in ADALN_DIMS
    B, T = 3, 101  # 303 rows: three full tiles and a ragged one of 15
    args = _inputs(B, T, D, Dout, seed=D + Dout)
    out, pad_act = tiled_adaln(*args)
    assert pad_act == 0.0  # the padded rows stay zeros
    assert out.shape == (B, T, Dout)
    out = out.float().numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = _f32(_adaln_pallas(*_jax(args)))
    for ref in (pallas, adaln_dense_plain(*args).float().numpy()):
        assert_bf16_close(out, ref)


def test_a_tile_spans_two_batch_rows():
    """T = 50: every tile holds rows of two or three batch rows, each
    modulated by its own scale and shift."""
    args = _inputs(4, 50, 256, 256, seed=5)
    out, _ = tiled_adaln(*args)
    assert_bf16_close(out.float().numpy(),
                      adaln_dense_plain(*args).float().numpy())
