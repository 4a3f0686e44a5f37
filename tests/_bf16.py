"""The bf16 comparison rule of the port's tests and ``chip_smoke.py``.

Imports numpy only, so the card tests (``tests/test_torch_cuda.py``, run
without the JAX package) and ``chip_smoke.py`` share it with the parity
tests (``tests/_torch_parity.py``).
"""

import numpy as np


def bf16_flips(out, ref) -> tuple:
    """(share of values that differ, largest difference in ulps) of a bf16
    result against its reference: one bf16 ulp of the reference value,
    floored at 2^-16 of the largest |ref| (where values cancel to near zero,
    the absolute error of f32 sums is more than their ulp). Takes numpy
    arrays or tensors (on any device)."""
    out, ref = (np.asarray(a.detach().float().cpu().numpy()
                           if hasattr(a, "detach") else a, np.float32)
                for a in (out, ref))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                  - 7)
    ulp = np.maximum(ulp, 2.0 ** -16 * np.abs(ref).max())
    return float((out != ref).mean()), float((np.abs(out - ref) / ulp).max())


def assert_bf16_flips(out, ref, share: float = 0.01) -> None:
    """At most ``share`` of the values one ulp (:func:`bf16_flips`) from the
    reference, and none further."""
    flipped, worst = bf16_flips(out, ref)
    assert flipped <= share and worst <= 1.0, (flipped, worst)
