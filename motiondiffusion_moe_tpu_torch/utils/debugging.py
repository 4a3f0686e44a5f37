"""Numerical-failure detection.

Port of ``motiondiffusion_moe_tpu/utils/debugging.py``:

- :func:`enable_nan_debugging` — ``torch.autograd.set_detect_anomaly``:
  a backward that produces a NaN raises at the producing op, with the
  forward's traceback;
- :func:`checked` / :func:`check_finite` — in place of checkify's error
  value, each call of a ``checked`` function keeps one device-side flag.
  Every :func:`check_finite` inside it ANDs ``torch.isfinite(x).all()``
  into the flag (and keeps its own result beside it) without a host sync;
  the wrapper reads them once, when the function returns, and raises
  ``FloatingPointError`` naming the checks that fired. A ``check_finite``
  outside any ``checked`` call checks at once (one host sync);
- :func:`assert_finite_tree` — host-side NaN/Inf sweep over nested dicts,
  lists and tuples of tensors and arrays, with the JAX version's message.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, List, Mapping, Tuple

import numpy as np
import torch


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise (with the forward's traceback) whenever a backward produces a
    NaN."""
    torch.autograd.set_detect_anomaly(enable)


class _Checks:
    """The checks of one ``checked`` call: the AND of all of them (the
    flag) and each one's own result, on the device."""

    def __init__(self):
        self.flag = None
        self.results: List[Tuple[str, torch.Tensor]] = []


_LOCAL = threading.local()


def _stack() -> List[_Checks]:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


def _message(names) -> str:
    return "; ".join(f"non-finite {n} detected" for n in names)


def check_finite(x: torch.Tensor, name: str = "value") -> None:
    """Finite assertion on ``x``: recorded on the device inside a
    :func:`checked` call, checked at once outside one."""
    ok = torch.isfinite(torch.as_tensor(x)).all()
    stack = _stack()
    if not stack:
        if not bool(ok):
            raise FloatingPointError(_message([name]))
        return
    checks = stack[-1]
    checks.flag = ok if checks.flag is None else checks.flag & ok
    checks.results.append((name, ok))


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that its :func:`check_finite` assertions stay on the
    device; the wrapper reads them once and raises on the host only when
    one fired.

    >>> step = checked(train_step)
    >>> out = step(state, batch)   # raises on NaN
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        checks = _Checks()
        _stack().append(checks)
        try:
            out = fn(*args, **kwargs)
        finally:
            _stack().pop()
        if checks.results:
            # one read: the flag, then each check's own result
            read = torch.stack([checks.flag] + [
                r.to(checks.flag.device) for _, r in checks.results]).tolist()
            if not read[0]:
                raise FloatingPointError(_message(
                    n for (n, _), ok in zip(checks.results, read[1:])
                    if not ok))
        return out

    return wrapper


def _leaves(tree: Any, path: str = ""):
    """(path, leaf) pairs in ``jax.tree_util``'s order (a dict's keys
    sorted), paths as ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return True
        return bool(torch.isfinite(leaf.detach()).all())
    a = np.asarray(leaf)
    if not np.issubdtype(a.dtype, np.inexact):
        return True
    return bool(np.isfinite(a).all())


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Host-side NaN/Inf sweep over nested dicts, lists and tuples of
    tensors and arrays (checkpoint / batch guard)."""
    bad = [path for path, leaf in _leaves(tree) if not _finite(leaf)]
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}: {', '.join(bad[:10])}"
            + (f" (+{len(bad)-10} more)" if len(bad) > 10 else ""))
