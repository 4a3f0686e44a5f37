"""The bf16 activations as the JAX package computes them, with their kernels.

In bf16 compute, XLA evaluates flax's ``nn.silu``, ``nn.gelu`` (the tanh
form) and ``nn.sigmoid`` step by step, each step in f32 and rounded to bf16
(the compiled CPU program: a bf16 ``convert`` after every ``neg``, ``exp``,
``add``, ``divide`` and ``multiply``; ``jax.nn.sigmoid`` is expanded as
``1 / (1 + exp(-x))``, and the weakly typed constants of ``nn.gelu`` are
bf16: 0.044677734375 and 0.796875). PyTorch's ``F.silu`` and ``F.gelu``
round once, so they differ from JAX by one ulp in 30-45% of the outputs.
The plain versions here take JAX's steps with torch ops; the CUDA kernel
(``csrc/activations.cu``, one elementwise pass per call) takes the same
steps in f32 with ``expf`` / ``tanhf`` and the same roundings.

Each activation may take the bias of the ``Dense`` that feeds it: flax
rounds the product to bf16 and then adds the bias in bf16, so
``act(x, bias)`` is ``act(bf16(x + bias))``, the bias broadcast over the
last axis; the kernel does the add in the same pass.

Other dtypes take PyTorch's own functions: in f32 the step roundings are at
f32 precision. The bf16 wrappers are ``torch.autograd.Function``s. They run
the plain version only for CPU tensors; a CUDA tensor launches the kernel or
raises. ``<wrapper>.launches`` counts the launches. The backward is
:func:`activation_grad`: the gradient as ``jax.grad`` of the JAX package's
bf16 function computes it, read from its jaxpr and compiled CPU program
(the sigmoid of the forward, s * (1 - s), and each product and sum of the
transposed program, every step rounded to bf16), so dx gives JAX's bits.
On the card it is the same kernel's gradient pass, one launch; the bias
gradient is the f32 sum of dx over the rows, rounded once, as XLA reduces
it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from motiondiffusion_moe_tpu_torch.ops.performer import _require, _stream

# flax's weakly typed gelu constants, rounded to bf16 as JAX rounds them
GELU_CUBIC = 0.044677734375   # 0.044715
GELU_SCALE = 0.796875         # sqrt(2 / pi)
# the kernel's op codes (csrc/activations.cu)
_OPS = {"silu": 0, "gelu": 1, "sigmoid": 2}


def _r(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and widen them back."""
    return x.to(torch.bfloat16).float()


def _biased(x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    xf = x.float()
    return xf if bias is None else _r(xf + bias.float())


def _sigmoid_steps(xf: torch.Tensor) -> torch.Tensor:
    return _r(1.0 / _r(_r(torch.exp(_r(-xf))) + 1.0))


def sigmoid_plain(x: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 ``nn.sigmoid`` as XLA computes it: 1 / (1 + exp(-x)), rounded
    after each step."""
    return _sigmoid_steps(_biased(x, bias)).to(x.dtype)


def silu_plain(x: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 ``nn.silu``: x * sigmoid(x), each step rounded."""
    xf = _biased(x, bias)
    return (xf * _sigmoid_steps(xf)).to(x.dtype)


def gelu_plain(x: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 ``nn.gelu`` (tanh form): x * 0.5 * (1 + tanh(c1 * (x + c0 *
    x^3))), each step rounded, x^3 as (x * x) * x."""
    xf = _biased(x, bias)
    cube = _r(_r(xf * xf) * xf)
    inner = _r(_r(xf + _r(cube * GELU_CUBIC)) * GELU_SCALE)
    half = _r(_r(_r(torch.tanh(inner)) + 1.0) * 0.5)
    return (xf * half).to(x.dtype)


_PLAIN = {"silu": silu_plain, "gelu": gelu_plain, "sigmoid": sigmoid_plain}


def _sigmoid_grad_steps(e: torch.Tensor):
    """(s, s * (1 - s)) of bf16 values e, each step rounded."""
    s = _r(_sigmoid_steps(e))
    return s, _r(s * _r(1.0 - s))


def activation_grad_plain(op: str, x: torch.Tensor, g: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """dx of ``op(x + bias)`` for the cotangent g, in bf16 as ``jax.grad``
    of the flax function computes it: the transposed program's steps in
    f32, each rounded to bf16."""
    e, gf = _biased(x, bias), g.float()
    if op == "sigmoid":
        return (gf * _sigmoid_grad_steps(e)[1]).to(x.dtype)
    if op == "silu":
        s, d = _sigmoid_grad_steps(e)
        return (_r(gf * s) + _r(_r(e * gf) * d)).to(x.dtype)
    square = _r(e * e)
    cube = _r(square * e)
    th = _r(torch.tanh(_r(_r(e + _r(cube * GELU_CUBIC)) * GELU_SCALE)))
    half = _r(_r(th + 1.0) * 0.5)
    y = _r(_r(_r(e * gf) * 0.5) * _r(1.0 - th))
    inner = _r(_r(y + _r(y * th)) * GELU_SCALE)
    return (_r(_r(gf * half) + inner)
            + _r(_r(inner * GELU_CUBIC) * _r(square * 3.0))).to(x.dtype)


def _launch(op: str, x: torch.Tensor, bias: Optional[torch.Tensor],
            g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's forward pass, or with a cotangent g its gradient pass
    (dx)."""
    _require(x.device.type == "cuda", f"{op}: unsupported device {x.device}")
    _require(x.dtype == torch.bfloat16 and x.is_contiguous(),
             f"{op}: x must be a contiguous bfloat16 tensor, got {x.dtype}")
    C = x.shape[-1] if x.dim() else 1
    if bias is not None:
        _require(bias.device == x.device and bias.dtype == x.dtype
                 and bias.shape == (C,) and bias.is_contiguous(),
                 f"{op}: bias must be a contiguous bfloat16 [{C}] tensor on "
                 f"{x.device}, got {bias.dtype} {tuple(bias.shape)} on "
                 f"{bias.device}")
    if g is not None:
        _require(g.device == x.device and g.dtype == x.dtype
                 and g.shape == x.shape and g.is_contiguous(),
                 f"{op}: the cotangent must be a contiguous bfloat16 tensor "
                 f"of x's shape on {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    from motiondiffusion_moe_tpu_torch.ops._build import library

    b = None if bias is None else bias.data_ptr()
    with torch.cuda.device(x.device):
        if g is None:
            rc = library().mdm_activation(x.data_ptr(), b, out.data_ptr(),
                                          x.numel(), C, _OPS[op],
                                          _stream(x.device))
        else:
            rc = library().mdm_activation_grad(
                x.data_ptr(), b, g.data_ptr(), out.data_ptr(), x.numel(), C,
                _OPS[op], _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc}")
    (_WRAPPERS[op] if g is None else activation_grad).launches += 1
    return out


def activation_grad(op: str, x: torch.Tensor, g: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx of the bf16 ``op(x + bias)`` for the cotangent g: the kernel's
    gradient pass, or :func:`activation_grad_plain` for CPU tensors."""
    if x.device.type == "cpu":
        return activation_grad_plain(op, x, g, bias)
    return _launch(op, x, bias, g)


class _Activation(torch.autograd.Function):
    """The kernel forward (the plain version on the CPU); the backward is
    JAX's bf16 gradient (see the module doc)."""

    @staticmethod
    def forward(ctx, x, bias, op):
        ctx.save_for_backward(x, bias)
        ctx.op = op
        if x.device.type == "cpu":
            return _PLAIN[op](x, bias)
        return _launch(op, x, bias)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx = activation_grad(ctx.op, x, g.to(x.dtype).contiguous(), bias)
        db = None
        if bias is not None and ctx.needs_input_grad[1]:
            db = dx.reshape(-1, dx.shape[-1]).sum(
                0, dtype=torch.float32).to(dx.dtype)
        return dx, db, None


def _activation(op: str, torch_fn, x: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        return torch_fn(x if bias is None else x + bias.to(x.dtype))
    bias = None if bias is None else bias.to(x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or (
            bias is not None and bias.requires_grad)):
        return _Activation.apply(x, bias, op)
    # no graph to record: skip the autograd Function's host cost, which is
    # most of a call's on a host-bound sampling path
    return _PLAIN[op](x, bias) if x.device.type == "cpu" else _launch(
        op, x, bias)


def silu(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nn.silu(x + bias)`` with the JAX package's bf16 roundings (see the
    module doc); other dtypes ``F.silu``."""
    return _activation("silu", F.silu, x, bias)


def gelu(x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nn.gelu(x + bias)`` (tanh form) with the JAX package's bf16
    roundings; other dtypes ``F.gelu(approximate="tanh")``."""
    return _activation("gelu", lambda y: F.gelu(y, approximate="tanh"), x,
                       bias)


def sigmoid(x: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nn.sigmoid(x + bias)`` with the JAX package's bf16 roundings;
    other dtypes ``torch.sigmoid``."""
    return _activation("sigmoid", torch.sigmoid, x, bias)


_WRAPPERS = {"silu": silu, "gelu": gelu, "sigmoid": sigmoid}
for _fn in (*_WRAPPERS.values(), activation_grad):
    _fn.launches = 0
