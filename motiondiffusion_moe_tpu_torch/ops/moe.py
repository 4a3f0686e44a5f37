"""The fused MoE ``dense_fused`` expert chain as one kernel, with its plain
version.

Counterpart of ``motiondiffusion_moe_tpu/ops/moe_pallas.py``:
:func:`moe_dense_fused` replaces ``moe_dense_fused`` (Pallas kernel
``_moe_kernel``). For tokens ``x [S, D]`` and the finished routing weights
``combine [S, E]`` it computes, with f32 accumulation,

    h   = gelu_tanh(x . W1m + b1) * combine      (per expert block, in f32)
    out = round(h) . W2m + combine . b2

where ``W1m [D, E*hid]`` / ``W2m [E*hid, D]`` are the experts' weights
merged along the hidden axis. The kernel (CUDA C++ in
``csrc/moe_dense_fused.cu``) reads the stored ``w1 [E, D, hid]`` and
``w2 [E, hid, D]`` as they are and indexes the merged views itself, so no
call copies the weights into the merged layout; the ``[S, E*hid]`` hidden
tensor never reaches device memory.

The wrapper is a ``torch.autograd.Function``: its backward is autograd
through the plain version, as the JAX ``custom_vjp`` differentiates the
reference (``moe_pallas.py:137-139``). It runs :func:`moe_dense_fused_plain`
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises. ``moe_dense_fused.launches`` counts the launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from motiondiffusion_moe_tpu_torch.ops.performer import (
    _KERNEL_DTYPES,
    _require,
    _stream,
    plain_vjp,
)

# latent widths the CUDA library is instantiated for (multiples of 128 up
# to moe_big's 768, and tools/train.py --model_size big's 1024); the hidden
# width must be a multiple of 128, as the JAX package's condition for the
# kernel asks (models/moe.py:145)
MOE_DIMS = {128, 256, 384, 512, 640, 768, 1024}
MOE_MAX_EXPERTS = 64


def moe_kernel_ok(D: int, hid: int, num_experts: int) -> bool:
    """Whether the CUDA library has an instance of kernel 5 for width
    ``D``, expert hidden width ``hid`` and ``num_experts`` experts; the
    wrapper raises on a CUDA tensor outside it."""
    return (D in MOE_DIMS and hid > 0 and hid % 128 == 0
            and 0 < num_experts <= MOE_MAX_EXPERTS)


def moe_dense_fused_plain(x: torch.Tensor, combine: torch.Tensor,
                          w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The kernel's math in plain PyTorch (``moe_dense_fused_reference``).

    x: [S, D]; combine: [S, E]; w1: [E, D, hid]; b1: [E, hid];
    w2: [E, hid, D]; b2: [E, D], all in x's dtype. Both products multiply
    x.dtype values and sum in f32; the bias, gelu and combine weighting run
    in f32 and are rounded to x.dtype once, before the second product.
    Returns [S, D] in x's dtype."""
    E, D, hid = w1.shape
    S = x.shape[0]
    w1m = w1.permute(1, 0, 2).reshape(D, E * hid)
    h = x.float() @ w1m.float() + b1.reshape(1, E * hid).float()
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    h = (h.view(S, E, hid) * combine.float()[:, :, None]).to(x.dtype)
    out = h.reshape(S, E * hid).float() @ w2.reshape(E * hid, D).float()
    out = out + combine.float() @ b2.float()
    return out.to(x.dtype)


def _check(x, combine, w1, b1, w2, b2):
    """Validate the kernel's inputs; returns (S, D, E, hid)."""
    _require(x.dim() == 2 and x.dtype in _KERNEL_DTYPES,
             f"moe_dense_fused: x must be a [S, D] float32 or bfloat16 "
             f"tensor, got {x.dtype} {tuple(x.shape)}")
    _require(w1.dim() == 3, "moe_dense_fused: w1 must be [E, D, hid]")
    S, D = x.shape
    E, _, hid = w1.shape
    _require(moe_kernel_ok(D, hid, E),
             f"moe_dense_fused: D={D} not in {sorted(MOE_DIMS)}, hid={hid} "
             f"not a multiple of 128 or E={E} outside [1, "
             f"{MOE_MAX_EXPERTS}]")
    _require(S > 0, "moe_dense_fused: empty input")
    _require(x.device.type == "cuda", f"moe_dense_fused: unsupported device "
                                      f"{x.device}")
    for name, t, shape in (("x", x, (S, D)), ("combine", combine, (S, E)),
                           ("w1", w1, (E, D, hid)), ("b1", b1, (E, hid)),
                           ("w2", w2, (E, hid, D)), ("b2", b2, (E, D))):
        _require(t.device == x.device and t.dtype == x.dtype
                 and tuple(t.shape) == shape and t.is_contiguous()
                 and t.data_ptr() % 16 == 0,
                 f"moe_dense_fused: {name} must be a contiguous, 16-byte "
                 f"aligned {x.dtype} {list(shape)} tensor on {x.device}, "
                 f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return S, D, E, hid


def _launch(x, combine, w1, b1, w2, b2) -> torch.Tensor:
    S, D, E, hid = _check(x, combine, w1, b1, w2, b2)
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.mdm_moe_dense_fused(
            x.data_ptr(), combine.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), S, D, E, hid,
            _KERNEL_DTYPES[x.dtype], _stream(x.device))
    if rc != 0:
        raise RuntimeError(
            f"moe_dense_fused kernel launch failed: CUDA error {rc}")
    moe_dense_fused.launches += 1
    return out


class _MoEDenseFused(torch.autograd.Function):
    """The kernel forward; the backward is autograd through the plain
    version, from the saved inputs."""

    @staticmethod
    def forward(ctx, x, combine, w1, b1, w2, b2):
        args = (x, combine, w1, b1, w2, b2)
        ctx.save_for_backward(*args)
        if x.device.type == "cpu":
            return moe_dense_fused_plain(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(moe_dense_fused_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, g)


def moe_dense_fused(x: torch.Tensor, combine: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    """The fused expert chain (see the module doc), differentiable on every
    device. CPU tensors take :func:`moe_dense_fused_plain`; CUDA tensors
    launch ``csrc/moe_dense_fused.cu``.

    On CUDA: every input contiguous, 16-byte aligned and in x's dtype (f32
    or bf16); D in :data:`MOE_DIMS`, hid a multiple of 128, at most
    :data:`MOE_MAX_EXPERTS` experts."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moe_dense_fused: unsupported device {x.device}")
    return _MoEDenseFused.apply(x, combine, w1, b1, w2, b2)


moe_dense_fused.launches = 0
