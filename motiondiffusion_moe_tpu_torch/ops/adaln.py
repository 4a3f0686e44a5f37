"""The fused AdaLN block body as one kernel, with its plain version.

Counterpart of ``motiondiffusion_moe_tpu/ops/adaln_pallas.py``:
:func:`adaln_dense` replaces ``adaln_dense`` (Pallas kernel
``_adaln_kernel``), the body of a ``StylizationBlock(fused=True)`` when no
dropout is active. For h ``[B, T, D]``, per-batch scale and shift ``[B, D]``,
the LayerNorm parameters ``[D]`` and the projection w ``[D, Dout]``,
b ``[Dout]``:

    act = silu(LayerNorm(h) * (1 + scale) + shift)    f32, rounded to w's dtype
    out = act . w + b                                  f32 sums, rounded once

CUDA C++ in ``csrc/adaln_dense.cu``: the normalised, modulated activations
never reach device memory, and the product runs inside the kernel (bf16 on
the tensor cores, f32 with IEEE FMAs).

In f32 the plain version equals ``adaln_dense_reference``. In bf16 the
reference rounds twice (after the product and again after ``+ b``); the TPU
kernel, the CUDA kernel and :func:`adaln_dense_plain` round once.

The wrapper is a ``torch.autograd.Function`` whose backward is autograd
through the plain version, as ``_adaln_bwd`` differentiates the reference.
It runs :func:`adaln_dense_plain` only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. ``adaln_dense.launches`` counts
the launches.
"""

from __future__ import annotations

import torch

from motiondiffusion_moe_tpu_torch.ops.performer import (
    _KERNEL_DTYPES,
    LN_EPS,
    _check_f32_vec,
    _require,
    _stream,
    plain_vjp,
)

# latent widths the CUDA library is instantiated for (small_dense 256,
# moe_small 512, moe_big 768, tools/train.py --model_size big 1024); Dout
# must be a multiple of 64
ADALN_DIMS = {256, 512, 768, 1024}


def adaln_kernel_ok(D: int, Dout: int) -> bool:
    """Whether the CUDA library has an instance of kernel 7 for input width
    ``D`` and output width ``Dout``; the wrapper raises on a CUDA tensor
    outside it."""
    return D in ADALN_DIMS and Dout > 0 and Dout % 64 == 0


def adaln_dense_plain(h: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's function in plain PyTorch. h: [B, T, D];
    scale/shift: [B, D]; ln_scale/ln_bias: [D]; w: [D, Dout]; b: [Dout].
    LayerNorm, modulation and SiLU in f32; the activations rounded to w's
    dtype; the product summed in f32 (the products of two w.dtype values
    are exact in f32); ``+ b`` in f32; one rounding to h's dtype."""
    hf = h.float()
    mu = hf.mean(-1, keepdim=True)
    var = ((hf - mu) ** 2).mean(-1, keepdim=True)
    normed = ((hf - mu) * torch.rsqrt(var + LN_EPS) * ln_scale.float()
              + ln_bias.float())
    mod = normed * (1 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    act = (mod * torch.sigmoid(mod)).to(w.dtype)
    out = torch.matmul(act.float(), w.float()) + b.float()
    return out.to(h.dtype)


def _launch(h, scale, shift, ln_scale, ln_bias, w, b) -> torch.Tensor:
    op = "adaln_dense"
    _require(h.dim() == 3 and h.dtype in _KERNEL_DTYPES,
             f"{op}: h must be a [B, T, D] float32 or bfloat16 tensor, got "
             f"{h.dtype} {tuple(h.shape)}")
    B, T, D = h.shape
    _require(w.dim() == 2 and w.shape[0] == D,
             f"{op}: w must be [{D}, Dout], got {tuple(w.shape)}")
    Dout = w.shape[1]
    _require(adaln_kernel_ok(D, Dout),
             f"{op}: D={D} not in {sorted(ADALN_DIMS)} or Dout={Dout} not a "
             "positive multiple of 64")
    _require(B > 0 and T > 0, f"{op}: empty input")
    _require(h.device.type == "cuda", f"{op}: unsupported device {h.device}")
    for name, t, shape in (("h", h, (B, T, D)), ("scale", scale, (B, D)),
                           ("shift", shift, (B, D)), ("w", w, (D, Dout)),
                           ("b", b, (Dout,))):
        _require(t.device == h.device and t.dtype == h.dtype
                 and tuple(t.shape) == shape and t.is_contiguous()
                 and t.data_ptr() % 16 == 0,
                 f"{op}: {name} must be a contiguous, 16-byte aligned "
                 f"{h.dtype} {list(shape)} tensor on {h.device}, got "
                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _check_f32_vec("ln_scale", ln_scale, D, h.device)
    _check_f32_vec("ln_bias", ln_bias, D, h.device)
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    out = torch.empty((B, T, Dout), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.mdm_adaln_dense(
            h.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), B * T, T, D, Dout,
            _KERNEL_DTYPES[h.dtype], _stream(h.device))
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc}")
    adaln_dense.launches += 1
    return out


class _AdalnDense(torch.autograd.Function):
    """The kernel forward; the backward is autograd through the plain
    version, from the saved inputs."""

    @staticmethod
    def forward(ctx, h, scale, shift, ln_scale, ln_bias, w, b):
        args = (h, scale, shift, ln_scale, ln_bias, w, b)
        ctx.save_for_backward(*args)
        if h.device.type == "cpu":
            return adaln_dense_plain(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(adaln_dense_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, g)


def adaln_dense(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm -> modulate -> SiLU -> dense (see the module doc),
    differentiable on every device. CPU tensors take
    :func:`adaln_dense_plain`; CUDA tensors launch ``csrc/adaln_dense.cu``.

    On CUDA: h, scale, shift, w and b contiguous, 16-byte aligned, one
    dtype (f32 or bf16); D in :data:`ADALN_DIMS`; Dout a multiple of 64;
    ln_scale and ln_bias contiguous float32 [D]."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"adaln_dense: unsupported device {h.device}")
    return _AdalnDense.apply(h, scale, shift, ln_scale, ln_bias, w, b)


adaln_dense.launches = 0
