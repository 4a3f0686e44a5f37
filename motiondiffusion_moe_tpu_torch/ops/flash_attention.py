"""Exact cross-attention kernels, with their plain versions.

Counterpart of ``motiondiffusion_moe_tpu/ops/flash_attention.py``:

- :func:`xattn_fastlayout` replaces ``xattn_fastlayout`` (Pallas kernel
  ``_xattn_fast_kernel``). It reads q ``[B, T, H*D]`` and k, v
  ``[B, N, H*D]`` straight in the Dense output layout, heads as column
  slices, and computes per head an exact softmax attention with no key mask
  (the reference leaves padded text keys unmasked).
- :func:`flash_cross_attention` replaces ``flash_cross_attention`` (Pallas
  kernel ``_flash_kernel``): the same function on head-major q
  ``[B, H, T, D]`` and k, v ``[B, H, N, D]``, for any N.

Both keep the scores, the softmax and ``probs @ v`` in f32, with one
rounding to q's dtype; the scores and probabilities never reach device
memory. bf16 inputs run on the tensor cores (``csrc/cross_attention_mma.cu``,
one kernel for both layouts, any N): q . k of bf16 values is exact in f32
sums, and the probabilities go through the second product as two bf16
terms, p = p_hi + p_lo, so they keep ~16 bits (rounding them to bf16, as
``scaled_dot_product_attention`` does, moves about a third of the outputs,
by up to tens of ulps near zero). f32 inputs keep IEEE f32 FMAs
(``csrc/xattn_fastlayout.cu``, where a whole head's k and v sit in shared
memory, which bounds N; ``csrc/flash_cross_attention.cu``, keys in blocks
of ``block_n``).

Each wrapper is a ``torch.autograd.Function`` whose backward is autograd
through the plain version, as the JAX ``custom_vjp``s differentiate their
references (``flash_attention.py:122-129, 234-242``). It runs the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises. ``<wrapper>.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from motiondiffusion_moe_tpu_torch.ops.performer import (
    _KERNEL_DTYPES,
    _require,
    _stream,
    plain_vjp,
)

# head dims the CUDA library is instantiated for (small_dense 64, moe_big
# 96, moe_small 128, tools/train.py --model_size big 256)
XATTN_HEAD_DIMS = {64, 96, 128, 256}


def xattn_kernel_ok(head_dim: int) -> bool:
    """Whether the CUDA library has an instance of kernels 6 and 9 for
    ``head_dim``; the wrappers raise on a CUDA tensor outside it."""
    return head_dim in XATTN_HEAD_DIMS


# shared memory one block of an sm_90 card may opt into
MAX_SMEM_PER_BLOCK = 232448


def xattn_fastlayout_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's math in plain PyTorch (``xattn_fastlayout_reference``).
    q: [B, T, H*D]; k, v: [B, N, H*D]. Returns [B, T, H*D] in q's dtype."""
    B, T, HD = q.shape
    N = k.shape[1]
    D = HD // num_heads
    s = scale if scale is not None else D ** -0.5
    qh = q.reshape(B, T, num_heads, D).float() * s
    kh = k.reshape(B, N, num_heads, D).float()
    vh = v.reshape(B, N, num_heads, D).float()
    probs = torch.softmax(torch.einsum("bthd,bnhd->bhtn", qh, kh), dim=-1)
    out = torch.einsum("bhtn,bnhd->bthd", probs, vh)
    return out.reshape(B, T, HD).to(q.dtype)


def _check(q, k, v, num_heads):
    """Validate the kernel's inputs; returns (B, T, N, H, D)."""
    _require(q.dim() == 3 and q.dtype in _KERNEL_DTYPES,
             f"xattn_fastlayout: q must be a [B, T, H*D] float32 or bfloat16 "
             f"tensor, got {q.dtype} {tuple(q.shape)}")
    B, T, HD = q.shape
    H = num_heads
    _require(H > 0 and HD % H == 0 and xattn_kernel_ok(HD // H),
             f"xattn_fastlayout: head dim {HD}/{H} not in "
             f"{sorted(XATTN_HEAD_DIMS)}")
    _require(q.device.type == "cuda", f"xattn_fastlayout: unsupported "
                                      f"device {q.device}")
    _require(k.dim() == 3 and k.shape[0] == B and k.shape[2] == HD,
             f"xattn_fastlayout: k must be [{B}, N, {HD}], got "
             f"{tuple(k.shape)}")
    N = k.shape[1]
    _require(B > 0 and T > 0 and N > 0, "xattn_fastlayout: empty input")
    for name, t, shape in (("q", q, (B, T, HD)), ("k", k, (B, N, HD)),
                           ("v", v, (B, N, HD))):
        _require(t.device == q.device and t.dtype == q.dtype
                 and tuple(t.shape) == shape and t.is_contiguous()
                 and t.data_ptr() % 16 == 0,
                 f"xattn_fastlayout: {name} must be a contiguous, 16-byte "
                 f"aligned {q.dtype} {list(shape)} tensor on {q.device}, "
                 f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return B, T, N, H, HD // H


def _launch(q, k, v, num_heads, scale) -> torch.Tensor:
    B, T, N, H, D = _check(q, k, v, num_heads)
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if q.dtype == torch.bfloat16:
        launch = lambda: lib.mdm_xattn_fastlayout_bf16(  # noqa: E731
            *ptrs, B, T, N, H, D, scale, _stream(q.device))
    else:
        smem = lib.mdm_xattn_fastlayout_smem_bytes(N, D)
        _require(smem <= MAX_SMEM_PER_BLOCK,
                 f"xattn_fastlayout: N={N} f32 keys of head dim {D} need "
                 f"{smem} bytes of shared memory, more than "
                 f"{MAX_SMEM_PER_BLOCK}")
        launch = lambda: lib.mdm_xattn_fastlayout(  # noqa: E731
            *ptrs, B, T, N, H, D, scale, _stream(q.device))
    with torch.cuda.device(q.device):
        rc = launch()
    if rc != 0:
        raise RuntimeError(
            f"xattn_fastlayout kernel launch failed: CUDA error {rc}")
    xattn_fastlayout.launches += 1
    return out


class _XAttnFastLayout(torch.autograd.Function):
    """The kernel forward; the backward is autograd through the plain
    version, from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        if q.device.type == "cpu":
            return xattn_fastlayout_plain(q, k, v, num_heads, scale)
        return _launch(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(xattn_fastlayout_plain, ctx.saved_tensors,
                           ctx.needs_input_grad, g, ctx.num_heads,
                           ctx.scale), None, None)


def xattn_fastlayout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Fast-layout exact cross-attention (see the module doc),
    differentiable on every device. CPU tensors take
    :func:`xattn_fastlayout_plain`; CUDA tensors launch
    ``csrc/xattn_fastlayout.cu``.

    On CUDA: q, k, v contiguous, 16-byte aligned, one dtype (f32 or bf16);
    head dim in :data:`XATTN_HEAD_DIMS`; any N in bf16; in f32, N small
    enough for k and v of one head to fit in shared memory (about 180 keys
    at head dim 128, 91 at head dim 256, where the text encoder emits
    85)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"xattn_fastlayout: unsupported device {q.device}")
    D = q.shape[-1] // num_heads
    s = float(scale) if scale is not None else D ** -0.5
    return _XAttnFastLayout.apply(q, k, v, num_heads, s)


xattn_fastlayout.launches = 0


# ---------------------------------------------------------------------------
# kernel 9: flash_cross_attention
# ---------------------------------------------------------------------------

def flash_cross_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """The Pallas ``_flash_kernel``'s function in plain PyTorch. q:
    [B, H, T, D]; k, v: [B, H, N, D]; no mask. Inputs widened to f32;
    scores, softmax and ``probs @ v`` in f32; one rounding to q's dtype.
    (The JAX CPU default, ``cross_attention_reference``, rounds the
    probabilities to q's dtype; in f32 the two agree.)"""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bhtd,bhnd->bhtn", q.float() * s, k.float())
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhtn,bhnd->bhtd", probs, v.float()).to(q.dtype)


def _launch_flash(q, k, v, scale, block_n) -> torch.Tensor:
    op = "flash_cross_attention"
    _require(q.dim() == 4 and q.dtype in _KERNEL_DTYPES,
             f"{op}: q must be a [B, H, T, D] float32 or bfloat16 tensor, "
             f"got {q.dtype} {tuple(q.shape)}")
    B, H, T, D = q.shape
    _require(xattn_kernel_ok(D),
             f"{op}: head dim {D} not in {sorted(XATTN_HEAD_DIMS)}")
    _require(q.device.type == "cuda", f"{op}: unsupported device {q.device}")
    _require(k.dim() == 4 and k.shape[:2] == (B, H) and k.shape[3] == D,
             f"{op}: k must be [{B}, {H}, N, {D}], got {tuple(k.shape)}")
    N = k.shape[2]
    _require(B > 0 and H > 0 and T > 0 and N > 0, f"{op}: empty input")
    for name, t, shape in (("q", q, (B, H, T, D)), ("k", k, (B, H, N, D)),
                           ("v", v, (B, H, N, D))):
        _require(t.device == q.device and t.dtype == q.dtype
                 and tuple(t.shape) == shape and t.is_contiguous()
                 and t.data_ptr() % 16 == 0,
                 f"{op}: {name} must be a contiguous, 16-byte aligned "
                 f"{q.dtype} {list(shape)} tensor on {q.device}, got "
                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if q.dtype == torch.bfloat16:
        launch = lambda: lib.mdm_flash_cross_attention_bf16(  # noqa: E731
            *ptrs, B * H, T, N, D, scale, _stream(q.device))
    else:
        # halved until the plan fits: at head dim 256 a block holds at most
        # 91 keys (128 do not fit)
        bn = min(block_n, N)
        while (bn > 1 and lib.mdm_flash_cross_attention_smem_bytes(bn, D)
               > MAX_SMEM_PER_BLOCK):
            bn = (bn + 1) // 2
        launch = lambda: lib.mdm_flash_cross_attention(  # noqa: E731
            *ptrs, B * H, T, N, D, bn, scale, _stream(q.device))
    with torch.cuda.device(q.device):
        rc = launch()
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc}")
    flash_cross_attention.launches += 1
    return out


class _FlashCrossAttention(torch.autograd.Function):
    """Kernel 9 forward; the backward is autograd through the plain
    version, as ``_flash_bwd`` differentiates the reference."""

    @staticmethod
    def forward(ctx, q, k, v, scale, block_n):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.device.type == "cpu":
            return flash_cross_attention_plain(q, k, v, scale)
        return _launch_flash(q, k, v, scale, block_n)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(flash_cross_attention_plain, ctx.saved_tensors,
                           ctx.needs_input_grad, g, ctx.scale), None, None)


def flash_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None, block_q: int = 128,
                          block_n: int = 128) -> torch.Tensor:
    """Exact cross-attention with an online softmax (see the module doc),
    differentiable on every device; the JAX signature. CPU tensors take
    :func:`flash_cross_attention_plain`; CUDA tensors launch
    ``csrc/cross_attention_mma.cu`` (bf16) or
    ``csrc/flash_cross_attention.cu`` (f32, keys through shared memory
    ``block_n`` rows at a time). ``block_q``, and in bf16 ``block_n``, are
    kept for the JAX signature and set no tile: the bf16 kernel takes 128
    query rows (64 at head dim 256) and 32 keys at a time, the f32 one 32
    query rows. In f32 ``block_n`` is halved until a block fits in shared
    memory (at head dim 256, 128 keys do not).

    On CUDA: q, k, v contiguous, 16-byte aligned, one dtype (f32 or bf16);
    head dim in :data:`XATTN_HEAD_DIMS`; any number of keys."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"flash_cross_attention: unsupported device {q.device}")
    if block_n <= 0:
        raise ValueError(
            f"flash_cross_attention: block_n={block_n} must be positive")
    s = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _FlashCrossAttention.apply(q, k, v, s, int(block_n))


flash_cross_attention.launches = 0
