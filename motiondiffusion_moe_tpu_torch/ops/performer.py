"""The two Performer kernels of the sampling path, with their plain versions.

Counterpart of ``motiondiffusion_moe_tpu/ops/performer_pallas.py``:

- :func:`favor_qkv` replaces ``favor_attention_qkv`` (Pallas kernel
  ``_favor_qkv_kernel_v2``): the whole FastAttention body on the merged
  ``[B, T, 3*H*D]`` qkv panel. CUDA C++ in ``csrc/favor_qkv.cu``.
- :func:`performer_epilogue` replaces ``performer_epilogue`` (Pallas kernel
  ``_epilogue_kernel``): post-LN -> L2*sqrt(D) -> style-LN -> modulate ->
  SiLU in one read and one write. CUDA C++ in ``csrc/performer_epilogue.cu``.

Each wrapper runs its plain PyTorch version (``*_plain``, mirroring
``favor_qkv_reference`` / ``performer_epilogue_reference``) only for tensors
on the CPU. For a CUDA tensor it launches the kernel or raises: there is no
fallback. Each wrapper counts its launches in ``<wrapper>.launches``; a run
can reset the count and read it to show that the main path went through the
kernel. The source notes in ``csrc/`` say what bounds each kernel on the card
and what its design does about it.

Forward only: the backward kernels come with the training port.
"""

from __future__ import annotations

from typing import Optional

import torch

LN_EPS = 1e-6  # flax.linen.LayerNorm default, as in the JAX ops

# (head_dim, num_features) pairs and epilogue widths the CUDA library is
# instantiated for (see the C entries in csrc/): those of the config presets
# moe_small (128, 128; 512), moe_big (96, 128; 768) and small_dense
# (64, 128; 256)
FAVOR_SHAPES = {(64, 128), (96, 128), (128, 128)}
EPILOGUE_DIMS = {256, 512, 768}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * w.float() + b.float()


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def favor_qkv_plain(qkv: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, projection: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, eps: float = 1e-6,
                    pre_scale: float = 0.1) -> torch.Tensor:
    """qkv: [B, T, 3*H*D] (column order q|k|v); ln_scale/ln_bias: [D];
    projection: [D, m]; mask: [B, T] or None. Returns [B, T, H*D] in qkv's
    dtype; everything inside runs in f32."""
    B, T, HD3 = qkv.shape
    HD = HD3 // 3
    D = projection.shape[0]
    H = HD // D

    def heads(x):
        return x.reshape(B, T, H, D).float() * pre_scale

    q, k, v = qkv.split(HD, dim=-1)
    qh = _l2(_ln(heads(q), ln_scale, ln_bias))
    kh = _l2(_ln(heads(k), ln_scale, ln_bias))
    vh = _ln(heads(v), ln_scale, ln_bias)
    proj = projection.float()
    q_proj = torch.exp(torch.clamp(
        torch.einsum("bthd,dm->bthm", qh, proj), -15, 15)) * 0.1
    k_proj = torch.exp(torch.clamp(
        torch.einsum("bthd,dm->bthm", kh, proj), -15, 15)) * 0.1
    if mask is not None:
        k_proj = k_proj * mask.float()[:, :, None, None]
    kv = torch.einsum("bthm,bthd->bhmd", k_proj, vh) * 0.1
    out = torch.einsum("bthm,bhmd->bthd", q_proj, kv) * 0.1
    den = (q_proj * k_proj).sum(-1, keepdim=True).clamp_min(eps)
    out = _ln(out / den, ln_scale, ln_bias)
    return out.reshape(B, T, HD).to(qkv.dtype)


def performer_epilogue_plain(y: torch.Tensor, scale: torch.Tensor,
                             shift: torch.Tensor, post_scale: torch.Tensor,
                             post_bias: torch.Tensor,
                             style_scale: torch.Tensor,
                             style_bias: torch.Tensor) -> torch.Tensor:
    """y: [B, T, D]; scale/shift: [B, D]; the four LN vectors: [D].
    Returns [B, T, D] in y's dtype; everything inside runs in f32."""
    D = y.shape[-1]
    h = _ln(y.float(), post_scale, post_bias)
    h = _l2(h) * (D ** 0.5)
    h = _ln(h, style_scale, style_bias)
    h = h * (1 + scale[:, None, :].float()) + shift[:, None, :].float()
    return (h * torch.sigmoid(h)).to(y.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_f32_vec(name: str, t: torch.Tensor, n: int,
                   device: torch.device) -> None:
    _require(t.device == device and t.dtype == torch.float32
             and t.shape == (n,) and t.is_contiguous(),
             f"{name}: expected a contiguous float32 [{n}] tensor on "
             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def favor_qkv(qkv: torch.Tensor, ln_scale: torch.Tensor,
              ln_bias: torch.Tensor, projection: torch.Tensor,
              mask: Optional[torch.Tensor] = None, eps: float = 1e-6,
              pre_scale: float = 0.1) -> torch.Tensor:
    """Fused merged-QKV Performer core (see module doc). CPU tensors take
    :func:`favor_qkv_plain`; CUDA tensors launch ``csrc/favor_qkv.cu``.

    On CUDA: qkv contiguous f32 or bf16; ln_scale, ln_bias, projection and
    mask contiguous f32; (D, m) one of :data:`FAVOR_SHAPES`."""
    if qkv.device.type == "cpu":
        return favor_qkv_plain(qkv, ln_scale, ln_bias, projection, mask,
                               eps, pre_scale)
    _require(qkv.device.type == "cuda",
             f"favor_qkv: unsupported device {qkv.device}")
    _require(qkv.dim() == 3 and qkv.dtype in _KERNEL_DTYPES
             and qkv.is_contiguous(),
             f"favor_qkv: qkv must be a contiguous [B, T, 3*H*D] float32 or "
             f"bfloat16 tensor, got {qkv.dtype} {tuple(qkv.shape)}")
    B, T, HD3 = qkv.shape
    _require(projection.dim() == 2, "favor_qkv: projection must be [D, m]")
    D, m = projection.shape
    _require((D, m) in FAVOR_SHAPES,
             f"favor_qkv: (D, m)=({D}, {m}) not in {sorted(FAVOR_SHAPES)}")
    _require(HD3 % (3 * D) == 0 and B > 0 and T > 0,
             f"favor_qkv: qkv width {HD3} is not 3*H*{D}")
    H = HD3 // (3 * D)
    dev = qkv.device
    _check_f32_vec("ln_scale", ln_scale, D, dev)
    _check_f32_vec("ln_bias", ln_bias, D, dev)
    _require(projection.device == dev and projection.dtype == torch.float32
             and projection.is_contiguous(),
             "favor_qkv: projection must be contiguous float32 on "
             f"{dev}")
    if mask is not None:
        _require(mask.device == dev and mask.dtype == torch.float32
                 and mask.shape == (B, T) and mask.is_contiguous(),
                 f"favor_qkv: mask must be a contiguous float32 [{B}, {T}] "
                 f"tensor on {dev}, got {mask.dtype} {tuple(mask.shape)}")
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    out = torch.empty((B, T, H * D), dtype=qkv.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mdm_favor_qkv(
            qkv.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            projection.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, T, H, D, m, _KERNEL_DTYPES[qkv.dtype], eps, pre_scale, stream)
    if rc != 0:
        raise RuntimeError(f"favor_qkv kernel launch failed: CUDA error {rc}")
    favor_qkv.launches += 1
    return out


favor_qkv.launches = 0


def performer_epilogue(y: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, post_scale: torch.Tensor,
                       post_bias: torch.Tensor, style_scale: torch.Tensor,
                       style_bias: torch.Tensor) -> torch.Tensor:
    """Fused Performer epilogue (see module doc). CPU tensors take
    :func:`performer_epilogue_plain`; CUDA tensors launch
    ``csrc/performer_epilogue.cu``.

    On CUDA: y contiguous f32 or bf16 with D in :data:`EPILOGUE_DIMS`;
    scale and shift contiguous [B, D] in y's dtype; the four LN vectors
    contiguous f32 [D]."""
    if y.device.type == "cpu":
        return performer_epilogue_plain(y, scale, shift, post_scale,
                                        post_bias, style_scale, style_bias)
    _require(y.device.type == "cuda",
             f"performer_epilogue: unsupported device {y.device}")
    _require(y.dim() == 3 and y.dtype in _KERNEL_DTYPES
             and y.is_contiguous(),
             f"performer_epilogue: y must be a contiguous [B, T, D] float32 "
             f"or bfloat16 tensor, got {y.dtype} {tuple(y.shape)}")
    B, T, D = y.shape
    _require(D in EPILOGUE_DIMS and B > 0 and T > 0,
             f"performer_epilogue: D={D} not in {sorted(EPILOGUE_DIMS)}")
    dev = y.device
    for name, t in (("scale", scale), ("shift", shift)):
        _require(t.device == dev and t.dtype == y.dtype
                 and t.shape == (B, D) and t.is_contiguous(),
                 f"performer_epilogue: {name} must be a contiguous "
                 f"{y.dtype} [{B}, {D}] tensor on {dev}, got {t.dtype} "
                 f"{tuple(t.shape)} on {t.device}")
    for name, t in (("post_scale", post_scale), ("post_bias", post_bias),
                    ("style_scale", style_scale),
                    ("style_bias", style_bias)):
        _check_f32_vec(name, t, D, dev)
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    out = torch.empty_like(y)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mdm_performer_epilogue(
            y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            post_scale.data_ptr(), post_bias.data_ptr(),
            style_scale.data_ptr(), style_bias.data_ptr(), out.data_ptr(),
            B * T, T, D, _KERNEL_DTYPES[y.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"performer_epilogue kernel launch failed: CUDA error {rc}")
    performer_epilogue.launches += 1
    return out


performer_epilogue.launches = 0
