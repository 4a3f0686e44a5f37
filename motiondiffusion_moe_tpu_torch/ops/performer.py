"""The Performer kernels and their backward kernels, with plain versions.

Counterpart of ``motiondiffusion_moe_tpu/ops/performer_pallas.py``:

- :func:`favor_qkv` replaces ``favor_attention_qkv`` (Pallas kernel
  ``_favor_qkv_kernel_v2``): the whole FastAttention body on the merged
  ``[B, T, 3*H*D]`` qkv panel. CUDA C++ in ``csrc/favor_qkv.cu``.
- :func:`favor_attention_full` replaces ``favor_attention_full`` (Pallas
  kernel ``_favor_full_kernel``): the same body on separate q, k, v
  ``[B, T, H*D]``; :func:`favor_attention` replaces ``favor_attention``
  (Pallas kernel ``_favor_kernel``): the FAVOR+ core alone, on normalised
  q, k, v ``[B, H, T, D]``, f32 out. Both launch the kernel of
  ``csrc/favor_qkv.cu`` in another layout (the second with the
  normalisation compiled out).
- :func:`performer_epilogue` replaces ``performer_epilogue`` (Pallas kernel
  ``_epilogue_kernel``): post-LN -> L2*sqrt(D) -> style-LN -> modulate ->
  SiLU in one read and one write. CUDA C++ in ``csrc/performer_epilogue.cu``.

All are ``torch.autograd.Function``s on every device (with grad disabled,
:func:`performer_epilogue` launches its kernel without one: the sampling
path's launch cost). The backward of
:func:`favor_qkv` and :func:`performer_epilogue` is :func:`favor_qkv_bwd`
(Pallas ``_favor_qkv_bwd_kernel``, CUDA C++ in ``csrc/favor_qkv_bwd.cu``)
and :func:`performer_epilogue_bwd` (Pallas ``_epilogue_bwd_kernel``,
``csrc/performer_epilogue_bwd.cu``); like the JAX ``custom_vjp``s they save
only the inputs and recompute the rest. The TPU kernels behind
:func:`favor_attention` and :func:`favor_attention_full` have no backward
kernel: their backward is autograd through the plain version.

On a seq rank's frames (``models/attention.py``) kernel 1 runs as two
launches of its template, :func:`favor_qkv_moments` (kv of the rank's rows)
and :func:`favor_qkv_apply` (the output from the seq ranks' summed kv), and
kernel 8 as :func:`favor_attention_moments` / :func:`favor_attention_apply`;
their plain versions (``*_moments_plain``, ``*_apply_plain``) are the steps
:func:`favor_full_plain` and :func:`favor_attention_plain` are built from.
Kernel 3 runs as three launches, :func:`favor_qkv_bwd_kv` (kv of the
rank's rows again), :func:`favor_qkv_bwd_q` (d(q) and g_kv of the rank's
rows from the summed kv) and :func:`favor_qkv_bwd_k` (d(k), d(v) and the
rank's share of d(ln), d(proj) from the summed g_kv), with plain versions
``favor_qkv_bwd_{kv,q,k}_plain``. :func:`favor_qkv_split` is the
differentiable whole of it (moments, the seq all-reduce of kv, apply;
backward: kv, all-reduce, q, all-reduce of g_kv, k), and
:func:`favor_attention_split` kernel 8's, its backward through the plain
steps. The JAX package has no such split: it turns its kernels off under a
seq axis.

``FAVOR_MXU_BF16=1`` (the JAX package's switch, read once per call of
:func:`favor_qkv`, as ``performer_pallas.py`` reads it for kernel 1) runs
the products of kernel 1 on bf16 operands with f32 accumulation, and its
backward does the same when, and only when, its forward did
(``performer_pallas_bwd.py``); LayerNorm, L2, the exp and the denominator
stay f32. Kernels 8 and 10 take no such switch in the JAX package either.

Each wrapper runs its plain PyTorch version (``*_plain``, mirroring the JAX
``*_reference`` functions, and autograd through them for the backward)
only for tensors on the CPU. For a CUDA tensor it launches the kernel or
raises: there is no fallback. Each wrapper counts its launches in
``<wrapper>.launches``; a run can reset the counts and read them to show
that the main path went through the kernels. The source notes in
``csrc/`` say what bounds each kernel on the card and what its design does
about it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, Optional

import torch

LN_EPS = 1e-6  # flax.linen.LayerNorm default, as in the JAX ops

# (head_dim, num_features) pairs and epilogue widths the CUDA library is
# instantiated for (see the C entries in csrc/): those of the config presets
# moe_small (128, 128; 512), moe_big (96, 128; 768) and small_dense
# (64, 128; 256), and of tools/train.py --model_size big (256, 128; 1024)
FAVOR_SHAPES = {(64, 128), (96, 128), (128, 128), (256, 128)}
EPILOGUE_DIMS = {256, 512, 768, 1024}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def favor_kernel_ok(D: int, m: int) -> bool:
    """Whether the CUDA library has an instance of the favor kernels (1, 3,
    8 and 10) for head dim ``D`` and ``m`` random features; the wrappers
    raise on a CUDA tensor outside it."""
    return (D, m) in FAVOR_SHAPES


def epilogue_kernel_ok(D: int) -> bool:
    """Whether the CUDA library has an instance of the epilogue kernels (2
    and 4) for width ``D``; the wrappers raise on a CUDA tensor outside
    it."""
    return D in EPILOGUE_DIMS


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * w.float() + b.float()


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


def favor_cluster(bh: int, device: torch.device, per_sm: int) -> int:
    """CTAs of a thread-block cluster that share the rows of one (b, h) in
    the kernels of ``csrc/favor_qkv.cu`` (``per_sm`` from
    :func:`favor_per_sm`) and ``csrc/favor_qkv_bwd.cu`` (``per_sm`` 1): as
    many as the card's SMs hold at once, 1 to 8. The flagship's B*H = 128
    takes 2 and 1; a serving batch of 2 x 4 heads takes 8."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(8, per_sm * sms // bh))


def favor_per_sm(D: int) -> int:
    """CTAs of the forward kernel of ``csrc/favor_qkv.cu`` an SM holds at
    head dim D: two up to D = 128; one at D = 256, whose shared memory
    (207 KB) and registers (a 256-column kv a warp) fill the SM."""
    return 2 if D <= 128 else 1


def _favor_scratch(B: int, T: int, H: int, m: int,
                   device: torch.device) -> torch.Tensor:
    """phi(q) and the denominators from pass 1 to pass 2 of the kernel of
    ``csrc/favor_qkv.cu``: B*H*T*(m + 1) floats."""
    return torch.empty(B * H * T * (m + 1), dtype=torch.float32,
                       device=device)


def mxu_bf16() -> bool:
    """``FAVOR_MXU_BF16=1``: kernel 1's products on bf16 operands."""
    return os.environ.get("FAVOR_MXU_BF16", "0") == "1"


def bf16_operand_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bf16 and f32 accumulation: the
    JAX kernels' ``jnp.dot(mx(a), mx(b), preferred_element_type=f32)``."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


class _Product(torch.autograd.Function):
    """``product(a, b) * scale`` for a product in another arithmetic than
    f32 (bf16 operands, or a test's emulation of the kernels'). Its backward
    takes the two products of the JAX backward kernel in the same
    arithmetic: ``product(g, b^T) * scale`` and ``product(a^T, g) * scale``
    (a 2-D ``b`` against batched rows: one product over all rows)."""

    @staticmethod
    def forward(ctx, a, b, scale, product):
        ctx.save_for_backward(a, b)
        ctx.scale, ctx.product = scale, product
        return product(a, b) * scale

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        mul, scale = ctx.product, ctx.scale
        da = db = None
        if ctx.needs_input_grad[0]:
            da = mul(g, b.transpose(-1, -2)) * scale
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                db = mul(a.reshape(-1, a.shape[-1]).T,
                         g.reshape(-1, g.shape[-1])) * scale
            else:
                db = mul(a.transpose(-1, -2), g) * scale
        return da, db, None, None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _favor_rows(x: torch.Tensor, D: int, ln_scale: torch.Tensor,
                ln_bias: torch.Tensor, pre_scale: float,
                l2: bool) -> torch.Tensor:
    """[B, T, H*D] -> [B, T, H, D] f32: times ``pre_scale``, the shared
    LayerNorm, and with ``l2`` the L2 normalisation (q and k)."""
    B, T, HD = x.shape
    h = _ln(x.reshape(B, T, HD // D, D).float() * pre_scale, ln_scale,
            ln_bias)
    return _l2(h) if l2 else h


def _mm(a, b, scale, product):
    return _Product.apply(a, b, scale, product)


def _logits(x: torch.Tensor, proj: torch.Tensor,
            product: Optional[Callable]) -> torch.Tensor:
    """The feature logits x @ proj of rows [B, T, H, D]."""
    if product is None:
        return torch.einsum("bthd,dm->bthm", x, proj)
    return _mm(x, proj, 1.0, product)


def _phi(lin: torch.Tensor) -> torch.Tensor:
    """The feature map exp(clip(logits, -15, 15)) * 0.1."""
    return torch.exp(torch.clamp(lin, -15, 15)) * 0.1


def _features(x: torch.Tensor, proj: torch.Tensor,
              product: Optional[Callable]) -> torch.Tensor:
    return _phi(_logits(x, proj, product))


def _masked(k_proj: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    return k_proj if mask is None else k_proj * mask.float()[:, :, None, None]


def _kv_moments(k_proj: torch.Tensor, vh: torch.Tensor,
                product: Optional[Callable]) -> torch.Tensor:
    """kv = phi(k)^T v * 0.1 over the given rows: [B, H, m, D] f32. The
    0.1 falls on each partial sum: a sum over seq ranks adds scaled
    partials, which differs from scaling the sum only in the rounding."""
    if product is None:
        return torch.einsum("bthm,bthd->bhmd", k_proj, vh) * 0.1
    return _mm(k_proj.permute(0, 2, 3, 1), vh.permute(0, 2, 1, 3), 0.1,
               product)


def _kv_apply(q_proj: torch.Tensor, k_proj: torch.Tensor, kv: torch.Tensor,
              ln_scale: torch.Tensor, ln_bias: torch.Tensor, eps: float,
              product: Optional[Callable]) -> torch.Tensor:
    """LN(phi(q) kv * 0.1 / max(sum_m phi(q) phi(k), eps)): [B, T, H, D]
    f32, the denominator at each row's own position."""
    if product is None:
        out = torch.einsum("bthm,bhmd->bthd", q_proj, kv) * 0.1
    else:
        out = _mm(q_proj.permute(0, 2, 1, 3), kv, 0.1,
                  product).permute(0, 2, 1, 3)
    den = (q_proj * k_proj).sum(-1, keepdim=True).clamp_min(eps)
    return _ln(out / den, ln_scale, ln_bias)


def favor_full_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                     projection: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, eps: float = 1e-6,
                     pre_scale: float = 0.1,
                     product: Optional[Callable] = None) -> torch.Tensor:
    """The kernels' normalised FAVOR+ math (``favor_full_reference``). q, k,
    v: [B, T, H*D]; ln_scale/ln_bias: [D]; projection: [D, m]; mask: [B, T]
    or None. Returns [B, T, H*D] in q's dtype; everything inside runs in
    f32. ``product`` (e.g. :func:`bf16_operand_product`) takes the four
    products (the two feature logits, kv, phi(q) kv) and their backward in
    its own arithmetic, at the JAX kernel's points; None: f32 products.

    It is :func:`favor_full_apply_plain` of :func:`favor_full_moments_plain`
    on the whole T, from the same steps, with phi(k) computed once (in the
    order that keeps autograd's sums, and so the backward's bits, as
    they were before the split)."""
    B, T, HD = q.shape
    D = projection.shape[0]
    qh, kh = (_favor_rows(x, D, ln_scale, ln_bias, pre_scale, True)
              for x in (q, k))
    vh = _favor_rows(v, D, ln_scale, ln_bias, pre_scale, False)
    proj = projection.float()
    q_lin, k_lin = _logits(qh, proj, product), _logits(kh, proj, product)
    q_proj, k_proj = _phi(q_lin), _masked(_phi(k_lin), mask)
    kv = _kv_moments(k_proj, vh, product)
    out = _kv_apply(q_proj, k_proj, kv, ln_scale, ln_bias, eps, product)
    return out.reshape(B, T, HD).to(q.dtype)


def favor_full_moments_plain(k: torch.Tensor, v: torch.Tensor,
                             ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                             projection: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             pre_scale: float = 0.1,
                             product: Optional[Callable] = None
                             ) -> torch.Tensor:
    """The kv moments of :func:`favor_full_plain` over the rows given (a
    seq rank's frames, its frame mask): phi(k)^T v * 0.1, [B, H, m, D] f32.
    Summed over the ranks that hold the rest of T, they are the whole T's
    kv."""
    D = projection.shape[0]
    kh = _favor_rows(k, D, ln_scale, ln_bias, pre_scale, True)
    vh = _favor_rows(v, D, ln_scale, ln_bias, pre_scale, False)
    k_proj = _masked(_features(kh, projection.float(), product), mask)
    return _kv_moments(k_proj, vh, product)


def favor_full_apply_plain(q: torch.Tensor, k: torch.Tensor,
                           kv: torch.Tensor, ln_scale: torch.Tensor,
                           ln_bias: torch.Tensor, projection: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           eps: float = 1e-6, pre_scale: float = 0.1,
                           product: Optional[Callable] = None
                           ) -> torch.Tensor:
    """The output of :func:`favor_full_plain` on the rows given from the
    whole T's ``kv`` [B, H, m, D] f32: phi(q) kv * 0.1 over the
    same-position denominator (phi(k) of the same rows, masked), then the
    output LayerNorm. [B, T, H*D] in q's dtype."""
    B, T, HD = q.shape
    D = projection.shape[0]
    proj = projection.float()
    kh = _favor_rows(k, D, ln_scale, ln_bias, pre_scale, True)
    k_proj = _masked(_features(kh, proj, product), mask)
    qh = _favor_rows(q, D, ln_scale, ln_bias, pre_scale, True)
    out = _kv_apply(_features(qh, proj, product), k_proj, kv.float(),
                    ln_scale, ln_bias, eps, product)
    return out.reshape(B, T, HD).to(q.dtype)


def favor_qkv_plain(qkv: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, projection: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, eps: float = 1e-6,
                    pre_scale: float = 0.1,
                    product: Optional[Callable] = None) -> torch.Tensor:
    """qkv: [B, T, 3*H*D] (column order q|k|v); the rest as
    :func:`favor_full_plain`. Returns [B, T, H*D] in qkv's dtype."""
    return favor_full_plain(*qkv.split(qkv.shape[-1] // 3, dim=-1), ln_scale,
                            ln_bias, projection, mask, eps, pre_scale,
                            product)


def favor_qkv_moments_plain(qkv: torch.Tensor, ln_scale: torch.Tensor,
                            ln_bias: torch.Tensor, projection: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            pre_scale: float = 0.1,
                            product: Optional[Callable] = None
                            ) -> torch.Tensor:
    """:func:`favor_full_moments_plain` on the merged panel: kv [B, H, m,
    D] f32 of the rows given."""
    _, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    return favor_full_moments_plain(k, v, ln_scale, ln_bias, projection,
                                    mask, pre_scale, product)


def favor_qkv_apply_plain(qkv: torch.Tensor, kv: torch.Tensor,
                          ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          projection: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          eps: float = 1e-6, pre_scale: float = 0.1,
                          product: Optional[Callable] = None
                          ) -> torch.Tensor:
    """:func:`favor_full_apply_plain` on the merged panel: [B, T, H*D] in
    qkv's dtype."""
    q, k, _ = qkv.split(qkv.shape[-1] // 3, dim=-1)
    return favor_full_apply_plain(q, k, kv, ln_scale, ln_bias, projection,
                                  mask, eps, pre_scale, product)


def favor_qkv_logits_plain(qkv: torch.Tensor, ln_scale: torch.Tensor,
                           ln_bias: torch.Tensor, projection: torch.Tensor,
                           pre_scale: float = 0.1):
    """The feature logits (q and k, each [B, T, H, m], f32) of
    :func:`favor_qkv_plain`: the normalised rows times the projection."""
    B, T, HD3 = qkv.shape
    D = projection.shape[0]
    H = HD3 // (3 * D)
    q, k, _ = qkv.reshape(B, T, 3, H, D).float().unbind(2)
    return tuple(torch.einsum("bthd,dm->bthm", _l2(_ln(
        x * pre_scale, ln_scale, ln_bias)), projection.float())
        for x in (q, k))


def _core_features(x: torch.Tensor, proj: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """phi of rows [B, H, T, D] (f32), times a [B, 1, T] mask if given."""
    f = torch.exp(torch.clamp(
        torch.einsum("bhtd,dm->bhtm", x.float(), proj), -15, 15)) * 0.1
    return f if mask is None else f * mask.float()[..., None]


def _core_kv(k_proj, v):
    """phi(k)^T v * 0.1 of rows [B, H, T, *], f32."""
    return torch.einsum("bhtm,bhtd->bhmd", k_proj, v.float()) * 0.1


def _core_apply(q_proj, k_proj, kv, eps):
    """phi(q) kv * 0.1 over the same-position denominator, f32."""
    out = torch.einsum("bhtm,bhmd->bhtd", q_proj, kv) * 0.1
    den = (q_proj * k_proj).sum(-1, keepdim=True)
    return out / den.clamp_min(eps)


def favor_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          projection: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          eps: float = 1e-6) -> torch.Tensor:
    """The FAVOR+ core alone (``favor_attention_reference``, the Pallas
    ``_favor_kernel``) on q, k, v [B, H, T, D] that the caller normalised,
    widened to f32; projection [D, m]; mask [B, 1, T] or None. Returns f32
    [B, H, T, D]: :func:`favor_attention_apply_plain` of
    :func:`favor_attention_moments_plain` on the whole T, phi(k) computed
    once."""
    proj = projection.float()
    q_proj = _core_features(q, proj)
    k_proj = _core_features(k, proj, mask)
    return _core_apply(q_proj, k_proj, _core_kv(k_proj, v), eps)


def favor_attention_moments_plain(k: torch.Tensor, v: torch.Tensor,
                                  projection: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The kv moments of :func:`favor_attention_plain` over the rows given:
    phi(k)^T v * 0.1, [B, H, m, D] f32."""
    return _core_kv(_core_features(k, projection.float(), mask), v)


def favor_attention_apply_plain(q: torch.Tensor, k: torch.Tensor,
                                kv: torch.Tensor, projection: torch.Tensor,
                                mask: Optional[torch.Tensor] = None,
                                eps: float = 1e-6) -> torch.Tensor:
    """The output of :func:`favor_attention_plain` on the rows given from
    the whole T's ``kv`` [B, H, m, D] f32: f32 [B, H, T, D]."""
    proj = projection.float()
    return _core_apply(_core_features(q, proj), _core_features(k, proj, mask),
                       kv.float(), eps)


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




def favor_qkv_bwd_plain(qkv: torch.Tensor, ln_scale: torch.Tensor,
                        ln_bias: torch.Tensor, projection: torch.Tensor,
                        mask: Optional[torch.Tensor], g: torch.Tensor,
                        eps: float = 1e-6, pre_scale: float = 0.1,
                        need_dproj: bool = True,
                        product: Optional[Callable] = None):
    """Backward of :func:`favor_qkv_plain` by autograd through it (the
    counterpart of ``_favor_qkv_bwd_reference``; with ``product``, of the
    JAX backward kernel's products in that arithmetic): (d qkv in qkv's
    dtype, d ln_scale, d ln_bias, d projection or None). The mask gets
    none."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (qkv, ln_scale, ln_bias)]
        proj = projection.detach().requires_grad_(need_dproj)
        out = favor_qkv_plain(*xs, proj, mask, eps, pre_scale, product)
        grads = torch.autograd.grad(out, xs + ([proj] if need_dproj else []),
                                    g)
    return (*grads[:3], grads[3] if need_dproj else None)


def _split_leaves(qkv, ln_scale, ln_bias, projection, need_dproj):
    """The leaves a plain step of kernel 3's split differentiates: qkv in
    f32 (its two steps' shares add up before the one rounding to its dtype,
    as the whole backward's do), the LayerNorm vectors and the projection
    (with ``need_dproj``)."""
    xs = [t.detach().float().requires_grad_()
          for t in (qkv, ln_scale, ln_bias)]
    return xs + ([projection.detach().float().requires_grad_()]
                 if need_dproj else [])


def favor_qkv_bwd_kv_plain(qkv: torch.Tensor, ln_scale: torch.Tensor,
                           ln_bias: torch.Tensor, projection: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           pre_scale: float = 0.1,
                           product: Optional[Callable] = None
                           ) -> torch.Tensor:
    """Kernel 3's first step on a seq rank's rows: their kv [B, H, m, D]
    f32, times 0.1 (:func:`favor_qkv_moments_plain`); the seq ranks' sum of
    it is the whole T's."""
    with torch.no_grad():
        return favor_qkv_moments_plain(qkv, ln_scale, ln_bias, projection,
                                       mask, pre_scale, product)


def favor_qkv_bwd_q_plain(qkv: torch.Tensor, kv: torch.Tensor,
                          ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          projection: torch.Tensor,
                          mask: Optional[torch.Tensor], g: torch.Tensor,
                          eps: float = 1e-6, pre_scale: float = 0.1,
                          need_dproj: bool = True,
                          product: Optional[Callable] = None):
    """Kernel 3's second step on a seq rank's rows, from ``kv`` (the seq
    ranks' sum) and the output's gradient ``g``: (g_kv [B, H, m, D] f32,
    the gradient of ``kv`` from these rows; ``part``, what this step adds
    to d(qkv) (f32), d(ln_scale), d(ln_bias) and d(proj)). The seq ranks'
    sum of g_kv goes to :func:`favor_qkv_bwd_k_plain` with ``part``."""
    with torch.enable_grad():
        xs = _split_leaves(qkv, ln_scale, ln_bias, projection, need_dproj)
        kv = kv.detach().float().requires_grad_()
        out = favor_qkv_apply_plain(xs[0], kv, xs[1], xs[2],
                                    xs[3] if need_dproj else projection,
                                    mask, eps, pre_scale, product)
        grads = torch.autograd.grad(out, [kv] + xs, g.float())
    return grads[0], grads[1:]


def favor_qkv_bwd_k_plain(qkv: torch.Tensor, g_kv: torch.Tensor,
                          ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          projection: torch.Tensor,
                          mask: Optional[torch.Tensor], part,
                          pre_scale: float = 0.1, need_dproj: bool = True,
                          product: Optional[Callable] = None):
    """Kernel 3's third step on a seq rank's rows, from ``g_kv`` (the seq
    ranks' sum) and the second step's ``part``: (d qkv in qkv's dtype, the
    rows' shares of d ln_scale, d ln_bias and d projection or None), as
    :func:`favor_qkv_bwd_plain` returns them; summed over the seq ranks the
    last three are the whole T's."""
    with torch.enable_grad():
        xs = _split_leaves(qkv, ln_scale, ln_bias, projection, need_dproj)
        kv = favor_qkv_moments_plain(xs[0], xs[1], xs[2],
                                     xs[3] if need_dproj else projection,
                                     mask, pre_scale, product)
        grads = torch.autograd.grad(kv, xs, g_kv.float())
    dqkv, ds, dc, *dp = (a + b for a, b in zip(part, grads))
    return dqkv.to(qkv.dtype), ds, dc, dp[0] if need_dproj else None


def performer_epilogue_bwd_plain(y: torch.Tensor, scale: torch.Tensor,
                                 shift: torch.Tensor, post_scale: torch.Tensor,
                                 post_bias: torch.Tensor,
                                 style_scale: torch.Tensor,
                                 style_bias: torch.Tensor, g: torch.Tensor):
    """Backward of :func:`performer_epilogue_plain` by autograd through it
    (the counterpart of ``_epilogue_bwd_reference``): the gradients of all
    seven inputs, each in its input's dtype."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (
            y, scale, shift, post_scale, post_bias, style_scale, style_bias)]
        return torch.autograd.grad(performer_epilogue_plain(*xs), xs, g)


# ---------------------------------------------------------------------------
# kernel wrappers: CPU tensors take the plain version, CUDA tensors launch
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


def _check_projection(op: str, projection, dev):
    """Validate the random-feature projection; returns (D, m)."""
    _require(projection.dim() == 2, f"{op}: projection must be [D, m]")
    D, m = projection.shape
    _require(favor_kernel_ok(D, m),
             f"{op}: (D, m)=({D}, {m}) not in {sorted(FAVOR_SHAPES)}")
    _require(projection.device == dev and projection.dtype == torch.float32
             and projection.is_contiguous(),
             f"{op}: projection must be contiguous float32 on {dev}")
    return D, m


def _check_favor(op: str, qkv, ln_scale, ln_bias, projection, mask,
                 parts: int = 3):
    """Validate the inputs of the normalised favor kernels, ``qkv`` being
    the merged panel (``parts`` 3) or q (``parts`` 1); returns (B, T, H, D,
    m)."""
    name = "qkv" if parts == 3 else "q"
    _require(qkv.dim() == 3 and qkv.dtype in _KERNEL_DTYPES
             and qkv.is_contiguous(),
             f"{op}: {name} must be a contiguous [B, T, {parts}*H*D] float32 "
             f"or bfloat16 tensor, got {qkv.dtype} {tuple(qkv.shape)}")
    B, T, HD3 = qkv.shape
    D, m = _check_projection(op, projection, qkv.device)
    _require(qkv.device.type == "cuda", f"{op}: unsupported device "
                                        f"{qkv.device}")
    _require(HD3 % (parts * D) == 0 and B > 0 and T > 0,
             f"{op}: {name} width {HD3} is not {parts}*H*{D}")
    dev = qkv.device
    _check_f32_vec("ln_scale", ln_scale, D, dev)
    _check_f32_vec("ln_bias", ln_bias, D, dev)
    if mask is not None:
        _require(mask.device == dev and mask.dtype == torch.float32
                 and mask.shape == (B, T) and mask.is_contiguous(),
                 f"{op}: mask must be a contiguous float32 [{B}, {T}] "
                 f"tensor on {dev}, got {mask.dtype} {tuple(mask.shape)}")
    return B, T, HD3 // (parts * D), D, m


def _check_epilogue(op: str, y, scale, shift, vecs, views: bool = False):
    """Validate the inputs of the epilogue kernels, raising with a message
    on the first one the kernel does not take; returns (B, T, D). With
    ``views`` (the forward kernel), scale and shift may be strided [B, D]
    views: column stride 1, a row stride >= D, every row 16-byte aligned;
    else (the backward kernel) they must be contiguous."""
    _require(y.dim() == 3 and y.dtype in _KERNEL_DTYPES
             and y.is_contiguous(),
             f"{op}: y must be a contiguous [B, T, D] float32 or bfloat16 "
             f"tensor, got {y.dtype} {tuple(y.shape)}")
    B, T, D = y.shape
    _require(epilogue_kernel_ok(D) and B > 0 and T > 0,
             f"{op}: D={D} not in {sorted(EPILOGUE_DIMS)}")
    _require(y.device.type == "cuda", f"{op}: unsupported device {y.device}")
    _require(y.data_ptr() % 16 == 0, f"{op}: y must be 16-byte aligned")
    dev = y.device
    for name, t in (("scale", scale), ("shift", shift)):
        _require(t.device == dev and t.dtype == y.dtype
                 and t.shape == (B, D),
                 f"{op}: {name} must be a {y.dtype} [{B}, {D}] tensor on "
                 f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if views:
            _require(_row_view_ok(t, D),
                     f"{op}: {name} must have column stride 1, a row stride "
                     f">= {D} and 16-byte aligned rows, got strides "
                     f"{t.stride()} at address {t.data_ptr()}")
        else:
            _require(t.is_contiguous(),
                     f"{op}: {name} must be contiguous, got strides "
                     f"{t.stride()}")
    for name, t in zip(("post_scale", "post_bias", "style_scale",
                        "style_bias"), vecs):
        _check_f32_vec(name, t, D, dev)
    return B, T, D


def _row_view_ok(t: torch.Tensor, D: int) -> bool:
    """A [B, D] operand the forward epilogue kernel reads 16 bytes a lane:
    column stride 1, rows at least D apart, every row 16-byte aligned."""
    rs, cs = t.stride()
    return (cs == 1 and rs >= D and not rs * t.element_size() % 16
            and not t.data_ptr() % 16)


def _epilogue_ok(y, scale, shift, vecs) -> bool:
    """What :func:`_check_epilogue` checks for the forward kernel, in one
    pass of plain comparisons with no message built: the launch path's
    check. Only when it fails does the wrapper run the detailed check,
    which raises with the reason."""
    if not (y.is_cuda and y.dim() == 3 and y.is_contiguous()):
        return False
    dt = y.dtype
    if dt not in _KERNEL_DTYPES or y.data_ptr() % 16:
        return False
    B, T, D = y.shape
    if not epilogue_kernel_ok(D) or not B or not T:
        return False
    index = y.get_device()
    for t in (scale, shift):
        if not (t.dtype is dt and t.get_device() == index
                and t.shape == (B, D) and _row_view_ok(t, D)):
            return False
    f32 = torch.float32
    for v in vecs:
        if not (v.dtype is f32 and v.get_device() == index
                and v.shape == (D,) and v.is_contiguous()):
            return False
    return True


def plain_vjp(plain, saved, needs_input_grad, g, *static):
    """The backward of a kernel wrapper whose TPU kernel has no backward
    kernel: autograd through its plain version ``plain(*saved, *static)``
    from the saved inputs, as the JAX ``custom_vjp``s differentiate their
    references. Returns one gradient (or None) per saved input."""
    with torch.enable_grad():
        xs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(saved, needs_input_grad)]
        out = plain(*xs, *static)
        wanted = [t for t in xs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in xs)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_favor_qkv(qkv, ln_scale, ln_bias, projection, mask, eps,
                      pre_scale, bf16_products: bool,
                      logits=None) -> torch.Tensor:
    B, T, H, D, m = _check_favor("favor_qkv", qkv, ln_scale, ln_bias,
                                 projection, mask)
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    out = torch.empty((B, T, H * D), dtype=qkv.dtype, device=qkv.device)
    scratch = _favor_scratch(B, T, H, m, qkv.device)
    lq, lk = (None, None) if logits is None else logits
    with torch.cuda.device(qkv.device):
        rc = lib.mdm_favor_qkv(
            qkv.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            projection.data_ptr(), _ptr(mask), out.data_ptr(),
            scratch.data_ptr(), _ptr(lq), _ptr(lk), B, T, H, D, m,
            _KERNEL_DTYPES[qkv.dtype], int(bf16_products), eps, pre_scale,
            favor_cluster(B * H, qkv.device, favor_per_sm(D)), _stream(qkv.device))
    if rc != 0:
        raise RuntimeError(f"favor_qkv kernel launch failed: CUDA error {rc}")
    favor_qkv.launches += 1
    return out


def favor_qkv_bwd(qkv: torch.Tensor, ln_scale: torch.Tensor,
                  ln_bias: torch.Tensor, projection: torch.Tensor,
                  mask: Optional[torch.Tensor], g: torch.Tensor,
                  eps: float = 1e-6, pre_scale: float = 0.1,
                  need_dproj: bool = True,
                  bf16_products: Optional[bool] = None, logits=None):
    """Backward of :func:`favor_qkv` from the inputs and the output's
    gradient ``g`` [B, T, H*D]: (d qkv, d ln_scale, d ln_bias, d projection
    or None when ``need_dproj`` is False). ``bf16_products``: the products
    on bf16 operands, as a forward under ``FAVOR_MXU_BF16=1`` took them
    (None: read the switch). CPU tensors take :func:`favor_qkv_bwd_plain`;
    CUDA tensors launch ``csrc/favor_qkv_bwd.cu`` (g contiguous, in qkv's
    dtype). ``logits``: None, or two f32 [B, T, H, m] tensors on the card
    that receive the kernel's feature logits of q and k (tests)."""
    if bf16_products is None:
        bf16_products = mxu_bf16()
    if qkv.device.type == "cpu":
        return favor_qkv_bwd_plain(
            qkv, ln_scale, ln_bias, projection, mask, g, eps, pre_scale,
            need_dproj, bf16_operand_product if bf16_products else None)
    B, T, H, D, m = _check_favor("favor_qkv_bwd", qkv, ln_scale, ln_bias,
                                 projection, mask)
    dev = qkv.device
    _require(g.device == dev and g.dtype == qkv.dtype
             and g.shape == (B, T, H * D) and g.is_contiguous(),
             f"favor_qkv_bwd: g must be a contiguous {qkv.dtype} "
             f"[{B}, {T}, {H * D}] tensor on {dev}, got {g.dtype} "
             f"{tuple(g.shape)} on {g.device}")
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    f32 = dict(dtype=torch.float32, device=dev)
    cluster = favor_cluster(B * H, dev, 1)
    dqkv = torch.empty_like(qkv)
    ds, dc = torch.empty(D, **f32), torch.empty(D, **f32)
    dp = torch.empty((D, m), **f32) if need_dproj else None
    scratch = torch.empty(lib.mdm_favor_qkv_bwd_scratch_floats(
        B, T, H, D, m, int(need_dproj), cluster), **f32)
    lq, lk = (None, None) if logits is None else logits
    with torch.cuda.device(dev):
        rc = lib.mdm_favor_qkv_bwd(
            qkv.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            projection.data_ptr(), _ptr(mask), g.data_ptr(), dqkv.data_ptr(),
            ds.data_ptr(), dc.data_ptr(), _ptr(dp), scratch.data_ptr(),
            _ptr(lq), _ptr(lk), B, T, H, D, m, _KERNEL_DTYPES[qkv.dtype],
            int(bf16_products), eps, pre_scale, cluster, _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"favor_qkv_bwd kernel launch failed: CUDA error {rc}")
    favor_qkv_bwd.launches += 1
    return dqkv, ds, dc, dp


favor_qkv_bwd.launches = 0


def favor_qkv_feature_logits(qkv: torch.Tensor, ln_scale: torch.Tensor,
                             ln_bias: torch.Tensor, projection: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             pre_scale: float = 0.1, source: str = "forward",
                             bf16_products: bool = False):
    """The feature logits of q and k (each [B, T, H, m], f32) as kernel 1
    (``source="forward"``) or its backward kernel (``"backward"``, from a
    zero output gradient) computes them, so that a test can hold the
    backward's clip masks to the forward's; its count goes up as for any
    launch. CPU tensors take :func:`favor_qkv_logits_plain`."""
    if qkv.device.type == "cpu":
        return favor_qkv_logits_plain(qkv, ln_scale, ln_bias, projection,
                                      pre_scale)
    B, T, HD3 = qkv.shape
    D, m = projection.shape
    logits = tuple(torch.zeros((B, T, HD3 // (3 * D), m),
                               dtype=torch.float32, device=qkv.device)
                   for _ in range(2))
    if source == "forward":
        _launch_favor_qkv(qkv, ln_scale, ln_bias, projection, mask, 1e-6,
                          pre_scale, bf16_products, logits)
    elif source == "backward":
        g = torch.zeros((B, T, HD3 // 3), dtype=qkv.dtype, device=qkv.device)
        favor_qkv_bwd(qkv, ln_scale, ln_bias, projection, mask, g,
                      pre_scale=pre_scale, need_dproj=False,
                      bf16_products=bf16_products, logits=logits)
    else:
        raise ValueError(f"source {source!r}: 'forward' or 'backward'")
    return logits


class _FavorQKV(torch.autograd.Function):
    """favor_qkv with its backward kernel. Saves only the inputs, as the
    JAX custom_vjp does; the backward recomputes the rest, with the
    forward's products (``FAVOR_MXU_BF16`` as the forward read it)."""

    @staticmethod
    def forward(ctx, qkv, ln_scale, ln_bias, projection, mask, eps,
                pre_scale):
        ctx.save_for_backward(qkv, ln_scale, ln_bias, projection, mask)
        ctx.eps, ctx.pre_scale = eps, pre_scale
        ctx.bf16_products = mxu_bf16()
        if qkv.device.type == "cpu":
            return favor_qkv_plain(
                qkv, ln_scale, ln_bias, projection, mask, eps, pre_scale,
                bf16_operand_product if ctx.bf16_products else None)
        return _launch_favor_qkv(qkv, ln_scale, ln_bias, projection, mask,
                                 eps, pre_scale, ctx.bf16_products)

    @staticmethod
    def backward(ctx, g):
        qkv, ln_scale, ln_bias, projection, mask = ctx.saved_tensors
        dq, ds, dc, dp = favor_qkv_bwd(
            qkv, ln_scale, ln_bias, projection, mask, g.contiguous(),
            ctx.eps, ctx.pre_scale, need_dproj=ctx.needs_input_grad[3],
            bf16_products=ctx.bf16_products)
        return dq, ds, dc, dp, None, None, None


def favor_qkv(qkv: torch.Tensor, ln_scale: torch.Tensor,
              ln_bias: torch.Tensor, projection: torch.Tensor,
              mask: Optional[torch.Tensor] = None, eps: float = 1e-6,
              pre_scale: float = 0.1) -> torch.Tensor:
    """Fused merged-QKV Performer core (see module doc), differentiable on
    every device. CPU tensors take :func:`favor_qkv_plain` and its autograd
    backward; CUDA tensors launch ``csrc/favor_qkv.cu`` forward and
    ``csrc/favor_qkv_bwd.cu`` backward (the projection's gradient only when
    it requires one). ``FAVOR_MXU_BF16=1``, read at each call, puts the
    products on bf16 operands (module doc).

    On CUDA: qkv contiguous f32 or bf16; ln_scale, ln_bias, projection and
    mask contiguous f32; (D, m) one of :data:`FAVOR_SHAPES`."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"favor_qkv: unsupported device {qkv.device}")
    return _FavorQKV.apply(qkv, ln_scale, ln_bias, projection, mask, eps,
                           pre_scale)


favor_qkv.launches = 0


# ---------------------------------------------------------------------------
# kernel 1 in two launches, for a seq rank's frames: the moments, the seq
# ranks' all-reduce of kv (the caller's), the apply
# ---------------------------------------------------------------------------

_SPLIT_FNS: dict = {}  # C entry name -> the library's function, taken once


def _split_entry(name: str):
    fn = _SPLIT_FNS.get(name)
    if fn is None:
        from motiondiffusion_moe_tpu_torch.ops._build import library

        fn = _SPLIT_FNS[name] = getattr(library(), name)
    return fn


def _split_ok(qkv, ln_scale, ln_bias, projection, mask, kv) -> bool:
    """What :func:`_check_favor` and the kv check of :func:`_check_split`
    check, in one pass of plain comparisons with no message built: the
    launch path's check, as kernel 2's."""
    if not (qkv.is_cuda and qkv.dim() == 3 and qkv.is_contiguous()
            and qkv.dtype in _KERNEL_DTYPES and projection.dim() == 2):
        return False
    B, T, HD3 = qkv.shape
    D, m = projection.shape
    if not favor_kernel_ok(D, m) or HD3 % (3 * D) or not B or not T:
        return False
    index = qkv.get_device()
    f32 = torch.float32
    wants = [(projection, (D, m)), (ln_scale, (D,)), (ln_bias, (D,))]
    if mask is not None:
        wants.append((mask, (B, T)))
    if kv is not None:
        wants.append((kv, (B, HD3 // (3 * D), m, D)))
    return all(t.dtype is f32 and t.get_device() == index
               and t.shape == shape and t.is_contiguous()
               for t, shape in wants)


def _check_split(op, qkv, ln_scale, ln_bias, projection, mask, kv):
    """The detailed check behind :func:`_split_ok`: raises with the reason
    of the first input the kernel does not take."""
    B, T, H, D, m = _check_favor(op, qkv, ln_scale, ln_bias, projection,
                                 mask)
    if kv is not None:
        _require(kv.device == qkv.device and kv.dtype == torch.float32
                 and kv.shape == (B, H, m, D) and kv.is_contiguous(),
                 f"{op}: kv must be a contiguous float32 [{B}, {H}, {m}, "
                 f"{D}] tensor on {qkv.device}, got {kv.dtype} "
                 f"{tuple(kv.shape)} on {kv.device}")
    raise ValueError(f"{op}: inputs the kernel does not take")


def favor_qkv_moments(qkv: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, projection: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      pre_scale: float = 0.1) -> torch.Tensor:
    """Kernel 1's first launch on a seq rank's frames: qkv [B, T_rank,
    3*H*D], mask [B, T_rank] -> kv [B, H, m, D] f32, phi(k)^T v * 0.1 of
    these rows; summed over the seq ranks it is the whole T's kv. CPU
    tensors take :func:`favor_qkv_moments_plain`; CUDA tensors launch
    ``mdm_favor_qkv_moments`` of ``csrc/favor_qkv.cu`` (the inputs as for
    :func:`favor_qkv`). ``FAVOR_MXU_BF16=1`` as for :func:`favor_qkv`.
    No gradient: :func:`favor_qkv_split` is the differentiable whole."""
    bf16 = mxu_bf16()
    if qkv.is_cpu:
        return favor_qkv_moments_plain(
            qkv, ln_scale, ln_bias, projection, mask, pre_scale,
            bf16_operand_product if bf16 else None)
    if not _split_ok(qkv, ln_scale, ln_bias, projection, mask, None):
        _check_split("favor_qkv_moments", qkv, ln_scale, ln_bias, projection,
                     mask, None)
    B, T, HD3 = qkv.shape
    D, m = projection.shape
    H = HD3 // (3 * D)
    index = qkv.get_device()
    kv = torch.empty((B, H, m, D), dtype=torch.float32, device=qkv.device)
    args = (qkv.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            projection.data_ptr(), _ptr(mask), kv.data_ptr(), B, T, H, D, m,
            _KERNEL_DTYPES[qkv.dtype], int(bf16), pre_scale,
            favor_cluster(B * H, qkv.device, favor_per_sm(D)))
    with torch.cuda.device(index):
        rc = _split_entry("mdm_favor_qkv_moments")(
            *args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(
            f"favor_qkv_moments kernel launch failed: CUDA error {rc}")
    favor_qkv_moments.launches += 1
    return kv


favor_qkv_moments.launches = 0


def favor_qkv_apply(qkv: torch.Tensor, kv: torch.Tensor,
                    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    projection: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, eps: float = 1e-6,
                    pre_scale: float = 0.1) -> torch.Tensor:
    """Kernel 1's second launch on a seq rank's frames: the output [B,
    T_rank, H*D] in qkv's dtype from ``kv`` [B, H, m, D] f32, the seq ranks'
    summed moments (:func:`favor_qkv_moments`). CPU tensors take
    :func:`favor_qkv_apply_plain`; CUDA tensors launch
    ``mdm_favor_qkv_apply`` of ``csrc/favor_qkv.cu``. No gradient (see
    :func:`favor_qkv_moments`)."""
    bf16 = mxu_bf16()
    if qkv.is_cpu:
        return favor_qkv_apply_plain(
            qkv, kv, ln_scale, ln_bias, projection, mask, eps, pre_scale,
            bf16_operand_product if bf16 else None)
    if not _split_ok(qkv, ln_scale, ln_bias, projection, mask, kv):
        _check_split("favor_qkv_apply", qkv, ln_scale, ln_bias, projection,
                     mask, kv)
    B, T, HD3 = qkv.shape
    D, m = projection.shape
    H = HD3 // (3 * D)
    index = qkv.get_device()
    out = torch.empty((B, T, H * D), dtype=qkv.dtype, device=qkv.device)
    scratch = _favor_scratch(B, T, H, m, qkv.device)
    args = (qkv.data_ptr(), kv.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), projection.data_ptr(), _ptr(mask),
            out.data_ptr(), scratch.data_ptr(), B, T, H, D, m,
            _KERNEL_DTYPES[qkv.dtype], int(bf16), eps, pre_scale,
            favor_cluster(B * H, qkv.device, favor_per_sm(D)))
    with torch.cuda.device(index):
        rc = _split_entry("mdm_favor_qkv_apply")(
            *args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(
            f"favor_qkv_apply kernel launch failed: CUDA error {rc}")
    favor_qkv_apply.launches += 1
    return out


favor_qkv_apply.launches = 0


# ---------------------------------------------------------------------------
# kernel 3 in three launches, for a seq rank's frames: kv, the seq ranks'
# all-reduce of kv, the q side and g_kv, the all-reduce of g_kv, the k and
# v side (the all-reduces are the caller's)
# ---------------------------------------------------------------------------

class FavorBwdSplit:
    """What the three launches of kernel 3's split share: the inputs, the
    flags and, on the card, one scratch, d(qkv) (each launch writes its
    thirds), the cluster size (all three take the same grid) and the
    shapes; on the CPU the second step's ``part``."""

    def __init__(self, qkv, ln_scale, ln_bias, projection, mask, pre_scale,
                 need_dproj, bf16_products):
        self.inputs = (qkv, ln_scale, ln_bias, projection, mask)
        self.pre_scale, self.need_dproj = pre_scale, need_dproj
        self.bf16 = bf16_products
        self.product = bf16_operand_product if bf16_products else None
        self.part = self.scratch = self.dqkv = None
        if qkv.is_cpu:
            return
        B, T, HD3 = qkv.shape
        D, m = projection.shape
        H = HD3 // (3 * D)
        self.dims = (B, T, H, D, m)
        self.cluster = favor_cluster(B * H, qkv.device, 1)
        self.scratch = torch.empty(
            _split_entry("mdm_favor_qkv_bwd_split_scratch_floats")(
                B, T, H, D, m, int(need_dproj), self.cluster),
            dtype=torch.float32, device=qkv.device)
        self.dqkv = torch.empty_like(qkv)

    def head(self):
        """The C entries' leading arguments: the inputs' pointers."""
        qkv, ln_scale, ln_bias, projection, mask = self.inputs
        return (qkv.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                projection.data_ptr(), _ptr(mask))

    def tail(self):
        """The shapes and the dtype flags."""
        return (*self.dims, _KERNEL_DTYPES[self.inputs[0].dtype],
                int(self.bf16))


def _split_run(op: str, entry: str, index: int, args) -> None:
    """Launch the C entry ``entry`` on card ``index``'s current stream, as
    kernel 2 launches: no device context when it is the current card."""
    fn = _split_entry(entry)
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc}")


def favor_qkv_bwd_kv(qkv: torch.Tensor, ln_scale: torch.Tensor,
                     ln_bias: torch.Tensor, projection: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     pre_scale: float = 0.1, need_dproj: bool = True,
                     bf16_products: Optional[bool] = None):
    """Kernel 3's first launch on a seq rank's frames: (kv [B, H, m, D]
    f32 of these rows, times 0.1; the :class:`FavorBwdSplit` the next two
    launches take). ``bf16_products`` as for :func:`favor_qkv_bwd`. CPU
    tensors take :func:`favor_qkv_bwd_kv_plain`; CUDA tensors launch
    ``mdm_favor_qkv_bwd_kv`` of ``csrc/favor_qkv_bwd_split.cu`` (the inputs
    as for :func:`favor_qkv`)."""
    if bf16_products is None:
        bf16_products = mxu_bf16()
    if qkv.is_cpu:
        split = FavorBwdSplit(qkv, ln_scale, ln_bias, projection, mask,
                              pre_scale, need_dproj, bf16_products)
        return favor_qkv_bwd_kv_plain(qkv, ln_scale, ln_bias, projection,
                                      mask, pre_scale, split.product), split
    if not _split_ok(qkv, ln_scale, ln_bias, projection, mask, None):
        _check_split("favor_qkv_bwd_kv", qkv, ln_scale, ln_bias, projection,
                     mask, None)
    split = FavorBwdSplit(qkv, ln_scale, ln_bias, projection, mask,
                          pre_scale, need_dproj, bf16_products)
    B, _, H, D, m = split.dims
    kv = torch.empty((B, H, m, D), dtype=torch.float32, device=qkv.device)
    _split_run("favor_qkv_bwd_kv", "mdm_favor_qkv_bwd_kv", qkv.get_device(),
               (*split.head(), kv.data_ptr(), split.scratch.data_ptr(),
                *split.tail(), pre_scale, int(need_dproj), split.cluster))
    favor_qkv_bwd_kv.launches += 1
    return kv, split


favor_qkv_bwd_kv.launches = 0


def favor_qkv_bwd_q(split: FavorBwdSplit, kv: torch.Tensor,
                    g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Kernel 3's second launch: from ``kv`` (the seq ranks' sum of
    :func:`favor_qkv_bwd_kv`'s) and the output's gradient ``g`` [B,
    T_rank, H*D] (contiguous, in qkv's dtype), d(q) of the rank's rows and
    their g_kv [B, H, m, D] f32, times 0.1, which it returns. CPU tensors
    take :func:`favor_qkv_bwd_q_plain`; CUDA tensors launch
    ``mdm_favor_qkv_bwd_q``."""
    qkv, ln_scale, ln_bias, projection, mask = split.inputs
    split.eps = eps
    if qkv.is_cpu:
        g_kv, split.part = favor_qkv_bwd_q_plain(
            qkv, kv, ln_scale, ln_bias, projection, mask, g, eps,
            split.pre_scale, split.need_dproj, split.product)
        return g_kv
    B, T, H, D, m = split.dims
    if not (_split_ok(qkv, ln_scale, ln_bias, projection, mask, kv)
            and g.dtype is qkv.dtype and g.shape == (B, T, H * D)
            and g.is_contiguous() and g.get_device() == qkv.get_device()):
        _require(g.device == qkv.device and g.dtype == qkv.dtype
                 and g.shape == (B, T, H * D) and g.is_contiguous(),
                 f"favor_qkv_bwd_q: g must be a contiguous {qkv.dtype} "
                 f"[{B}, {T}, {H * D}] tensor on {qkv.device}, got "
                 f"{g.dtype} {tuple(g.shape)} on {g.device}")
        _check_split("favor_qkv_bwd_q", qkv, ln_scale, ln_bias, projection,
                     mask, kv)
    g_kv = torch.empty_like(kv)
    _split_run("favor_qkv_bwd_q", "mdm_favor_qkv_bwd_q", qkv.get_device(),
               (*split.head(), g.data_ptr(), kv.data_ptr(),
                split.dqkv.data_ptr(), g_kv.data_ptr(),
                split.scratch.data_ptr(), *split.tail(), eps,
                split.pre_scale, int(split.need_dproj), split.cluster))
    favor_qkv_bwd_q.launches += 1
    return g_kv


favor_qkv_bwd_q.launches = 0


def favor_qkv_bwd_k(split: FavorBwdSplit, g_kv: torch.Tensor):
    """Kernel 3's third launch: from ``g_kv`` (the seq ranks' sum of
    :func:`favor_qkv_bwd_q`'s), (d qkv of the rank's rows, and these rows'
    shares of d ln_scale, d ln_bias, d projection or None), as
    :func:`favor_qkv_bwd` returns the whole T's. CPU tensors take
    :func:`favor_qkv_bwd_k_plain`; CUDA tensors launch
    ``mdm_favor_qkv_bwd_k``."""
    qkv, ln_scale, ln_bias, projection, mask = split.inputs
    if qkv.is_cpu:
        return favor_qkv_bwd_k_plain(
            qkv, g_kv, ln_scale, ln_bias, projection, mask, split.part,
            split.pre_scale, split.need_dproj, split.product)
    B, T, H, D, m = split.dims
    if not _split_ok(qkv, ln_scale, ln_bias, projection, mask, g_kv):
        _check_split("favor_qkv_bwd_k", qkv, ln_scale, ln_bias, projection,
                     mask, g_kv)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    ds, dc = torch.empty(D, **f32), torch.empty(D, **f32)
    dp = torch.empty((D, m), **f32) if split.need_dproj else None
    _split_run("favor_qkv_bwd_k", "mdm_favor_qkv_bwd_k", qkv.get_device(),
               (*split.head(), g_kv.data_ptr(), split.dqkv.data_ptr(),
                ds.data_ptr(), dc.data_ptr(), _ptr(dp),
                split.scratch.data_ptr(), *split.tail(), split.eps,
                split.pre_scale, split.cluster))
    favor_qkv_bwd_k.launches += 1
    return split.dqkv, ds, dc, dp


favor_qkv_bwd_k.launches = 0


class _FavorQKVSplit(torch.autograd.Function):
    """Kernel 1 over the seq ranks (``group``, a ``DataGroup``), with its
    backward kernel: forward, :func:`favor_qkv_moments`, the f32 sum of kv
    over the group, :func:`favor_qkv_apply`; backward, kernel 3's three
    launches with the sums of kv and of g_kv between them. Saves only the
    inputs, as :class:`_FavorQKV`. Every seq rank runs the same sums in
    the same order."""

    @staticmethod
    def forward(ctx, qkv, ln_scale, ln_bias, projection, mask, group, eps,
                pre_scale):
        ctx.save_for_backward(qkv, ln_scale, ln_bias, projection, mask)
        ctx.group, ctx.eps, ctx.pre_scale = group, eps, pre_scale
        ctx.bf16_products = mxu_bf16()
        kv = group.sum_(favor_qkv_moments(qkv, ln_scale, ln_bias, projection,
                                          mask, pre_scale))
        return favor_qkv_apply(qkv, kv, ln_scale, ln_bias, projection, mask,
                               eps, pre_scale)

    @staticmethod
    def backward(ctx, g):
        qkv, ln_scale, ln_bias, projection, mask = ctx.saved_tensors
        kv, split = favor_qkv_bwd_kv(
            qkv, ln_scale, ln_bias, projection, mask, ctx.pre_scale,
            need_dproj=ctx.needs_input_grad[3],
            bf16_products=ctx.bf16_products)
        g_kv = favor_qkv_bwd_q(split, ctx.group.sum_(kv), g.contiguous(),
                               ctx.eps)
        dq, ds, dc, dp = favor_qkv_bwd_k(split, ctx.group.sum_(g_kv))
        return dq, ds, dc, dp, None, None, None, None


def favor_qkv_split(qkv: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, projection: torch.Tensor,
                    mask: Optional[torch.Tensor], group, eps: float = 1e-6,
                    pre_scale: float = 0.1) -> torch.Tensor:
    """:func:`favor_qkv` on a seq rank's frames (qkv [B, T_rank, 3*H*D],
    mask [B, T_rank]), the kv sum closed over ``group`` (the seq ranks'
    ``DataGroup``): the rank's rows of the whole T's output, differentiable
    (:class:`_FavorQKVSplit`). The kernels on CUDA tensors, the plain steps
    on the CPU."""
    return _FavorQKVSplit.apply(qkv, ln_scale, ln_bias, projection, mask,
                                group, eps, pre_scale)


class _SeqSum(torch.autograd.Function):
    """The f32 sum over the seq ranks (``group``) of a partial sum over T
    (kv): each rank's gradient is the sum of the ranks' gradients of the
    total."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum_(g.clone()), None


def seq_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the seq ranks of ``group``, differentiable."""
    return _SeqSum.apply(x, group)


def favor_qkv_split_plain(qkv: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, projection: torch.Tensor,
                          mask: Optional[torch.Tensor], group,
                          eps: float = 1e-6, pre_scale: float = 0.1,
                          product: Optional[Callable] = None
                          ) -> torch.Tensor:
    """:func:`favor_qkv_split` in plain PyTorch: the moments, their sum
    over ``group`` (:func:`seq_sum`), the apply; autograd sums g_kv."""
    kv = seq_sum(favor_qkv_moments_plain(qkv, ln_scale, ln_bias, projection,
                                         mask, pre_scale, product), group)
    return favor_qkv_apply_plain(qkv, kv, ln_scale, ln_bias, projection,
                                 mask, eps, pre_scale, product)


_EPILOGUE_SLOTS: dict = {}  # (device index, D, dtype) -> blocks at once
_EPILOGUE_FN = None  # the C entry, taken from the library once


def epilogue_chunks(B: int, T: int, slots: int) -> int:
    """Blocks per batch row (each ceil(T / C) rows) of the kernel of
    ``csrc/performer_epilogue.cu`` on a card that holds ``slots`` of its
    blocks at once: as many as fill it, 1 at the least and no more than
    leave each of a block's 8 warps a row (8 at the flagship's B = 32, T =
    196 on an H100, which holds two blocks on each of its 132 SMs)."""
    return max(1, min(-(-T // 8), slots // B))


def epilogue_slots(index: int, D: int, dtype: torch.dtype) -> int:
    """Blocks of the kernel of ``csrc/performer_epilogue.cu`` that card
    ``index`` holds at once at width D in ``dtype``: its occupancy per SM
    times the SMs, asked once per card, width and dtype."""
    key = (index, D, dtype)
    n = _EPILOGUE_SLOTS.get(key)
    if n is None:
        from motiondiffusion_moe_tpu_torch.ops._build import library

        per_sm = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = library().mdm_performer_epilogue_blocks_per_sm(
                D, _KERNEL_DTYPES[dtype], ctypes.byref(per_sm))
        if rc != 0 or per_sm.value < 1:
            raise RuntimeError(f"performer_epilogue occupancy query failed: "
                               f"CUDA error {rc}, {per_sm.value} blocks")
        n = _EPILOGUE_SLOTS[key] = per_sm.value * torch.cuda.\
            get_device_properties(index).multi_processor_count
    return n


def _launch_performer_epilogue(y, scale, shift, post_scale, post_bias,
                               style_scale, style_bias,
                               chunks: Optional[int] = None) -> torch.Tensor:
    """Launch kernel 2 on the card: one check of the inputs (the detailed
    one, which raises, only where it fails), the output, the C entry on
    the current stream, entering a device context only when y lies on
    another card than the current one. ``chunks`` forces the blocks per
    batch row (a measurement's sweep); None takes :func:`epilogue_chunks`."""
    global _EPILOGUE_FN
    vecs = (post_scale, post_bias, style_scale, style_bias)
    if not _epilogue_ok(y, scale, shift, vecs):
        _check_epilogue("performer_epilogue", y, scale, shift, vecs,
                        views=True)
        raise ValueError("performer_epilogue: inputs the kernel does not "
                         "take")
    if _EPILOGUE_FN is None:
        from motiondiffusion_moe_tpu_torch.ops._build import library

        _EPILOGUE_FN = library().mdm_performer_epilogue
    B, T, D = y.shape
    index = y.get_device()
    if chunks is None:
        chunks = epilogue_chunks(B, T, epilogue_slots(index, D, y.dtype))
    out = torch.empty_like(y)
    args = (y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            scale.stride(0), shift.stride(0), post_scale.data_ptr(),
            post_bias.data_ptr(), style_scale.data_ptr(),
            style_bias.data_ptr(), out.data_ptr(), B, T, D,
            _KERNEL_DTYPES[y.dtype], chunks)
    if index == torch.cuda.current_device():
        rc = _EPILOGUE_FN(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = _EPILOGUE_FN(*args,
                              torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(
            f"performer_epilogue kernel launch failed: CUDA error {rc}")
    performer_epilogue.launches += 1
    return out


def performer_epilogue_bwd(y: torch.Tensor, scale: torch.Tensor,
                           shift: torch.Tensor, post_scale: torch.Tensor,
                           post_bias: torch.Tensor, style_scale: torch.Tensor,
                           style_bias: torch.Tensor, g: torch.Tensor):
    """Backward of :func:`performer_epilogue` from the inputs and the
    output's gradient ``g`` [B, T, D]: (dy, d scale, d shift, d post_scale,
    d post_bias, d style_scale, d style_bias). CPU tensors take
    :func:`performer_epilogue_bwd_plain`; CUDA tensors launch
    ``csrc/performer_epilogue_bwd.cu`` (g contiguous, in y's dtype)."""
    if y.device.type == "cpu":
        return performer_epilogue_bwd_plain(y, scale, shift, post_scale,
                                            post_bias, style_scale,
                                            style_bias, g)
    vecs = (post_scale, post_bias, style_scale, style_bias)
    B, T, D = _check_epilogue("performer_epilogue_bwd", y, scale, shift,
                              vecs)
    _require(g.device == y.device and g.dtype == y.dtype
             and g.shape == y.shape and g.is_contiguous(),
             f"performer_epilogue_bwd: g must be a contiguous {y.dtype} "
             f"{tuple(y.shape)} tensor on {y.device}, got {g.dtype} "
             f"{tuple(g.shape)} on {g.device}")
    _require(g.data_ptr() % 16 == 0,
             "performer_epilogue_bwd: g must be 16-byte aligned")
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    dy = torch.empty_like(y)
    dscale, dshift = torch.empty_like(scale), torch.empty_like(shift)
    dvecs = [torch.empty_like(v) for v in vecs]
    scratch = torch.empty(
        lib.mdm_performer_epilogue_bwd_scratch_floats(B, T, D),
        dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        rc = lib.mdm_performer_epilogue_bwd(
            y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            *[v.data_ptr() for v in vecs], g.data_ptr(), dy.data_ptr(),
            dscale.data_ptr(), dshift.data_ptr(),
            *[v.data_ptr() for v in dvecs], scratch.data_ptr(),
            B, T, D, _KERNEL_DTYPES[y.dtype], _stream(y.device))
    if rc != 0:
        raise RuntimeError(
            f"performer_epilogue_bwd kernel launch failed: CUDA error {rc}")
    performer_epilogue_bwd.launches += 1
    return (dy, dscale, dshift, *dvecs)


performer_epilogue_bwd.launches = 0


def epilogue_bwd_cluster(B: int, T: int, D: int, dtype: torch.dtype) -> int:
    """The blocks per batch row (a thread-block cluster, each block a chunk
    of ceil(T / C) rows) that the kernel of ``csrc/performer_epilogue_bwd.cu``
    launches on the current card for these shapes: the largest C <= min(8,
    T) for which all B clusters are resident at once, else 1 (3 at the
    flagship's B = 32 on an H100, where 32 clusters of 4 do not fit)."""
    from motiondiffusion_moe_tpu_torch.ops._build import library

    out = ctypes.c_int(0)
    rc = library().mdm_performer_epilogue_bwd_cluster(
        B, T, D, _KERNEL_DTYPES[dtype], ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"epilogue_bwd_cluster failed: CUDA error {rc}")
    return out.value


class _PerformerEpilogue(torch.autograd.Function):
    """performer_epilogue with its backward kernel; saves only the
    inputs. Kernel 4 takes scale and shift contiguous: the backward copies
    strided views (the forward kernel reads them as they are)."""

    @staticmethod
    def forward(ctx, y, scale, shift, post_scale, post_bias, style_scale,
                style_bias):
        args = (y, scale, shift, post_scale, post_bias, style_scale,
                style_bias)
        ctx.save_for_backward(*args)
        if y.device.type == "cpu":
            return performer_epilogue_plain(*args)
        return _launch_performer_epilogue(*args)

    @staticmethod
    def backward(ctx, g):
        y, scale, shift, *vecs = ctx.saved_tensors
        return performer_epilogue_bwd(y, scale.contiguous(),
                                      shift.contiguous(), *vecs,
                                      g.contiguous())


def performer_epilogue(y: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, post_scale: torch.Tensor,
                       post_bias: torch.Tensor, style_scale: torch.Tensor,
                       style_bias: torch.Tensor) -> torch.Tensor:
    """Fused Performer epilogue (see module doc), differentiable on every
    device. CPU tensors take :func:`performer_epilogue_plain` and its
    autograd backward; CUDA tensors launch ``csrc/performer_epilogue.cu``
    forward and ``csrc/performer_epilogue_bwd.cu`` backward. With grad
    disabled (``torch.no_grad``, ``torch.inference_mode``: sampling) the
    call goes straight to the launch, without the autograd Function.

    On CUDA: y contiguous f32 or bf16 with D in :data:`EPILOGUE_DIMS`;
    scale and shift [B, D] in y's dtype, contiguous or strided views with
    column stride 1, a row stride >= D and 16-byte aligned rows (the
    ``chunk`` halves of a [B, 2D] tensor); the four LN vectors contiguous
    f32 [D]."""
    if not torch.is_grad_enabled():
        if y.is_cuda:
            return _launch_performer_epilogue(
                y, scale, shift, post_scale, post_bias, style_scale,
                style_bias)
        if y.is_cpu:
            return performer_epilogue_plain(
                y, scale, shift, post_scale, post_bias, style_scale,
                style_bias)
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"performer_epilogue: unsupported device {y.device}")
    return _PerformerEpilogue.apply(y, scale, shift, post_scale, post_bias,
                                    style_scale, style_bias)


performer_epilogue.launches = 0


# ---------------------------------------------------------------------------
# kernels 8 and 10: the same CUDA kernel, other layouts; their backward is
# autograd through the plain version (the TPU kernels have no backward
# kernel either)
# ---------------------------------------------------------------------------

def _launch_favor_attention(q, k, v, projection, mask, eps) -> torch.Tensor:
    op = "favor_attention"
    _require(q.dim() == 4, f"{op}: q must be [B, H, T, D], got "
                           f"{tuple(q.shape)}")
    B, H, T, D = q.shape
    dev = q.device
    Dp, m = _check_projection(op, projection, dev)
    _require(q.device.type == "cuda", f"{op}: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.device == dev and t.dtype == torch.float32
                 and t.shape == q.shape and t.is_contiguous(),
                 f"{op}: {name} must be a contiguous float32 "
                 f"{list(q.shape)} tensor on {dev}, got {t.dtype} "
                 f"{tuple(t.shape)} on {t.device}")
    _require(B > 0 and H > 0 and T > 0, f"{op}: empty input")
    _require(Dp == D, f"{op}: projection is [{Dp}, {m}] for head dim {D}")
    if mask is not None:
        _require(mask.device == dev and mask.dtype == torch.float32
                 and mask.shape == (B, 1, T) and mask.is_contiguous(),
                 f"{op}: mask must be a contiguous float32 [{B}, 1, {T}] "
                 f"tensor on {dev}, got {mask.dtype} {tuple(mask.shape)}")
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    out = torch.empty_like(q)
    scratch = _favor_scratch(B, T, H, m, dev)
    with torch.cuda.device(dev):
        rc = lib.mdm_favor_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), projection.data_ptr(),
            _ptr(mask), out.data_ptr(), scratch.data_ptr(), B, H, T, D, m,
            eps, favor_cluster(B * H, dev, favor_per_sm(D)), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"favor_attention kernel launch failed: CUDA error {rc}")
    favor_attention.launches += 1
    return out


class _FavorAttention(torch.autograd.Function):
    """Kernel 8 forward; the backward is autograd through the plain
    version, as ``_favor_bwd`` differentiates the reference."""

    @staticmethod
    def forward(ctx, q, k, v, projection, mask, eps):
        ctx.save_for_backward(q, k, v, projection, mask)
        ctx.eps = eps
        if q.device.type == "cpu":
            return favor_attention_plain(q, k, v, projection, mask, eps)
        return _launch_favor_attention(q, k, v, projection, mask, eps)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(favor_attention_plain, ctx.saved_tensors,
                           ctx.needs_input_grad, g, ctx.eps), None)


def favor_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    projection: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    eps: float = 1e-6) -> torch.Tensor:
    """The FAVOR+ core on normalised q, k, v [B, H, T, D] (the counterpart
    of ``favor_attention``, Pallas kernel ``_favor_kernel``): f32 out,
    differentiable on every device. CPU tensors take
    :func:`favor_attention_plain`; CUDA tensors launch the kernel of
    ``csrc/favor_qkv.cu`` with the normalisation compiled out.

    On CUDA: q, k, v contiguous float32 [B, H, T, D]; projection contiguous
    float32 with (D, m) one of :data:`FAVOR_SHAPES`; mask contiguous float32
    [B, 1, T] or None."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"favor_attention: unsupported device {q.device}")
    return _FavorAttention.apply(q, k, v, projection, mask, eps)


favor_attention.launches = 0


def _check_core_split(op, x, projection, mask, kv, parts):
    """Validate kernel 8's split inputs (``parts``: the [B, H, T, D]
    tensors, each f32 and contiguous like ``x``); returns (B, H, T, D,
    m)."""
    _require(x.dim() == 4 and x.device.type == "cuda",
             f"{op}: expected [B, H, T, D] CUDA tensors, got "
             f"{tuple(x.shape)} on {x.device}")
    B, H, T, D = x.shape
    dev = x.device
    Dp, m = _check_projection(op, projection, dev)
    _require(Dp == D and B > 0 and H > 0 and T > 0,
             f"{op}: projection is [{Dp}, {m}] for head dim {D}")
    for name, t in parts:
        _require(t.device == dev and t.dtype == torch.float32
                 and t.shape == x.shape and t.is_contiguous(),
                 f"{op}: {name} must be a contiguous float32 {list(x.shape)}"
                 f" tensor on {dev}, got {t.dtype} {tuple(t.shape)}")
    if mask is not None:
        _require(mask.device == dev and mask.dtype == torch.float32
                 and mask.shape == (B, 1, T) and mask.is_contiguous(),
                 f"{op}: mask must be a contiguous float32 [{B}, 1, {T}] "
                 f"tensor on {dev}, got {mask.dtype} {tuple(mask.shape)}")
    if kv is not None:
        _require(kv.device == dev and kv.dtype == torch.float32
                 and kv.shape == (B, H, m, D) and kv.is_contiguous(),
                 f"{op}: kv must be a contiguous float32 [{B}, {H}, {m}, "
                 f"{D}] tensor on {dev}, got {kv.dtype} {tuple(kv.shape)}")
    return B, H, T, D, m


def favor_attention_moments(k: torch.Tensor, v: torch.Tensor,
                            projection: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Kernel 8's first launch on a seq rank's frames (the unfused
    Performer's core): k, v [B, H, T_rank, D] f32, mask [B, 1, T_rank] ->
    kv [B, H, m, D] f32. CPU tensors take
    :func:`favor_attention_moments_plain`; CUDA tensors launch
    ``mdm_favor_attention_moments``. No gradient:
    :func:`favor_attention_split` is the differentiable whole."""
    if k.is_cpu:
        return favor_attention_moments_plain(k, v, projection, mask)
    B, H, T, D, m = _check_core_split("favor_attention_moments", k,
                                      projection, mask, None,
                                      (("k", k), ("v", v)))
    dev = k.device
    kv = torch.empty((B, H, m, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _split_entry("mdm_favor_attention_moments")(
            k.data_ptr(), v.data_ptr(), projection.data_ptr(), _ptr(mask),
            kv.data_ptr(), B, H, T, D, m,
            favor_cluster(B * H, dev, favor_per_sm(D)), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"favor_attention_moments kernel launch failed: CUDA error {rc}")
    favor_attention_moments.launches += 1
    return kv


favor_attention_moments.launches = 0


def favor_attention_apply(q: torch.Tensor, k: torch.Tensor, kv: torch.Tensor,
                          projection: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          eps: float = 1e-6) -> torch.Tensor:
    """Kernel 8's second launch: f32 [B, H, T_rank, D] from q, k of the
    rank's frames and ``kv``, the seq ranks' summed moments. CPU tensors
    take :func:`favor_attention_apply_plain`; CUDA tensors launch
    ``mdm_favor_attention_apply``. No gradient."""
    if q.is_cpu:
        return favor_attention_apply_plain(q, k, kv, projection, mask, eps)
    B, H, T, D, m = _check_core_split("favor_attention_apply", q,
                                      projection, mask, kv,
                                      (("q", q), ("k", k)))
    dev = q.device
    out = torch.empty_like(q)
    scratch = _favor_scratch(B, T, H, m, dev)
    with torch.cuda.device(dev):
        rc = _split_entry("mdm_favor_attention_apply")(
            q.data_ptr(), k.data_ptr(), kv.data_ptr(), projection.data_ptr(),
            _ptr(mask), out.data_ptr(), scratch.data_ptr(), B, H, T, D, m,
            eps, favor_cluster(B * H, dev, favor_per_sm(D)), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"favor_attention_apply kernel launch failed: CUDA error {rc}")
    favor_attention_apply.launches += 1
    return out


favor_attention_apply.launches = 0


def favor_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, projection: torch.Tensor,
                                mask: Optional[torch.Tensor], group,
                                eps: float = 1e-6) -> torch.Tensor:
    """:func:`favor_attention_plain` on a seq rank's frames (q, k, v [B, H,
    T_rank, D], mask [B, 1, T_rank]), the kv sum closed over ``group`` by
    :func:`seq_sum`: differentiable through autograd."""
    kv = seq_sum(favor_attention_moments_plain(k, v, projection, mask),
                 group)
    return favor_attention_apply_plain(q, k, kv, projection, mask, eps)


class _FavorAttentionSplit(torch.autograd.Function):
    """Kernel 8 over the seq ranks: forward, :func:`favor_attention_moments`,
    the f32 sum of kv over ``group``, :func:`favor_attention_apply`;
    backward through :func:`favor_attention_split_plain` (kv again and its
    sum, then autograd, which sums g_kv), as :class:`_FavorAttention`'s
    goes through the plain version: the TPU kernel has no backward
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, projection, mask, group, eps):
        ctx.save_for_backward(q, k, v, projection, mask)
        ctx.group, ctx.eps = group, eps
        kv = group.sum_(favor_attention_moments(k, v, projection, mask))
        return favor_attention_apply(q, k, kv, projection, mask, eps)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(favor_attention_split_plain, ctx.saved_tensors,
                           ctx.needs_input_grad, g, ctx.group, ctx.eps),
                None, None)


def favor_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          projection: torch.Tensor,
                          mask: Optional[torch.Tensor], group,
                          eps: float = 1e-6) -> torch.Tensor:
    """:func:`favor_attention` on a seq rank's frames with the kv sum closed
    over ``group``: differentiable (:class:`_FavorAttentionSplit`), the
    kernels on CUDA tensors and the plain steps on the CPU."""
    return _FavorAttentionSplit.apply(q, k, v, projection, mask, group, eps)


def _launch_favor_full(q, k, v, ln_scale, ln_bias, projection, mask, eps,
                       pre_scale) -> torch.Tensor:
    op = "favor_attention_full"
    B, T, H, D, m = _check_favor(op, q, ln_scale, ln_bias, projection, mask,
                                 parts=1)
    for name, t in (("k", k), ("v", v)):
        _require(t.device == q.device and t.dtype == q.dtype
                 and t.shape == q.shape and t.is_contiguous(),
                 f"{op}: {name} must be a contiguous {q.dtype} "
                 f"{list(q.shape)} tensor on {q.device}, got {t.dtype} "
                 f"{tuple(t.shape)} on {t.device}")
    from motiondiffusion_moe_tpu_torch.ops._build import library

    lib = library()
    out = torch.empty_like(q)
    scratch = _favor_scratch(B, T, H, m, q.device)
    with torch.cuda.device(q.device):
        rc = lib.mdm_favor_attention_full(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), projection.data_ptr(), _ptr(mask),
            out.data_ptr(), scratch.data_ptr(), B, T, H, D, m,
            _KERNEL_DTYPES[q.dtype], eps, pre_scale,
            favor_cluster(B * H, q.device, favor_per_sm(D)), _stream(q.device))
    if rc != 0:
        raise RuntimeError(
            f"favor_attention_full kernel launch failed: CUDA error {rc}")
    favor_attention_full.launches += 1
    return out


class _FavorFull(torch.autograd.Function):
    """Kernel 10 forward; the backward is autograd through the plain
    version, as ``_favor_full_bwd`` differentiates the reference."""

    @staticmethod
    def forward(ctx, q, k, v, ln_scale, ln_bias, projection, mask, eps,
                pre_scale):
        args = (q, k, v, ln_scale, ln_bias, projection, mask)
        ctx.save_for_backward(*args)
        ctx.eps, ctx.pre_scale = eps, pre_scale
        if q.device.type == "cpu":
            return favor_full_plain(*args, eps, pre_scale)
        return _launch_favor_full(*args, eps, pre_scale)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(favor_full_plain, ctx.saved_tensors,
                           ctx.needs_input_grad, g, ctx.eps, ctx.pre_scale),
                None, None)


def favor_attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                         projection: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         eps: float = 1e-6,
                         pre_scale: float = 0.1) -> torch.Tensor:
    """Kernel 1's whole FastAttention body on separate q, k, v [B, T, H*D]
    (the counterpart of ``favor_attention_full``, Pallas kernel
    ``_favor_full_kernel``), differentiable on every device. CPU tensors
    take :func:`favor_full_plain`; CUDA tensors launch the kernel of
    ``csrc/favor_qkv.cu`` with three base pointers.

    On CUDA: q, k, v contiguous, one dtype (f32 or bf16); ln_scale,
    ln_bias, projection and mask as for :func:`favor_qkv`."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"favor_attention_full: unsupported device {q.device}")
    return _FavorFull.apply(q, k, v, ln_scale, ln_bias, projection, mask, eps,
                            pre_scale)


favor_attention_full.launches = 0
