"""Card-only tests: each hand-written CUDA kernel against its plain version,
and small sampling pipelines on the card against the same on the CPU.

Marked ``cuda``; without a CUDA device they skip. On a machine with an H100
and nvcc run them with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks; this file imports only torch, numpy and ``tests/_bf16.py``.)

Tolerances: f32 kernels do the same IEEE f32 math as the plain version in
another summation order -> 1e-4 relative to the output's scale. bf16
outputs are the same f32 result rounded once to bf16 -> one bf16 ulp
(2**-7 relative) plus a small absolute floor. The pipeline: f32 compute
through 3 DPM-Solver++ steps -> 1e-4 of the sample's largest value (the
eps -> x0 factor reaches ~1e2 at t = T-1). The backward kernels: their f32
outputs are sums over T (and over B*H for the parameter gradients) taken in
another order than autograd's -> 1e-3 of the output's largest value; bf16
gradients (d qkv, dy, d scale, d shift) are that result rounded once ->
one bf16 ulp plus the same floor. The fused MoE in bf16: the final
rounding (one ulp) plus the rare one-ulp flips of the rounded hidden
activations, each worth one ulp of one term of the second product -> one
bf16 ulp plus 1e-3 of the output's largest value. The exact
cross-attention in bf16 (kernels 6 and 9 on the tensor cores, the
probabilities in two bf16 terms): at most 1% of the outputs differ from the
plain version's, each by one ulp (floored at 2^-16 of the largest value,
the f32 sums' absolute error where values cancel to near zero). The bf16
activations and their gradient pass take the plain versions' steps with
the same roundings: their bits on >= 99.9% of the values (expf and tanhf may differ from PyTorch's in
the last f32 bit, which can move a rounding), one ulp elsewhere. The
DeBERTa text encoder (plain PyTorch ops in f32, cuBLAS with TF32 off, on
f32- and bf16-stored weights) on the card against the CPU: 1e-4 of the
output's largest value.
"""

import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu_torch.ops import activations as ACT
from motiondiffusion_moe_tpu_torch.ops import adaln as AD
from motiondiffusion_moe_tpu_torch.ops import flash_attention as XA
from motiondiffusion_moe_tpu_torch.ops import moe as MOE
from motiondiffusion_moe_tpu_torch.ops import performer as P
# the tests directory itself, which pytest puts on the path: an installed
# package named ``tests`` may shadow ``tests._bf16``
from _bf16 import assert_bf16_flips, bf16_flips

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for "
                    "sm_90a and run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _favor_inputs(dev, B, T, H, D, m, dtype, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D))
                           .astype(np.float32)).to(dev, dtype)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(D))
                             .astype(np.float32)).to(dev)
    bias = torch.from_numpy((0.1 * rng.standard_normal(D))
                            .astype(np.float32)).to(dev)
    proj = torch.from_numpy((rng.standard_normal((D, m)) * D ** -0.25)
                            .astype(np.float32)).to(dev)
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T
    mask = torch.from_numpy((np.arange(T)[None] < lengths[:, None])
                            .astype(np.float32)).to(dev)
    return qkv, scale, bias, proj, mask


@pytest.mark.parametrize("shape", [(3, 37, 2, 64, 128), (4, 196, 4, 128, 128),
                                   (2, 98, 8, 96, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_qkv_kernel_matches_plain(dev, shape, dtype):
    B, T, H, D, m = shape
    qkv, scale, bias, proj, mask = _favor_inputs(dev, B, T, H, D, m, dtype)
    n0 = P.favor_qkv.launches
    out = P.favor_qkv(qkv, scale, bias, proj, mask)
    torch.cuda.synchronize()
    assert P.favor_qkv.launches == n0 + 1
    ref = P.favor_qkv_plain(qkv, scale, bias, proj, mask)
    assert out.dtype == dtype and out.shape == (B, T, H * D)
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert (err <= 2 ** -7 * ref.float().abs() + 1e-3).all()


def test_favor_qkv_kernel_without_mask(dev):
    qkv, scale, bias, proj, _ = _favor_inputs(dev, 2, 50, 4, 128, 128,
                                              torch.float32, seed=1)
    out = P.favor_qkv(qkv, scale, bias, proj, None)
    ref = P.favor_qkv_plain(qkv, scale, bias, proj, None)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def _epilogue_inputs(dev, B, T, D, dtype, views, seed=2):
    """y, scale, shift and the four LN vectors; with ``views`` scale and
    shift are the ``chunk`` halves of one [B, 2D] tensor, as the style
    block's Dense gives them (row stride 2D, shift at +D elements)."""
    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0, off=0.0):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    y = t(B, T, D).to(dtype)
    both = t(B, 2 * D, s=0.3).to(dtype)
    scale, shift = both.chunk(2, dim=-1)
    if not views:
        scale, shift = scale.contiguous(), shift.contiguous()
    vecs = [t(D, s=0.1, off=1.0), t(D, s=0.1), t(D, s=0.1, off=1.0),
            t(D, s=0.1)]
    return y, scale, shift, vecs


# T = 37, 98, 196: no multiple of the 8 rows a block's warps take at once;
# at B = 5 the wrapper's chunks per batch row are 5, 13 and 25
@pytest.mark.parametrize("views", [False, True], ids=["contiguous", "views"])
@pytest.mark.parametrize("T", [37, 98, 196])
@pytest.mark.parametrize("D", [256, 512, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_kernel_matches_plain(dev, D, T, dtype, views):
    B = 5
    y, scale, shift, vecs = _epilogue_inputs(dev, B, T, D, dtype, views)
    assert scale.is_contiguous() != views
    n0 = P.performer_epilogue.launches
    out = P.performer_epilogue(y, scale, shift, *vecs)
    torch.cuda.synchronize()
    assert P.performer_epilogue.launches == n0 + 1
    ref = P.performer_epilogue_plain(y, scale, shift, *vecs)
    assert out.dtype == dtype and out.shape == y.shape
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert (err <= 2 ** -7 * ref.float().abs() + 1e-3).all()
    # no atomics, no cross-row sums: the same bits on a second call, and
    # from contiguous copies of the views
    assert torch.equal(P.performer_epilogue(y, scale, shift, *vecs), out)
    assert torch.equal(P.performer_epilogue(
        y, scale.contiguous(), shift.contiguous(), *vecs), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_launch_path_without_grad(dev, dtype):
    """Under inference mode and no_grad the wrapper launches without the
    autograd Function: one launch counted each, the same bits as with
    grad; forced chunkings of the rows give the same bits too."""
    y, scale, shift, vecs = _epilogue_inputs(dev, 32, 196, 512, dtype,
                                             views=True, seed=9)
    ref = P.performer_epilogue(y, scale, shift, *vecs)
    n0 = P.performer_epilogue.launches
    with torch.inference_mode():
        a = P.performer_epilogue(y, scale, shift, *vecs)
    with torch.no_grad():
        b = P.performer_epilogue(y, scale, shift, *vecs)
    assert P.performer_epilogue.launches == n0 + 2
    assert a.grad_fn is None and b.grad_fn is None
    assert torch.equal(a, ref) and torch.equal(b, ref)
    for c in (1, 2, 3, 6, 8, 25, 196):
        assert torch.equal(P._launch_performer_epilogue(
            y, scale, shift, *vecs, chunks=c), ref)
    slots = P.epilogue_slots(0, 512, dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert slots % sms == 0 and slots >= sms
    assert 1 <= P.epilogue_chunks(32, 196, slots) <= 25


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_kernel_on_rows_whose_l2_norm_is_zero(dev, dtype):
    """post_scale = post_bias = 0: h1 = 0, the L2 step's max(|h1|, 1e-12)
    (in bf16 sqrt(D) min(rsqrt(0), 1e12)), and SiLU(mb) everywhere."""
    y, scale, shift, vecs = _epilogue_inputs(dev, 3, 37, 512, dtype,
                                             views=True, seed=8)
    vecs[0].zero_()
    vecs[1].zero_()
    out = P.performer_epilogue(y, scale, shift, *vecs)
    ref = P.performer_epilogue_plain(y, scale, shift, *vecs)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert (err <= 2 ** -7 * ref.float().abs() + 1e-3).all()


def test_epilogue_refuses_views_the_kernel_cannot_read(dev):
    """ValueError for a column stride other than 1, a row stride < D and
    a base that is not 16-byte aligned, under grad and without."""
    B, T, D = 4, 37, 256
    y, scale, shift, vecs = _epilogue_inputs(dev, B, T, D, torch.bfloat16,
                                             views=True)
    wide = torch.zeros(B, 2 * D + 16, device=dev, dtype=torch.bfloat16)
    bad = {"column stride 2": wide[:, :2 * D:2],
           "row stride < D": wide.view(-1).as_strided((B, D), (D - 8, 1)),
           "misaligned base": wide[:, 1:D + 1],
           "misaligned rows": wide.view(-1).as_strided((B, D), (D + 1, 1))}
    for name, x in bad.items():
        assert x.shape == (B, D), name
        for grad in (True, False):
            with torch.set_grad_enabled(grad):
                with pytest.raises(ValueError):
                    P.performer_epilogue(y, x, shift, *vecs)
                with pytest.raises(ValueError):
                    P.performer_epilogue(y, scale, x, *vecs)
    # the backward kernel keeps its contract: contiguous scale and shift
    g = torch.zeros_like(y)
    with pytest.raises(ValueError):
        P.performer_epilogue_bwd(y, scale, shift, *vecs, g)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    qkv, scale, bias, proj, mask = _favor_inputs(dev, 2, 16, 2, 64, 128,
                                                 torch.float32)
    with pytest.raises(ValueError):
        P.favor_qkv(qkv.half(), scale, bias, proj, mask)
    with pytest.raises(ValueError):
        P.favor_qkv(qkv, scale.double(), bias, proj, mask)
    with pytest.raises(ValueError):
        P.favor_qkv(qkv.transpose(0, 1), scale, bias, proj, mask)
    with pytest.raises(ValueError):
        P.favor_qkv(qkv, scale, bias, proj[:, :32].contiguous(), mask)
    y = torch.zeros(2, 4, 100, device=dev)
    v = torch.ones(100, device=dev)
    with pytest.raises(ValueError):
        P.performer_epilogue(y, y[:, 0], y[:, 0], v, v, v, v)


def test_pipeline_on_the_card_matches_the_cpu(dev):
    """One layer per scale at the small_dense preset's attention shape
    (head 64, 128 features, width 256): kernels on the card vs the plain
    versions on the CPU, same weights and injected noise."""
    from motiondiffusion_moe_tpu_torch.config import (
        DataConfig, DiffusionConfig, ExperimentConfig, ModelConfig)
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    cfg = ExperimentConfig(
        data=DataConfig(dim_pose=26, max_motion_length=40, num_joints=4),
        diffusion=DiffusionConfig(num_timesteps=100),
        model=ModelConfig(input_feats=26, max_frames=40, latent_dim=256,
                          ff_size=64, num_layers=1, num_heads=4,
                          num_experts=4, text_latent_dim=32,
                          text_max_tokens=12, dtype="float32"))
    model = init_weights(MotionTransformer(cfg.model), 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # the zero-init leaves, or the output is zero
        for name, p in model.named_parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=g)
    noise = torch.randn(2, 40, 26, generator=g)
    tok = cfg.model.text_max_tokens
    ids_c = torch.from_numpy(hash_tokenize(["walk", "jump twice"], tok))
    ids_u = torch.from_numpy(hash_tokenize(["", ""], tok))
    lengths = torch.tensor([40, 17])
    outs = {}
    for d in ("cpu", dev):
        pipe = GenerationPipeline(cfg, model, sampler="dpm",
                                  num_inference_steps=3, micro_batch=2,
                                  device=d)
        n0 = P.favor_qkv.launches
        outs[str(d)] = pipe.sample(ids_c, ids_u, lengths,
                                   noise=noise).cpu()
    assert P.favor_qkv.launches - n0 == 4 * 4  # 4 Performers x 4 forwards
    ref, out = outs["cpu"], outs[str(dev)]
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def _assert_close(out, ref, dtype, floor_rel=1e-3):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    floor = floor_rel * ref.abs().max().item()
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= floor
    else:
        assert ((out - ref).abs() <= 2 ** -7 * ref.abs() + floor).all()


@pytest.mark.parametrize("need_dproj", [True, False])
@pytest.mark.parametrize("shape", [(3, 37, 2, 64, 128), (4, 196, 4, 128, 128),
                                   (2, 98, 8, 96, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_qkv_bwd_kernel_matches_plain(dev, shape, dtype, need_dproj):
    B, T, H, D, m = shape
    qkv, scale, bias, proj, mask = _favor_inputs(dev, B, T, H, D, m, dtype)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, T, H * D)).astype(np.float32)).to(dev, dtype)
    n0 = P.favor_qkv_bwd.launches
    out = P.favor_qkv_bwd(qkv, scale, bias, proj, mask, g,
                          need_dproj=need_dproj)
    torch.cuda.synchronize()
    assert P.favor_qkv_bwd.launches == n0 + 1
    ref = P.favor_qkv_bwd_plain(qkv, scale, bias, proj, mask, g,
                                need_dproj=need_dproj)
    assert out[0].dtype == dtype and out[0].shape == qkv.shape
    for o, r, dt in zip(out[:3], ref[:3], (dtype, torch.float32,
                                           torch.float32)):
        _assert_close(o, r, dt)
    if need_dproj:
        _assert_close(out[3], ref[3], torch.float32)
    else:
        assert out[3] is None
    again = P.favor_qkv_bwd(qkv, scale, bias, proj, mask, g,
                            need_dproj=need_dproj)
    for a, o in zip(again, out):  # no atomics: identical bits
        assert (a is None and o is None) or torch.equal(a, o)


# T = 1, 37, 196 and 300: no multiple of the chunk of rows a block takes;
# at B = 5 one block per batch row (T = 1) and clusters of 8 (the others)
@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("T", [1, 37, 196, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_bwd_kernel_matches_plain(dev, D, T, dtype):
    rng = np.random.default_rng(3)
    B = 5

    def t(*shape, s=1.0, off=0.0):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    y, g = t(B, T, D).to(dtype), t(B, T, D).to(dtype)
    scale, shift = t(B, D, s=0.3).to(dtype), t(B, D, s=0.3).to(dtype)
    vecs = [t(D, s=0.1, off=1.0), t(D, s=0.1), t(D, s=0.1, off=1.0),
            t(D, s=0.1)]
    n0 = P.performer_epilogue_bwd.launches
    out = P.performer_epilogue_bwd(y, scale, shift, *vecs, g)
    torch.cuda.synchronize()
    assert P.performer_epilogue_bwd.launches == n0 + 1
    ref = P.performer_epilogue_bwd_plain(y, scale, shift, *vecs, g)
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.dtype == r.dtype and o.shape == r.shape
        _assert_close(o, r, dtype if i < 3 else torch.float32)
    again = P.performer_epilogue_bwd(y, scale, shift, *vecs, g)
    assert all(torch.equal(a, o) for a, o in zip(again, out))
    cluster = P.epilogue_bwd_cluster(B, T, D, dtype)
    assert 1 <= cluster <= min(8, T)


def test_autograd_functions_take_the_backward_kernels(dev):
    """The wrappers are autograd Functions on the card: backward launches
    the backward kernels and returns what they return; the frozen
    projection gets no gradient and costs none."""
    qkv, scale, bias, proj, mask = _favor_inputs(dev, 2, 50, 4, 128, 128,
                                                 torch.bfloat16, seed=4)
    qkv.requires_grad_()
    scale.requires_grad_()
    bias.requires_grad_()
    out = P.favor_qkv(qkv, scale, bias, proj, mask)
    g = torch.randn_like(out)
    n0 = P.favor_qkv_bwd.launches
    out.backward(g)
    assert P.favor_qkv_bwd.launches == n0 + 1 and proj.grad is None
    ref = P.favor_qkv_bwd(qkv.detach(), scale.detach(), bias.detach(), proj,
                          mask, g, need_dproj=False)
    assert torch.equal(qkv.grad, ref[0]) and torch.equal(scale.grad, ref[1])

    rng = np.random.default_rng(6)
    y = torch.from_numpy(rng.standard_normal((2, 30, 512)).astype(
        np.float32)).to(dev, torch.bfloat16).requires_grad_()
    sc = torch.zeros(2, 512, device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    vecs = [torch.ones(512, device=dev, requires_grad=True) for _ in range(4)]
    out = P.performer_epilogue(y, sc, sc, *vecs)
    n0 = P.performer_epilogue_bwd.launches
    out.float().sum().backward()
    assert P.performer_epilogue_bwd.launches == n0 + 1
    assert all(v.grad is not None and torch.isfinite(v.grad).all()
               for v in [y, sc] + vecs)


def test_epilogue_backward_through_views(dev):
    """Scale and shift as chunk views of one [B, 2D] leaf: the backward
    kernel gets contiguous copies and the leaf's gradient is kernel 4's
    d(scale) | d(shift), the same bits as from contiguous inputs."""
    y, scale, shift, vecs = _epilogue_inputs(dev, 8, 98, 512,
                                             torch.bfloat16, views=True)
    both = torch.cat([scale, shift], dim=-1).requires_grad_()
    g = torch.randn_like(y)
    n0 = P.performer_epilogue_bwd.launches
    P.performer_epilogue(y, *both.chunk(2, dim=-1), *vecs).backward(g)
    assert P.performer_epilogue_bwd.launches == n0 + 1
    ref = P.performer_epilogue_bwd(y, scale.contiguous(), shift.contiguous(),
                                   *vecs, g)
    assert torch.equal(both.grad, torch.cat([ref[1], ref[2]], dim=-1))


def test_backward_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    qkv, scale, bias, proj, mask = _favor_inputs(dev, 2, 16, 2, 64, 128,
                                                 torch.float32)
    g = torch.zeros(2, 16, 128, device=dev)
    with pytest.raises(ValueError):
        P.favor_qkv_bwd(qkv, scale, bias, proj, mask, g.bfloat16())
    with pytest.raises(ValueError):
        P.favor_qkv_bwd(qkv, scale, bias, proj, mask, g[:, :8])
    y = torch.zeros(2, 4, 256, device=dev)
    v = torch.ones(256, device=dev)
    with pytest.raises(ValueError):
        P.performer_epilogue_bwd(y, y[:, 0], y[:, 0], v, v, v, v,
                                 y.transpose(0, 1))


def _moe_inputs(dev, S, D, E, hid, dtype, seed=7):
    """x, top-2 combine weights and the stored expert weights."""
    rng = np.random.default_rng(seed)
    p = np.exp(rng.standard_normal((S, E)))
    p /= p.sum(-1, keepdims=True)
    idx = np.argsort(-p, -1, kind="stable")[:, :2]
    combine = np.zeros((S, E), np.float32)
    np.put_along_axis(combine, idx, np.take_along_axis(p, idx, -1), -1)
    arrays = (rng.standard_normal((S, D)), combine,
              rng.standard_normal((E, D, hid)) * D ** -0.5,
              0.1 * rng.standard_normal((E, hid)),
              rng.standard_normal((E, hid, D)) * hid ** -0.5,
              0.1 * rng.standard_normal((E, D)))
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
            for a in arrays]


@pytest.mark.parametrize("shape", [(6272, 512, 4, 256), (600, 128, 4, 128),
                                   (1000, 768, 16, 1024), (37, 256, 2, 128),
                                   (1000, 384, 3, 128), (600, 512, 3, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dense_fused_kernel_matches_plain(dev, shape, dtype):
    S, D, E, hid = shape
    args = _moe_inputs(dev, S, D, E, hid, dtype)
    n0 = MOE.moe_dense_fused.launches
    out = MOE.moe_dense_fused(*args)
    torch.cuda.synchronize()
    assert MOE.moe_dense_fused.launches == n0 + 1
    ref = MOE.moe_dense_fused_plain(*args)
    assert out.dtype == dtype and out.shape == (S, D)
    _assert_close(out, ref, dtype)
    assert torch.equal(MOE.moe_dense_fused(*args), out)  # no atomics


@pytest.mark.parametrize("shape", [(32, 196, 85, 4, 128), (3, 37, 20, 8, 96),
                                   (2, 50, 7, 2, 64), (2, 40, 160, 4, 128),
                                   (4, 196, 85, 4, 256), (2, 37, 91, 2, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xattn_fastlayout_kernel_matches_plain(dev, shape, dtype):
    B, T, N, H, D = shape
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, dtype) for s in ((B, T, H * D), (B, N, H * D),
                                         (B, N, H * D)))
    n0 = XA.xattn_fastlayout.launches
    out = XA.xattn_fastlayout(q, k, v, H, D ** -0.5)
    torch.cuda.synchronize()
    assert XA.xattn_fastlayout.launches == n0 + 1
    ref = XA.xattn_fastlayout_plain(q, k, v, H, D ** -0.5)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        err = (out - ref).abs()
        assert err.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert_bf16_flips(out, ref)


def test_xattn_fastlayout_f32_at_head_dim_256_raises_past_91_keys(dev):
    """k and v of a head in shared memory: 91 keys fit at head dim 256 (the
    text encoder emits 85), 92 do not, and the wrapper says so; bf16 streams
    any number."""
    x = torch.zeros(1, 8, 4 * 256, device=dev)
    kv = torch.zeros(1, 92, 4 * 256, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        XA.xattn_fastlayout(x, kv, kv, 4)
    out = XA.xattn_fastlayout(x.bfloat16(), kv.bfloat16(), kv.bfloat16(), 4)
    torch.cuda.synchronize()
    assert out.shape == x.shape


def test_xattn_fastlayout_bf16_takes_any_number_of_keys(dev):
    """1024 keys: past what the f32 kernel holds in shared memory; the bf16
    kernel streams them."""
    B, T, N, H, D = 2, 50, 1024, 4, 128
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, torch.bfloat16) for s in ((B, T, H * D),
                                                  (B, N, H * D),
                                                  (B, N, H * D)))
    out = XA.xattn_fastlayout(q, k, v, H)
    assert_bf16_flips(out, XA.xattn_fastlayout_plain(q, k, v, H))


def test_fused_wrappers_differentiate_through_the_plain_versions(dev):
    """On the card the two new wrappers' gradients are autograd of their
    plain versions on the same inputs."""
    args = _moe_inputs(dev, 300, 256, 4, 128, torch.float32, seed=9)
    xs = [a.clone().requires_grad_() for a in args]
    g = torch.randn(300, 256, device=dev)
    (MOE.moe_dense_fused(*xs) * g).sum().backward()
    ys = [a.clone().requires_grad_() for a in args]
    (MOE.moe_dense_fused_plain(*ys) * g).sum().backward()
    for x, y in zip(xs, ys):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-6)
    q, k, v = (torch.randn(2, 30, 4 * 128, device=dev) for _ in range(3))
    qs = [a.clone().requires_grad_() for a in (q, k, v)]
    ps = [a.clone().requires_grad_() for a in (q, k, v)]
    g = torch.randn(2, 30, 512, device=dev)
    (XA.xattn_fastlayout(*qs, 4) * g).sum().backward()
    (XA.xattn_fastlayout_plain(*ps, 4) * g).sum().backward()
    for a, b in zip(qs, ps):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    args = _moe_inputs(dev, 64, 128, 4, 128, torch.float32)
    with pytest.raises(ValueError):  # D not instantiated
        MOE.moe_dense_fused(*_moe_inputs(dev, 64, 96, 4, 128, torch.float32))
    with pytest.raises(ValueError):  # hid not a multiple of 128
        MOE.moe_dense_fused(*_moe_inputs(dev, 64, 128, 4, 96, torch.float32))
    with pytest.raises(ValueError):  # mixed dtypes
        MOE.moe_dense_fused(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError):  # not contiguous
        MOE.moe_dense_fused(args[0].t().contiguous().t(), *args[1:])
    q = torch.zeros(2, 8, 4 * 80, device=dev)
    with pytest.raises(ValueError):  # head dim 80
        XA.xattn_fastlayout(q, q, q, 4)
    q = torch.zeros(1, 8, 128, device=dev)
    kv = torch.zeros(1, 1000, 128, device=dev)
    with pytest.raises(ValueError):  # f32 k and v past shared memory
        XA.xattn_fastlayout(q, kv, kv, 1)


def test_pipeline_with_both_fused_paths_on_the_card_matches_the_cpu(
        dev, monkeypatch):
    """use_fast_xattn and MOE_FUSED_KERNEL=1 at widths that qualify (latent
    256, expert hidden 128): kernels on the card vs the plain versions on
    the CPU, same weights and injected noise; both new kernels launch."""
    from motiondiffusion_moe_tpu_torch.config import (
        DataConfig, DiffusionConfig, ExperimentConfig, ModelConfig)
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    monkeypatch.setenv("MOE_FUSED_KERNEL", "1")
    cfg = ExperimentConfig(
        data=DataConfig(dim_pose=26, max_motion_length=40, num_joints=4),
        diffusion=DiffusionConfig(num_timesteps=100),
        model=ModelConfig(input_feats=26, max_frames=40, latent_dim=256,
                          ff_size=128, num_layers=1, num_heads=4,
                          num_experts=4, text_latent_dim=32,
                          text_max_tokens=12, dtype="float32",
                          use_fast_xattn=True))
    model = init_weights(MotionTransformer(cfg.model), 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # the zero-init leaves, or the output is zero
        for name, p in model.named_parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=g)
    noise = torch.randn(2, 40, 26, generator=g)
    tok = cfg.model.text_max_tokens
    ids_c = torch.from_numpy(hash_tokenize(["walk", "jump twice"], tok))
    ids_u = torch.from_numpy(hash_tokenize(["", ""], tok))
    lengths = torch.tensor([40, 17])
    outs = {}
    for d in ("cpu", dev):
        pipe = GenerationPipeline(cfg, model, sampler="dpm",
                                  num_inference_steps=3, micro_batch=2,
                                  device=d)
        n_moe, n_xa = MOE.moe_dense_fused.launches, XA.xattn_fastlayout.launches
        outs[str(d)] = pipe.sample(ids_c, ids_u, lengths,
                                   noise=noise).cpu()
    # 4 forwards x (2 blocks x 2 branches) and x 2 blocks
    assert MOE.moe_dense_fused.launches - n_moe == 4 * 4
    assert XA.xattn_fastlayout.launches - n_xa == 4 * 2
    ref, out = outs["cpu"], outs[str(dev)]
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# ------------------------------------------------------- kernels 7 to 10

def _adaln_inputs(dev, B, T, D, Dout, dtype, seed=11):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, T, D)),
              0.3 * rng.standard_normal((B, D)),
              0.3 * rng.standard_normal((B, D)),
              1 + 0.1 * rng.standard_normal(D), 0.1 * rng.standard_normal(D),
              rng.standard_normal((D, Dout)) * D ** -0.5,
              0.1 * rng.standard_normal(Dout))
    ts = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]
    return [t if i in (3, 4) else t.to(dtype) for i, t in enumerate(ts)]


# B*T = 6272, 111, 100, 26, 99 and 305: tiles of 96 rows with a ragged last
# one; Dout = 128 and 320 take 64-column slices, the others 256
@pytest.mark.parametrize("shape", [(32, 196, 512, 512), (3, 37, 256, 256),
                                   (2, 50, 768, 768), (2, 13, 512, 128),
                                   (3, 33, 768, 512), (5, 61, 512, 320)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adaln_dense_kernel_matches_plain(dev, shape, dtype):
    B, T, D, Dout = shape
    args = _adaln_inputs(dev, B, T, D, Dout, dtype)
    n0 = AD.adaln_dense.launches
    out = AD.adaln_dense(*args)
    torch.cuda.synchronize()
    assert AD.adaln_dense.launches == n0 + 1
    ref = AD.adaln_dense_plain(*args)
    assert out.dtype == dtype and out.shape == (B, T, Dout)
    _assert_close(out, ref, dtype)
    assert torch.equal(AD.adaln_dense(*args), out)  # no atomics


def _normalised_heads(dev, B, H, T, D, seed):
    """q, k, v [B, H, T, D] as FastAttention hands them over: q and k rows
    of unit length."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, D)).astype(
        np.float32)).to(dev) for _ in range(3))
    q = q / q.norm(dim=-1, keepdim=True)
    k = k / k.norm(dim=-1, keepdim=True)
    return q, k, v


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape", [(4, 4, 196, 128, 128), (3, 2, 37, 64, 128),
                                   (2, 8, 98, 96, 128)])
def test_favor_attention_kernel_matches_plain(dev, shape, masked):
    B, H, T, D, m = shape
    _, _, _, proj, mask = _favor_inputs(dev, B, T, H, D, m, torch.float32)
    q, k, v = _normalised_heads(dev, B, H, T, D, seed=12)
    mask = mask[:, None, :].contiguous() if masked else None
    n0 = P.favor_attention.launches
    out = P.favor_attention(q, k, v, proj, mask)
    torch.cuda.synchronize()
    assert P.favor_attention.launches == n0 + 1
    ref = P.favor_attention_plain(q, k, v, proj, mask)
    assert out.dtype == torch.float32 and out.shape == q.shape
    if not masked:
        _assert_close_f32(out, ref)
        return
    # a masked frame's denominator is the eps floor, so its row is ~1e5
    # larger: each kind of row is held to its own scale
    valid = (mask[:, :, :, None] > 0).expand(B, H, T, D)
    _assert_close_f32(out[valid], ref[valid])
    _assert_close_f32(out[~valid], ref[~valid])


def _assert_close_f32(out, ref):
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("shape", [(3, 37, 2, 64, 128), (4, 196, 4, 128, 128),
                                   (2, 98, 8, 96, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_attention_full_kernel_matches_plain(dev, shape, dtype):
    """Three pointers into kernel 1's kernel: against the plain version, and
    bit for bit against kernel 1 on the same q, k, v merged into one
    panel."""
    B, T, H, D, m = shape
    qkv, scale, bias, proj, mask = _favor_inputs(dev, B, T, H, D, m, dtype,
                                                 seed=13)
    q, k, v = (x.contiguous() for x in qkv.split(H * D, dim=-1))
    n0 = P.favor_attention_full.launches
    out = P.favor_attention_full(q, k, v, scale, bias, proj, mask)
    torch.cuda.synchronize()
    assert P.favor_attention_full.launches == n0 + 1
    ref = P.favor_full_plain(q, k, v, scale, bias, proj, mask)
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert (err <= 2 ** -7 * ref.float().abs() + 1e-3).all()
    assert torch.equal(out, P.favor_qkv(qkv, scale, bias, proj, mask))


@pytest.mark.parametrize("shape", [(32, 4, 196, 85, 128, 128),
                                   (2, 4, 50, 1024, 128, 128),
                                   (3, 8, 37, 20, 96, 128),
                                   (2, 2, 33, 300, 64, 64),
                                   (1, 2, 7, 5, 128, 128),
                                   (4, 4, 196, 85, 256, 128),
                                   (2, 2, 33, 200, 256, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cross_attention_kernel_matches_plain(dev, shape, dtype):
    B, H, T, N, D, block_n = shape
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, dtype) for s in ((B, H, T, D), (B, H, N, D),
                                         (B, H, N, D)))
    n0 = XA.flash_cross_attention.launches
    out = XA.flash_cross_attention(q, k, v, block_n=block_n)
    torch.cuda.synchronize()
    assert XA.flash_cross_attention.launches == n0 + 1
    ref = XA.flash_cross_attention_plain(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        err = (out - ref).abs()
        assert err.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert_bf16_flips(out, ref)


def test_new_wrappers_never_run_their_plain_versions_on_the_card(
        dev, monkeypatch):
    """The plain versions made to raise: the four wrappers still give
    their results on CUDA tensors (they launch), and only on the CPU reach
    the plain version."""
    def boom(*a, **k):
        raise AssertionError("plain version called")

    for mod, name in ((AD, "adaln_dense_plain"),
                      (P, "favor_attention_plain"),
                      (P, "favor_full_plain"),
                      (XA, "flash_cross_attention_plain")):
        monkeypatch.setattr(mod, name, boom)
    args = _adaln_inputs(dev, 2, 9, 256, 256, torch.float32)
    AD.adaln_dense(*args)
    qkv, scale, bias, proj, mask = _favor_inputs(dev, 2, 9, 2, 64, 128,
                                                 torch.float32)
    q, k, v = (x.contiguous() for x in qkv.split(128, dim=-1))
    P.favor_attention_full(q, k, v, scale, bias, proj, mask)
    qh, kh, vh = _normalised_heads(dev, 2, 2, 9, 64, seed=15)
    P.favor_attention(qh, kh, vh, proj, mask[:, None, :].contiguous())
    XA.flash_cross_attention(qh, kh, vh)
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        AD.adaln_dense(*[a.cpu() for a in args])


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    args = _adaln_inputs(dev, 2, 9, 256, 256, torch.float32)
    with pytest.raises(ValueError):  # D not instantiated
        AD.adaln_dense(*_adaln_inputs(dev, 2, 9, 384, 384, torch.float32))
    with pytest.raises(ValueError):  # Dout not a multiple of 64
        AD.adaln_dense(*_adaln_inputs(dev, 2, 9, 256, 100, torch.float32))
    with pytest.raises(ValueError):  # mixed dtypes
        AD.adaln_dense(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError):  # ln vectors not f32
        AD.adaln_dense(*args[:3], args[3].double(), *args[4:])
    qkv, scale, bias, proj, mask = _favor_inputs(dev, 2, 9, 2, 64, 128,
                                                 torch.float32)
    q, k, v = (x.contiguous() for x in qkv.split(128, dim=-1))
    with pytest.raises(ValueError):  # mixed dtypes
        P.favor_attention_full(q, k.bfloat16(), v, scale, bias, proj, mask)
    with pytest.raises(ValueError):  # (D, m) not instantiated
        P.favor_attention_full(q, k, v, scale, bias,
                               proj[:, :64].contiguous(), mask)
    qh, kh, vh = _normalised_heads(dev, 2, 2, 9, 64, seed=16)
    with pytest.raises(ValueError):  # bf16: the core takes f32
        P.favor_attention(qh.bfloat16(), kh, vh, proj)
    with pytest.raises(ValueError):  # mask [B, T], not [B, 1, T]
        P.favor_attention(qh, kh, vh, proj, mask)
    with pytest.raises(ValueError):  # not contiguous
        P.favor_attention(qh.transpose(1, 2).contiguous().transpose(1, 2),
                          kh, vh, proj)
    x = torch.zeros(1, 2, 8, 80, device=dev)
    with pytest.raises(ValueError):  # head dim 80
        XA.flash_cross_attention(x, x, x)
    with pytest.raises(ValueError):  # k of another batch
        XA.flash_cross_attention(qh, kh[:1].contiguous(), vh[:1].contiguous())


def test_new_wrappers_differentiate_through_the_plain_versions(dev):
    """On the card the four wrappers' gradients are autograd of their plain
    versions on the same inputs."""
    def check(fn, plain, args, wanted):
        xs = [a.clone().requires_grad_(i in wanted) for i, a in
              enumerate(args)]
        ys = [a.clone().requires_grad_(i in wanted) for i, a in
              enumerate(args)]
        out = fn(*xs)
        g = torch.randn_like(out)
        (out * g).sum().backward()
        (plain(*ys) * g).sum().backward()
        for i in wanted:
            torch.testing.assert_close(xs[i].grad, ys[i].grad, rtol=1e-5,
                                       atol=1e-6)

    check(AD.adaln_dense, AD.adaln_dense_plain,
          _adaln_inputs(dev, 2, 30, 512, 512, torch.float32), range(7))
    qkv, scale, bias, proj, mask = _favor_inputs(dev, 2, 30, 4, 128, 128,
                                                 torch.float32, seed=17)
    q, k, v = (x.contiguous() for x in qkv.split(512, dim=-1))
    check(P.favor_attention_full, P.favor_full_plain,
          [q, k, v, scale, bias, proj, mask], range(5))
    qh, kh, vh = _normalised_heads(dev, 2, 4, 30, 128, seed=18)
    check(P.favor_attention, P.favor_attention_plain,
          [qh, kh, vh, proj, mask[:, None, :].contiguous()], range(3))
    kv = torch.randn(2, 4, 200, 128, device=dev)
    check(XA.flash_cross_attention, XA.flash_cross_attention_plain,
          [qh, kv, kv.flip(2).contiguous()], range(3))


def test_module_forms_on_the_card_match_the_cpu(dev):
    """A small denoiser (latent 256, head 64, 128 features) with every
    style block fused and every Performer unfused: on the card through
    kernels 2, 7 and 8 against the same on the CPU; exact launch counts."""
    from motiondiffusion_moe_tpu_torch.config import ModelConfig
    from motiondiffusion_moe_tpu_torch.models.bridge import (
        unfuse_performers)
    from motiondiffusion_moe_tpu_torch.models.embeddings import (
        StylizationBlock)
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    cfg = ModelConfig(input_feats=26, max_frames=40, latent_dim=256,
                      ff_size=64, num_layers=1, num_heads=4, num_experts=4,
                      text_latent_dim=32, text_max_tokens=12,
                      dtype="float32")
    model = init_weights(MotionTransformer(cfg), 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=g)
    unfuse_performers(model)
    for m in model.modules():
        if isinstance(m, StylizationBlock):
            m.fused = True
    model.eval()
    x = torch.randn(2, 40, 26, generator=g)
    t = torch.tensor([5, 90])
    length = torch.tensor([40, 17])
    ids = torch.randint(1, 100, (2, 12), generator=g)
    with torch.no_grad():
        ref = model(x, t, length, text_ids=ids)
        model.to(dev)
        counts = (AD.adaln_dense, P.favor_attention, P.performer_epilogue,
                  P.favor_qkv)
        n0 = [c.launches for c in counts]
        out = model(*(a.to(dev) for a in (x, t, length)),
                    text_ids=ids.to(dev)).cpu()
    made = [c.launches - n for c, n in zip(counts, n0)]
    # 2 blocks: 4 Performers, 4 non-Performer style blocks
    assert made == [4, 4, 4, 0]
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# ---------------------------------------------------------------- activations

@pytest.mark.parametrize("grad", [False, True], ids=["forward", "gradient"])
@pytest.mark.parametrize("op", ["silu", "gelu", "sigmoid"])
@pytest.mark.parametrize("shape,bias", [((6272, 2048), True),
                                        ((32, 196, 512), False),
                                        ((3, 37, 20), True), ((512,), False),
                                        ((1,), False)])
def test_activation_kernels_give_the_plain_bits(dev, op, shape, bias, grad):
    """Vector (8 values a thread) and scalar paths, with and without the
    Dense bias, at widths the flagship gives them: the forward pass and the
    gradient pass (dx for a cotangent, ``activation_grad``)."""
    rng = np.random.default_rng(30)
    x = torch.from_numpy((3 * rng.standard_normal(shape)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    b = (torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32))
         .to(dev, torch.bfloat16) if bias else None)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    if grad:
        counter = ACT.activation_grad
        run = lambda: ACT.activation_grad(op, x, g, b)  # noqa: E731
        plain = lambda: ACT.activation_grad_plain(op, x, g, b)  # noqa: E731
    else:
        counter = getattr(ACT, op)
        run = lambda: counter(x, b)  # noqa: E731
        plain = lambda: getattr(ACT, f"{op}_plain")(x, b)  # noqa: E731
    n0 = counter.launches
    out = run()
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    ref = plain()
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert_bf16_flips(out, ref, share=1e-3)


def test_activation_wrappers_raise_and_differentiate(dev):
    x = torch.randn(4, 64, device=dev).bfloat16()
    with pytest.raises(ValueError):  # not contiguous
        ACT.gelu(x.t())
    with pytest.raises(ValueError):  # bias of another width
        ACT.silu(x, torch.zeros(32, device=dev, dtype=torch.bfloat16))
    # f32 takes PyTorch's own function, no launch
    n0 = ACT.silu.launches
    torch.testing.assert_close(ACT.silu(x.float()),
                               torch.nn.functional.silu(x.float()))
    assert ACT.silu.launches == n0
    # the backward on the card (the gradient pass, then the f32 row sum
    # for the bias) and on the CPU (the plain steps): dx the same bits but
    # for the rare expf / tanhf flips (256 values: at most 1%, two),
    # d(bias) summed in another order
    b = torch.randn(64, device=dev).bfloat16()
    for op in ("silu", "gelu", "sigmoid"):
        xs = [a.clone().requires_grad_() for a in (x, b)]
        ys = [a.cpu().requires_grad_() for a in (x, b)]
        g = torch.randn_like(x)
        n0 = ACT.activation_grad.launches
        getattr(ACT, op)(*xs).backward(g)
        assert ACT.activation_grad.launches == n0 + 1
        getattr(ACT, op)(*ys).backward(g.cpu())
        assert_bf16_flips(xs[0].grad, ys[0].grad)
        assert_bf16_flips(xs[1].grad, ys[1].grad)


# ---- kernels 1 and 3 on the tensor cores, T split over a cluster ----------
# (b, h)'s T rows go in tiles of 16 to the P.FAVOR_CLUSTER CTAs of a cluster:
# T = 1 and 37 leave CTAs without a tile, 200 is no multiple of the tiles'
# share, B * H = 1 is a cluster alone on the card.
FAVOR_EDGE_SHAPES = [(1, 1, 1, 128, 128), (2, 37, 2, 64, 128),
                     (1, 98, 1, 96, 128), (2, 196, 4, 128, 128),
                     (2, 200, 2, 96, 128), (1, 200, 1, 64, 128)]


def _edge_id(shape):
    return "B{}-T{}-H{}-D{}".format(*shape[:4])


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("shape", FAVOR_EDGE_SHAPES, ids=_edge_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_qkv_kernel_takes_any_t_and_repeats_its_bits(dev, shape, dtype,
                                                           masked):
    B, T, H, D, m = shape
    qkv, scale, bias, proj, mask = _favor_inputs(dev, B, T, H, D, m, dtype,
                                                 seed=21)
    mask = mask if masked else None
    out = P.favor_qkv(qkv, scale, bias, proj, mask)
    torch.cuda.synchronize()
    ref = P.favor_qkv_plain(qkv, scale, bias, proj, mask)
    assert out.dtype == dtype and out.shape == (B, T, H * D)
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert (err <= 2 ** -7 * ref.float().abs() + 1e-3).all()
    # no atomics: the cluster's partial kv are added in rank order
    assert torch.equal(out, P.favor_qkv(qkv, scale, bias, proj, mask))


@pytest.mark.parametrize("need_dproj", [True, False],
                         ids=["dproj", "no_dproj"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("shape", FAVOR_EDGE_SHAPES, ids=_edge_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_qkv_bwd_kernel_takes_any_t_and_repeats_its_bits(
        dev, shape, dtype, masked, need_dproj):
    B, T, H, D, m = shape
    qkv, scale, bias, proj, mask = _favor_inputs(dev, B, T, H, D, m, dtype,
                                                 seed=22)
    mask = mask if masked else None
    g = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (B, T, H * D)).astype(np.float32)).to(dev, dtype)
    out = P.favor_qkv_bwd(qkv, scale, bias, proj, mask, g,
                          need_dproj=need_dproj)
    torch.cuda.synchronize()
    ref = P.favor_qkv_bwd_plain(qkv, scale, bias, proj, mask, g,
                                need_dproj=need_dproj)
    for o, r, dt in zip(out[:3], ref[:3], (dtype, torch.float32,
                                           torch.float32)):
        _assert_close(o, r, dt)
    if need_dproj and T > 1:
        _assert_close(out[3], ref[3], torch.float32)
    elif need_dproj:
        # one frame: the output is v's LayerNorm scaled, whatever q, k and
        # the projection, so d(proj) is zero up to rounding on both sides
        scale_g = ref[0].float().abs().max().item()
        assert out[3].abs().max().item() <= 1e-6 * scale_g
        assert ref[3].abs().max().item() <= 1e-6 * scale_g
    again = P.favor_qkv_bwd(qkv, scale, bias, proj, mask, g,
                            need_dproj=need_dproj)
    for a, o in zip(again, out):
        assert (a is None and o is None) or torch.equal(a, o)


def _logits_near_the_clip(dev, B, T, H, D, m, dtype):
    """favor_qkv inputs whose projection puts logits within ~1e-6 of +15 and
    -15: columns 0-7 are +-15 (1 + d) times the normalised q of rows 0-7 of
    batch row 0, head 0, columns 8-15 the same of k (d from -4e-7 to
    +3e-7)."""
    qkv, scale, bias, proj, mask = _favor_inputs(dev, B, T, H, D, m,
                                                 torch.float32, seed=24)
    x = qkv.reshape(B, T, 3, H, D)
    rows = P._l2(P._ln(x * 0.1, scale, bias))  # [B, T, 3, H, D]
    proj = proj.clone()
    for c in range(16):
        part, t = divmod(c, 8)
        sign = 1.0 if c % 2 == 0 else -1.0
        proj[:, c] = sign * 15.0 * (1 + (t - 4) * 1e-7) * rows[0, t, part, 0]
    return qkv.to(dtype), scale, bias, proj.contiguous(), mask


@pytest.mark.parametrize("bf16_products", [False, True],
                         ids=["3xtf32", "mxu_bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_bwd_clip_masks_are_the_forwards(dev, dtype, bf16_products):
    """The backward's feature logits, and so its clip pass-through masks,
    are the forward's bit for bit, at logits built to sit at +-15."""
    B, T, H, D, m = 2, 37, 2, 128, 128
    qkv, scale, bias, proj, mask = _logits_near_the_clip(dev, B, T, H, D, m,
                                                         dtype)
    fwd = P.favor_qkv_feature_logits(qkv, scale, bias, proj, mask,
                                     source="forward",
                                     bf16_products=bf16_products)
    bwd = P.favor_qkv_feature_logits(qkv, scale, bias, proj, mask,
                                     source="backward",
                                     bf16_products=bf16_products)
    torch.cuda.synchronize()
    for f, b in zip(fwd, bwd):
        assert torch.equal(f, b)
        assert torch.equal(f.abs() <= 15, b.abs() <= 15)
    ql, kl = fwd
    if not bf16_products:  # the built logits do sit at the clip
        near = ((ql[0, :8, 0, :8].diagonal().abs() - 15).abs().max(),
                (kl[0, :8, 0, 8:16].diagonal().abs() - 15).abs().max())
        assert max(n.item() for n in near) < 1e-4
    plain = P.favor_qkv_logits_plain(qkv, scale, bias, proj)
    for f, p in zip(fwd, plain):
        # bf16 operands: each rounded by up to 2^-9 -> 2^-8 of |logit| <= 15
        assert (f - p).abs().max().item() <= 1e-4 * p.abs().max().item() + (
            15 * 2 ** -8 if bf16_products else 0.0)


@pytest.mark.parametrize("shape", [(2, 37, 2, 64, 128), (4, 196, 4, 128, 128),
                                   (2, 200, 2, 96, 128)], ids=_edge_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_mxu_bf16_kernels_match_plain_with_bf16_operands(
        dev, shape, dtype, monkeypatch):
    """FAVOR_MXU_BF16=1: one bf16 mma per product, against the plain
    versions with bf16 operands. The two sides round the same f32 values,
    computed in another order, to bf16, so an operand may land one bf16 ulp
    (2^-8) apart: held at bf16 resolution, 2^-8 of the output's largest
    value (and one ulp more for bf16 outputs). The backward follows the
    forward's setting, not the environment at backward time."""
    B, T, H, D, m = shape
    qkv, scale, bias, proj, mask = _favor_inputs(dev, B, T, H, D, m, dtype,
                                                 seed=25)
    g = torch.from_numpy(np.random.default_rng(26).standard_normal(
        (B, T, H * D)).astype(np.float32)).to(dev, dtype)
    monkeypatch.setenv("FAVOR_MXU_BF16", "1")
    x = qkv.clone().requires_grad_()
    out = P.favor_qkv(x, scale, bias, proj, mask)
    ref = P.favor_qkv_plain(qkv, scale, bias, proj, mask,
                            product=P.bf16_operand_product)
    _assert_close(out, ref, dtype, 2 ** -8)
    f32 = P.favor_qkv_plain(qkv, scale, bias, proj, mask)
    assert not torch.equal(out.float(), f32.float())  # the switch took
    monkeypatch.setenv("FAVOR_MXU_BF16", "0")
    (dx,) = torch.autograd.grad(out, x, g)
    ref_b = P.favor_qkv_bwd_plain(qkv, scale, bias, proj, mask, g,
                                  product=P.bf16_operand_product)
    _assert_close(dx, ref_b[0], dtype, 2 ** -8)
    outs = P.favor_qkv_bwd(qkv, scale, bias, proj, mask, g,
                           bf16_products=True)
    for o, r, dt in zip(outs, ref_b, (dtype, torch.float32, torch.float32,
                                      torch.float32)):
        _assert_close(o, r, dt, 2 ** -8)



# ---------------------------------------------------------------------------
# tools/train.py --model_size big widths (latent 1024, head dim 256, expert
# hidden 512): the kernel instances added for them
# ---------------------------------------------------------------------------

BIG_CLI = ["--dataset", "synthetic", "--model_size", "big", "--num_layers",
           "1", "--batch_size", "2", "--synthetic_size", "2",
           "--log_every", "1"]


def test_big_widths_forward_on_the_card(dev, monkeypatch):
    """One forward in f32 compute at ``--model_size big`` widths (one block
    per scale) through the kernels on the card, with ``MOE_FUSED_KERNEL=1``,
    against the CPU (the plain versions: 1e-4 of the output's largest
    value); the favor, epilogue and MoE kernels each launch once per
    module. The same in bf16 compute: finite."""
    import dataclasses

    from motiondiffusion_moe_tpu_torch.models.attention import (
        PerformerSelfAttention)
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.tools.train import (
        build_argparser, config_from_args)

    monkeypatch.setenv("MOE_FUSED_KERNEL", "1")
    cfg = config_from_args(build_argparser().parse_args(BIG_CLI)).model
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = init_weights(MotionTransformer(cfg), 0).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=g)
    T = cfg.max_frames
    x = torch.randn(2, T, cfg.input_feats, generator=g)
    t, length = torch.tensor([10, 900]), torch.tensor([T, 77])
    ids = torch.from_numpy(hash_tokenize(["walk", "jump"],
                                         cfg.text_max_tokens))
    with torch.no_grad():
        ref = model(x, t, length, text_ids=ids)
    counted = (P.favor_qkv, P.performer_epilogue, MOE.moe_dense_fused)
    n0 = [c.launches for c in counted]
    model.to(dev)
    with torch.no_grad():
        out = model(x.to(dev), t.to(dev), length.to(dev),
                    text_ids=ids.to(dev)).cpu()
    n_perf = sum(isinstance(m, PerformerSelfAttention)
                 for m in model.modules())
    n_moe = sum(isinstance(m, SwitchMoELayer) for m in model.modules())
    assert [c.launches - n for c, n in zip(counted, n0)] == [
        n_perf, n_perf, n_moe]
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    bf = MotionTransformer(dataclasses.replace(cfg, dtype="bfloat16"))
    bf.load_state_dict(model.state_dict())
    with torch.no_grad():
        out = bf.to(dev).eval()(x.to(dev), t.to(dev), length.to(dev),
                                text_ids=ids.to(dev))
    assert torch.isfinite(out).all()


def test_big_widths_train_on_the_card(dev, tmp_path):
    """tools/train.py at ``--model_size big`` widths on the card: one batch
    = two optimizer steps (cond, uncond) through kernel 1 and its backward,
    finite parameters."""
    from motiondiffusion_moe_tpu_torch.tools import train as train_cli

    n0 = (P.favor_qkv.launches, P.favor_qkv_bwd.launches)
    state = train_cli.main(BIG_CLI + ["--device", "cuda", "--num_epochs",
                                      "1", "--checkpoint_dir",
                                      str(tmp_path)])
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert P.favor_qkv.launches > n0[0] and P.favor_qkv_bwd.launches > n0[1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_big_width_kernels_match_plain(dev, dtype):
    """Kernels 1-5 and 7 at ``--model_size big`` widths (head dim 256,
    latent 1024, 4 experts of hidden 512) against their plain versions:
    f32 to 1e-4 of the largest value (1e-3 for the backward kernels' sums
    over T), bf16 to one rounding plus 1e-3 of the largest value."""
    rng = np.random.default_rng(7)
    B, T, H, hd, m, D, E, hid = 2, 64, 4, 256, 128, 1024, 4, 512

    def r(*shape, s=1.0, off=0.0):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    def close(out, ref, rel=1e-4):
        err, top = (out.float() - ref.float()).abs(), ref.abs().max().item()
        if out.dtype == torch.float32:
            assert err.max().item() <= rel * top
        else:
            assert bool((err <= 2 ** -7 * ref.float().abs()
                         + 1e-3 * top).all())

    mask = (torch.arange(T, device=dev)[None] < torch.tensor(
        [T, 41], device=dev)[:, None]).float()
    ln_s, ln_b, proj = r(hd, s=0.1, off=1.0), r(hd, s=0.1), r(
        hd, m, s=hd ** -0.25)
    qkv, g = r(B, T, 3 * H * hd).to(dtype), r(B, T, H * hd).to(dtype)
    close(P.favor_qkv(qkv, ln_s, ln_b, proj, mask),
          P.favor_qkv_plain(qkv, ln_s, ln_b, proj, mask))
    for o, ref in zip(P.favor_qkv_bwd(qkv, ln_s, ln_b, proj, mask, g),
                      P.favor_qkv_bwd_plain(qkv, ln_s, ln_b, proj, mask, g)):
        close(o, ref, 1e-3)
    y = r(B, T, D).to(dtype)
    sc, sh = r(B, D, s=0.3).to(dtype), r(B, D, s=0.3).to(dtype)
    vecs = [r(D, s=0.1, off=1.0), r(D, s=0.1), r(D, s=0.1, off=1.0),
            r(D, s=0.1)]
    close(P.performer_epilogue(y, sc, sh, *vecs),
          P.performer_epilogue_plain(y, sc, sh, *vecs))
    for o, ref in zip(P.performer_epilogue_bwd(y, sc, sh, *vecs, g),
                      P.performer_epilogue_bwd_plain(y, sc, sh, *vecs, g)):
        close(o, ref, 1e-3)
    S = B * T
    p = rng.random((S, E)).astype(np.float32)  # top-2 routing weights
    p[np.arange(S)[:, None], np.argsort(p, -1)[:, :E - 2]] = 0.0
    args = [r(S, D), torch.from_numpy(p).to(dev), r(E, D, hid, s=D ** -0.5),
            r(E, hid, s=0.1), r(E, hid, D, s=hid ** -0.5), r(E, D, s=0.1)]
    args = [a.to(dtype) for a in args]
    close(MOE.moe_dense_fused(*args), MOE.moe_dense_fused_plain(*args))
    args = [y, sc, sh, vecs[0], vecs[1], r(D, D, s=D ** -0.5).to(dtype),
            r(D, s=0.1).to(dtype)]
    close(AD.adaln_dense(*args), AD.adaln_dense_plain(*args))


# ---------------------------------------------------------------------------
# the motion codec on the card: raw joints -> features
# ---------------------------------------------------------------------------

def test_process_file_on_the_card_matches_the_cpu(dev):
    """``process_file`` of a seeded t2m clip on the card against the same
    on the CPU: features within 1e-4 (f32 IK chains, another order of sums
    and other sqrt / trig roundings), foot contacts equal. The clip stands,
    walks at 1.4 m/s (20 fps), then stands again: a foot either stays still
    or moves about as fast as the root, so its squared speed stays away
    from the contact threshold (checked)."""
    from motiondiffusion_moe_tpu_torch.motion.process import (
        ProcessConfig, build_target_offsets, process_file)
    from motiondiffusion_moe_tpu_torch.motion.skeleton import Skeleton

    cfg = ProcessConfig.t2m()
    rng = np.random.default_rng(3)
    rest = np.zeros((22, 3), np.float32)
    for chain in cfg.kinematic_chain:  # shoulders wider than hips
        for a, b in zip(chain[:-1], chain[1:]):
            wide = a != 0 and cfg.raw_offsets[b][0] != 0
            rest[b] = rest[a] + (0.5 if wide else 0.3) * cfg.raw_offsets[b]
    skel = Skeleton(cfg.raw_offsets, cfg.kinematic_chain)
    skel.get_offsets_joints(torch.from_numpy(rest))
    T = 120
    walking = (np.arange(T) >= 30) & (np.arange(T) < 90)
    angles = (np.cumsum(rng.standard_normal((T, 22, 3)) * 0.005
                        * walking[:, None, None], axis=0)
              + 0.1 * rng.standard_normal((22, 3)))
    theta = np.linalg.norm(angles, axis=-1, keepdims=True)
    quat = np.concatenate([np.cos(theta / 2),
                           0.5 * np.sinc(theta / (2 * np.pi)) * angles],
                          axis=-1).astype(np.float32)
    x = np.cumsum(0.07 * walking)
    root = np.stack([x, np.full(T, 0.9), 0.5 * x], -1).astype(np.float32)
    joints = skel.forward_kinematics(torch.from_numpy(quat),
                                     torch.from_numpy(root)).numpy()
    tgt = build_target_offsets(joints, cfg)
    ref = process_file(joints, cfg, tgt, device="cpu")
    out = process_file(joints, cfg, tgt, device=dev)
    feet = list(cfg.fid_l) + list(cfg.fid_r)
    speed_sq = (np.diff(ref[1][:, feet], axis=0) ** 2).sum(-1)
    assert np.abs(speed_sq / cfg.feet_thre - 1).min() > 1e-3
    assert 0 < ref[0][:, -4:].mean() < 1
    assert out[0].shape == ref[0].shape == (T - 1, 263)
    np.testing.assert_array_equal(out[0][:, -4:], ref[0][:, -4:])
    for o, r in zip(out, ref):
        assert np.isfinite(o).all()
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=0)


def test_evaluator_on_the_card_matches_the_cpu(dev):
    """The evaluator networks (the released widths: conv encoder, GRU hidden
    512 and 1024) on the card in f32 (cuDNN, TF32 off) against the same
    weights on the CPU: text and motion co-embeddings of a ragged pool in
    input order within 1e-4 of their largest value."""
    from motiondiffusion_moe_tpu_torch.eval.evaluator_models import (
        EvaluatorModelWrapper)

    cpu = EvaluatorModelWrapper(dim_pose=263, device="cpu", seed=5)
    card = EvaluatorModelWrapper(
        dim_pose=263, device=dev,
        state_dicts={k: m.state_dict() for k, m in cpu.encoders().items()})
    rng = np.random.default_rng(0)
    B = 12
    motions = rng.standard_normal((B, 196, 263)).astype(np.float32)
    m_lens = rng.integers(40, 197, size=B)
    m_lens[3] = 196
    words = rng.standard_normal((B, 22, 300)).astype(np.float32)
    pos = rng.standard_normal((B, 22, 15)).astype(np.float32)
    cap_lens = rng.integers(3, 23, size=B)
    ref = cpu.get_co_embeddings(words, pos, cap_lens, motions, m_lens)
    out = card.get_co_embeddings(words, pos, cap_lens, motions, m_lens)
    assert card.motion_enc.gru.weight_ih_l0.is_cuda
    for o, r in zip(out, ref):
        assert o.shape == (B, 512) and np.isfinite(o).all()
        np.testing.assert_allclose(o, r, atol=1e-4 * np.abs(r).max())


def test_generate_motion_embeddings_on_the_card(dev):
    """The fused sample-and-embed path on the card (the small_dense
    attention shape, kernels 1 and 2): equal to generate() then embedding
    the padded motions, within 1e-5 of the largest value (the same motions,
    embedded in other batch groupings by cuDNN); only [n, 512] rows come
    back."""
    from motiondiffusion_moe_tpu_torch.config import (
        DataConfig, DiffusionConfig, ExperimentConfig, ModelConfig)
    from motiondiffusion_moe_tpu_torch.eval.evaluator_models import (
        EvaluatorModelWrapper)
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    cfg = ExperimentConfig(
        data=DataConfig(dim_pose=26, max_motion_length=40, num_joints=4),
        diffusion=DiffusionConfig(num_timesteps=100),
        model=ModelConfig(input_feats=26, max_frames=40, latent_dim=256,
                          ff_size=64, num_layers=1, num_heads=4,
                          num_experts=4, text_latent_dim=32,
                          text_max_tokens=12, dtype="float32"))
    model = init_weights(MotionTransformer(cfg.model), 0)
    pipe = GenerationPipeline(cfg, model, sampler="dpm",
                              num_inference_steps=3, micro_batch=2,
                              device=dev)
    wrapper = EvaluatorModelWrapper(dim_pose=26, device=dev, seed=2)
    captions = ["walk", "jump twice", "turn", "", "wave"]
    lens = [40, 8, 17, 33, 4]
    n0 = P.favor_qkv.launches
    embs = pipe.generate_motion_embeddings(
        captions, lens, wrapper, generator=torch.Generator(dev).manual_seed(3))
    assert P.favor_qkv.launches - n0 == 3 * 4 * 4  # 3 micro-batches
    motions = pipe.generate(captions, lens,
                            generator=torch.Generator(dev).manual_seed(3))
    padded = np.zeros((5, 40, 26), np.float32)
    for i, m in enumerate(motions):
        padded[i, :len(m)] = m
    ref = wrapper.get_motion_embeddings(padded, np.array(lens))
    assert embs.shape == (5, 512) and np.isfinite(embs).all()
    np.testing.assert_allclose(embs, ref, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError):
        pipe.generate_motion_embeddings(["a"], [41], wrapper)
    cpu_wrapper = EvaluatorModelWrapper(dim_pose=26, device="cpu")
    with pytest.raises(ValueError, match="evaluator is on"):
        pipe.generate_motion_embeddings(["a"], [8], cpu_wrapper)


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("stored", [torch.float32, torch.bfloat16])
def test_deberta_on_the_card_matches_the_cpu(dev, share, stored):
    """The DeBERTa text encoder (no kernel of its own) at tiny width, with
    ragged ids and an empty prompt, on the card against the CPU."""
    import dataclasses

    from motiondiffusion_moe_tpu_torch.models import deberta as TD
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.pipeline import cast_params_

    cfg = dataclasses.replace(TD.DebertaConfig.tiny(), share_att_key=share)
    mod = init_weights(TD.DebertaTextEncoder(16, cfg), 0).eval()
    cast_params_(mod, stored)
    ids = torch.from_numpy(TD.get_deberta_tokenizer(77, cfg.vocab_size)(
        ["a person walks forward", "", "jump twice then sit down"]))
    with torch.no_grad():
        ref = mod(ids)
        card = mod.to(dev)(ids.to(dev))
    for out, want in ((card.pooled, ref.pooled), (card.tokens, ref.tokens)):
        assert out.is_cuda and out.dtype == torch.float32
        err = (out.cpu() - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item()


def test_deberta_pipeline_on_the_card_matches_the_cpu(dev):
    """test_pipeline_on_the_card_matches_the_cpu with the DeBERTa text
    encoder (deberta-tiny) in front of the denoiser."""
    from motiondiffusion_moe_tpu_torch.config import (
        DataConfig, DiffusionConfig, ExperimentConfig, ModelConfig)
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    cfg = ExperimentConfig(
        data=DataConfig(dim_pose=26, max_motion_length=40, num_joints=4),
        diffusion=DiffusionConfig(num_timesteps=100),
        model=ModelConfig(input_feats=26, max_frames=40, latent_dim=256,
                          ff_size=64, num_layers=1, num_heads=4,
                          num_experts=4, text_latent_dim=32,
                          text_max_tokens=12, dtype="float32",
                          text_encoder="deberta-tiny"))
    model = init_weights(MotionTransformer(cfg.model), 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # the zero-init leaves, or the output is zero
        for name, p in model.named_parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=g)
    noise = torch.randn(2, 40, 26, generator=g)
    lengths = torch.tensor([40, 17])
    outs = {}
    for d in ("cpu", dev):
        pipe = GenerationPipeline(cfg, model, sampler="dpm",
                                  num_inference_steps=3, micro_batch=2,
                                  device=d)
        ids_c = torch.from_numpy(pipe.tokenize(["walk", "jump twice"]))
        ids_u = torch.from_numpy(pipe.tokenize(["", ""]))
        n0 = P.favor_qkv.launches
        outs[str(d)] = pipe.sample(ids_c, ids_u, lengths,
                                   noise=noise).cpu()
    assert P.favor_qkv.launches - n0 == 4 * 4  # 4 Performers x 4 forwards
    ref, out = outs["cpu"], outs[str(dev)]
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
