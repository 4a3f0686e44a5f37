"""Card-only tests: each hand-written CUDA kernel against its plain version,
and a small sampling pipeline on the card against the same on the CPU.

Marked ``cuda``; without a CUDA device they skip. On a machine with an H100
and nvcc run them with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks; this file imports only torch and numpy.)

Tolerances: f32 kernels do the same IEEE f32 math as the plain version in
another summation order -> 1e-4 relative to the output's scale. bf16
outputs are the same f32 result rounded once to bf16 -> one bf16 ulp
(2**-7 relative) plus a small absolute floor. The pipeline: f32 compute
through 3 DPM-Solver++ steps -> 1e-4 of the sample's largest value (the
eps -> x0 factor reaches ~1e2 at t = T-1).
"""

import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu_torch.ops import performer as P

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


@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_kernel_matches_plain(dev, D, dtype):
    rng = np.random.default_rng(2)
    B, T = 5, 37

    def t(*shape, s=1.0, off=0.0):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    y = t(B, T, D).to(dtype)
    scale, shift = t(B, D, s=0.3).to(dtype), t(B, D, s=0.3).to(dtype)
    vecs = [t(D, s=0.1, off=1.0), t(D, s=0.1), t(D, s=0.1, off=1.0),
            t(D, s=0.1)]
    n0 = P.performer_epilogue.launches
    out = P.performer_epilogue(y, scale, shift, *vecs)
    torch.cuda.synchronize()
    assert P.performer_epilogue.launches == n0 + 1
    ref = P.performer_epilogue_plain(y, scale, shift, *vecs)
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert (err <= 2 ** -7 * ref.float().abs() + 1e-3).all()


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
    from motiondiffusion_moe_tpu.config import (DataConfig, DiffusionConfig,
                                                ExperimentConfig, ModelConfig)
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
