"""The widths the port's CUDA kernel library holds instances of.

The library is instantiated for the presets' widths and for
``tools/train.py --model_size big`` (latent 1024, head dim 256, expert
hidden 512). One predicate per kernel (``favor_kernel_ok``,
``epilogue_kernel_ok``, ``adaln_kernel_ok``, ``moe_kernel_ok``,
``xattn_kernel_ok``) says which, and the wrappers' checks use it: on a CUDA
tensor outside the set a wrapper raises, and no module chooses the plain
version instead. This is logic: no card is needed. The card's side (the
kernels against their plain versions, a forward and a train step at
``--model_size big`` widths) is in tests/test_torch_cuda.py and
chip_smoke.py phase G2.
"""

import dataclasses

import pytest
import torch

from motiondiffusion_moe_tpu_torch.config import ExperimentConfig, ModelConfig
from motiondiffusion_moe_tpu_torch.models.attention import (
    CrossAttentionBlock,
    FastAttention,
    PerformerSelfAttention,
)
from motiondiffusion_moe_tpu_torch.models.embeddings import StylizationBlock
from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.ops import adaln as AD
from motiondiffusion_moe_tpu_torch.ops import flash_attention as FA
from motiondiffusion_moe_tpu_torch.ops import moe as MO
from motiondiffusion_moe_tpu_torch.ops import performer as P
from motiondiffusion_moe_tpu_torch.tools.train import (
    build_argparser,
    config_from_args,
)

PRESETS = ["moe_small", "moe_big", "small_dense"]


def _meta_model(cfg: ModelConfig, **kw) -> MotionTransformer:
    with torch.device("meta"):
        return MotionTransformer(cfg, **kw)


def _big_config() -> ModelConfig:
    """``tools/train.py --model_size big``: latent 1024, head dim 256."""
    args = build_argparser().parse_args(["--dataset", "synthetic",
                                         "--model_size", "big"])
    return config_from_args(args).model


def _instances(model: MotionTransformer) -> dict:
    """Kernel -> whether the library holds an instance for the widths each
    module of this kind in ``model`` gives it (False if any lacks one)."""
    found: dict = {}

    def note(kind, ok):
        found[kind] = found.get(kind, True) and ok

    for m in model.modules():
        if isinstance(m, PerformerSelfAttention):
            note("favor_qkv", P.favor_kernel_ok(m.head_dim,
                                                m.fa_projection.shape[1])
                 if m.fused else True)
        elif isinstance(m, FastAttention):
            note("favor_attention", P.favor_kernel_ok(*m.projection.shape))
        elif isinstance(m, StylizationBlock):
            D = m.norm_scale.shape[0]
            note("performer_epilogue", P.epilogue_kernel_ok(D))
            note("adaln_dense", AD.adaln_kernel_ok(D, D))
        elif isinstance(m, SwitchMoELayer):
            E, D, hid = m.w1.shape
            note("moe_dense_fused", MO.moe_kernel_ok(D, hid, E))
        elif isinstance(m, CrossAttentionBlock):
            note("xattn_fastlayout", FA.xattn_kernel_ok(
                m.query.weight.shape[0] // m.num_heads))
    return found


def test_favor_predicate_is_its_shape_set():
    for D in (32, 64, 96, 128, 256, 512):
        for m in (32, 64, 128, 256):
            assert P.favor_kernel_ok(D, m) == ((D, m) in P.FAVOR_SHAPES)
    assert P.favor_kernel_ok(128, 128) and P.favor_kernel_ok(256, 128)
    assert not P.favor_kernel_ok(256, 64)


@pytest.mark.parametrize("D", [64, 128, 256, 384, 512, 640, 768, 1024])
def test_width_predicates_are_their_sets(D):
    assert P.epilogue_kernel_ok(D) == (D in P.EPILOGUE_DIMS)
    assert AD.adaln_kernel_ok(D, D) == (D in AD.ADALN_DIMS)
    assert not AD.adaln_kernel_ok(D, 96) and not AD.adaln_kernel_ok(D, 0)
    for hid in (64, 128, 256, 1024):
        assert MO.moe_kernel_ok(D, hid, 4) == (D in MO.MOE_DIMS
                                                and hid % 128 == 0)
    assert not MO.moe_kernel_ok(D, 256, MO.MOE_MAX_EXPERTS + 1)
    assert FA.xattn_kernel_ok(D // 8) == (D // 8 in FA.XATTN_HEAD_DIMS)


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_take_every_kernel(preset):
    """Every module of a preset, and with the attributes and the switch no
    preset sets (every style block fused, ``use_fast_xattn``), has its
    kernel instance."""
    cfg = getattr(ExperimentConfig, preset)().model
    found = _instances(_meta_model(dataclasses.replace(
        cfg, use_fast_xattn=True)))
    assert {"favor_qkv", "performer_epilogue", "adaln_dense",
            "xattn_fastlayout"} <= found.keys()
    assert ("moe_dense_fused" in found) == cfg.use_moe
    assert all(found.values()), found


@pytest.mark.parametrize("kind", ["favor_qkv", "performer_epilogue",
                                  "adaln_dense", "moe_dense_fused",
                                  "xattn_fastlayout"])
def test_big_widths_have_every_instance(kind):
    """``--model_size big`` (head dim 256, latent 1024, expert hidden 512):
    kernels 1-5 and 7 have instances, and so do kernels 6 and 9 at head dim
    256 (``use_fast_xattn``, which the CLI does not set)."""
    cfg = _big_config()
    assert (cfg.latent_dim, cfg.latent_dim // cfg.num_heads,
            cfg.ff_size) == (1024, 256, 512)
    found = _instances(_meta_model(cfg))
    assert found[kind]
    assert FA.xattn_kernel_ok(cfg.latent_dim // cfg.num_heads)


def test_construction_prints_nothing(capsys):
    """Building a model says nothing about kernels, at any width: there is
    no route to choose."""
    _meta_model(ExperimentConfig.moe_small().model)
    _meta_model(_big_config())
    _meta_model(_big_config(), use_kernels=False)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("latent", [64, 128])
def test_modules_call_the_wrappers_at_any_width(latent, monkeypatch):
    """The Performer, the epilogue and (with ``MOE_FUSED_KERNEL``, at
    widths that are multiples of 128, the JAX condition) the MoE layer call
    the kernels' wrappers, though the library holds no instance of these
    small widths: on a CPU tensor the wrapper computes the plain version, on
    a CUDA tensor it launches or raises."""
    from motiondiffusion_moe_tpu_torch.models import attention as ATT
    from motiondiffusion_moe_tpu_torch.models import embeddings as EMB
    from motiondiffusion_moe_tpu_torch.models import moe as MOE_MOD
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights

    calls = {"favor_qkv": 0, "performer_epilogue": 0, "moe_dense_fused": 0}
    for mod, name in ((ATT, "favor_qkv"), (EMB, "performer_epilogue"),
                      (MOE_MOD, "moe_dense_fused")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setenv("MOE_FUSED_KERNEL", "1")
    cfg = ModelConfig(input_feats=12, max_frames=8, latent_dim=latent,
                      ff_size=128, num_layers=1, num_heads=2, num_experts=2,
                      text_latent_dim=16, num_random_features=16,
                      text_max_tokens=6, dropout=0.0)
    model = init_weights(MotionTransformer(cfg), 0).eval()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 12, generator=g)
    ids = torch.randint(1, 100, (2, 6), generator=g)
    with torch.no_grad():
        out = model(x, torch.tensor([3, 90]), torch.tensor([8, 5]),
                    text_ids=ids)
    assert torch.isfinite(out).all()
    n_perf = sum(isinstance(m, PerformerSelfAttention)
                 for m in model.modules())
    n_moe = sum(isinstance(m, SwitchMoELayer) for m in model.modules())
    want_moe = n_moe if latent % 128 == 0 else 0  # the JAX condition
    assert calls == {"favor_qkv": n_perf, "performer_epilogue": n_perf,
                     "moe_dense_fused": want_moe}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("D,m,ok", [(512, 128, False), (128, 64, False),
                                     (128, 128, True), (256, 128, True)])
def test_favor_wrapper_checks_raise_outside_the_set(D, m, ok):
    """The kernels' own checks keep raising at a shape without an instance
    (meta tensors reach the check; an in-set shape gets past the width to
    the device check)."""
    qkv, vec, proj = _meta(2, 8, 3 * 2 * D), _meta(D), _meta(D, m)
    match = "unsupported device" if ok else r"\(D, m\)"
    with pytest.raises(ValueError, match=match):
        P._check_favor("favor_qkv", qkv, vec, vec, proj, None)
    with pytest.raises(ValueError, match=match):
        P._launch_favor_attention(_meta(2, 2, 8, D), _meta(2, 2, 8, D),
                                  _meta(2, 2, 8, D), proj, None, 1e-6)


@pytest.mark.parametrize("D,ok", [(1280, False), (1024, True), (512, True)])
def test_epilogue_and_adaln_checks_raise_outside_the_set(D, ok):
    y, sc, v = _meta(2, 8, D), _meta(2, D), _meta(D)
    match = "unsupported device" if ok else f"D={D}"
    with pytest.raises(ValueError, match=match):
        P._check_epilogue("performer_epilogue", y, sc, sc, (v, v, v, v))
    with pytest.raises(ValueError, match=match):
        P._launch_performer_epilogue(y, sc, sc, v, v, v, v)
    with pytest.raises(ValueError, match=match):
        AD._launch(y, sc, sc, v, v, _meta(D, D), v)


@pytest.mark.parametrize("D,hid,ok", [(1152, 512, False), (512, 96, False),
                                      (512, 256, True), (1024, 512, True)])
def test_moe_check_raises_outside_the_set(D, hid, ok):
    match = "unsupported device" if ok else f"D={D}"
    with pytest.raises(ValueError, match=match):
        MO._check(_meta(6, D), _meta(6, 4), _meta(4, D, hid), _meta(4, hid),
                  _meta(4, hid, D), _meta(4, D))


@pytest.mark.parametrize("head_dim,ok", [(512, False), (80, False),
                                         (256, True), (128, True)])
def test_xattn_checks_raise_outside_the_set(head_dim, ok):
    H = 4
    q, k = _meta(2, 8, H * head_dim), _meta(2, 5, H * head_dim)
    match = "unsupported device" if ok else "head dim"
    with pytest.raises(ValueError, match=match):
        FA._check(q, k, k, H)
    with pytest.raises(ValueError, match=match):
        FA._launch_flash(_meta(2, H, 8, head_dim), _meta(2, H, 5, head_dim),
                         _meta(2, H, 5, head_dim), 0.1, 64)
