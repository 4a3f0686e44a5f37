"""The flax -> torch weight bridge (motiondiffusion_moe_tpu_torch.models.bridge).

Each mapping rule is pinned by running the flax module and the port module
on the same numpy input with the bridged weights. Tolerance: f32 on the CPU,
same math in another summation order -> 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
    stack_block_params,
)
from motiondiffusion_moe_tpu_torch.models.bridge import (
    convert_leaf,
    jax_to_state_dict,
    unstack_block_params,
)
from motiondiffusion_moe_tpu_torch.models.layers import Dense, LayerNorm
from motiondiffusion_moe_tpu_torch.models.text_encoder import (
    MultiHeadDotProductAttention,
)
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer

from tests._torch_parity import (
    load_into,
    perturb_zero_leaves,
    random_params,
    t,
    tiny_model_config,
    to_port,
)

ATOL = 1e-5


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_dense_kernel_is_transposed():
    x = _x(3, 5, 8)
    mod = nn.Dense(6)
    v = mod.init(jax.random.key(0), x)
    params = perturb_zero_leaves(v["params"])
    ref = np.asarray(mod.apply({"params": params}, x))
    key, w = convert_leaf(("kernel",), params["kernel"])
    assert key == "weight" and w.shape == (6, 8)
    out = load_into(Dense(8, 6), params)(t(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)


def test_merged_qkv_rows_stay_q_k_v():
    D = 8
    kernel = _x(D, 3 * D)
    _, w = convert_leaf(("local_attn", "qkv", "kernel"), kernel)
    for i in range(3):  # weight rows [iD, (i+1)D) = kernel columns of block i
        np.testing.assert_array_equal(w[i * D:(i + 1) * D],
                                      kernel[:, i * D:(i + 1) * D].T)


def test_layernorm_scale_becomes_weight_eps_1e6():
    x = _x(4, 16) * 1e-3  # small variance: eps 1e-6 vs 1e-5 matters here
    mod = nn.LayerNorm()
    v = mod.init(jax.random.key(0), x)
    params = perturb_zero_leaves(v["params"])
    params["scale"] = params["scale"] + _x(16, seed=1)
    ref = np.asarray(mod.apply({"params": params}, x))
    key, _ = convert_leaf(("norm", "scale"), params["scale"])
    assert key == "norm.weight"
    out = load_into(LayerNorm(16), params)(t(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)


def _load_as(module, name, params):
    """Load the flax subtree ``params`` of module ``name`` into ``module``."""
    sd = jax_to_state_dict({name: params})
    module.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()},
                           strict=True)


def _port_unet(D=8):
    cfg = tiny_model_config(latent_dim=D, num_heads=1, num_random_features=32)
    return MotionTransformer(to_port(cfg))


@pytest.mark.parametrize("T", [16, 15])
def test_conv_downsample_same_padding(T):
    D = 8
    x = _x(2, T, D)
    mod = nn.Conv(D, kernel_size=(2,), strides=(2,))
    v = mod.init(jax.random.key(0), x)
    params = perturb_zero_leaves(v["params"])
    ref = np.asarray(mod.apply({"params": params}, x))
    key, w = convert_leaf(("downsample", "kernel"), params["kernel"])
    assert key == "downsample.weight" and w.shape == (D, D, 2)
    model = _port_unet(D)
    _load_as(model.downsample, "downsample", params)
    out = model._conv(model.downsample, t(x))
    assert out.shape == ref.shape  # ceil(T / 2) frames
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)


def test_conv_transpose_upsample_kernel_flipped():
    D = 8
    x = _x(2, 7, D)
    mod = nn.ConvTranspose(D, kernel_size=(2,), strides=(2,))
    v = mod.init(jax.random.key(0), x)
    params = perturb_zero_leaves(v["params"])
    ref = np.asarray(mod.apply({"params": params}, x))
    key, w = convert_leaf(("upsample", "kernel"), params["kernel"])
    assert key == "upsample.weight"
    np.testing.assert_array_equal(
        w, np.asarray(params["kernel"])[::-1].transpose(1, 2, 0))
    model = _port_unet(D)
    _load_as(model.upsample, "upsample", params)
    out = model._conv(model.upsample, t(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    # without the flip the two taps are swapped: the rule is load-bearing
    w_noflip = torch.from_numpy(
        np.ascontiguousarray(np.asarray(params["kernel"]).transpose(1, 2, 0)))
    with torch.no_grad():
        model.upsample.weight.copy_(w_noflip)
    bad = model._conv(model.upsample, t(x)).detach().numpy()
    assert np.abs(bad - ref).max() > 1e-3


def test_mha_dense_general_reshape():
    C, H, N = 16, 4, 6
    x = _x(2, N, C)
    mask = np.ones((2, N), bool)
    mask[1, 4:] = False
    mod = nn.MultiHeadDotProductAttention(num_heads=H, deterministic=True)
    v = mod.init(jax.random.key(0), x, x, mask=mask[:, None, None, :])
    params = perturb_zero_leaves(v["params"])
    ref = np.asarray(mod.apply({"params": params}, x, x,
                               mask=mask[:, None, None, :]))
    assert np.asarray(params["query"]["kernel"]).shape == (C, H, C // H)
    assert np.asarray(params["out"]["kernel"]).shape == (H, C // H, C)
    sd = jax_to_state_dict({"attn_0": params})
    assert sd["attn_0.query.weight"].shape == (C, C)
    assert sd["attn_0.query.bias"].shape == (C,)
    port = MultiHeadDotProductAttention(C, H)
    _load_as(port, "attn_0", params)
    out = port(t(x), t(mask))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)


def _model_params(cfg):
    return random_params(
        JaxMotionTransformer(cfg), jnp.zeros((1, 16, 26)),
        jnp.zeros((1,), jnp.int32), jnp.asarray([16]),
        text_ids=jnp.ones((1, 12), jnp.int32))


def test_block_names_and_strict_load_of_the_whole_tree():
    cfg = tiny_model_config(num_layers=2)
    params = _model_params(cfg)
    sd = jax_to_state_dict({"params": params})  # a variables dict works too
    assert "blocks_low.1.ffn.branch_0_moe.w1" in sd
    assert "blocks_high.0.dual_self_attn.local_attn.fa_projection" in sd
    assert sd["text_encoder.embed.weight"].shape == (8192, 256)
    # raw params keep their flax layout: out_kernel is [in, out]
    k = "blocks_low.0.ffn.proj_out.out_kernel"
    np.testing.assert_array_equal(
        sd[k].numpy(),
        np.asarray(params["block_low_0"]["ffn"]["proj_out"]["out_kernel"]))
    MotionTransformer(to_port(cfg)).load_state_dict(sd, strict=True)


def test_stacked_scan_layout_is_unstacked():
    named = _model_params(tiny_model_config(num_layers=2))
    stacked = jax.device_get(stack_block_params({"params": named})["params"])
    assert "blocks_low" in stacked and "block_low_0" not in stacked
    assert set(unstack_block_params(stacked)) == set(named)
    a, b = jax_to_state_dict(named), jax_to_state_dict(stacked)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


def _performer_trees():
    """Seeded flax trees of an unfused Performer and of the fused one
    grafted from it as ``tests/test_ops.py`` grafts them (q|k|v
    concatenated, the FastAttention norm and projection moved to the
    ``fa_*`` leaves)."""
    from motiondiffusion_moe_tpu.models.attention import (
        PerformerSelfAttention)

    kw = dict(latent_dim=16, num_heads=2, dropout=0.0, time_embed_dim=64,
              num_features=32)
    args = (_x(2, 6, 16), _x(2, 16, seed=1),
            (np.arange(6)[None] < np.array([6, 4])[:, None]).astype(
                np.float32)[..., None])
    pu = perturb_zero_leaves(random_params(
        PerformerSelfAttention(**kw, fused=False), *args))
    pf = {k: v for k, v in pu.items() if k not in (
        "query", "key", "value", "fast_attention")}
    pf["qkv"] = {n: np.concatenate([pu[p][n] for p in ("query", "key",
                                                       "value")], axis=-1)
                 for n in ("kernel", "bias")}
    pf["fa_norm_scale"] = pu["fast_attention"]["norm"]["scale"]
    pf["fa_norm_bias"] = pu["fast_attention"]["norm"]["bias"]
    pf["fa_projection"] = pu["fast_attention"]["projection"]
    return kw, args, pu, pf


def test_unfused_performer_tree_keys_and_layouts():
    from motiondiffusion_moe_tpu.models.attention import (
        PerformerSelfAttention)
    from motiondiffusion_moe_tpu_torch.models.attention import (
        PerformerSelfAttention as PortPerformer)

    kw, args, pu, _ = _performer_trees()
    sd = jax_to_state_dict(pu)
    np.testing.assert_array_equal(sd["query.weight"].numpy(),
                                  np.asarray(pu["query"]["kernel"]).T)
    np.testing.assert_array_equal(sd["fast_attention.norm.weight"].numpy(),
                                  pu["fast_attention"]["norm"]["scale"])
    np.testing.assert_array_equal(  # a raw param keeps its [D, m] layout
        sd["fast_attention.projection"].numpy(),
        pu["fast_attention"]["projection"])
    assert not any(k.startswith(("qkv", "fa_")) for k in sd)
    port = PortPerformer(16, 2, 64, 32, fused=False)
    load_into(port, pu)  # strict
    assert not port.fast_attention.projection.requires_grad
    ref = PerformerSelfAttention(**kw, fused=False).apply({"params": pu},
                                                          *args)
    out = port(t(args[0]), t(args[1]), t(args[2][..., 0]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


def test_fused_to_unfused_graft():
    """unfuse_performer_state inverts the JAX graft leaf for leaf, and
    unfuse_performers gives a twin with the same parameters, dtypes and
    outputs."""
    from motiondiffusion_moe_tpu_torch.models.attention import (
        PerformerSelfAttention as PortPerformer)
    from motiondiffusion_moe_tpu_torch.models.bridge import (
        unfuse_performer_state,
        unfuse_performers,
    )
    from motiondiffusion_moe_tpu_torch.pipeline import cast_params_

    _, args, pu, pf = _performer_trees()
    expect = jax_to_state_dict(pu)
    got = unfuse_performer_state(jax_to_state_dict(pf))
    assert got.keys() == expect.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), expect[k].numpy())
    # whole-model keys keep their prefix
    prefixed = unfuse_performer_state(
        {"blocks_low.0.dual_self_attn.local_attn.qkv.bias": torch.arange(6.),
         "blocks_low.0.dual_self_attn.local_attn.fa_norm_bias": torch.ones(2)})
    assert sorted(prefixed) == [
        "blocks_low.0.dual_self_attn.local_attn.fast_attention.norm.bias",
        "blocks_low.0.dual_self_attn.local_attn.key.bias",
        "blocks_low.0.dual_self_attn.local_attn.query.bias",
        "blocks_low.0.dual_self_attn.local_attn.value.bias"]

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = PortPerformer(16, 2, 64, 32)

    x, emb, mask = t(args[0]), t(args[1]), t(args[2][..., 0])
    holder = Holder()
    load_into(holder.attn, pf)
    with torch.no_grad():
        ref = holder.attn(x, emb, mask)
        unfuse_performers(holder)
        out = holder.attn(x, emb, mask)
    assert not holder.attn.fused and not holder.attn.training
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    # bf16 weights stay bf16, the projection f32 (as the pipeline keeps it)
    holder = Holder()
    cast_params_(holder, torch.bfloat16)
    unfuse_performers(holder)
    assert holder.attn.query.weight.dtype == torch.bfloat16
    assert holder.attn.fast_attention.projection.dtype == torch.float32
