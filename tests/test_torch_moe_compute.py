"""The port's ``moe_compute="dense"`` and ``"dispatch"`` against the JAX
package's, on one device.

The layer (``SwitchMoELayer``) and the whole denoiser, seeded flax
parameters bridged into the port, seeded numpy inputs; JAX runs on the CPU.

Tolerances. f32: the same math in another summation order -> 1e-5 for the
layer and its gradients (relative to the largest value), 1e-4 for the
denoiser (as ``tests/test_torch_models.py``). bf16: XLA's compiled program
rounds the expert products, the bias adds and gelu's steps to bf16 and sums
the combine in f32 (read from ``jax.jit(...).lower(...).compile()``), and
so does the port; routed as JAX routes (its top-2 choice injected through
``top_k_lowest_index``, as ``tests/test_torch_deberta_slice.py`` does: bf16
routing flips at near ties, and under ``dispatch`` one flip moves the
positions of every later token), the layer is held to
``assert_bf16_close`` (one bf16 ulp plus 2^-12 of the largest value) and the
denoiser to the 1.2e-2 relative RMS of the bf16 denoiser tests. The port's
own bf16 routing is counted against JAX's and printed.

Dropped tokens: under ``dispatch`` the kept (token, expert) pairs are read
from each package's own function with w1 = b1 = 0 and b2 the first E unit
vectors, so that output column e of token s is its gate value for expert e
if that pair was kept and 0 if it was dropped.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.models import moe as JM
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu_torch.models import moe as TM
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.models.transformer import (
    MotionTransformer,
)

from tests._torch_parity import (
    assert_bf16_close,
    load_into,
    random_params,
    rel_rms,
    t,
    tiny_config,
    tiny_model_config,
    to_port,
)
from tests.test_torch_train_step import (
    _apply_jax_update,
    _batch,
    _check_grads,
    _check_params,
    _half,
    _jax_loss_fn,
    _port,
    _port_batch,
)

B, T, D, HID, E = 2, 10, 64, 32, 4
S = B * T
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(
        np.float32)


def _params(compute, cf, skew, seed=0):
    """Seeded layer parameters; ``skew`` adds a bias that favours experts 0
    and 1, so that they overflow a capacity of S * cf / E."""
    jmod = JM.SwitchMoELayer(latent_dim=D, hidden_dim=HID, num_experts=E,
                             top_k=2, capacity_factor=cf, compute=compute)
    params = random_params(jmod, _x(), seed=seed)
    if skew:
        params["gate"]["bias"] = params["gate"]["bias"] + np.array(
            [1.0, 0.6, 0.0, -0.5], np.float32)
    return params


def _jax_layer(compute, cf, dtype="float32"):
    return JM.SwitchMoELayer(latent_dim=D, hidden_dim=HID, num_experts=E,
                             top_k=2, capacity_factor=cf, compute=compute,
                             dtype=DTYPES[dtype][0])


def _port_layer(compute, cf, params, dtype="float32"):
    return load_into(TM.SwitchMoELayer(D, HID, E, 2, DTYPES[dtype][1],
                                       compute, cf), params)


def _jax_apply(compute, cf, params, x, dtype="float32"):
    jmod = _jax_layer(compute, cf, dtype)
    out, sown = jax.jit(lambda p, a: jmod.apply(
        {"params": p}, a, mutable=["moe_metrics", "moe_losses"]))(params, x)
    return np.asarray(out.astype(jnp.float32)), sown


def _kept_probe(params):
    """The same gate; experts that output their gate value in column e."""
    probe = {k: dict(v) if isinstance(v, dict) else np.array(v)
             for k, v in params.items()}
    probe["w1"] = np.zeros_like(params["w1"])
    probe["b1"] = np.zeros_like(params["b1"])
    probe["b2"] = np.eye(E, D, dtype=np.float32)
    return probe


@pytest.mark.parametrize("S_, cf, E_", [(20, 2.0, 4), (6272, 2.0, 4),
                                        (7, 1.25, 3), (20, 0.0, 4),
                                        (3, 0.01, 8), (100, 4.0, 4),
                                        (13, 0.3, 5)])
def test_expert_capacity_is_the_jax_formula(S_, cf, E_):
    want = max(1, int(-(-S_ * cf // E_)))  # moe.py:213
    assert TM.expert_capacity(S_, E_, cf) == want


@pytest.mark.parametrize("case", ["ample", "overflow", "clamp"])
@pytest.mark.parametrize("compute", ["dense", "dispatch"])
def test_switch_moe_matches_jax_f32(compute, case):
    """ample: cf = E, no expert can overflow, so dispatch equals dense;
    overflow: cf = 2 with the gate skewed towards experts 0 and 1, so both
    packages drop the same tokens; clamp: cf = 0 -> C = max(1, 0) = 1."""
    cf = {"ample": float(E), "overflow": 2.0, "clamp": 0.0}[case]
    params = _params(compute, cf, skew=case != "ample")
    x = _x(1)
    ref, sown = _jax_apply(compute, cf, params, x)
    port = _port_layer(compute, cf, params)
    with torch.no_grad():
        out, metrics = port(t(x), with_metrics=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    for name in ("expert_usage", "expert_importance"):
        np.testing.assert_allclose(metrics[name].numpy(),
                                   np.asarray(sown["moe_metrics"][name]),
                                   atol=1e-5)
    np.testing.assert_allclose(metrics["aux"].numpy(),
                               np.asarray(sown["moe_losses"]["aux"]),
                               atol=1e-6)
    if compute == "dense" or case == "ample":
        dense_ref, _ = _jax_apply("dense", cf, params, x)
        np.testing.assert_allclose(out.numpy(), dense_ref, rtol=0,
                                   atol=1e-5 * np.abs(dense_ref).max())
        return
    # the same (token, expert) pairs kept in both packages, and some dropped
    probe = _kept_probe(params)
    jax_kept, _ = _jax_apply("dispatch", cf, probe, x)
    with torch.no_grad():
        port_kept = _port_layer("dispatch", cf, probe)(t(x)).numpy()
    jax_kept = jax_kept.reshape(S, D)[:, :E] != 0
    port_kept = port_kept.reshape(S, D)[:, :E] != 0
    np.testing.assert_array_equal(port_kept, jax_kept)
    C = TM.expert_capacity(S, E, cf)
    assert (jax_kept.sum(0) <= C).all()
    dropped = 2 * S - int(jax_kept.sum())
    assert dropped > 0
    if case == "clamp":
        assert C == 1 and dropped == 2 * S - jax_kept.any(0).sum()
    # the port's own slot bookkeeping says the same
    _, top_idx = TM.top_k_lowest_index(torch.softmax(
        port.gate(t(x).reshape(S, D)), -1), 2)
    slot, keep = TM.capacity_slots(top_idx, E, C)
    assert int(keep.sum()) == 2 * S - dropped
    kept = slot[keep].tolist()
    assert len(set(kept)) == len(kept)  # no slot taken twice
    np.testing.assert_array_equal(  # the same pairs as JAX's
        np.sort(top_idx[keep].numpy() + E * np.nonzero(keep.numpy())[0]),
        np.sort(np.nonzero(jax_kept)[1] + E * np.nonzero(jax_kept)[0]))


def test_dispatch_fill_order_and_padding_rows():
    """Slots fill choice 0 over all tokens first, in flattened row order
    (padding rows count), then choice 1 from where each expert stopped."""
    top_idx = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 1], [2, 0]])
    slot, keep = TM.capacity_slots(top_idx, 3, 2)
    pairs = [(s_, j, int(slot[s_, j])) for s_, j in keep.nonzero().tolist()]
    # expert 0: tokens 0, 1 (choice 0) fill it; token 3's first choice and
    # the second choices of tokens 2 and 4 drop. expert 1: token 2 (choice
    # 0), then token 0 (choice 1); token 3's second choice drops. expert 2:
    # token 4 (choice 0), token 1 (choice 1).
    assert pairs == [(0, 0, 0), (0, 1, 3), (1, 0, 1), (1, 1, 5), (2, 0, 2),
                     (4, 0, 4)]


@pytest.mark.parametrize("compute", ["dense", "dispatch"])
def test_switch_moe_gradients_match_jax(compute):
    """A train-mode call (``deterministic=False``), f32: the gradients of x
    and of gate, w1, b1, w2 and b2 of <out, g>; under dispatch with tokens
    dropped (the router's gradient then comes from the kept slots only)."""
    cf = 2.0
    params = _params(compute, cf, skew=True, seed=3)
    x, g = _x(4), _x(5)
    jmod = _jax_layer(compute, cf)

    def loss(p, a):
        out, _ = jmod.apply({"params": p}, a, deterministic=False,
                            mutable=["moe_metrics", "moe_losses"])
        return jnp.sum(out * g)

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    port = _port_layer(compute, cf, params).train()
    xt = t(x).requires_grad_(True)
    (port(xt) * t(g)).sum().backward()

    def close(got, want, name):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-8,
                                   err_msg=name)

    close(xt.grad.numpy(), jgx, "x")
    close(port.gate.weight.grad.numpy().T, jgp["gate"]["kernel"], "gate")
    close(port.gate.bias.grad.numpy(), jgp["gate"]["bias"], "gate bias")
    assert np.abs(np.asarray(jgp["gate"]["kernel"])).max() > 0
    for name in ("w1", "b1", "w2", "b2"):
        close(getattr(port, name).grad.numpy(), jgp[name], name)


def _jax_top2(compute, cf, params, x, dtype):
    """JAX's top-2 choice (in its order) under its own bf16 routing."""
    jmod = _jax_layer(compute, cf, dtype)
    _, state = jax.jit(lambda p, a: jmod.apply(
        {"params": p}, a, capture_intermediates=lambda m, _: m.name == "gate",
        mutable=["moe_metrics", "moe_losses", "intermediates"]))(params, x)
    logits = state["intermediates"]["gate"]["__call__"][0]
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, 2)[1])


def _forcing(forced, chosen):
    """A ``top_k_lowest_index`` that records the port's own choice and
    routes by ``forced`` (one [S, k] array per call, JAX's order),
    weighted by the port's own probabilities."""
    own = TM.top_k_lowest_index

    def top_k(probs, k):
        vals, idx = own(probs, k)
        chosen.append(idx.numpy())
        if forced is not None:
            idx = torch.tensor(forced[len(chosen) - 1]).long()
            vals = probs.gather(1, idx)
        return vals, idx

    return top_k


@pytest.mark.parametrize("compute", ["dense", "dispatch"])
def test_switch_moe_bf16_routed_as_jax(compute, monkeypatch):
    cf = 2.0
    params = _params(compute, cf, skew=True, seed=6)
    x = _x(7)
    ref, _ = _jax_apply(compute, cf, params, x, "bfloat16")
    top2 = _jax_top2(compute, cf, params, x, "bfloat16")
    port = _port_layer(compute, cf, params, "bfloat16")
    chosen = []
    monkeypatch.setattr(TM, "top_k_lowest_index", _forcing([top2], chosen))
    with torch.no_grad():
        out = port(t(x)).float().numpy()
    flips = int((np.sort(chosen[0], -1) != np.sort(top2, -1)).any(-1).sum())
    print(f"bf16 {compute}: the port's own top-2 differs from JAX's at "
          f"{flips} of {S} tokens")
    assert_bf16_close(out, ref)


def _denoiser_inputs(Tn=16):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, Tn, 26)).astype(np.float32)
    ts = np.array([5, 500, 99], np.int32)
    lengths = np.array([Tn, 9, 1], np.int32)
    ids = hash_tokenize(["a person walks", "turn left", ""], 12)
    return x, ts, lengths, ids


@pytest.fixture(scope="module")
def denoiser_params():
    x, ts, lengths, ids = _denoiser_inputs()
    return random_params(JaxMotionTransformer(tiny_model_config(
        num_layers=1)), x, ts, lengths, text_ids=ids, seed=2)


_JAX_DENOISED = {}


def _jax_denoise(cfg, params):
    """JAX's output and each MoE layer's top-2 choice (its order), one
    compile per (compute, dtype, capacity under dispatch)."""
    if cfg.moe_compute != "dispatch":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=2.0)
    key = (cfg.moe_compute, cfg.dtype, cfg.moe_capacity_factor)
    if key not in _JAX_DENOISED:
        jm = JaxMotionTransformer(cfg)
        out, state = jax.jit(lambda p, *a: jm.apply(
            {"params": p}, *a[:3], text_ids=a[3],
            capture_intermediates=lambda m, _: m.name == "gate",
            mutable=["moe_losses", "moe_metrics", "intermediates"]))(
                params, *_denoiser_inputs())
        gates = state["intermediates"]
        top2 = [np.asarray(jax.lax.top_k(jax.nn.softmax(
            gates[b]["ffn"][f"branch_{i}_moe"]["gate"]["__call__"][0]
            .astype(jnp.float32), axis=-1), 2)[1])
            for b in ("block_low_0", "block_high_0") for i in (0, 1)]
        _JAX_DENOISED[key] = (np.asarray(out), top2)
    return _JAX_DENOISED[key]


def _port_denoise(cfg, params, monkeypatch=None, forced=None):
    port = load_into(MotionTransformer(to_port(cfg)), params)
    x, ts, lengths, ids = _denoiser_inputs()
    chosen = []
    with torch.no_grad():
        if monkeypatch is None:
            out = port(t(x), t(ts), t(lengths), text_ids=t(ids))
        else:
            with monkeypatch.context() as mp:
                mp.setattr(TM, "top_k_lowest_index", _forcing(forced, chosen))
                out = port(t(x), t(ts), t(lengths), text_ids=t(ids))
    return out.numpy(), chosen


# cf = 1: each expert takes a quarter of the tokens, so the top-2 choices
# (twice as many) must overflow
@pytest.mark.parametrize("compute, cf", [("dense", 2.0), ("dispatch", 1.0)])
def test_motion_transformer_f32(compute, cf, denoiser_params):
    cfg = tiny_model_config(num_layers=1, moe_compute=compute,
                            moe_capacity_factor=cf)
    ref, top2 = _jax_denoise(cfg, denoiser_params)
    out, _ = _port_denoise(cfg, denoiser_params)
    assert out.shape == (3, 16, 26)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    if compute == "dispatch":
        S_low, S_high = 3 * 8, 3 * 16
        kept = [int(TM.capacity_slots(torch.tensor(idx).long(), 4,
                                      TM.expert_capacity(s, 4, cf))[1].sum())
                for idx, s in zip(top2, (S_low, S_low, S_high, S_high))]
        dropped = sum(2 * s - k for s, k in zip(
            (S_low, S_low, S_high, S_high), kept))
        assert dropped > 0
        dense_ref, _ = _jax_denoise(dataclasses.replace(
            cfg, moe_compute="dense"), denoiser_params)
        assert np.abs(ref - dense_ref).max() > 1e-3


@pytest.mark.parametrize("compute", ["dense", "dispatch"])
def test_motion_transformer_bf16_routed_as_jax(compute, denoiser_params,
                                               monkeypatch):
    cfg = tiny_model_config("bfloat16", num_layers=1, moe_compute=compute)
    ref, top2 = _jax_denoise(cfg, denoiser_params)
    own, chosen = _port_denoise(cfg, denoiser_params, monkeypatch, None)
    flips = sum(int((np.sort(c, -1) != np.sort(j, -1)).any(-1).sum())
                for c, j in zip(chosen, top2))
    forced, _ = _port_denoise(cfg, denoiser_params, monkeypatch, top2)
    dist = rel_rms(forced, ref)
    print(f"tiny bf16 denoiser, moe_compute={compute}: {flips} of "
          f"{sum(len(j) for j in top2)} token-routings differ from JAX's; "
          f"routed as JAX routes, relative RMS {dist:.3e} (own routing "
          f"{rel_rms(own, ref):.3e})")
    assert np.isfinite(own).all()
    assert dist <= 1.2e-2


@pytest.mark.parametrize("compute", ["dense", "dispatch"])
def test_train_step_matches_jax(compute):
    """One train step against JAX's ``jax.grad`` + ``make_optimizer``, as
    ``tests/test_torch_train_step.py`` holds ``dense_fused``: the loss and
    every gradient in both modes, Adam's update (which does not see the
    mode) under dispatch; cf = 1 under dispatch, so tokens drop."""
    cfg = tiny_config(num_layers=1, moe_compute=compute,
                      moe_capacity_factor=1.0 if compute == "dispatch"
                      else 2.0)
    model, vg = _jax_loss_fn(cfg)
    batch, noise = _half(*_batch(), 0)
    params = random_params(model, batch["motion"], batch["t"],
                           batch["length"], text_ids=batch["text_ids"],
                           seed=8)
    jloss, jgrads = vg(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.asarray(noise))
    state, step = _port(cfg, params)
    assert all(m.compute == compute for m in state.model.modules()
               if isinstance(m, TM.SwitchMoELayer))
    metrics = step.backward(state, _port_batch(batch), None, noise=t(noise))
    np.testing.assert_allclose(metrics["loss_total"].item(), float(jloss),
                               rtol=1e-5)
    _check_grads(state.model, jgrads)
    if compute == "dispatch":  # Adam does not see the mode: checked once
        step.apply_update(state, metrics)
        _check_params(state.model, _apply_jax_update(cfg, params, jgrads),
                      jgrads, cfg.train.lr)


def test_unknown_moe_compute_raises():
    with pytest.raises(ValueError, match="unknown moe compute mode"):
        TM.SwitchMoELayer(D, HID, E, 2, compute="sparse")
    with pytest.raises(ValueError, match="unknown moe compute mode"):
        MotionTransformer(to_port(tiny_model_config(moe_compute="sparse")))


def test_moe_fused_kernel_switch_leaves_dense_and_dispatch_alone(
        monkeypatch):
    """``MOE_FUSED_KERNEL=1`` applies to ``dense_fused`` only, as in JAX."""
    calls = []
    monkeypatch.setenv("MOE_FUSED_KERNEL", "1")
    monkeypatch.setattr(TM, "moe_dense_fused",
                        lambda x, *a: calls.append(1) or torch.zeros_like(x))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (S, 128)).astype(np.float32))
    for compute in ("dense", "dispatch"):
        layer = TM.SwitchMoELayer(128, 128, 4, 2, compute=compute).eval()
        layer(x)
    assert calls == []
    TM.SwitchMoELayer(128, 128, 4, 2).eval()(x)
    assert calls == [1]


def _computes(model):
    return {m.compute for m in model.modules()
            if isinstance(m, TM.SwitchMoELayer)}


@pytest.mark.parametrize("compute", ["dense", "dispatch"])
def test_a_moe_compute_config_goes_through_export_serve_and_train(
        compute, tmp_path, monkeypatch):
    """The parameter names are the same in every mode, so a JAX export of
    a ``dense`` / ``dispatch`` config (written as the JAX ``export_run``
    writes it: ``config.json``, ``flax.serialization.msgpack_serialize`` of
    the params) serves through ``from_export`` and the serve CLI, and the
    train CLI (neither package's has a flag for the mode: patched into its
    config) writes a run that ``load_run`` and the serve CLI read back."""
    import flax.serialization as fser

    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools import train as train_cli
    from motiondiffusion_moe_tpu_torch.tools.export import load_run
    from motiondiffusion_moe_tpu_torch.tools.serve import build_server

    cfg = tiny_config(num_layers=1, moe_compute=compute,
                      moe_capacity_factor=1.0)
    export = tmp_path / "export"
    export.mkdir()
    cfg.save(str(export / "config.json"))
    x, ts, lengths, ids = _denoiser_inputs()
    params = random_params(JaxMotionTransformer(cfg.model), x, ts, lengths,
                           text_ids=ids, seed=4)
    (export / "params.msgpack").write_bytes(fser.msgpack_serialize(
        {"params": params}, in_place=True))
    pipe = GenerationPipeline.from_export(str(export), sampler="dpm",
                                          num_inference_steps=2,
                                          micro_batch=2, device="cpu")
    assert _computes(pipe.model) == {compute}
    direct = load_into(MotionTransformer(to_port(cfg.model)), params)
    with torch.no_grad():
        out = pipe.model(t(x), t(ts), t(lengths), text_ids=t(ids))
        assert torch.equal(out, direct(t(x), t(ts), t(lengths),
                                       text_ids=t(ids)))
    motions = pipe.generate(["a person walks", "jump"], [16, 5])
    assert [m.shape for m in motions] == [(16, 26), (5, 26)]
    assert all(np.isfinite(m).all() for m in motions)
    server = build_server(["--export_dir", str(export), "--device", "cpu",
                           "--port", "0"])
    try:
        assert _computes(server.pipe.model) == {compute}
    finally:
        server.server_close()

    config_from_args = train_cli.config_from_args

    def with_compute(args):
        c = config_from_args(args)
        return dataclasses.replace(c, model=dataclasses.replace(
            c.model, moe_compute=compute, moe_capacity_factor=1.0))

    monkeypatch.setattr(train_cli, "config_from_args", with_compute)
    state = train_cli.main([
        "--device", "cpu", "--batch_size", "4", "--num_epochs", "1",
        "--num_layers", "1", "--latent_dim", "32", "--ff_size", "16",
        "--num_heads", "2", "--num_experts", "4", "--text_latent_dim", "16",
        "--diffusion_steps", "50", "--no_uncond_step", "--dataset",
        "synthetic", "--synthetic_size", "8", "--name", "run",
        "--checkpoint_dir", str(tmp_path)])
    assert _computes(state.model) == {compute} and state.step == 2
    run_cfg, _, step, _ = load_run(str(tmp_path / "run"))
    assert run_cfg.model.moe_compute == compute and step == 2
    server = build_server(["--run_dir", str(tmp_path / "run"), "--device",
                           "cpu", "--port", "0"])
    try:
        assert _computes(server.pipe.model) == {compute}
    finally:
        server.server_close()
