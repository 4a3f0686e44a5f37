"""The DeBERTa text encoder in front of the denoiser, through every entry
point of the port, at ``tiny_config(text_encoder="deberta-tiny")``.

The same flax weights (seeded numpy draws) and inputs go through the JAX
package and the port: the denoiser, a sampling run with injected noise, the
weight bridge both ways, and a JAX export served by ``from_export``. The
graft of an HF checkpoint (a seeded one in the HF layout, half precision
as the published file stores it) goes into the trainer's state bit for
bit, as the JAX graft puts it into the flax tree. ``tools/train.py
--text_encoder deberta-tiny --deberta_ckpt`` trains on the CPU; its run
is evaluated, exported and served.

Tolerances: f32 compute -> max abs error <= 1e-5 x the largest output
value (the same math in another summation order; the sampler's guidance
and eps -> x0 factor scale the error with the output). bf16 compute (the
text encoder stays f32, within 1e-5 of JAX's) -> relative RMS <= 1.2e-2,
the hash flagship's rule in ``tests/test_torch_models.py``: with the dense
FFN as it stands, with the MoE FFN routed as JAX routes and its own routing
held apart (``test_motion_transformer_bf16``).
Grafted and bridged weights: equal, bit for bit.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.diffusion import make_schedule as jax_schedule
from motiondiffusion_moe_tpu.diffusion.dpm_solver import (
    dpm_solver_pp_2m as jax_dpm,
)
from motiondiffusion_moe_tpu.models import deberta as JD
from motiondiffusion_moe_tpu.models.text_encoder import (
    get_text_encoder as jax_get_text_encoder,
)
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu.tools.export import export_run as jax_export_run
from motiondiffusion_moe_tpu.training import (
    CheckpointManager as JaxCheckpointManager,
    Trainer as JaxTrainer,
)
from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
from motiondiffusion_moe_tpu_torch.models import deberta as TD
from motiondiffusion_moe_tpu_torch.models import moe as TM
from motiondiffusion_moe_tpu_torch.models.bridge import (
    jax_to_state_dict,
    state_dict_to_jax,
)
from motiondiffusion_moe_tpu_torch.models.layers import init_weights
from motiondiffusion_moe_tpu_torch.models.text_encoder import (
    HashTextEncoder,
    get_text_encoder,
    get_tokenizer,
    hash_tokenize,
    make_text_encoder,
)
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
from motiondiffusion_moe_tpu_torch.tools.evaluate import main as eval_main
from motiondiffusion_moe_tpu_torch.tools.export import main as export_main
from motiondiffusion_moe_tpu_torch.tools.serve import build_server
from motiondiffusion_moe_tpu_torch.tools.train import main as train_main
from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

from tests._torch_parity import (
    load_into,
    perturb_zero_leaves,
    random_params,
    rel_rms,
    t,
    tiny_config,
    to_port,
)
from tests.test_torch_deberta import _hf_layout
from tests.test_torch_eval import _save_finest_tar
from tests.test_torch_evaluate_cli import FIXTURE_GLOVE

os.environ.setdefault("HF_HUB_OFFLINE", "1")

PROMPTS = ["a person walks forward", "jump", ""]
LENGTHS = [16, 9, 1]
MB = 3
STEPS = 3


def _cfg(dtype="float32", **kw):
    return tiny_config(dtype, num_layers=1, text_encoder="deberta-tiny", **kw)


def _ids(cfg, texts=PROMPTS):
    tokenize, _ = jax_get_text_encoder(cfg.model)
    return tokenize(texts)


@pytest.fixture(scope="module")
def flax_params():
    cfg = _cfg()
    T, F = cfg.model.max_frames, cfg.model.input_feats
    params = random_params(JaxMotionTransformer(cfg.model),
                           np.zeros((MB, T, F), np.float32),
                           np.zeros(MB, np.int32), np.full(MB, T, np.int32),
                           text_ids=_ids(cfg), seed=1)
    # a head 10x smaller than the draw keeps the guided samples near the
    # scale of real ones (as tests/test_torch_pipeline.py does)
    params["out"] = {k: 0.1 * v for k, v in params["out"].items()}
    return params


# ---------------------------------------------------------------- lookup

def test_get_text_encoder_picks_the_configured_backend():
    cfg = to_port(_cfg()).model
    tok, mod = get_text_encoder(cfg)
    assert isinstance(mod, TD.DebertaTextEncoder)
    assert mod.bert.cfg == TD.DebertaConfig.tiny()
    ids = tok(PROMPTS)
    np.testing.assert_array_equal(ids, _ids(_cfg()))
    assert ids.max() < 256  # the encoder's vocab, not the hash default
    # the tokenizer and the module each on their own, and the JAX name for
    # both: the same choices
    np.testing.assert_array_equal(get_tokenizer(cfg)(PROMPTS), ids)
    assert isinstance(make_text_encoder(cfg), TD.DebertaTextEncoder)
    tok, mod = TD.get_deberta_encoder(cfg)
    np.testing.assert_array_equal(tok(PROMPTS), ids)
    assert mod.bert.cfg == TD.DebertaConfig.tiny()
    hash_cfg = dataclasses.replace(cfg, text_encoder="hash")
    tok, mod = get_text_encoder(hash_cfg)
    assert isinstance(mod, HashTextEncoder)
    assert isinstance(make_text_encoder(hash_cfg), HashTextEncoder)
    np.testing.assert_array_equal(tok(PROMPTS), hash_tokenize(PROMPTS, 12))
    np.testing.assert_array_equal(get_tokenizer(hash_cfg)(PROMPTS),
                                  hash_tokenize(PROMPTS, 12))
    clip = dataclasses.replace(cfg, text_encoder="clip")
    for lookup in (get_text_encoder, get_tokenizer, make_text_encoder):
        with pytest.raises(ValueError, match="unknown text encoder"):
            lookup(clip)


def test_flagship_with_deberta_v3_large_builds():
    cfg = dataclasses.replace(ExperimentConfig.moe_small().model,
                              text_encoder="deberta-v3-large")
    with torch.device("meta"):
        model = MotionTransformer(cfg)
    bert = model.text_encoder.bert
    n = sum(p.numel() for p in model.text_encoder.parameters())
    assert bert.cfg == TD.DebertaConfig.large()
    assert model.text_encoder.proj_dense.weight.shape == (128, 1024)
    # 128100 x 1024 embeddings + 24 layers + the relative table + the head
    assert 434_000_000 < n < 435_000_000


# ---------------------------------------------------------------- denoiser

def _denoiser_inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 16, 26)).astype(np.float32)
    return (x, np.array([5, 50, 99], np.int32),
            np.array([16, 9, 1], np.int32), _ids(_cfg()))


def _denoise_both(dtype, params, **kw):
    cfg = _cfg(dtype, **kw)
    x, ts, lengths, ids = _denoiser_inputs()
    jm = JaxMotionTransformer(cfg.model)
    ref = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:3], text_ids=a[3],
        mutable=["moe_losses", "moe_metrics"])[0])(params, x, ts, lengths, ids)
    port = load_into(MotionTransformer(to_port(cfg.model)), params)
    with torch.no_grad():
        out = port(t(x), t(ts), t(lengths), text_ids=t(ids))
        enc = port.encode_text(t(ids))
    assert out.dtype == torch.float32 and out.shape == (3, 16, 26)
    # the text encoder computes in f32 whatever the denoiser's dtype
    enc_ref = jax.jit(lambda p, i: jm.apply(
        {"params": p}, i, method=lambda m, i: m.encode_text(i)))(params, ids)
    for a, b in ((enc.pooled, enc_ref.pooled), (enc.tokens, enc_ref.tokens)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and b.dtype == np.float32
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    return out.numpy(), np.asarray(ref)


def test_motion_transformer_f32(flax_params):
    out, ref = _denoise_both("float32", flax_params)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.fixture(scope="module")
def dense_flax_params():
    cfg = _cfg(use_moe=False)
    T, F = cfg.model.max_frames, cfg.model.input_feats
    return random_params(JaxMotionTransformer(cfg.model),
                         np.zeros((MB, T, F), np.float32),
                         np.zeros(MB, np.int32), np.full(MB, T, np.int32),
                         text_ids=_ids(cfg), seed=1)


def _jax_routed(dtype, params):
    """JAX's denoiser output and, for each MoE layer in call order
    (block_low_0 branches 0, 1, then block_high_0's), its router
    probabilities: the softmax of the captured gate logits, as
    ``SwitchMoELayer`` computes it."""
    jm = JaxMotionTransformer(_cfg(dtype).model)
    out, state = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:3], text_ids=a[3],
        capture_intermediates=lambda m, _: m.name == "gate",
        mutable=["moe_losses", "moe_metrics", "intermediates"]))(
            params, *_denoiser_inputs())
    gates = state["intermediates"]
    probs = [np.asarray(jax.nn.softmax(
        gates[b]["ffn"][f"branch_{i}_moe"]["gate"]["__call__"][0]
        .astype(jnp.float32), axis=-1))
        for b in ("block_low_0", "block_high_0") for i in (0, 1)]
    return np.asarray(out), probs


def _top2(probs):
    """The top-2 experts of each token (``jax.lax.top_k``'s choice: the
    lowest index wins a tie), as a sorted pair."""
    return np.sort(np.argsort(-probs, axis=-1, kind="stable")[:, :2], -1)


def _port_routed(params, monkeypatch, forced=None):
    """The port's bf16 denoiser output and each MoE layer's top-2 choice;
    with ``forced`` (one [S, 2] array per layer) the layers route by those
    choices instead, weighted by the port's own probabilities."""
    own = TM.top_k_lowest_index
    chosen = []

    def top_k(probs, k):
        vals, idx = own(probs, k)
        chosen.append(np.sort(idx.numpy(), -1))
        if forced is not None:
            idx = torch.from_numpy(forced[len(chosen) - 1]).long()
            vals = probs.gather(1, idx)
        return vals, idx

    port = load_into(MotionTransformer(to_port(_cfg("bfloat16").model)),
                     params)
    x, ts, lengths, ids = _denoiser_inputs()
    with monkeypatch.context() as mp, torch.no_grad():
        mp.setattr(TM, "top_k_lowest_index", top_k)
        out = port(t(x), t(ts), t(lengths), text_ids=t(ids))
    return out.numpy(), chosen


@pytest.mark.parametrize("ffn", ["dense", "moe"])
def test_motion_transformer_bf16(ffn, flax_params, dense_flax_params,
                                 monkeypatch):
    """bf16 compute. The DeBERTa encodings inside are f32 and JAX's (the
    check in ``_denoise_both``). With the dense FFN the denoiser is held to
    the hash flagship's 1.2e-2 relative RMS.

    The MoE FFN's top-2 routing is discontinuous: where two experts are
    near a tie, one bf16 rounding more or less picks the other. On this
    fixture the port's bf16 routing differs from JAX's bf16 routing at 2
    of the 144 token-routings (both in block_high_0's branch 0), and that
    alone puts the port's output 4.39e-2 (relative RMS) from JAX's, against
    JAX's own 1.05e-2 from its f32 result. So the MoE case is held in two
    parts. Routing: at most 3 of the 144 differ (the most on any of 48
    draws of this fixture's weights, PERF.md), and each is a near tie,
    its f32 gap between the 2nd and 3rd expert within twice the largest
    move JAX's own bf16 rounding makes to a router probability in that
    layer. Arithmetic: routed as JAX routes, the port's output is within
    the same 1.2e-2 relative RMS of JAX's (8.58e-3 here)."""
    if ffn == "dense":
        out, ref = _denoise_both("bfloat16", dense_flax_params, use_moe=False)
        assert rel_rms(out, ref) <= 1.2e-2
        assert np.isfinite(out).all()
        return
    _denoise_both("bfloat16", flax_params)  # the f32 encodings' check
    ref, jax_b = _jax_routed("bfloat16", flax_params)
    _, jax_f = _jax_routed("float32", flax_params)
    out, own = _port_routed(flax_params, monkeypatch)
    assert np.isfinite(out).all()
    flips = 0
    for p_b, p_f, mine in zip(jax_b, jax_f, own):
        differ = (mine != _top2(p_b)).any(-1)
        flips += int(differ.sum())
        srt = -np.sort(-p_f, -1)
        gap = srt[:, 1] - srt[:, 2]
        assert (gap[differ] <= 2 * np.abs(p_b - p_f).max()).all()
    assert sum(len(c) for c in own) == 144 and flips <= 3
    forced, _ = _port_routed(flax_params, monkeypatch,
                             forced=[_top2(p) for p in jax_b])
    dist = rel_rms(forced, ref)
    print(f"tiny bf16 MoE denoiser behind deberta-tiny: {flips} of 144 "
          f"token-routings differ from JAX's; routed as JAX routes, "
          f"relative RMS {dist:.3e} (own routing {rel_rms(out, ref):.3e})")
    assert dist <= 1.2e-2


def test_bridge_round_trips_the_deberta_tree(flax_params):
    cfg = to_port(_cfg())
    sd = jax_to_state_dict(flax_params)
    assert "text_encoder.bert.layer_0.attention.query_proj.weight" in sd
    assert "text_encoder.bert.rel_embeddings" in sd
    model = MotionTransformer(cfg.model)
    model.load_state_dict(sd, strict=True)
    back = state_dict_to_jax(model.state_dict(), cfg)
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(v) for p, v in  # noqa
                         jax.tree_util.tree_leaves_with_path(tree)}
    a, b = flat(back), flat(flax_params)
    assert set(a) == set(b)
    for k in a:  # the bridge holds every leaf as f32
        assert a[k].dtype == np.float32, k
        assert np.array_equal(a[k], b[k].astype(np.float32)), k


# ---------------------------------------------------------------- sampling

def _jax_dpm(cfg, params, noise):
    """The JAX pipeline's sampler (``pipeline.py:192-226``) for dpm with
    the initial noise injected and the configured tokenizer."""
    model = JaxMotionTransformer(cfg.model)
    sched = jax_schedule(schedule_name=cfg.diffusion.beta_schedule,
                         num_timesteps=cfg.diffusion.num_timesteps)
    ids_c, ids_u = jnp.asarray(_ids(cfg)), jnp.asarray(_ids(cfg, [""] * MB))
    lengths = jnp.asarray(LENGTHS, jnp.int32)

    def fn(variables, noise):
        enc = lambda i: model.apply(variables, i,  # noqa: E731
                                    method=lambda m, x: m.encode_text(x))
        enc_c, enc_u = enc(ids_c), enc(ids_u)
        xf_proj = jnp.concatenate([enc_c.pooled, enc_u.pooled])
        xf_out = jnp.concatenate([enc_c.tokens, enc_u.tokens])
        length2 = jnp.concatenate([lengths, lengths])

        def model_doubled(x2, t2):
            return model.apply(variables, x2, t2, length2, xf_proj=xf_proj,
                               xf_out=xf_out,
                               mutable=["moe_losses", "moe_metrics"])[0]

        return jax_dpm(sched, model_doubled, noise, num_steps=STEPS,
                       guidance_scale=cfg.diffusion.cfg_scale)

    return np.asarray(jax.jit(fn)({"params": params}, jnp.asarray(noise)))


def _port_dpm(pipe, noise):
    out = pipe.sample(torch.from_numpy(pipe.tokenize(PROMPTS)),
                      torch.from_numpy(pipe.tokenize([""] * MB)),
                      torch.tensor(LENGTHS), noise=torch.from_numpy(noise))
    return out.numpy()


def _noise(seed=5):
    return np.random.default_rng(seed).standard_normal(
        (MB, 16, 26)).astype(np.float32)


def test_pipeline_sample_matches_jax(flax_params):
    cfg = _cfg()
    noise = _noise()
    ref = _jax_dpm(cfg, flax_params, noise)
    model = load_into(MotionTransformer(to_port(cfg.model)), flax_params)
    pipe = GenerationPipeline(to_port(cfg), model, sampler="dpm",
                              num_inference_steps=STEPS, micro_batch=MB,
                              device="cpu")
    np.testing.assert_array_equal(pipe.tokenize(PROMPTS), _ids(cfg))
    out = _port_dpm(pipe, noise)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A JAX run of deberta-tiny (the JAX trainer warns: random-init
    backbone) with nonzero weights, exported by the JAX package."""
    tmp = tmp_path_factory.mktemp("jax")
    cfg = _cfg()
    run = str(tmp / cfg.name)
    os.makedirs(run)
    cfg.save(os.path.join(run, "config.json"))
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        state = JaxTrainer(cfg).init_state()
    state = state.replace(params=perturb_zero_leaves(state.params, seed=2))
    ckpt = JaxCheckpointManager(os.path.join(run, "ckpt"))
    ckpt.save(0, state, epoch=0, rng=jax.random.key(3))
    ckpt.wait()
    return cfg, jax_export_run(run, str(tmp / "export"))


def test_port_samples_a_jax_export_as_jax_does(jax_export):
    from motiondiffusion_moe_tpu.tools.export import load_export

    cfg, export_dir = jax_export
    _, params, _ = load_export(export_dir)
    noise = _noise(6)
    ref = _jax_dpm(cfg, params["params"], noise)
    pipe = GenerationPipeline.from_export(export_dir, sampler="dpm",
                                          num_inference_steps=STEPS,
                                          micro_batch=MB, device="cpu")
    assert isinstance(pipe.model.text_encoder, TD.DebertaTextEncoder)
    out = _port_dpm(pipe, noise)
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


# ---------------------------------------------------------------- graft

@pytest.fixture(scope="module")
def hf_ckpt(tmp_path_factory):
    """A seeded HF-layout ``pytorch_model.bin`` for DebertaConfig.tiny(),
    in half precision, as the published checkpoint is stored."""
    d = tmp_path_factory.mktemp("hf")
    sd = _hf_layout(TD.DebertaConfig.tiny(), seed=3, dtype=torch.float16)
    torch.save(sd, d / "pytorch_model.bin")
    return str(d), sd


def _train_cfg(ckpt, ema=0.0):
    cfg = to_port(_cfg())
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, text_encoder_ckpt=ckpt),
        train=dataclasses.replace(cfg.train, ema_decay=ema, batch_size=3))


def test_trainer_grafts_bit_identically_and_the_ema_follows(hf_ckpt):
    path, sd = hf_ckpt
    tc = TD.DebertaConfig.tiny()
    want = TD.convert_hf_deberta_checkpoint(sd, tc)
    trainer = Trainer(_train_cfg(path, ema=0.99), device="cpu")
    state = trainer.init_state()
    bert = state.model.text_encoder.bert.state_dict()
    for k, v in want.items():
        assert bert[k].dtype == torch.float32
        assert torch.equal(bert[k], v.float()), k
    names = [n for n, _ in state.model.named_parameters()]
    ema = dict(zip(names, state.ema.params))
    for k, v in want.items():
        assert torch.equal(ema[f"text_encoder.bert.{k}"], v.float()), k
    # the JAX graft puts the same bits into the flax tree
    jcfg = dataclasses.replace(_cfg().model, text_encoder_ckpt=path)
    jparams = random_params(JaxMotionTransformer(jcfg),
                            np.zeros((1, 16, 26), np.float32),
                            np.zeros(1, np.int32), np.full(1, 16, np.int32),
                            text_ids=_ids(_cfg())[:1])
    grafted = JD.graft_pretrained_text_encoder({"params": jparams}, jcfg)
    ref = jax_to_state_dict(grafted["params"]["text_encoder"]["bert"])
    assert all(torch.equal(bert[k], ref[k]) for k in ref)
    # the tokenizer is the configured encoder's (ids inside its vocab)
    np.testing.assert_array_equal(trainer.tokenize(PROMPTS), _ids(_cfg()))


def test_graft_warns_without_a_checkpoint_and_keeps_the_init():
    cfg = _train_cfg("")
    model = init_weights(MotionTransformer(cfg.model), 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        assert TD.graft_pretrained_text_encoder(model, cfg.model) is model
    assert all(torch.equal(v, before[k]) for k, v in
               model.state_dict().items())
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        Trainer(cfg, device="cpu").init_state()
    hash_cfg = dataclasses.replace(cfg.model, text_encoder="hash",
                                   text_encoder_ckpt="unused")
    assert TD.graft_pretrained_text_encoder(model, hash_cfg) is model


def test_graft_raises_on_a_mismatch(hf_ckpt, tmp_path):
    path, sd = hf_ckpt
    cfg = _train_cfg(path).model
    # a backbone of the other layout: a different key set
    model = MotionTransformer(cfg)
    model.text_encoder.bert = TD.DebertaEncoder(
        dataclasses.replace(TD.DebertaConfig.tiny(), share_att_key=False))
    with pytest.raises(ValueError, match="tree mismatch.*pos_key_proj"):
        TD.graft_pretrained_text_encoder(model, cfg)
    # a checkpoint of another vocab: a shape that differs
    wide = dict(sd)
    wide["embeddings.word_embeddings.weight"] = torch.zeros(300, 32)
    torch.save(wide, tmp_path / "model.bin")
    with pytest.raises(ValueError, match="shape mismatch at "
                                         "word_embeddings.weight"):
        TD.graft_pretrained_text_encoder(
            MotionTransformer(cfg),
            dataclasses.replace(cfg, text_encoder_ckpt=str(tmp_path)))
    # a model without the DeBERTa backbone
    hash_model = MotionTransformer(dataclasses.replace(cfg,
                                                       text_encoder="hash"))
    with pytest.raises(ValueError, match="no text_encoder.bert"):
        TD.graft_pretrained_text_encoder(hash_model, cfg)


def test_pipeline_grafts_only_when_asked(hf_ckpt):
    path, sd = hf_ckpt
    cfg = _train_cfg(path)
    model = init_weights(MotionTransformer(cfg.model), 0)
    want = TD.convert_hf_deberta_checkpoint(sd, TD.DebertaConfig.tiny())
    kept = GenerationPipeline(cfg, model, device="cpu")
    grafted = GenerationPipeline(cfg, model, graft_pretrained_text=True,
                                 param_dtype="bfloat16", device="cpu")
    for k, v in want.items():
        assert torch.equal(kept.model.text_encoder.bert.state_dict()[k],
                           model.text_encoder.bert.state_dict()[k])
        got = grafted.model.text_encoder.bert.state_dict()[k]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, v.float().to(torch.bfloat16)), k
    # the caller's module keeps its weights
    assert not torch.equal(model.text_encoder.bert.rel_embeddings,
                           want["rel_embeddings"].float())


# ---------------------------------------------------------------- the CLIs

TINY = ["--device", "cpu", "--batch_size", "4", "--num_epochs", "1",
        "--num_layers", "1", "--latent_dim", "32", "--ff_size", "16",
        "--num_heads", "2", "--num_experts", "4", "--text_latent_dim", "16",
        "--diffusion_steps", "50", "--dataset", "synthetic",
        "--synthetic_size", "8", "--log_every", "1", "--ema_decay", "0.9"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, hf_ckpt):
    root = tmp_path_factory.mktemp("runs")
    state = train_main(TINY + ["--name", "deb", "--checkpoint_dir",
                               str(root), "--text_encoder", "deberta-tiny",
                               "--deberta_ckpt", hf_ckpt[0]])
    return str(root / "deb"), state


def test_train_cli_trains_deberta_from_the_checkpoint(cli_run, hf_ckpt):
    run, state = cli_run
    assert state.step == 4  # 2 batches x (cond + uncond)
    cfg = ExperimentConfig.load(os.path.join(run, "config.json"))
    assert cfg.model.text_encoder == "deberta-tiny"
    assert cfg.model.text_encoder_ckpt == hf_ckpt[0]
    want = TD.convert_hf_deberta_checkpoint(hf_ckpt[1],
                                            TD.DebertaConfig.tiny())
    bert = state.model.text_encoder.bert.state_dict()
    assert all(torch.isfinite(v).all() for v in bert.values())
    moved = [k for k, v in want.items() if not torch.equal(bert[k],
                                                           v.float())]
    assert "layer_0.attention.query_proj.weight" in moved  # trained jointly
    pipe = GenerationPipeline(cfg, state.model, sampler="dpm",
                              num_inference_steps=2, micro_batch=2,
                              device="cpu")
    out = pipe.generate(["a person walks", "jump"], [40, 196])
    assert [o.shape for o in out] == [(40, 263), (196, 263)]
    assert all(np.isfinite(o).all() for o in out)


def test_deberta_run_evaluates(cli_run, tmp_path):
    finest = str(tmp_path / "finest.tar")
    _save_finest_tar(finest)
    result = eval_main([
        "--device", "cpu", "--batch_size", "4", "--sampler", "ddim",
        "--steps", "2", "--mm_num_samples", "4", "--mm_num_repeats", "3",
        "--mm_num_times", "2", "--diversity_times", "4",
        "--protocol_batch_size", "4", "--glove_dir", FIXTURE_GLOVE,
        "--run_dir", cli_run[0], "--dataset", "synthetic",
        "--max_samples", "8", "--replication_times", "1",
        "--evaluator_ckpt", finest, "--skip_joint_scores",
        "--log_file", str(tmp_path / "e.log")])
    for metric, per_model in result["summary"].items():
        for name, (mean, ci) in per_model.items():
            assert np.all(np.isfinite(mean)), (metric, name)


def test_deberta_run_exports_and_serves(cli_run, tmp_path):
    import json
    import urllib.request

    out = str(tmp_path / "export")
    export_main(["--run_dir", cli_run[0], "--out", out, "--use_ema",
                 "--dtype", "bfloat16"])
    srv = build_server(["--export_dir", out, "--device", "cpu", "--port",
                        "0", "--sampler", "dpm", "--steps", "2",
                        "--micro_batch", "2"])
    assert isinstance(srv.pipe.model.text_encoder, TD.DebertaTextEncoder)
    bert = srv.pipe.model.text_encoder.bert
    assert bert.rel_embeddings.dtype == torch.bfloat16
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/generate"
    try:
        req = urllib.request.Request(
            url, data=json.dumps({"texts": ["a person waves", ""],
                                  "lengths": [12, 30], "seed": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    assert body["shapes"] == [[12, 263], [30, 263]]
    assert all(np.isfinite(np.asarray(m)).all() for m in body["motions"])
