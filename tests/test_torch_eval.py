"""The port's evaluation stack against the JAX package's, on the CPU.

The same flax params (seeded numpy draws, or the JAX wrapper's own init)
reach the port through ``models/evaluator_bridge.py``; the same numpy
inputs (from a seed) go through both. JAX runs on the CPU.

Tolerances: the evaluator modules in f32, the same math in another order
(torch's GRU against a masked ``lax.scan``) -> atol 1e-5 at small widths;
the released widths (GRU hidden 1024 over 12 steps) -> 1e-4 of the
largest co-embedding value. The metrics are the same numpy code -> equal.
``evaluation()`` on embeddings 1e-5 apart -> R-precision equal (no
near-ties at these sizes), every other metric within 1e-4 relative.
``generate_motion_embeddings`` against ``generate`` then embedding: the
same motions through the same encoder in other batch groupings -> 1e-6 of
the largest value.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.eval import evaluator_models as JEM
from motiondiffusion_moe_tpu.eval import metrics as JM
from motiondiffusion_moe_tpu.eval import protocol as JP
from motiondiffusion_moe_tpu.eval import word_vectorizer as JW
from motiondiffusion_moe_tpu_torch.eval import evaluator_models as EM
from motiondiffusion_moe_tpu_torch.eval import metrics as M
from motiondiffusion_moe_tpu_torch.eval import protocol as P
from motiondiffusion_moe_tpu_torch.eval import word_vectorizer as W
from motiondiffusion_moe_tpu_torch.models.evaluator_bridge import (
    evaluator_jax_to_state_dict,
    evaluator_wrapper_state_dicts,
)
from motiondiffusion_moe_tpu_torch.models.layers import init_weights
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

from tests._torch_parity import random_params, t, tiny_config, to_port

FIXTURE_GLOVE = os.path.join(os.path.dirname(__file__), "fixtures", "glove")
ATOL = 1e-5


def _n(*shape, seed=0, s=1.0):
    return (s * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _port(module, params):
    module.load_state_dict(evaluator_jax_to_state_dict(params), strict=True)
    return module.eval()


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


# ------------------------------------------------------------------ modules

def test_masked_bigru_ragged_lengths_match_jax():
    """seq (padded frames included: zero at t >= length) and last, rows in
    input order with unsorted lengths, 1 and T among them."""
    B, T, D, H = 5, 7, 5, 6
    x, h0 = _n(B, T, D), _n(2, B, H, seed=1)
    lengths = np.array([3, 7, 1, 5, 7], np.int32)
    jmod = JEM.MaskedBiGRU(hidden_size=H)
    params = random_params(jmod, x, lengths, h0)
    port = _port(EM.MaskedBiGRU(D, H), params)
    for init in (h0, None):
        seq, last = jmod.apply({"params": params}, x, lengths, init)
        with torch.no_grad():
            pseq, plast = port(t(x), lengths,
                               None if init is None else t(init))
        _close(pseq.numpy(), seq)
        _close(plast.numpy(), last)
        for i, L in enumerate(lengths):
            assert np.all(pseq[i, L:].numpy() == 0.0)
    with pytest.raises(ValueError):
        port(t(x), np.array([0, 7, 1, 5, 7]))


def _decoder_init(m, latent, inputs, p, *rng):
    return m(inputs, m.get_init_hidden(latent), p, *rng)


def _decoder_run(m, latent, inputs, p, *rng):
    hidden = m.get_init_hidden(latent)
    out = m(inputs, hidden, p, *rng)
    return out, hidden


CASES = {
    "movement_conv_encoder": (
        lambda: JEM.MovementConvEncoder(hidden_size=8, output_size=6),
        lambda: EM.MovementConvEncoder(10, 8, 6),
        lambda: [_n(2, 12, 10)]),
    "movement_conv_decoder": (
        lambda: JEM.MovementConvDecoder(hidden_size=8, output_size=5),
        lambda: EM.MovementConvDecoder(6, 8, 5),
        lambda: [_n(2, 3, 6)]),
    "text_encoder_bigru_co": (
        lambda: JEM.TextEncoderBiGRUCo(hidden_size=8, output_size=6),
        lambda: EM.TextEncoderBiGRUCo(10, 5, 8, 6),
        lambda: [_n(3, 6, 10), _n(3, 6, 5, seed=1),
                 np.array([4, 6, 1], np.int32)]),
    "motion_encoder_bigru_co": (
        lambda: JEM.MotionEncoderBiGRUCo(hidden_size=8, output_size=6),
        lambda: EM.MotionEncoderBiGRUCo(7, 8, 6),
        lambda: [_n(3, 5, 7), np.array([5, 2, 1], np.int32)]),
    "motion_len_estimator_bigru": (
        lambda: JEM.MotionLenEstimatorBiGRU(hidden_size=8, output_size=9),
        lambda: EM.MotionLenEstimatorBiGRU(10, 5, 8, 9),
        lambda: [_n(3, 6, 10), _n(3, 6, 5, seed=1),
                 np.array([6, 2, 3], np.int32)]),
    "text_encoder_bigru": (
        lambda: JEM.TextEncoderBiGRU(hidden_size=8),
        lambda: EM.TextEncoderBiGRU(10, 5, 8),
        lambda: [_n(3, 6, 10), _n(3, 6, 5, seed=1),
                 np.array([6, 1, 4], np.int32)]),
    "att_layer": (
        lambda: JEM.AttLayer(value_dim=5),
        lambda: EM.AttLayer(6, 7, 5),
        lambda: [_n(3, 6), _n(3, 4, 7, seed=1)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluator_module_matches_jax(name):
    make_jax, make_port, make_args = CASES[name]
    jmod, args = make_jax(), make_args()
    params = random_params(jmod, *args)
    ref = jmod.apply({"params": params}, *args)
    port = _port(make_port(), params)
    with torch.no_grad():
        out = port(*[t(a) if a.dtype == np.float32 else a for a in args])
    for o, r in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(ref)):
        _close(o.numpy(), r)


@pytest.mark.parametrize("kind", ["vae", "text"])
def test_gru_cell_decoders_match_jax(kind):
    """TextVAEDecoder / TextDecoder: z2init into 2 GRU cells, the
    positional encoding at p = 3, flax's LayerNorm epsilon (1e-6); the
    TextDecoder's reparameterization noise injected from JAX's draw."""
    B, text, inp, out, hid = 3, 4, 5, 6, 8
    latent, inputs = _n(B, text), _n(B, inp, seed=1)
    rng = jax.random.key(3)
    if kind == "vae":
        jmod = JEM.TextVAEDecoder(text_size=text, input_size=inp,
                                  output_size=out, hidden_size=hid,
                                  n_layers=2, max_len=20)
        port = EM.TextVAEDecoder(text, inp, out, hid, 2, max_len=20)
        extra = ()
    else:
        jmod = JEM.TextDecoder(text_size=text, input_size=inp,
                               output_size=out, hidden_size=hid, n_layers=2,
                               max_len=20)
        port = EM.TextDecoder(text, inp, out, hid, 2, max_len=20)
        extra = (rng,)
    params = random_params(jmod, latent, inputs, 3, *extra,
                           method=_decoder_init)
    (ref, ref_hidden) = jmod.apply({"params": params}, latent, inputs, 3,
                                   *extra, method=_decoder_run)
    _port(port, params)
    assert port.emb[1].eps == 1e-6
    with torch.no_grad():
        hidden = port.get_init_hidden(t(latent))
        if kind == "vae":
            got = port(t(inputs), hidden, 3)
        else:
            eps = jax.random.normal(rng, (B, out), jnp.float32)
            got = port(t(inputs), hidden, 3, eps=t(eps))
    for o, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        _close(o.numpy(), r)
    for h, r in zip(hidden, ref_hidden):
        _close(h.numpy(), r)


def test_tables_reparameterize_and_contrastive_loss():
    np.testing.assert_array_equal(
        EM.positional_encoding_table(30, 8).numpy(),
        np.asarray(JEM.positional_encoding_table(30, 8)))
    mu, logvar = _n(4, 3), _n(4, 3, seed=1, s=0.3)
    rng = jax.random.key(0)
    eps = np.asarray(jax.random.normal(rng, (4, 3), jnp.float32))
    _close(EM.reparameterize(t(mu), t(logvar), eps=t(eps)).numpy(),
           JEM.reparameterize(rng, mu, logvar))
    g = torch.Generator().manual_seed(0)
    a = EM.reparameterize(t(mu), t(logvar), generator=g)
    b = EM.reparameterize(t(mu), t(logvar),
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, t(mu))
    o1, o2 = _n(5, 4), _n(5, 4, seed=1)
    for label in (np.array([0, 1, 0, 1, 1], np.float32),
                  np.array([[0], [1], [0], [1], [1]], np.float32)):
        _close(EM.contrastive_loss(t(o1), t(o2), t(label)).numpy(),
               JEM.contrastive_loss(o1, o2, label))


# ------------------------------------------------------- finest.tar, wrapper

def _save_finest_tar(path: str, dim_pose: int = 263) -> None:
    """A finest.tar with the released layout and shapes (the reference's
    torch modules), seeded weights."""
    from torch import nn as tnn

    torch.manual_seed(7)
    mov = tnn.Module()
    mov.main = tnn.Sequential(
        tnn.Conv1d(dim_pose - 4, 512, 4, 2, 1), tnn.Dropout(0.2),
        tnn.LeakyReLU(0.2), tnn.Conv1d(512, 512, 4, 2, 1),
        tnn.Dropout(0.2), tnn.LeakyReLU(0.2))
    mov.out_net = tnn.Linear(512, 512)

    def bigru_co(input_size, hidden, with_pos):
        m = tnn.Module()
        if with_pos:
            m.pos_emb = tnn.Linear(15, 300)
        m.input_emb = tnn.Linear(input_size, hidden)
        m.gru = tnn.GRU(hidden, hidden, batch_first=True, bidirectional=True)
        m.output_net = tnn.Sequential(
            tnn.Linear(hidden * 2, hidden), tnn.LayerNorm(hidden),
            tnn.LeakyReLU(0.2), tnn.Linear(hidden, 512))
        m.hidden = tnn.Parameter(torch.randn(2, 1, hidden))
        return m

    torch.save({"movement_encoder": mov.state_dict(),
                "text_encoder": bigru_co(300, 512, True).state_dict(),
                "motion_encoder": bigru_co(512, 1024, False).state_dict(),
                "epoch": 3}, path)


def test_finest_tar_read_by_both_packages(tmp_path):
    path = str(tmp_path / "finest.tar")
    _save_finest_tar(path)
    B, T_m, T_w = 3, 48, 10
    motions = _n(B, T_m, 263)
    m_lens = np.array([36, 48, 24], np.int32)  # unsorted: input order kept
    word_embs, pos = _n(B, T_w, 300, seed=1), _n(B, T_w, 15, seed=2)
    cap_lens = np.array([7, 10, 4], np.int32)
    jw = JEM.EvaluatorModelWrapper.from_torch_checkpoint(path, dim_pose=263)
    j_te, j_me = jw.get_co_embeddings(word_embs, pos, cap_lens, motions,
                                      m_lens)
    pw = EM.EvaluatorModelWrapper.from_torch_checkpoint(path, dim_pose=263,
                                                        device="cpu")
    p_te, p_me = pw.get_co_embeddings(word_embs, pos, cap_lens, motions,
                                      m_lens)
    assert p_te.shape == p_me.shape == (B, 512) and pw.embed_dim == 512
    for p, j in ((p_te, j_te), (p_me, j_me)):
        np.testing.assert_allclose(p, j, atol=1e-4 * np.abs(j).max())
    # the bridge inverts the JAX reader: the same weights, bit for bit
    bridged = evaluator_wrapper_state_dicts(jax.device_get(jw.params))
    for key, module in pw.encoders().items():
        sd = module.state_dict()
        assert sorted(sd) == sorted(bridged[key])
        for name, v in sd.items():
            assert torch.equal(v, bridged[key][name]), (key, name)


def test_wrapper_random_init_is_seeded_and_checks_lengths():
    a = EM.EvaluatorModelWrapper(dim_pose=20, device="cpu", seed=1)
    b = EM.EvaluatorModelWrapper(dim_pose=20, device="cpu", seed=1)
    c = EM.EvaluatorModelWrapper(dim_pose=20, device="cpu", seed=2)
    motions, lens = _n(2, 16, 20), np.array([16, 8])
    ea = a.get_motion_embeddings(motions, lens)
    np.testing.assert_array_equal(ea, b.get_motion_embeddings(motions, lens))
    assert not np.allclose(ea, c.get_motion_embeddings(motions, lens))
    assert a.movement_enc.main[0].weight.device.type == "cpu"
    with pytest.raises(ValueError):  # 3 // 4 = 0 movement frames
        a.get_motion_embeddings(motions, np.array([16, 3]))


# ------------------------------------------------------------------ metrics

def test_metrics_equal_the_jax_package():
    e1, e2 = _n(12, 8), _n(12, 8, seed=1)
    rng = lambda: np.random.default_rng(5)  # noqa: E731
    for name, args in (
            ("euclidean_distance_matrix", (e1, e2)),
            ("calculate_R_precision", (e1, e2, 3)),
            ("calculate_matching_score", (e1, e2)),
            ("calculate_activation_statistics", (e1,)),
            ("get_metric_statistics", (e1, 12))):
        got, ref = getattr(M, name)(*args), getattr(JM, name)(*args)
        for p, j in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(
        M.calculate_R_precision(e1, e2, 3, sum_all=True),
        JM.calculate_R_precision(e1, e2, 3, sum_all=True))
    assert (M.calculate_diversity(e1, 5, rng()) ==
            JM.calculate_diversity(e1, 5, rng()))
    mm = _n(3, 6, 8)
    assert (M.calculate_multimodality(mm, 4, rng()) ==
            JM.calculate_multimodality(mm, 4, rng()))
    (mu1, s1), (mu2, s2) = (M.calculate_activation_statistics(e1),
                            M.calculate_activation_statistics(e2))
    assert (M.calculate_frechet_distance(mu1, s1, mu2, s2) ==
            JM.calculate_frechet_distance(mu1, s1, mu2, s2))
    mae, vel, jerk, pae = P.score_mae_velocity_jerk(_n(2, 9, 4, 3),
                                                    _n(2, 9, 4, 3, seed=1))
    ref = JP.score_mae_velocity_jerk(_n(2, 9, 4, 3), _n(2, 9, 4, 3, seed=1))
    np.testing.assert_array_equal(mae, ref[0])
    assert (vel, jerk) == ref[1:3]
    np.testing.assert_array_equal(pae, ref[3])


def test_word_vectorizers_equal_the_jax_package():
    wv, jwv = W.get_word_vectorizer(FIXTURE_GLOVE), JW.get_word_vectorizer(
        FIXTURE_GLOVE)
    assert isinstance(wv, W.WordVectorizer) and len(wv) == len(jwv) == 29
    hv, jhv = W.get_word_vectorizer("/nonexistent"), JW.HashedWordVectorizer()
    assert isinstance(hv, W.HashedWordVectorizer)
    for item in ("person/NOUN", "left/NOUN", "walk/VERB", "xyzzy/VERB",
                 "walks/ADJ"):
        for port, ref in ((wv, jwv), (hv, jhv)):
            for p, j in zip(port[item], ref[item]):
                np.testing.assert_array_equal(p, j)
    assert W.POS_enumerator == JW.POS_enumerator
    tokens = ["a/DET", "person/NOUN", "walk/VERB"]
    for p, j in zip(P.vectorize_tokens(tokens, wv, 5),
                    JP.vectorize_tokens(tokens, jwv, 5)):
        np.testing.assert_array_equal(p, j)


# ----------------------------------------------------------------- protocol

D_POSE, T_MAX = 20, 32


def _eval_samples(n=10):
    rng = np.random.default_rng(0)
    samples = []
    for i in range(n):
        L = int(rng.integers(12, T_MAX + 1))
        motion = np.zeros((T_MAX, D_POSE), np.float32)
        motion[:L] = rng.standard_normal((L, D_POSE))
        words = ["a/DET", "person/NOUN", ["walk/VERB", "jump/VERB",
                                          "turn/VERB"][i % 3]]
        samples.append(JP.EvalSample(caption=f"caption {i}",
                                     tokens=words[: 1 + i % 3],
                                     motion=motion, m_length=L))
    return samples


def _generate(captions, lens, seed):
    """Deterministic 'generation': a motion from the caption and seed."""
    out = []
    for c, L in zip(captions, lens):
        r = np.random.default_rng([seed, int(c.split()[-1]), len(out)])
        out.append(r.standard_normal((L, D_POSE)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def wrappers():
    jw = JEM.EvaluatorModelWrapper(dim_pose=D_POSE, rng=jax.random.key(4))
    pw = EM.EvaluatorModelWrapper(
        dim_pose=D_POSE, device="cpu",
        state_dicts=evaluator_wrapper_state_dicts(jax.device_get(jw.params)))
    return jw, pw


@pytest.mark.parametrize("path", ["host", "embeddings"])
def test_evaluation_matches_jax(path, wrappers, tmp_path):
    jw, pw = wrappers
    samples = _eval_samples()
    port_samples = [P.EvalSample(s.caption, s.tokens, s.motion, s.m_length)
                    for s in samples]
    cfg = dict(mm_num_samples=3, mm_num_repeats=3, mm_num_times=2,
               diversity_times=4, replication_times=2, batch_size=4,
               max_motion_length=T_MAX)

    def embed_with(wrapper):
        def embed_generate(captions, lens, seed):
            motions = np.zeros((len(lens), T_MAX, D_POSE), np.float32)
            for i, m in enumerate(_generate(captions, lens, seed)):
                motions[i, :len(m)] = m
            return wrapper.get_motion_embeddings(motions, np.array(lens))
        return embed_generate if path == "embeddings" else None

    per_rep = {}
    got = P.evaluation(port_samples, _generate, pw, W.HashedWordVectorizer(),
                       str(tmp_path / "port.log"), P.ProtocolConfig(**cfg),
                       embed_generate=embed_with(pw),
                       per_replication=per_rep)
    ref = JP.evaluation(samples, _generate, jw, JW.HashedWordVectorizer(),
                        str(tmp_path / "jax.log"), JP.ProtocolConfig(**cfg),
                        embed_generate=embed_with(jw))
    assert list(got) == list(ref)
    for metric in ref:
        assert list(got[metric]) == list(ref[metric])
        for model in ref[metric]:
            for p, j in zip(got[metric][model], ref[metric][model]):
                if metric == "R_precision":
                    np.testing.assert_array_equal(p, j)
                else:
                    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-6)
            assert len(per_rep[metric][model]) == 2
    log = (tmp_path / "port.log").read_text()
    for key in ("Matching Score Summary", "R_precision Summary",
                "FID Summary", "Diversity Summary", "MultiModality Summary"):
        assert key in log


# -------------------------------------------- generate_motion_embeddings

@pytest.fixture(scope="module")
def tiny_pipe():
    cfg = to_port(tiny_config(num_layers=1))
    model = init_weights(MotionTransformer(cfg.model), 0)
    pipe = GenerationPipeline(cfg, model, sampler="ddim",
                              num_inference_steps=4, micro_batch=2,
                              device="cpu")
    wrapper = EM.EvaluatorModelWrapper(dim_pose=cfg.model.input_feats,
                                       device="cpu", seed=3)
    return cfg, pipe, wrapper


def test_generate_motion_embeddings_equal_embedding_generate(tiny_pipe):
    cfg, pipe, wrapper = tiny_pipe
    T, F = cfg.model.max_frames, cfg.model.input_feats
    captions = ["a person walks", "jump", "turn left", "", "wave"]
    lens = [16, 4, 9, 12, 7]  # 3 micro-batches of 2, the tail padded
    embs = pipe.generate_motion_embeddings(
        captions, lens, wrapper, generator=torch.Generator().manual_seed(3))
    motions = pipe.generate(captions, lens,
                            generator=torch.Generator().manual_seed(3))
    padded = np.zeros((len(lens), T, F), np.float32)
    for i, m in enumerate(motions):
        padded[i, :len(m)] = m
    ref = wrapper.get_motion_embeddings(padded, np.array(lens))
    assert embs.shape == (5, wrapper.embed_dim) and embs.dtype == np.float32
    np.testing.assert_allclose(embs, ref, atol=1e-6 * np.abs(ref).max())
    # another seed embeds other motions
    other = pipe.generate_motion_embeddings(captions, lens, wrapper)
    assert not np.allclose(other, embs)


def test_generate_motion_embeddings_checks_lengths(tiny_pipe):
    cfg, pipe, wrapper = tiny_pipe
    T = cfg.model.max_frames
    for lens in ([4, 0], [4, T + 1]):
        with pytest.raises(ValueError, match="outside"):
            pipe.generate_motion_embeddings(["a", "b"], lens, wrapper)
    with pytest.raises(ValueError, match="captions"):
        pipe.generate_motion_embeddings(["a", "b"], [4], wrapper)
    narrow = EM.EvaluatorModelWrapper(dim_pose=cfg.model.input_feats,
                                      device="cpu")
    narrow.motion_enc.output_net[-1] = torch.nn.Linear(1024, 64)
    empty = pipe.generate_motion_embeddings([], [], narrow)
    assert empty.shape == (0, 64) and empty.dtype == np.float32
