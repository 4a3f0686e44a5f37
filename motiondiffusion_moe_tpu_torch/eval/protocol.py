"""The full evaluation protocol.

The port of ``motiondiffusion_moe_tpu/eval/protocol.py`` (the reference's
``text2motion/tools/evaluation.py`` and ``datasets1/evaluator.py``): per
replication, generate the evaluation set again through the sampling
pipeline (with the multimodality subset generated repeatedly), compute
Matching Score, R-precision (top 3), FID, Diversity and MultiModality
against the frozen contrastive evaluator, plus the MAE / velocity-error /
jerk-error joint-space scores; report the mean and 95% confidence interval
over replications.

Protocol constants (the reference's): mm_num_samples=100,
mm_num_repeats=30, mm_num_times=10, diversity_times=300,
replication_times=20, retrieval pools of 512.

The metric math is numpy on the host; replication r draws from
``np.random.default_rng(r)`` call for call as the JAX package does, so the
same embeddings give the same diversity and multimodality pairs.
Generation and the evaluator's embeddings run on the card
(``GenerationPipeline``, ``EvaluatorModelWrapper``).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, TextIO, Tuple

import numpy as np

from motiondiffusion_moe_tpu_torch.eval.evaluator_models import (
    EvaluatorModelWrapper,
)
from motiondiffusion_moe_tpu_torch.eval.metrics import (
    calculate_activation_statistics,
    calculate_diversity,
    calculate_frechet_distance,
    calculate_multimodality,
    calculate_top_k,
    euclidean_distance_matrix,
    get_metric_statistics,
)


@dataclass
class EvalSample:
    """One evaluation item: caption (tokenized for GloVe) + GT motion."""

    caption: str
    tokens: List[str]             # "word/POS" strings
    motion: np.ndarray            # [T, D] normalized
    m_length: int


@dataclass
class EvalBatch:
    word_embs: np.ndarray         # [B, L, 300]
    pos_ohots: np.ndarray         # [B, L, 15]
    captions: List[str]
    sent_lens: np.ndarray         # [B]
    motions: np.ndarray           # [B, T, D]
    m_lens: np.ndarray            # [B]


def vectorize_tokens(tokens: List[str], w_vectorizer, max_text_len: int = 20
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """sos/eos/unk framing exactly as ``dataset1.py:143-160``."""
    if len(tokens) < max_text_len:
        tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
        sent_len = len(tokens)
        tokens = tokens + ["unk/OTHER"] * (max_text_len + 2 - sent_len)
    else:
        tokens = tokens[:max_text_len]
        tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
        sent_len = len(tokens)
    embs, ohots = zip(*[w_vectorizer[t] for t in tokens])
    return (np.stack(embs).astype(np.float32),
            np.stack(ohots).astype(np.float32), sent_len)


def make_batches(samples: Sequence[EvalSample], w_vectorizer,
                 batch_size: int, max_text_len: int = 20) -> List[EvalBatch]:
    """Batch eval samples, DROPPING the ragged tail like the reference
    eval loaders (``datasets1/evaluator.py:331,387`` use
    ``drop_last=True``): a smaller final retrieval pool would bias
    R-precision/Matching Score (and a pool of <3 crashes top-3). The
    tail is kept only when the whole set is smaller than one batch."""
    n_full = (len(samples) // batch_size) * batch_size
    if 0 < n_full < len(samples):
        print(f"[protocol] dropping ragged tail: {len(samples) - n_full} "
              f"of {len(samples)} samples (batch_size={batch_size}, "
              f"reference drop_last semantics)")
        samples = samples[:n_full]
    batches = []
    for start in range(0, len(samples), batch_size):
        chunk = samples[start: start + batch_size]
        embs, ohots, lens = zip(*[
            vectorize_tokens(s.tokens, w_vectorizer, max_text_len)
            for s in chunk])
        batches.append(EvalBatch(
            word_embs=np.stack(embs),
            pos_ohots=np.stack(ohots),
            captions=[s.caption for s in chunk],
            sent_lens=np.asarray(lens, np.int32),
            motions=np.stack([s.motion for s in chunk]).astype(np.float32),
            m_lens=np.asarray([s.m_length for s in chunk], np.int32)))
    return batches


def snap_length(m_len: int, unit_length: int = 4, min_mov_length: int = 10,
                max_motion_length: int = 196) -> int:
    """Length snapping used when generating eval motions
    (``tools/evaluation.py:84-86``)."""
    return int(min(max(m_len // unit_length * unit_length,
                       min_mov_length * unit_length), max_motion_length))


def snap_length_random(m_len: int, unit_length: int = 4,
                       rng: Optional[np.random.Generator] = None) -> int:
    """The GT eval dataset's stochastic unit-length snapping
    (``datasets1/evaluator.py:283-294``): 2/3 probability floor to the unit
    ('single'), 1/3 probability one unit shorter ('double'); always 'single'
    when unit_length >= 10."""
    rng = rng or np.random.default_rng()
    if unit_length < 10:
        coin2 = rng.choice(["single", "single", "double"])
    else:
        coin2 = "single"
    if coin2 == "double":
        return (m_len // unit_length - 1) * unit_length
    return (m_len // unit_length) * unit_length


# GenerateFn(captions, m_lens, seed) -> list of [len_i, D] arrays
GenerateFn = Callable[[List[str], List[int], int], List[np.ndarray]]


def build_generated_samples(samples: Sequence[EvalSample],
                            generate: GenerateFn,
                            *,
                            mm_num_samples: int = 100,
                            mm_num_repeats: int = 30,
                            max_motion_length: int = 196,
                            unit_length: int = 4,
                            seed: int = 0,
                            rng: Optional[np.random.Generator] = None
                            ) -> Tuple[List[EvalSample], np.ndarray]:
    """Regenerate every eval motion; mm subset generated mm_num_repeats
    times (``datasets1/evaluator.py:16-121``). Returns (generated samples,
    mm_motions [mm_num_samples, mm_num_repeats, T, D])."""
    rng = rng or np.random.default_rng(seed)
    n = len(samples)
    mm_count = min(mm_num_samples, n)
    mm_idxs = np.sort(rng.choice(n, mm_count, replace=False))
    mm_set = set(int(i) for i in mm_idxs)

    captions: List[str] = []
    lens: List[int] = []
    owners: List[Tuple[int, bool]] = []   # (sample idx, is_mm_repeat)
    for i, s in enumerate(samples):
        L = snap_length(s.m_length, unit_length,
                        max_motion_length=max_motion_length)
        reps = mm_num_repeats if i in mm_set else 1
        for _ in range(reps):
            captions.append(s.caption)
            lens.append(L)
            owners.append((i, i in mm_set))

    outs = generate(captions, lens, seed)

    D = samples[0].motion.shape[-1]
    gen_samples: List[EvalSample] = [None] * n  # type: ignore
    mm_motions = np.zeros((mm_count, mm_num_repeats, max_motion_length, D),
                          np.float32)
    mm_lens = np.zeros((mm_count,), np.int32)
    mm_fill: Dict[int, int] = {}
    mm_order = {int(idx): k for k, idx in enumerate(mm_idxs)}
    for (i, is_mm), out, L in zip(owners, outs, lens):
        padded = np.zeros((max_motion_length, D), np.float32)
        padded[: out.shape[0]] = out[:max_motion_length]
        if gen_samples[i] is None:
            s = samples[i]
            gen_samples[i] = EvalSample(caption=s.caption, tokens=s.tokens,
                                        motion=padded, m_length=L)
        if is_mm:
            k = mm_order[i]
            j = mm_fill.get(i, 0)
            if j < mm_num_repeats:
                mm_motions[k, j] = padded
                mm_lens[k] = L
                mm_fill[i] = j + 1
    return list(gen_samples), (mm_motions, mm_lens)


# EmbedGenerateFn(captions, m_lens, seed) -> [len(captions), E] embedding
# rows (the fused sample-and-embed path,
# ``GenerationPipeline.generate_motion_embeddings``)
EmbedGenerateFn = Callable[[List[str], List[int], int], np.ndarray]


def build_generated_embeddings(samples: Sequence[EvalSample],
                               embed_generate: EmbedGenerateFn,
                               *,
                               mm_num_samples: int = 100,
                               mm_num_repeats: int = 30,
                               max_motion_length: int = 196,
                               unit_length: int = 4,
                               seed: int = 0,
                               rng: Optional[np.random.Generator] = None
                               ) -> Tuple[np.ndarray,
                                          Tuple[np.ndarray, np.ndarray]]:
    """``build_generated_samples`` with the motions never leaving the
    device: identical caption/length/mm-repeat schedule and identical rng
    consumption (one ``rng.choice`` for the mm subset), but the generator
    returns evaluator co-embedding rows. Returns (gen_embs [n, E],
    (mm_embs [mm, reps, E], mm_lens [mm]))."""
    rng = rng or np.random.default_rng(seed)
    n = len(samples)
    mm_count = min(mm_num_samples, n)
    mm_idxs = np.sort(rng.choice(n, mm_count, replace=False))
    mm_set = set(int(i) for i in mm_idxs)

    captions: List[str] = []
    lens: List[int] = []
    owners: List[Tuple[int, bool]] = []
    for i, s in enumerate(samples):
        L = snap_length(s.m_length, unit_length,
                        max_motion_length=max_motion_length)
        reps = mm_num_repeats if i in mm_set else 1
        for _ in range(reps):
            captions.append(s.caption)
            lens.append(L)
            owners.append((i, i in mm_set))

    embs = np.asarray(embed_generate(captions, lens, seed))
    assert embs.shape[0] == len(captions), (
        f"embed_generate returned {embs.shape[0]} rows for "
        f"{len(captions)} prompts")
    E = embs.shape[-1]
    gen_embs = np.zeros((n, E), embs.dtype)
    seen = np.zeros((n,), bool)
    mm_embs = np.zeros((mm_count, mm_num_repeats, E), embs.dtype)
    mm_lens = np.zeros((mm_count,), np.int32)
    mm_fill: Dict[int, int] = {}
    mm_order = {int(idx): k for k, idx in enumerate(mm_idxs)}
    for (i, is_mm), row, L in zip(owners, embs, lens):
        if not seen[i]:
            gen_embs[i] = row
            seen[i] = True
        if is_mm:
            k = mm_order[i]
            j = mm_fill.get(i, 0)
            if j < mm_num_repeats:
                mm_embs[k, j] = row
                mm_lens[k] = L
                mm_fill[i] = j + 1
    return gen_embs, (mm_embs, mm_lens)


# ---------------------------------------------------------------------------
# metric passes (tools/evaluation.py:144-319)
# ---------------------------------------------------------------------------

def _log(file: Optional[TextIO], msg: str) -> None:
    print(msg)
    if file is not None:
        print(msg, file=file, flush=True)


def _matching_from_pools(pools, name: str, file: Optional[TextIO]):
    """Accumulate Matching Score / R-precision / activations over
    (text_emb, motion_emb) retrieval pools (one pool = one protocol
    batch of 512)."""
    all_motion_embeddings = []
    matching_score_sum = 0.0
    top_k_count = np.zeros(3)
    all_size = 0
    for te, me in pools:
        dist_mat = euclidean_distance_matrix(te, me)
        matching_score_sum += dist_mat.trace()
        argsorted = np.argsort(dist_mat, axis=1)
        top_k_count = top_k_count + calculate_top_k(argsorted, 3).sum(axis=0)
        all_size += te.shape[0]
        all_motion_embeddings.append(me)
    matching_score = matching_score_sum / all_size
    R_precision = top_k_count / all_size
    _log(file, f"---> [{name}] Matching Score: {matching_score:.4f}")
    line = f"---> [{name}] R_precision: " + " ".join(
        f"(top {i+1}): {R_precision[i]:.4f}" for i in range(3))
    _log(file, line)
    return (matching_score, R_precision,
            np.concatenate(all_motion_embeddings, axis=0))


def evaluate_matching_score(eval_wrapper: EvaluatorModelWrapper,
                            batch_dict: Dict[str, List[EvalBatch]],
                            file: Optional[TextIO] = None):
    match_score_dict = OrderedDict()
    R_precision_dict = OrderedDict()
    activation_dict = OrderedDict()
    _log(file, "========== Evaluating Matching Score ==========")
    for name, batches in batch_dict.items():
        pools = (eval_wrapper.get_co_embeddings(
            b.word_embs, b.pos_ohots, b.sent_lens, b.motions, b.m_lens)
            for b in batches)
        (match_score_dict[name], R_precision_dict[name],
         activation_dict[name]) = _matching_from_pools(pools, name, file)
    return match_score_dict, R_precision_dict, activation_dict


def evaluate_matching_score_from_embeddings(
        eval_wrapper: EvaluatorModelWrapper,
        gt_batches: List[EvalBatch],
        gen_embs: np.ndarray,
        model_name: str,
        file: Optional[TextIO] = None):
    """The matching pass when generated motions were embedded ON DEVICE
    (``build_generated_embeddings``): the text side comes from the GT
    batches (generation preserves caption order, so the text pools are
    identical), the motion side from the precomputed rows."""
    match_score_dict = OrderedDict()
    R_precision_dict = OrderedDict()
    activation_dict = OrderedDict()
    _log(file, "========== Evaluating Matching Score ==========")
    gt_pools = []
    te_pools = []
    for b in gt_batches:
        te, me = eval_wrapper.get_co_embeddings(
            b.word_embs, b.pos_ohots, b.sent_lens, b.motions, b.m_lens)
        gt_pools.append((te, me))
        te_pools.append(te)
    (match_score_dict["ground truth"], R_precision_dict["ground truth"],
     activation_dict["ground truth"]) = _matching_from_pools(
        gt_pools, "ground truth", file)
    sizes = [b.motions.shape[0] for b in gt_batches]
    # make_batches drops the ragged tail (reference drop_last semantics);
    # gen_embs covers EVERY sample in order, so slice to the pooled rows
    assert sum(sizes) <= gen_embs.shape[0], (
        f"{gen_embs.shape[0]} generated embeddings vs "
        f"{sum(sizes)} GT rows")
    me_pools = np.split(gen_embs[:sum(sizes)], np.cumsum(sizes)[:-1])
    (match_score_dict[model_name], R_precision_dict[model_name],
     activation_dict[model_name]) = _matching_from_pools(
        zip(te_pools, me_pools), model_name, file)
    return match_score_dict, R_precision_dict, activation_dict


def evaluate_fid(eval_wrapper: EvaluatorModelWrapper,
                 gt_batches: List[EvalBatch],
                 activation_dict: Dict[str, np.ndarray],
                 file: Optional[TextIO] = None):
    eval_dict = OrderedDict()
    _log(file, "========== Evaluating FID ==========")
    gt_embs = np.concatenate([
        eval_wrapper.get_motion_embeddings(b.motions, b.m_lens)
        for b in gt_batches], axis=0)
    gt_mu, gt_cov = calculate_activation_statistics(gt_embs)
    for name, embs in activation_dict.items():
        mu, cov = calculate_activation_statistics(embs)
        fid = calculate_frechet_distance(gt_mu, gt_cov, mu, cov)
        _log(file, f"---> [{name}] FID: {fid:.4f}")
        eval_dict[name] = fid
    return eval_dict


def evaluate_diversity(activation_dict: Dict[str, np.ndarray],
                       diversity_times: int = 300,
                       file: Optional[TextIO] = None,
                       rng: Optional[np.random.Generator] = None):
    eval_dict = OrderedDict()
    _log(file, "========== Evaluating Diversity ==========")
    for name, embs in activation_dict.items():
        div = calculate_diversity(embs, diversity_times, rng=rng)
        eval_dict[name] = div
        _log(file, f"---> [{name}] Diversity: {div:.4f}")
    return eval_dict


def evaluate_multimodality(eval_wrapper: EvaluatorModelWrapper,
                           mm_dict: Dict[str, Tuple[np.ndarray, np.ndarray]],
                           mm_num_times: int = 10,
                           file: Optional[TextIO] = None,
                           rng: Optional[np.random.Generator] = None):
    eval_dict = OrderedDict()
    _log(file, "========== Evaluating MultiModality ==========")
    for name, (mm_motions, mm_lens) in mm_dict.items():
        if mm_motions.shape[0] == 0:
            eval_dict[name] = 0.0
            continue
        embs = []
        for k in range(mm_motions.shape[0]):
            reps = mm_motions[k]
            lens = np.full((reps.shape[0],), mm_lens[k], np.int32)
            embs.append(eval_wrapper.get_motion_embeddings(reps, lens)[None])
        embs = np.concatenate(embs, axis=0)
        mm = calculate_multimodality(embs, mm_num_times, rng=rng)
        eval_dict[name] = mm
        _log(file, f"---> [{name}] Multimodality: {mm:.4f}")
    return eval_dict


def evaluate_multimodality_from_embeddings(
        mm_embs_dict: Dict[str, np.ndarray],
        mm_num_times: int = 10,
        file: Optional[TextIO] = None,
        rng: Optional[np.random.Generator] = None):
    """``evaluate_multimodality`` when the [mm, reps, E] repeat embeddings
    were computed on device with the generation."""
    eval_dict = OrderedDict()
    _log(file, "========== Evaluating MultiModality ==========")
    for name, embs in mm_embs_dict.items():
        if embs.shape[0] == 0:
            eval_dict[name] = 0.0
            continue
        mm = calculate_multimodality(embs, mm_num_times, rng=rng)
        eval_dict[name] = mm
        _log(file, f"---> [{name}] Multimodality: {mm:.4f}")
    return eval_dict


def score_mae_velocity_jerk(predicted_joints: np.ndarray,
                            original_joints: np.ndarray):
    """MAE / velocity-error / jerk-error over [B, T, J, 3] joint arrays
    (``tools/evaluation.py:47-140``, minus the generation plumbing)."""
    assert predicted_joints.shape == original_joints.shape
    mae = np.mean(np.abs(predicted_joints - original_joints), axis=(1, 2, 3))
    pae = np.mean(np.abs(predicted_joints - original_joints), axis=(0, 1, 2))
    vel_p = np.diff(predicted_joints, axis=1)
    vel_o = np.diff(original_joints, axis=1)
    velocity_error = float(np.mean(np.abs(vel_p - vel_o)))
    jerk_p = np.diff(vel_p, axis=1)
    jerk_o = np.diff(vel_o, axis=1)
    jerk_error = float(np.mean(np.abs(jerk_p - jerk_o)))
    return mae, velocity_error, jerk_error, pae


# ---------------------------------------------------------------------------
# the replication loop (tools/evaluation.py:329-415)
# ---------------------------------------------------------------------------

@dataclass
class ProtocolConfig:
    mm_num_samples: int = 100
    mm_num_repeats: int = 30
    mm_num_times: int = 10
    diversity_times: int = 300
    replication_times: int = 20
    # the reference protocol's retrieval-pool size (tools/evaluation.py:
    # 423): R-precision/Matching Score are computed over pools of this
    # size, so a different value is NOT comparable to reference numbers
    batch_size: int = 512
    unit_length: int = 4
    max_motion_length: int = 196
    max_text_len: int = 20


def evaluation(gt_samples: Sequence[EvalSample],
               generate: Optional[GenerateFn],
               eval_wrapper: EvaluatorModelWrapper,
               w_vectorizer,
               log_file: str,
               cfg: ProtocolConfig = ProtocolConfig(),
               model_name: str = "model",
               embed_generate: Optional[EmbedGenerateFn] = None,
               per_replication: Optional[Dict[str, Dict[str, list]]] = None
               ) -> Dict[str, Dict[str, np.ndarray]]:
    """Run the full replicated protocol; returns mean/CI per metric.

    With ``embed_generate`` set, generated motions are embedded on the
    device with their sampling (``generate_motion_embeddings``) and never
    fetched to the host — identical metric math over the same pools;
    ``generate`` may then be None. ``per_replication``, when given, is
    filled with each metric's value per replication
    (``per_replication[metric][model]``, a list)."""
    all_metrics = per_replication if per_replication is not None else {}
    for key in ("Matching Score", "R_precision", "FID", "Diversity",
                "MultiModality"):
        all_metrics[key] = OrderedDict()
    with open(log_file, "w") as f:
        gt_batches = make_batches(gt_samples, w_vectorizer, cfg.batch_size,
                                  cfg.max_text_len)
        for replication in range(cfg.replication_times):
            rng = np.random.default_rng(replication)
            _log(f, f"==================== Replication {replication} "
                    f"====================")
            t0 = time.time()
            if embed_generate is not None:
                gen_embs, (mm_embs, _mm_lens) = build_generated_embeddings(
                    gt_samples, embed_generate,
                    mm_num_samples=cfg.mm_num_samples,
                    mm_num_repeats=cfg.mm_num_repeats,
                    max_motion_length=cfg.max_motion_length,
                    unit_length=cfg.unit_length,
                    seed=replication, rng=rng)
                _log(f, f"generation+device-embed took "
                        f"{time.time()-t0:.1f}s")
                t1 = time.time()
                mat, rprec, act = evaluate_matching_score_from_embeddings(
                    eval_wrapper, gt_batches, gen_embs, model_name, f)
            else:
                gen_samples, mm = build_generated_samples(
                    gt_samples, generate,
                    mm_num_samples=cfg.mm_num_samples,
                    mm_num_repeats=cfg.mm_num_repeats,
                    max_motion_length=cfg.max_motion_length,
                    unit_length=cfg.unit_length,
                    seed=replication, rng=rng)
                _log(f, f"generation took {time.time()-t0:.1f}s")
                gen_batches = make_batches(gen_samples, w_vectorizer,
                                           cfg.batch_size, cfg.max_text_len)
                batch_dict = {"ground truth": gt_batches,
                              model_name: gen_batches}
                t1 = time.time()
                mat, rprec, act = evaluate_matching_score(eval_wrapper,
                                                          batch_dict, f)
            t2 = time.time()
            _log(f, f"matching/R-precision embedding took {t2-t1:.1f}s")
            fid = evaluate_fid(eval_wrapper, gt_batches,
                               {model_name: act[model_name]}, f)
            div = evaluate_diversity(act, cfg.diversity_times, f, rng=rng)
            t3 = time.time()
            if embed_generate is not None:
                mm_res = evaluate_multimodality_from_embeddings(
                    {model_name: mm_embs}, cfg.mm_num_times, f, rng=rng)
            else:
                mm_res = evaluate_multimodality(
                    eval_wrapper, {model_name: mm}, cfg.mm_num_times, f,
                    rng=rng)
            t4 = time.time()
            _log(f, f"fid+diversity took {t3-t2:.1f}s, "
                    f"multimodality embedding took {t4-t3:.1f}s; "
                    f"replication total {t4-t0:.1f}s "
                    f"(generation {t1-t0:.1f}s)")

            for key, d in (("Matching Score", mat), ("R_precision", rprec),
                           ("FID", fid), ("Diversity", div),
                           ("MultiModality", mm_res)):
                for name, value in d.items():
                    all_metrics[key].setdefault(name, []).append(value)

        _log(f, f"\n\n!!! DONE !!!")
        summary: Dict[str, Dict[str, np.ndarray]] = {}
        for metric_name, metric_dict in all_metrics.items():
            _log(f, f"========== {metric_name} Summary ==========")
            summary[metric_name] = {}
            for model, values in metric_dict.items():
                mean, ci = get_metric_statistics(np.asarray(values),
                                                 cfg.replication_times)
                summary[metric_name][model] = (mean, ci)
                if np.ndim(mean) == 0:
                    _log(f, f"---> [{model}] Mean: {mean:.4f} "
                            f"CInterval: {ci:.4f}")
                else:
                    line = f"---> [{model}]"
                    for i in range(len(mean)):
                        line += f" (top {i+1}) Mean: {mean[i]:.4f} " \
                                f"CInt: {ci[i]:.4f};"
                    _log(f, line)
        return summary
