"""Evaluation metrics math (numpy / scipy, host-side).

The port's own copy of ``motiondiffusion_moe_tpu/eval/metrics.py``, the
reference's ``text2motion/utils/metrics.py`` with its numpy / scipy
semantics, plus ``get_metric_statistics`` (mean and 95% confidence interval
over replications). These run on small embedding sets on the host; the
expensive part of evaluation, generation and embedding, runs on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import linalg


def euclidean_distance_matrix(matrix1: np.ndarray,
                              matrix2: np.ndarray) -> np.ndarray:
    """Pairwise L2 distances [N1, N2] (``metrics.py:6-20``)."""
    assert matrix1.shape[1] == matrix2.shape[1]
    d1 = -2 * np.dot(matrix1, matrix2.T)
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(mat: np.ndarray, top_k: int) -> np.ndarray:
    """Cumulative top-k hit matrix (``metrics.py:22-36``, minus its debug
    prints)."""
    size = mat.shape[0]
    gt_mat = np.expand_dims(np.arange(size), 1).repeat(size, 1)
    bool_mat = mat == gt_mat
    correct_vec = False
    top_k_list = []
    for i in range(top_k):
        correct_vec = correct_vec | bool_mat[:, i]
        top_k_list.append(correct_vec[:, None])
    return np.concatenate(top_k_list, axis=1)


def calculate_R_precision(embedding1: np.ndarray, embedding2: np.ndarray,
                          top_k: int, sum_all: bool = False) -> np.ndarray:
    """(``metrics.py:39-45``)."""
    dist_mat = euclidean_distance_matrix(embedding1, embedding2)
    argsorted = np.argsort(dist_mat, axis=1)
    top_k_mat = calculate_top_k(argsorted, top_k)
    return top_k_mat.sum(axis=0) if sum_all else top_k_mat


def calculate_matching_score(embedding1: np.ndarray, embedding2: np.ndarray,
                             sum_all: bool = False):
    """Mean/sum co-embedding distance (``metrics.py:48-57``)."""
    assert embedding1.ndim == 2 and embedding1.shape == embedding2.shape
    dist = linalg.norm(embedding1 - embedding2, axis=1)
    return dist.sum(axis=0) if sum_all else dist


def calculate_activation_statistics(activations: np.ndarray
                                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, cov) (``metrics.py:61-71``)."""
    mu = np.mean(activations, axis=0)
    cov = np.cov(activations, rowvar=False)
    return mu, cov


def calculate_diversity(activation: np.ndarray, diversity_times: int,
                        rng: Optional[np.random.Generator] = None) -> float:
    """Mean distance of random pairs (``metrics.py:74-82``). ``rng`` added
    for reproducibility (reference uses global np.random)."""
    assert activation.ndim == 2
    assert activation.shape[0] > diversity_times
    rng = rng or np.random.default_rng()
    num_samples = activation.shape[0]
    first = rng.choice(num_samples, diversity_times, replace=False)
    second = rng.choice(num_samples, diversity_times, replace=False)
    dist = linalg.norm(activation[first] - activation[second], axis=1)
    return float(dist.mean())


def calculate_multimodality(activation: np.ndarray, multimodality_times: int,
                            rng: Optional[np.random.Generator] = None) -> float:
    """Mean intra-prompt pair distance (``metrics.py:85-93``)."""
    assert activation.ndim == 3
    assert activation.shape[1] > multimodality_times
    rng = rng or np.random.default_rng()
    num_per_sent = activation.shape[1]
    first = rng.choice(num_per_sent, multimodality_times, replace=False)
    second = rng.choice(num_per_sent, multimodality_times, replace=False)
    dist = linalg.norm(activation[:, first] - activation[:, second], axis=2)
    return float(dist.mean())


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2,
                               eps: float = 1e-6) -> float:
    """FID between two Gaussians, Sutherland-stable sqrtm path
    (``metrics.py:96-147``)."""
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape
    assert sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    tr_covmean = np.trace(covmean)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * tr_covmean)


def get_metric_statistics(values: np.ndarray, replication_times: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """mean and 95% confidence interval over replications
    (``tools/evaluation.py:322-326``)."""
    mean = np.mean(values, axis=0)
    std = np.std(values, axis=0)
    conf_interval = 1.96 * std / np.sqrt(replication_times)
    return mean, conf_interval
