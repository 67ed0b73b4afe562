"""Statistically-robust aggregate metrics (rliable-style, Agarwal et al. 2021).

A copy of `repro.eval.stats` (numpy only), kept in the port so that it
imports nothing of the JAX package; the tests hold it bitwise against it.

Point aggregates (mean, median, interquartile mean) plus stratified-bootstrap
confidence intervals over a ``(num_seeds, num_episodes)`` score matrix — the
"scientifically sound and statistically robust research" half of the Mava
pitch.  Pure numpy on the host: aggregation happens once per eval sweep, so
there is nothing to fuse, and host numpy keeps the bootstrap deterministic
and dtype-stable across accelerators.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np


def _as_matrix(scores) -> np.ndarray:
    """Coerce scores to (num_seeds, num_episodes); 1-D input is one seed."""
    x = np.asarray(scores, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"scores must be 1-D or 2-D, got shape {x.shape}")
    return x


def mean(scores) -> float:
    """Mean over the flattened score matrix."""
    return float(np.mean(_as_matrix(scores)))


def median(scores) -> float:
    """Median over the flattened score matrix."""
    return float(np.median(_as_matrix(scores)))


def iqm(scores) -> float:
    """Interquartile mean: mean of the middle 50% of all scores.

    Discards the bottom and top 25% (floor'd), falling back to the plain
    mean when fewer than 4 scores are available.
    """
    x = np.sort(_as_matrix(scores), axis=None)
    cut = int(np.floor(x.size * 0.25))
    return float(np.mean(x[cut : x.size - cut]))


def stratified_bootstrap_ci(
    scores,
    statistic: Callable[[np.ndarray], float] = iqm,
    num_resamples: int = 2000,
    confidence: float = 0.95,
    seed: int = 0,
) -> Tuple[float, float]:
    """Percentile bootstrap CI, stratified by seed.

    Each resample redraws episodes with replacement *within every seed row*
    (the stratification), recomputes ``statistic`` on the resampled matrix,
    and the CI is the central ``confidence`` mass of the resulting
    distribution.  Deterministic for a fixed ``seed``.
    """
    x = _as_matrix(scores)
    rng = np.random.default_rng(seed)
    n_seeds, n_eps = x.shape
    stats = np.empty(num_resamples)
    for i in range(num_resamples):
        idx = rng.integers(0, n_eps, size=(n_seeds, n_eps))
        stats[i] = statistic(np.take_along_axis(x, idx, axis=1))
    alpha = (1.0 - confidence) / 2.0
    lo, hi = np.quantile(stats, [alpha, 1.0 - alpha])
    return float(lo), float(hi)


def aggregate(
    scores,
    num_resamples: int = 2000,
    confidence: float = 0.95,
    seed: int = 0,
) -> Dict[str, object]:
    """The full rliable-style report for one (system, env) cell."""
    x = _as_matrix(scores)
    report: Dict[str, object] = {
        "mean": mean(x),
        "median": median(x),
        "iqm": iqm(x),
        "std": float(np.std(x)),
        "num_seeds": int(x.shape[0]),
        "num_episodes": int(x.shape[1]),
    }
    for name, stat in (("iqm", iqm), ("mean", mean)):
        lo, hi = stratified_bootstrap_ci(
            x, stat, num_resamples=num_resamples, confidence=confidence, seed=seed
        )
        report[f"{name}_ci{int(confidence * 100)}"] = [lo, hi]
    return report
