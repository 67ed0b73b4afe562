"""Env-backed synthetic traffic for the decision-serving engine (port of `repro.serve.traffic`).

A reproducible stand-in for many users: ``N`` concurrent user streams,
each submitting episode requests with exponential inter-arrival gaps (a
Poisson process a stream), merged into one arrival sequence counted in
engine ticks.  The arrivals come from ``np.random.default_rng(seed)`` in
the reference's order, so a (seed, streams, rate) triple gives the
reference's ticks and uids exactly.  Each request's episode seed is
derived from ``seed`` and its (stream, index) coordinates, where the
reference folds them into a JAX key.

`serve_workload` drives a `DecisionEngine` through one such trace and
reduces its ``tick_log``: every decision made in a tick waited that
tick's wall time, so the per-decision latency distribution is the tick
times weighted by live-slot counts.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serve.engine import DecisionEngine, ServeRequest


def request_seed(seed: int, stream: int, index: int) -> int:
    """The episode seed of a stream's ``index``-th request: a hash of the three."""
    return int(np.random.SeedSequence([seed, stream, index]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def poisson_requests(num_streams: int, episodes_per_stream: int, arrival_rate: float,
                     seed: int = 0) -> List[ServeRequest]:
    """Poisson arrivals over ``num_streams`` concurrent streams.

    Each stream emits ``episodes_per_stream`` requests with exponential
    gaps of rate ``arrival_rate`` (requests a tick a stream); streams are
    merged and sorted by arrival tick (ties by stream, then index, so
    admission order is fixed).  ``ServeRequest.arrival_tick`` holds the
    tick, uids number the merged sequence 0..R-1, and ``seed`` is
    `request_seed` of the request's coordinates.
    """
    if arrival_rate <= 0:
        raise ValueError(f"arrival_rate must be > 0, got {arrival_rate}")
    rng = np.random.default_rng(seed)
    arrivals = []  # (tick, stream, index)
    for s in range(num_streams):
        gaps = rng.exponential(1.0 / arrival_rate, size=episodes_per_stream)
        ticks = np.floor(np.cumsum(gaps)).astype(np.int64)
        for j, t in enumerate(ticks):
            arrivals.append((int(t), s, j))
    arrivals.sort()
    return [ServeRequest(uid=uid, seed=request_seed(seed, s, j), arrival_tick=tick)
            for uid, (tick, s, j) in enumerate(arrivals)]


def serve_workload(engine: DecisionEngine, requests: Sequence[ServeRequest],
                   max_ticks: int = 1_000_000) -> Dict:
    """Replay an arrival trace through ``engine`` and reduce the stats.

    Requests are submitted when the engine's tick clock passes their
    ``arrival_tick``; idle gaps between arrivals are skipped rather than
    ticked through.  Returns `workload_stats` of the ticks served.
    """
    pending = sorted(requests, key=lambda r: (r.arrival_tick, r.uid))
    first_logged = len(engine.tick_log)
    first_finished = len(engine.finished)
    clock = 0
    i = 0
    for _ in range(max_ticks):
        while i < len(pending) and pending[i].arrival_tick <= clock:
            engine.submit(pending[i])
            i += 1
        if engine.idle():
            if i >= len(pending):
                break
            clock = pending[i].arrival_tick  # skip the idle gap
            continue
        engine.tick()
        clock += 1
    return workload_stats(engine.tick_log[first_logged:], engine.finished[first_finished:])


def workload_stats(tick_log: Sequence[Dict], finished: Sequence[ServeRequest]) -> Dict:
    """Reduce a tick log and finished episodes to the serving artifact's cell block."""
    if not tick_log:
        raise ValueError("empty tick log: the workload never served a decision")
    seconds = np.asarray([t["seconds"] for t in tick_log], np.float64)
    live = np.asarray([t["live"] for t in tick_log], np.int64)
    # each of a tick's `live` decisions experienced that tick's wall time
    per_decision = np.repeat(seconds, live)
    total = float(seconds.sum())
    decisions = int(live.sum())
    returns = [r.episode_return for r in finished]
    return {
        "ticks": len(tick_log),
        "decisions": decisions,
        "episodes": len(finished),
        "decisions_per_sec": decisions / total if total > 0 else 0.0,
        "latency": {
            "p50_ms": float(np.percentile(per_decision, 50) * 1e3),
            "p99_ms": float(np.percentile(per_decision, 99) * 1e3),
            "mean_ms": float(per_decision.mean() * 1e3),
        },
        "mean_live_slots": float(live.mean()),
        "episode_return_mean": float(np.mean(returns)) if returns else 0.0,
        "wall_seconds": total,
    }
