"""Per-phase timing from the runners' phase split (port of `repro.obs.phases`).

The anakin runner already splits one training iteration into the rollout
phase (`repro_torch.core.system._step_phase`: act, env step, dataset
write) and the update phase (`_do_updates`, the gated trainer updates).
The run record carries a micro-benchmark of each at the run's operating
point: each phase alone, warm, best of ``repeats``.  Every timed call
ends in a device synchronise, so a time is never a wall that ends before
the queued work does.

Where the reference times the update on a fresh dataset (its jitted
update runs the same program on any contents), the port fills the
dataset until the system's ``can_sample`` gate opens, as a run does, and
times the update there: an eager update on an empty replay table would
sample nothing.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from repro_torch import resolve_device

MAX_FILL_ITERATIONS = 100_000  # far past any registry config's min_replay / rollout_len


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(fn, device, repeats: int) -> float:
    """Best-of-``repeats`` seconds of ``fn()``, each from a synchronised start to its last op."""
    fn()  # warm: first-use builds and allocations
    best = float("inf")
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_phase_timing(system, num_envs: int, seed: int = 0, eval_episodes: int = 0,
                         eval_num_envs: Optional[int] = None, repeats: int = 3,
                         device=None) -> Dict[str, float]:
    """Seconds a phase for one iteration of ``system`` at ``num_envs``.

    Returns ``{"rollout_seconds", "update_seconds"}`` (one `_step_phase`
    call; one `_do_updates` block on a dataset that is ready) and, with
    ``eval_episodes``, ``"eval_seconds"`` (one evaluator call).  Raises
    when the dataset is not ready after `MAX_FILL_ITERATIONS`.
    """
    from repro_torch.core.system import (
        _do_updates,
        _step_phase,
        _training_env,
        init_system_state,
    )

    device = resolve_device(device)
    tenv = _training_env(system.env)
    generator = torch.Generator(device).manual_seed(seed)
    st = init_system_state(system, generator, num_envs, train_env=tenv)

    def step():
        with torch.no_grad():
            return _step_phase(system, tenv, st)[0]

    out: Dict[str, float] = {"rollout_seconds": _best_of(step, device, repeats)}
    for _ in range(MAX_FILL_ITERATIONS):
        if system.can_sample(st.buffer):
            break
        st = step()
    else:
        raise RuntimeError(f"the dataset is not ready after {MAX_FILL_ITERATIONS} iterations")
    out["update_seconds"] = _best_of(
        lambda: _do_updates(system, st.train, st.buffer, generator), device, repeats)
    if eval_episodes > 0:
        from repro_torch.eval.evaluator import make_evaluator

        eval_fn = make_evaluator(system, eval_episodes, eval_num_envs or num_envs)
        out["eval_seconds"] = _best_of(lambda: eval_fn(st.train, seed), device, repeats)
    return out
