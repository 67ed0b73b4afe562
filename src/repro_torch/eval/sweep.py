"""Scenario-sweep harness: systems x environments, registry-driven (port of `repro.eval.sweep`).

One command evaluates any set of registered systems across the registered
envs over several seeds, and reports each cell's robust aggregates (IQM
and stratified-bootstrap 95% CI, `repro_torch.eval.stats`) and its greedy
evaluation rate.

Every (system, env) cell swept is emitted: runnable cells carry scores,
incompatible ones the registry's reason (`registry.compatibility`, the
reference's words), so the artifact doubles as the compatibility matrix.
Seeds go as lanes of one batch (`repro_torch.lanes`) where the reference
vmaps them: training is one seed-lane `train_anakin` run and evaluation
one lane-batched evaluator call.

Artifacts: ``results/port/BENCH_eval.json`` by default (the reference's
default, ``BENCH_eval.json`` at the root, is the JAX package's committed
artifact) and a markdown table beside it.  Each carries the port's
provenance, with ``"framework": "torch"``.
"""
from __future__ import annotations

import json
import math
import pathlib
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import lanes, resolve_device
from repro_torch.core.system import _eval_seed, seed_generators, train_anakin
from repro_torch.envs import REGISTRY as ENV_REGISTRY
from repro_torch.eval.evaluator import make_evaluator
from repro_torch.eval.stats import aggregate
from repro_torch.obs import ConsoleSink, provenance
from repro_torch.systems.registry import REGISTRY as SYS_REGISTRY
from repro_torch.systems.registry import compatibility, make_pair

DEFAULT_OUT = "results/port/BENCH_eval.json"

_console = ConsoleSink()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_on_env(system, seeds: Sequence[int], num_episodes: int, num_envs: int,
                    train_iterations: int = 0, train_num_envs: int = 8,
                    device=None) -> Dict[str, object]:
    """Evaluate one system on its env over ``seeds``; returns the JSON cell.

    The seeds are lanes: training (``train_iterations > 0``) is one
    seed-lane `train_anakin` run from seeds ``seeds``, otherwise each
    lane's train state is ``init_train`` from its seed's generator; the
    evaluation seeds are one draw from each lane's generator afterwards,
    as anakin's interleaved evaluations take them.  The evaluation is
    timed warm, best of 3, each call from a synchronised start to its
    last op.
    """
    device = resolve_device(device)
    num_seeds = len(seeds)
    eval_fn = make_evaluator(system, num_episodes, num_envs)
    horizon = int(system.env.horizon)
    eff_envs = min(num_envs, num_episodes)
    steps_per_call = math.ceil(num_episodes / eff_envs) * eff_envs * horizon

    if train_iterations > 0:
        st, _ = train_anakin(system, list(seeds), train_iterations, train_num_envs,
                             num_seeds=num_seeds, device=device)
        train, generators = st.train, st.key
    else:
        generators = seed_generators(list(seeds), num_seeds, device)
        train = lanes.stack([system.init_train(g) for g in generators])
    eval_seeds = _eval_seed(generators)

    metrics = eval_fn(train, eval_seeds)  # warm: first-use costs
    best = float("inf")
    for _ in range(3):  # best of 3: host noise swamps ms-scale eval calls
        _sync(device)
        t0 = time.perf_counter()
        metrics = eval_fn(train, eval_seeds)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    sps = num_seeds * steps_per_call / best

    team = metrics.episode_return.cpu().numpy()  # (num_seeds, num_episodes)
    return {
        "compatible": True,
        "returns": team.tolist(),
        "aggregates": aggregate(team),
        "per_agent_mean": {a: float(r.float().mean()) for a, r in metrics.agent_returns.items()},
        "mean_episode_length": float(metrics.episode_length.float().mean()),
        "steps_per_sec": float(sps),
        "horizon": horizon,
    }


def run_sweep(system_names: Optional[Sequence[str]] = None,
              env_names: Optional[Sequence[str]] = None, seeds: Sequence[int] = (0, 1, 2),
              num_episodes: int = 32, num_envs: int = 16, train_iterations: int = 0,
              out_path: str = DEFAULT_OUT, system_overrides: Optional[dict] = None,
              device=None) -> Dict[str, object]:
    """Sweep systems x envs; write ``out_path`` (JSON) and the markdown beside it.

    Incompatible cells are recorded with their reason, not skipped, so the
    artifact carries the whole support matrix.  ``system_overrides`` maps
    a system name to config-field overrides.  ``device`` defaults to CUDA
    and raises when there is none.
    """
    device = resolve_device(device)
    system_names = list(system_names) if system_names else sorted(SYS_REGISTRY)
    env_names = list(env_names) if env_names else sorted(ENV_REGISTRY)
    overrides = system_overrides or {}
    results: Dict[str, object] = {
        "framework": "torch",
        "provenance": provenance(device),
        "seeds": list(seeds),
        "num_episodes": num_episodes,
        "num_envs": num_envs,
        "train_iterations": train_iterations,
        "systems": {},
    }
    for sys_name in system_names:
        per_env: Dict[str, object] = {}
        results["systems"][sys_name] = {"envs": per_env}
        for env_name in env_names:
            t0 = time.perf_counter()
            reason = compatibility(sys_name, env_name)
            if reason is not None:
                per_env[env_name] = {"compatible": False, "reason": reason}
                _console.line(f"{sys_name:>10s} x {env_name:<18s}: skipped ({reason})")
                continue
            _, system = make_pair(sys_name, env_name, **overrides.get(sys_name, {}))
            cell = evaluate_on_env(system, seeds, num_episodes, num_envs, train_iterations,
                                   device=device)
            per_env[env_name] = cell
            agg = cell["aggregates"]
            lo, hi = agg["iqm_ci95"]
            _console.line(
                f"{sys_name:>10s} x {env_name:<18s}: IQM={agg['iqm']:8.3f} "
                f"[{lo:.3f}, {hi:.3f}]  mean={agg['mean']:8.3f}  "
                f"{cell['steps_per_sec']:,.0f} steps/s  "
                f"({time.perf_counter() - t0:.1f}s)"
            )

    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    md_path = out.with_suffix(".md")
    with open(md_path, "w") as f:
        f.write(to_markdown(results))
    _console.line(f"wrote {out} and {md_path}")
    return results


def to_markdown(results: Dict[str, object]) -> str:
    """Render the sweep as a systems x envs support/score matrix."""
    systems = list(results["systems"])
    env_names = sorted({e for s in systems for e in results["systems"][s]["envs"]})
    prov = results.get("provenance", {})
    lines = [
        "# Evaluation sweep (PyTorch port) — systems x environments",
        "",
        f"{len(results['seeds'])} seeds x {results['num_episodes']} episodes "
        f"per cell, {results['train_iterations']} training iterations, on "
        f"{prov.get('device_kind', 'an unrecorded device')}"
        f"{', ' + prov['power_limit'] if prov.get('power_limit') else ''}. "
        "Cells show IQM of team return [95% CI]; `--` marks incompatible "
        "(system, env) pairs.",
        "",
        "| system | " + " | ".join(env_names) + " |",
        "|---|" + "---|" * len(env_names),
    ]
    for sys_name in systems:
        cells = []
        for env_name in env_names:
            cell = results["systems"][sys_name]["envs"].get(env_name)
            if cell is None or not cell.get("compatible"):
                cells.append("--")
                continue
            agg = cell["aggregates"]
            lo, hi = agg["iqm_ci95"]
            cells.append(f"{agg['iqm']:.2f} [{lo:.2f}, {hi:.2f}]")
        lines.append(f"| {sys_name} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"
