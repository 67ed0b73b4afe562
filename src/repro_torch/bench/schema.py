"""Artifact schema checks of the port: BENCH_eval / BENCH_speed / BENCH_serve / run records.

Port of `repro.bench.schema`, with the same checkers and the same
coverage pins.  The port's artifacts (``results/port/BENCH_*.json`` from
`repro_torch.launch.bench_marl`, ``eval_marl`` and ``serve_marl``, and the
``run.json`` records of ``train_marl --log-dir``) carry the same keys as
the reference's, so downstream tooling reads them alike; what differs is
the provenance block, which is `repro_torch.obs.provenance`'s:
``torch_version`` stands where the reference has ``jax_version``, and a
document made on a GPU (``backend == "cuda"``) must name the card and its
power limit (``gpu``, ``power_limit``, as ``nvidia-smi`` prints them), so
no port number travels without them.  docs/PORT_BENCH.md lists every
difference.

It imports nothing but the standard library (no torch, no numpy), so a
script can load it from its file (``scripts/check_port_bench_schema.py``).
Each checker returns a list of human-readable problems, empty when the
document conforms.
"""
from __future__ import annotations

import json
from typing import Dict, List

_AGGREGATE_KEYS = (
    "mean", "median", "iqm", "std", "num_seeds", "num_episodes",
    "iqm_ci95", "mean_ci95",
)
_RUNNER_KEYS = ("python_loop", "anakin", "shard_map")
_SEEDVEC_KEYS = (
    "num_seeds", "serial_steps_per_sec", "vmapped_steps_per_sec", "speedup",
)
# the optional per-cell fused-recurrent rung (recurrent systems only):
# anakin with the linear associative-scan core vs the reference GRU core
_FUSED_RECURRENT_NUM_KEYS = (
    "reference_steps_per_sec", "fused_steps_per_sec", "speedup",
)
# the optional per-cell async actor/learner rung (repro_torch.distributed.impala):
# one row per actor count, throughput scaling with actor replicas
_ASYNC_ROW_NUM_KEYS = ("num_actors", "steps_per_sec", "env_steps", "wall_seconds")
# the provenance block (produced by repro_torch.obs.record.provenance)
# required on every artifact: string fields + the device count, and on a
# GPU the card's name and power limit
_PROVENANCE_STR_KEYS = (
    "git_sha", "torch_version", "backend", "device_kind", "timestamp",
)
_CUDA_PROVENANCE_KEYS = ("gpu", "power_limit")
# the required sections of a run record (repro_torch.obs.record.RunRecord)
_RUN_RECORD_SECTIONS = ("provenance", "config", "timing", "metrics")
_RUN_TIMING_KEYS = ("total_seconds", "compile_seconds", "steady_seconds")
_RUN_RETRACE_KEYS = ("jaxpr_traces", "backend_compiles", "compile_seconds")

# The coverage pins of a full artifact (smoke runs emit partial slices and
# are validated without them).  Literal copies of the registries (this
# module imports nothing of the package, so a script can file-load it), so
# growing either registry means growing these tuples in the same change: a
# new system/env that never lands in a full matrix fails `--full`
# validation.  The port's registries hold the reference's names.
FULL_MATRIX_SYSTEMS = (
    "dial", "ippo", "mad4pg", "maddpg", "madqn", "madqn-fp", "mappo",
    "qmix", "rec_ippo", "rec_madqn", "rec_mappo", "rial", "vdn",
)
FULL_MATRIX_ENVS = (
    "lbf", "matrix_game", "robot_warehouse", "smax_lite",
    "speaker_listener", "spread", "switch_game",
)
SPEED_SLICE_SYSTEMS = ("vdn", "ippo", "rec_ippo")
# a full slice's async actor/learner coverage: every runnable speed-slice
# cell must carry an async_actors rung at exactly these actor counts, and
# at least MIN_ASYNC_MONOTONIC_CELLS of them must show steps/sec increasing
# monotonically with actor count (the rung's whole point: throughput scales
# with actor replicas instead of being bound by the lockstep scan)
ASYNC_ACTOR_COUNTS = (1, 2, 4)
MIN_ASYNC_MONOTONIC_CELLS = 2
# a full slice's fused-recurrent coverage: the recurrent speed-slice system
# must carry a fused_recurrent rung on the matrix game plus one gridworld,
# so the rec/ff gap number stays comparable across PRs
FUSED_RECURRENT_SYSTEM = "rec_ippo"
FUSED_RECURRENT_ENVS = ("matrix_game", "lbf")
# a full BENCH_serve's coverage: a feed-forward and a recurrent system
# must each be served at >= MIN_SERVE_SLOT_COUNTS distinct slot-pool sizes
# (the artifact's whole point is latency/throughput *vs slot count*)
SERVE_SLICE_SYSTEMS = ("ippo", "rec_ippo")
MIN_SERVE_SLOT_COUNTS = 2
_SERVE_CONFIG_NUM_KEYS = (
    "streams", "episodes_per_stream", "arrival_rate", "seed",
)
_SERVE_LATENCY_KEYS = ("p50_ms", "p99_ms", "mean_ms")
_SERVE_CELL_NUM_KEYS = ("ticks", "decisions", "episodes", "wall_seconds")


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def check_provenance(doc: Dict) -> List[str]:
    """Problems with a document's ``provenance`` block.

    Every artifact (BENCH_eval / BENCH_speed / BENCH_serve / run records)
    must say where it came from: git sha, torch version, backend + device
    kind, device count and a timestamp, and on a GPU the card's name and
    power limit: the block `repro_torch.obs.record.provenance` emits,
    pinned here so artifacts can't silently drop their origin.
    """
    errs: List[str] = []
    prov = doc.get("provenance")
    if not isinstance(prov, dict):
        return ["missing top-level 'provenance' object"]
    for k in _PROVENANCE_STR_KEYS:
        if not isinstance(prov.get(k), str) or not prov.get(k):
            errs.append(f"provenance.{k} must be a non-empty string")
    if not _num(prov.get("num_devices")):
        errs.append("provenance.num_devices must be a number")
    if prov.get("backend") == "cuda":
        for k in _CUDA_PROVENANCE_KEYS:
            if not isinstance(prov.get(k), str) or not prov.get(k):
                errs.append(f"provenance.{k} must be a non-empty string on a GPU")
    return errs


def check_run_record(doc: Dict) -> List[str]:
    """Problems with a ``run.json`` run record (schema in
    docs/OBSERVABILITY.md; the port's differences in
    docs/PORT_OBSERVABILITY.md).

    Required: ``run_id``, the provenance block, a ``config`` object, a
    ``timing`` object with the total/compile/steady wall split, and a
    ``metrics`` object.  Optional sections are type-checked when present:
    ``timing.phases`` (numbers), ``retrace`` (the `RetraceCounter`
    summary) and ``profile`` (``trace_dir`` + optional roofline numbers).
    """
    errs: List[str] = []
    if not isinstance(doc.get("run_id"), str) or not doc.get("run_id"):
        errs.append("run_id must be a non-empty string")
    for section in _RUN_RECORD_SECTIONS:
        if not isinstance(doc.get(section), dict):
            errs.append(f"missing section {section!r} (must be an object)")
    if errs:
        return errs
    errs.extend(check_provenance(doc))
    timing = doc["timing"]
    for k in _RUN_TIMING_KEYS:
        if not _num(timing.get(k)):
            errs.append(f"timing.{k} must be a number")
    phases = timing.get("phases")
    if phases is not None:
        if not isinstance(phases, dict):
            errs.append("timing.phases must be an object")
        else:
            for k, v in phases.items():
                if not _num(v):
                    errs.append(f"timing.phases.{k} must be a number")
    retrace = doc.get("retrace")
    if retrace is not None:
        for k in _RUN_RETRACE_KEYS:
            if not _num(retrace.get(k)):
                errs.append(f"retrace.{k} must be a number")
    profile = doc.get("profile")
    if profile is not None:
        if not isinstance(profile.get("trace_dir"), str):
            errs.append("profile.trace_dir must be a string")
        roofline = profile.get("roofline")
        if roofline is not None:
            for k in ("hlo_flops", "hlo_bytes", "collective_bytes"):
                if not _num(roofline.get(k)):
                    errs.append(f"profile.roofline.{k} must be a number")
    return errs


def check_eval_schema(doc: Dict) -> List[str]:
    """Problems with a BENCH_eval.json document (schema in docs/BENCH.md)."""
    errs: List[str] = list(check_provenance(doc))
    for k in ("seeds", "num_episodes", "num_envs", "train_iterations", "systems"):
        if k not in doc:
            errs.append(f"missing top-level key {k!r}")
    if errs:
        return errs
    num_seeds, num_episodes = len(doc["seeds"]), doc["num_episodes"]
    if not isinstance(doc["systems"], dict) or not doc["systems"]:
        return ["'systems' must be a non-empty object"]
    for sys_name, entry in doc["systems"].items():
        envs = entry.get("envs")
        if not isinstance(envs, dict) or not envs:
            errs.append(f"systems.{sys_name}.envs must be a non-empty object")
            continue
        for env_name, cell in envs.items():
            where = f"systems.{sys_name}.envs.{env_name}"
            if not isinstance(cell.get("compatible"), bool):
                errs.append(f"{where}.compatible must be a bool")
                continue
            if not cell["compatible"]:
                if not isinstance(cell.get("reason"), str):
                    errs.append(f"{where}: incompatible cell needs a 'reason'")
                continue
            returns = cell.get("returns")
            if (
                not isinstance(returns, list)
                or len(returns) != num_seeds
                or any(len(row) != num_episodes for row in returns)
            ):
                errs.append(
                    f"{where}.returns must be a "
                    f"({num_seeds}, {num_episodes}) nested list"
                )
            agg = cell.get("aggregates", {})
            for k in _AGGREGATE_KEYS:
                if k not in agg:
                    errs.append(f"{where}.aggregates missing {k!r}")
            if not isinstance(cell.get("per_agent_mean"), dict):
                errs.append(f"{where}.per_agent_mean must be an object")
            for k in ("mean_episode_length", "steps_per_sec", "horizon"):
                if not _num(cell.get(k)):
                    errs.append(f"{where}.{k} must be a number")
    return errs


def check_speed_schema(doc: Dict) -> List[str]:
    """Problems with a BENCH_speed.json document (schema in docs/BENCH.md)."""
    errs: List[str] = list(check_provenance(doc))
    cfg = doc.get("config")
    if not isinstance(cfg, dict):
        errs.append("missing top-level 'config' object")
    else:
        for k in ("iterations", "num_envs", "num_seeds", "loop_episodes"):
            if not _num(cfg.get(k)):
                errs.append(f"config.{k} must be a number")
    cells = doc.get("cells")
    if not isinstance(cells, list) or not cells:
        errs.append("'cells' must be a non-empty list")
        return errs
    for i, cell in enumerate(cells):
        where = f"cells[{i}]"
        for k in ("system", "env"):
            if not isinstance(cell.get(k), str):
                errs.append(f"{where}.{k} must be a string")
        if not isinstance(cell.get("compatible"), bool):
            errs.append(f"{where}.compatible must be a bool")
            continue
        if not cell["compatible"]:
            if not isinstance(cell.get("reason"), str):
                errs.append(f"{where}: incompatible cell needs a 'reason'")
            continue
        runners = cell.get("runners", {})
        for r in _RUNNER_KEYS:
            sps = runners.get(r, {}).get("steps_per_sec")
            if not _num(sps) or sps <= 0:
                errs.append(f"{where}.runners.{r}.steps_per_sec must be > 0")
        sv = cell.get("seed_vectorization", {})
        for k in _SEEDVEC_KEYS:
            if not _num(sv.get(k)):
                errs.append(f"{where}.seed_vectorization.{k} must be a number")
        if _num(sv.get("speedup")) and sv["speedup"] <= 0:
            errs.append(f"{where}.seed_vectorization.speedup must be > 0")
        fr = cell.get("fused_recurrent")
        if fr is not None:
            for k in ("core", "reference_core"):
                if not isinstance(fr.get(k), str) or not fr.get(k):
                    errs.append(
                        f"{where}.fused_recurrent.{k} must be a non-empty string"
                    )
            for k in _FUSED_RECURRENT_NUM_KEYS:
                if not _num(fr.get(k)) or fr.get(k, 0) <= 0:
                    errs.append(f"{where}.fused_recurrent.{k} must be > 0")
        aa = cell.get("async_actors")
        if aa is not None:
            errs.extend(_check_async_block(aa, where))
    return errs


def _check_async_block(aa, where: str) -> List[str]:
    """Problems with one cell's ``async_actors`` block (docs/BENCH.md)."""
    errs: List[str] = []
    where = f"{where}.async_actors"
    if not isinstance(aa, dict):
        return [f"{where} must be an object"]
    counts = aa.get("actor_counts")
    if not isinstance(counts, list) or not all(_num(c) for c in counts):
        errs.append(f"{where}.actor_counts must be a list of numbers")
        counts = []
    for k in ("param_sync_every", "unroll_len"):
        if not _num(aa.get(k)) or aa.get(k, 0) < 1:
            errs.append(f"{where}.{k} must be a number >= 1")
    rows = aa.get("cells")
    if not isinstance(rows, list) or len(rows) != len(counts):
        errs.append(f"{where}.cells must be a list matching actor_counts")
        return errs
    for j, (count, row) in enumerate(zip(counts, rows)):
        rwhere = f"{where}.cells[{j}]"
        if not isinstance(row, dict):
            errs.append(f"{rwhere} must be an object")
            continue
        if row.get("num_actors") != count:
            errs.append(
                f"{rwhere}.num_actors must equal actor_counts[{j}] ({count})"
            )
        for k in _ASYNC_ROW_NUM_KEYS:
            if not _num(row.get(k)) or row.get(k, 0) <= 0:
                errs.append(f"{rwhere}.{k} must be > 0")
    return errs


def check_serve_schema(doc: Dict) -> List[str]:
    """Problems with a BENCH_serve.json document (schema in docs/BENCH.md).

    A serving artifact declares itself with ``"workload": "serve"`` and
    carries the provenance block, the traffic config (streams, episodes
    per stream, arrival rate, seed, mode) and one cell per
    (checkpoint, slot count) pair: per-decision latency percentiles,
    decisions/sec and episode counts for a restored policy served behind
    a `repro_torch.serve.DecisionEngine` slot pool.
    """
    errs: List[str] = list(check_provenance(doc))
    if doc.get("workload") != "serve":
        errs.append("'workload' must be the string 'serve'")
    cfg = doc.get("config")
    if not isinstance(cfg, dict):
        errs.append("missing top-level 'config' object")
    else:
        for k in _SERVE_CONFIG_NUM_KEYS:
            if not _num(cfg.get(k)):
                errs.append(f"config.{k} must be a number")
        if cfg.get("mode") not in ("greedy", "sample"):
            errs.append("config.mode must be 'greedy' or 'sample'")
    cells = doc.get("cells")
    if not isinstance(cells, list) or not cells:
        errs.append("'cells' must be a non-empty list")
        return errs
    for i, cell in enumerate(cells):
        where = f"cells[{i}]"
        for k in ("system", "env", "checkpoint"):
            if not isinstance(cell.get(k), str) or not cell.get(k):
                errs.append(f"{where}.{k} must be a non-empty string")
        if not _num(cell.get("max_slots")) or cell.get("max_slots", 0) < 1:
            errs.append(f"{where}.max_slots must be a number >= 1")
        for k in _SERVE_CELL_NUM_KEYS:
            if not _num(cell.get(k)):
                errs.append(f"{where}.{k} must be a number")
        if not _num(cell.get("decisions_per_sec")) or cell.get(
            "decisions_per_sec", 0
        ) <= 0:
            errs.append(f"{where}.decisions_per_sec must be > 0")
        if not _num(cell.get("episode_return_mean")):
            errs.append(f"{where}.episode_return_mean must be a number")
        lat = cell.get("latency")
        if not isinstance(lat, dict):
            errs.append(f"{where}.latency must be an object")
            continue
        for k in _SERVE_LATENCY_KEYS:
            if not _num(lat.get(k)) or lat.get(k, 0) <= 0:
                errs.append(f"{where}.latency.{k} must be > 0")
        if (
            _num(lat.get("p50_ms"))
            and _num(lat.get("p99_ms"))
            and lat["p99_ms"] < lat["p50_ms"]
        ):
            errs.append(f"{where}.latency.p99_ms must be >= p50_ms")
    return errs


def check_serve_slice(doc: Dict) -> List[str]:
    """Schema plus coverage of a full serving slice.

    A full ``BENCH_serve.json`` must serve a feed-forward and a
    recurrent system (`SERVE_SLICE_SYSTEMS`) at `MIN_SERVE_SLOT_COUNTS`+
    distinct slot counts each — the two axes the subsystem exists to
    measure.  Smoke runs validate with `check_serve_schema` alone.
    """
    errs = check_serve_schema(doc)
    cells = doc.get("cells")
    if not isinstance(cells, list):
        return errs
    for s in SERVE_SLICE_SYSTEMS:
        slot_counts = {
            c.get("max_slots") for c in cells
            if isinstance(c, dict) and c.get("system") == s
        }
        if len(slot_counts) < MIN_SERVE_SLOT_COUNTS:
            errs.append(
                f"serve slice needs system {s!r} at >= "
                f"{MIN_SERVE_SLOT_COUNTS} slot counts (got "
                f"{sorted(slot_counts, key=str)})"
            )
    return errs


def check_eval_full_matrix(doc: Dict) -> List[str]:
    """Schema plus coverage: every registered (system, env) cell present.

    The pin of a full ``BENCH_eval.json``: the artifact must span
    the full `FULL_MATRIX_SYSTEMS` x `FULL_MATRIX_ENVS` matrix (runnable
    or reasoned-incompatible), so registry growth without a regenerated
    matrix fails.
    """
    errs = check_eval_schema(doc)
    systems = doc.get("systems", {})
    if not isinstance(systems, dict):
        return errs
    for s in FULL_MATRIX_SYSTEMS:
        if s not in systems:
            errs.append(f"full matrix missing system {s!r}")
            continue
        envs = systems[s].get("envs", {})
        for e in FULL_MATRIX_ENVS:
            if e not in envs:
                errs.append(f"full matrix missing cell ({s}, {e})")
    return errs


def check_speed_full_matrix(doc: Dict) -> List[str]:
    """Schema plus coverage of the default throughput slice.

    A full ``BENCH_speed.json`` must carry a row per system in
    `SPEED_SLICE_SYSTEMS` (one replay, one on-policy, one recurrent
    family), keeping the perf trajectory comparable across PRs.  Every
    runnable slice cell must additionally carry an ``async_actors`` rung
    at exactly `ASYNC_ACTOR_COUNTS`, with at least
    `MIN_ASYNC_MONOTONIC_CELLS` cells showing steps/sec monotonically
    increasing with actor count.
    """
    errs = check_speed_schema(doc)
    cells = doc.get("cells")
    have = {c.get("system") for c in cells} if isinstance(cells, list) else set()
    for s in SPEED_SLICE_SYSTEMS:
        if s not in have:
            errs.append(f"speed slice missing system {s!r}")
    if isinstance(cells, list):
        fused_envs = {
            c.get("env") for c in cells
            if isinstance(c, dict)
            and c.get("system") == FUSED_RECURRENT_SYSTEM
            and isinstance(c.get("fused_recurrent"), dict)
        }
        for e in FUSED_RECURRENT_ENVS:
            if e not in fused_envs:
                errs.append(
                    f"speed slice missing fused_recurrent rung for "
                    f"({FUSED_RECURRENT_SYSTEM}, {e})"
                )
        monotonic = 0
        for c in cells:
            if not (isinstance(c, dict) and c.get("compatible")):
                continue
            if c.get("system") not in SPEED_SLICE_SYSTEMS:
                continue
            aa = c.get("async_actors")
            where = f"({c.get('system')}, {c.get('env')})"
            if not isinstance(aa, dict):
                errs.append(f"speed slice missing async_actors rung for {where}")
                continue
            if tuple(aa.get("actor_counts", ())) != ASYNC_ACTOR_COUNTS:
                errs.append(
                    f"{where}.async_actors.actor_counts must be "
                    f"{list(ASYNC_ACTOR_COUNTS)}"
                )
                continue
            sps = [row.get("steps_per_sec", 0) for row in aa.get("cells", [])]
            if len(sps) == len(ASYNC_ACTOR_COUNTS) and all(
                b > a for a, b in zip(sps, sps[1:])
            ):
                monotonic += 1
        if monotonic < MIN_ASYNC_MONOTONIC_CELLS:
            errs.append(
                f"async_actors rung must scale monotonically over "
                f"{list(ASYNC_ACTOR_COUNTS)} actors on >= "
                f"{MIN_ASYNC_MONOTONIC_CELLS} speed-slice cells "
                f"(got {monotonic})"
            )
    return errs


def validate_path(path: str, full: bool = False) -> List[str]:
    """Validate one artifact file, dispatching on its contents.

    Dispatch: ``run_id`` marks a run record, ``workload: "serve"`` a
    BENCH_serve document, ``cells`` a BENCH_speed document, ``systems`` a
    BENCH_eval document.  ``full`` additionally enforces the
    coverage pins (`check_eval_full_matrix` / `check_speed_full_matrix` /
    `check_serve_slice`) — for full artifacts, not the partial smoke
    slices (run records have no coverage pin).
    """
    with open(path) as f:
        doc = json.load(f)
    if "run_id" in doc:
        return check_run_record(doc)
    if doc.get("workload") == "serve":
        return check_serve_slice(doc) if full else check_serve_schema(doc)
    if "cells" in doc:
        return check_speed_full_matrix(doc) if full else check_speed_schema(doc)
    if "systems" in doc:
        return check_eval_full_matrix(doc) if full else check_eval_schema(doc)
    return [
        f"{path}: not a run record (run_id), BENCH_serve (workload), "
        "BENCH_eval (systems) or BENCH_speed (cells) document"
    ]
