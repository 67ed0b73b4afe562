"""Find a cell's files by name, run its driver, and print the contract's result line.

A cell of BENCHMARK.json names its configuration (``configs[].file``) and
its traffic mix (``traffic/<traffic>.json``, whose ``driver`` names the
general driver in ``drivers/`` that reads it); its correctness limits sit
in ``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  Nothing here knows a cell by name.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
# modules the process that prints a result may not hold, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its files' contents and the run's arguments."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: object = None


@dataclasses.dataclass
class Outcome:
    """What a driver hands back.

    ``metrics``: end-to-end values by name; ``checks``: each compared number
    with its limit, ``{name: (value, limit)}``; ``window``: what the metric
    readers read of the traced window besides the trace (for example the
    work it did); ``trace``: the `portbench.trace.Trace` of a traced run;
    ``check_s``: the seconds the check against the reference took.
    """

    metrics: dict
    checks: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    window: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    check_s: float = 0.0


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    """BENCHMARK.json at ``root``."""
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry named ``name``."""
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[c['name'] for c in bench['workloads']]}")


def config_of(bench: dict, cell: dict, root: pathlib.Path = ROOT) -> dict:
    """The configuration file that ``cell`` names, read."""
    for cfg in bench["configs"]:
        if cfg["name"] == cell["config"]:
            return json.loads((root / cfg["file"]).read_text())
    raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")


def traffic_of(cell: dict, here: pathlib.Path = HERE) -> dict:
    """The traffic file ``traffic/<traffic>.json`` of ``cell``."""
    return json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())


def limits_of(cell: dict, here: pathlib.Path = HERE) -> dict:
    """The correctness limits ``limits/<cell>.json`` of ``cell``."""
    return json.loads((here / "limits" / f"{cell['name']}.json").read_text())


def _applies(metric: dict, cell_name: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def end_to_end_of(bench: dict, cell: dict) -> list[dict]:
    """The end-to-end metrics ``cell`` reports."""
    return [m for m in bench["end_to_end"] if _applies(m, cell["name"], set())]


def per_layer_of(bench: dict, cell: dict) -> list[dict]:
    """The per-layer metrics ``cell``'s traced run reports."""
    reported = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"] if _applies(m, cell["name"], reported)]


def driver(name: str):
    """The driver module ``drivers/<name>.py``."""
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(name: str, here: pathlib.Path = HERE):
    """The reader ``metrics/<name>.py`` of a per-layer metric (its ``read(trace, window)``)."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None) -> list[str]:
    """The top-level names of ``names`` (the loaded modules by default) in `FORBIDDEN`."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def result_line(bench: dict, cell: dict, out: Outcome, trace_run: bool, device: dict) -> dict:
    """The contract's last line: ``checks`` (each compared number and its limit) comes last."""
    correct = all(v <= lim for v, lim in out.checks.values())
    if trace_run:
        metrics = {}
        for m in per_layer_of(bench, cell):
            value = reader(m["name"]).read(out.trace, out.window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = dict(device, busy_s=out.trace.busy_s, window_s=out.trace.window_s)
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]}
                   for m in end_to_end_of(bench, cell)}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace_run:
        line["breakdown"] = {"device_ops": out.trace.device_ops,
                             "idle_gaps": out.trace.idle_gaps}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line
