"""Roofline table: formats the port's dry-run JSON into the §Roofline report
(counterpart of the root's ``benchmarks/roofline.py``).

Reads ``results/port/dryrun_baseline.json`` (written by ``python -m
repro_torch.launch.dryrun --all --json results/port/dryrun_baseline.json``);
if it is absent, runs a reduced subset of pairs through the dry run in a
subprocess (a fake world of 256 ranks; no card).  The figures are dry-run
estimates at H100 SXM5 datasheet constants, not measurements.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
BASELINE = os.path.join(ROOT, "results", "port", "dryrun_baseline.json")

_SUBSET = [
    ("internlm2-1.8b", "train_4k"),
    ("olmoe-1b-7b", "train_4k"),
    ("falcon-mamba-7b", "decode_32k"),
]


def _ensure_records(fast: bool):
    if os.path.exists(BASELINE):
        with open(BASELINE) as f:
            return json.load(f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    records = []
    for arch, shape in _SUBSET[: 1 if fast else 3]:
        out = os.path.join(ROOT, "results", "port", f"_roofline_{arch}_{shape}.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--json", out],
            env=env, cwd=ROOT, timeout=1200, capture_output=True,
        )
        if os.path.exists(out):
            with open(out) as f:
                records.extend(json.load(f))
    return records


def bench(fast: bool = False, device=None):
    """One row a dry-run record: the dominant term's time a step, and the terms."""
    del device  # the dry run runs on no device
    rows = []
    for rec in _ensure_records(fast):
        r = rec["roofline"]
        dom_ms = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3
        rows.append(
            (
                f"roofline/{rec['arch']}/{rec['shape']}",
                dom_ms * 1e3,  # us per step at the dominant-term bound
                f"dom={r['dominant']} compute={r['compute_s']*1e3:.2f}ms "
                f"mem={r['memory_s']*1e3:.2f}ms coll={r['collective_s']*1e3:.2f}ms "
                f"useful={r['useful_ratio']:.2f} peak/dev="
                f"{rec['bytes_per_device']['peak_est']/2**30:.1f}GiB",
            )
        )
    return rows
