"""Structured run records under ``<root>/<run_id>/`` (port of `repro.obs.record`).

A run record is one directory per launch: ``run.json`` (config,
provenance, timing, final metrics, an optional profile section) beside the
metric stream (``metrics.jsonl`` / ``metrics.csv`` from the logger sinks)
and any profiler trace.  The sections are the reference's
(``provenance``, ``config``, ``timing``, ``metrics``).

`provenance()` is the port's: where the reference names JAX's version,
backend and device kind, this names torch's and CUDA's versions, nvcc's,
the card and its power limit as ``nvidia-smi`` reads them, and the device
count.  docs/PORT_OBSERVABILITY.md lists the fields that differ.
"""
from __future__ import annotations

import json
import pathlib
import platform
import re
import subprocess
import time
import uuid
from typing import Any, Dict, Mapping, Optional

import torch

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def _run(cmd, cwd=None) -> Optional[str]:
    """``cmd``'s standard output, or None when it is missing or fails."""
    try:
        out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def git_sha(repo_root=None) -> str:
    """The repo's current commit sha, or ``"unknown"`` outside a checkout."""
    return _run(["git", "rev-parse", "HEAD"], cwd=str(repo_root or _REPO_ROOT)) or "unknown"


def nvidia_smi() -> Optional[str]:
    """The first card's ``name, power.limit`` line from ``nvidia-smi``, or None."""
    out = _run(NVIDIA_SMI_QUERY)
    return out.splitlines()[0].strip() if out else None


def nvcc_version() -> Optional[str]:
    """The CUDA compiler's release (``"12.4"``, say), or None when there is no nvcc."""
    from repro_torch.kernels import _nvcc

    try:
        out = _run([_nvcc(), "--version"])
    except RuntimeError:  # no CUDA toolkit on this machine
        return None
    m = re.search(r"release ([\d.]+)", out or "")
    return m.group(1) if m else None


def provenance(device=None) -> Dict[str, Any]:
    """Where, when and on what a run ran: the reproducibility block.

    ``device`` is the device the run used (default: CUDA when there is
    one, else the CPU).  On a GPU, ``device_kind`` is
    ``torch.cuda.get_device_name`` and ``gpu`` / ``power_limit`` are what
    ``nvidia-smi --query-gpu=name,power.limit`` prints; ``num_devices``
    counts the CUDA devices (1 for the CPU).
    """
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    out: Dict[str, Any] = {
        "git_sha": git_sha(),
        "framework": "torch",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "nvcc_version": nvcc_version(),
        "backend": device.type,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    if device.type == "cuda":
        smi = nvidia_smi()
        name, _, limit = (smi or "").partition(",")
        out.update(
            device_kind=torch.cuda.get_device_name(device),
            num_devices=torch.cuda.device_count(),
            gpu=name.strip() or None,
            power_limit=limit.strip() or None,
        )
    else:
        out.update(device_kind=platform.processor() or platform.machine() or "cpu",
                   num_devices=1, gpu=None, power_limit=None)
    return out


def default_run_id(tag: str = "run") -> str:
    """A sortable, collision-safe id: ``<tag>-<utc time>-<hex>``."""
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
    return f"{tag}-{stamp}-{uuid.uuid4().hex[:6]}"


class RunRecord:
    """One launch's structured artifact directory.

        record = RunRecord("results/port/runs", config=vars(args), tag="ippo")
        logger = MultiLogger(ConsoleSink(),
                             JsonlSink(record.metrics_path("jsonl")),
                             CsvSink(record.metrics_path("csv")))
        ... train ...
        record.update("timing", total_seconds=wall, compile_seconds=c)
        record.save()

    The document always carries ``run_id`` / ``provenance`` / ``config``
    / ``timing`` / ``metrics``; sections grow through `update` and land
    in ``<dir>/run.json`` on `save`.  ``device`` goes to `provenance`.
    """

    def __init__(self, root="results/port/runs", run_id: Optional[str] = None,
                 config: Optional[Mapping[str, Any]] = None, tag: str = "run", device=None):
        self.run_id = run_id or default_run_id(tag)
        self.dir = pathlib.Path(root) / self.run_id
        self.dir.mkdir(parents=True, exist_ok=True)
        self.doc: Dict[str, Any] = {
            "run_id": self.run_id,
            "provenance": provenance(device),
            "config": dict(config or {}),
            "timing": {},
            "metrics": {},
        }

    @property
    def path(self) -> pathlib.Path:
        """Where `save` writes the record document."""
        return self.dir / "run.json"

    def metrics_path(self, fmt: str) -> pathlib.Path:
        """The conventional location of the ``fmt`` metric stream."""
        return self.dir / f"metrics.{fmt}"

    def update(self, section: str, **fields: Any) -> None:
        """Merge ``fields`` into a (possibly new) top-level dict section."""
        self.doc.setdefault(section, {}).update(fields)

    def save(self) -> pathlib.Path:
        """Write ``run.json`` and return its path."""
        with open(self.path, "w") as f:
            json.dump(self.doc, f, indent=2, default=str)
        return self.path
