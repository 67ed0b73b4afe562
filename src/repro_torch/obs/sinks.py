"""The logger multiplexer: one ``Logger`` protocol, many sinks (port of `repro.obs.sinks`).

Telemetry producers (the runners' metric tap, the launchers) write
dict-shaped metric rows through one ``Logger`` interface; where the rows
end up (terminal, ``metrics.jsonl``, ``metrics.csv``, several at once) is
decided at launch time:

    logger = MultiLogger(ConsoleSink(), JsonlSink(p), CsvSink(p2))
    logger.write({"episode_return": 1.5, "sps": 80_000}, step=128)

`SeedAggregator` wraps any sink for seed-lane runs: values with a leading
``(num_seeds,)`` lane axis become mean / min / max columns, so an 8-lane
run logs one row per tap instead of eight.

Sinks observe host values: the tap hands them numpy arrays, and
`to_python` also takes a tensor on any device (it copies it to the host).
They never feed anything back into the run.
"""
from __future__ import annotations

import csv
import json
import sys
from typing import Any, Dict, Mapping, Optional, Protocol, Sequence

import numpy as np
import torch


def _host(value: Any) -> Any:
    """A tensor on any device as a numpy array (bfloat16 widened to float32)."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return value


def to_python(value: Any) -> Any:
    """A JSON/CSV-serialisable python value from any scalar, array or tensor leaf."""
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    arr = np.asarray(_host(value))
    if arr.ndim == 0:
        if arr.dtype == np.bool_:
            return bool(arr)
        if np.issubdtype(arr.dtype, np.integer):
            return int(arr)
        return float(arr)
    return arr.tolist()


class Logger(Protocol):
    """The sink interface every telemetry consumer implements."""

    def write(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        """Record one row of named metric values (``step`` orders rows)."""
        ...

    def close(self) -> None:
        """Flush and release any underlying resource (idempotent)."""
        ...


class ConsoleSink:
    """Human-facing terminal sink: the one formatting path for the launchers' stdout.

    ``write`` renders a metric row as ``key=value`` pairs; ``line`` emits
    free-form text through the same prefix.
    """

    def __init__(self, stream=None, prefix: str = ""):
        self._stream = stream if stream is not None else sys.stdout
        self.prefix = prefix

    @staticmethod
    def _fmt(value: Any) -> str:
        value = to_python(value)
        if isinstance(value, float):
            return f"{value:,.4g}"
        if isinstance(value, list):
            return np.array2string(np.asarray(value), precision=3)
        return str(value)

    def write(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        """Print one row as ``step=... key=value ...``."""
        parts = [] if step is None else [f"step={step}"]
        parts += [f"{k}={self._fmt(v)}" for k, v in metrics.items()]
        self.line("  ".join(parts))

    def line(self, text: str) -> None:
        """Free-form console output."""
        print(f"{self.prefix}{text}", file=self._stream, flush=True)

    def close(self) -> None:
        """Nothing to release: the stream is borrowed, not owned."""


class JsonlSink:
    """One JSON object per row, appended to ``path``."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "a")

    def write(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        """Append one row as a JSON object and flush."""
        row: Dict[str, Any] = {} if step is None else {"step": int(step)}
        row.update({k: to_python(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        """Close the file (idempotent)."""
        if not self._f.closed:
            self._f.close()


class CsvSink:
    """A rectangular CSV of the metric stream.

    The first row written pins the header; later rows may omit columns
    (logged empty), but a new key raises: a stream whose schema drifts is
    a bug in its producer.
    """

    def __init__(self, path):
        self.path = path
        self._f = open(path, "a", newline="")
        self._writer: Optional[csv.DictWriter] = None

    def write(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        """Append one row; the first pins the header, a new key later raises."""
        row: Dict[str, Any] = {} if step is None else {"step": int(step)}
        row.update({k: to_python(v) for k, v in metrics.items()})
        if self._writer is None:
            self._writer = csv.DictWriter(self._f, fieldnames=list(row))
            self._writer.writeheader()
        unknown = set(row) - set(self._writer.fieldnames)
        if unknown:
            raise ValueError(
                f"CsvSink: keys {sorted(unknown)} not in the header pinned by "
                f"the first row {self._writer.fieldnames}"
            )
        self._writer.writerow(row)
        self._f.flush()

    def close(self) -> None:
        """Close the file (idempotent)."""
        if not self._f.closed:
            self._f.close()


class MultiLogger:
    """Fan one ``write`` out to several sinks."""

    def __init__(self, *sinks: Logger):
        self.sinks: Sequence[Logger] = tuple(sinks)

    def write(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        """Write the row to every sink, in order."""
        for s in self.sinks:
            s.write(metrics, step=step)

    def close(self) -> None:
        """Close every sink."""
        for s in self.sinks:
            s.close()


class SeedAggregator:
    """Reduce seed-lane metric values before they reach a sink.

    A value with a leading ``(num_seeds,)`` axis becomes three columns:
    ``k`` (the mean over lanes of each lane's mean), ``k/min`` and
    ``k/max``.  Scalars pass through untouched, so the wrapper is safe to
    leave on for runs without lanes.
    """

    def __init__(self, inner: Logger):
        self.inner = inner

    def write(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        """Reduce the row's lane values and forward it to the inner sink."""
        out: Dict[str, Any] = {}
        for k, v in metrics.items():
            arr = np.asarray(_host(v))
            if arr.ndim == 0 or isinstance(v, (str, bool)):
                out[k] = v
                continue
            lanes = arr.reshape(arr.shape[0], -1).mean(axis=1)
            out[k] = float(lanes.mean())
            out[f"{k}/min"] = float(lanes.min())
            out[f"{k}/max"] = float(lanes.max())
        self.inner.write(out, step=step)

    def close(self) -> None:
        """Close the inner sink."""
        self.inner.close()
