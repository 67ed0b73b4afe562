"""Streaming telemetry, run records and profiler hooks (port of `repro.obs`).

What a run is doing while it runs (the runners' `MetricTap` and the
logger sinks), what it did once it finished (the structured `RunRecord`
under ``results/port/runs/<run_id>/``), and why it was slow
(`profile_trace` / `RetraceCounter` / `roofline_summary`).  See
docs/PORT_OBSERVABILITY.md for where the port's record differs from the
reference's (docs/OBSERVABILITY.md).
"""
from repro_torch.obs.phases import measure_phase_timing
from repro_torch.obs.profile import RetraceCounter, profile_trace, roofline_summary
from repro_torch.obs.record import RunRecord, default_run_id, git_sha, provenance
from repro_torch.obs.sinks import (
    ConsoleSink,
    CsvSink,
    JsonlSink,
    Logger,
    MultiLogger,
    SeedAggregator,
    to_python,
)
from repro_torch.obs.stream import MetricTap, host_values

__all__ = [
    "ConsoleSink",
    "CsvSink",
    "JsonlSink",
    "Logger",
    "MetricTap",
    "MultiLogger",
    "RetraceCounter",
    "RunRecord",
    "SeedAggregator",
    "default_run_id",
    "git_sha",
    "host_values",
    "measure_phase_timing",
    "profile_trace",
    "provenance",
    "roofline_summary",
    "to_python",
]
