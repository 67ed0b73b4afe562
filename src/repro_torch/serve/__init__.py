"""Checkpointed MARL policies behind a slot-based engine (port of `repro.serve`).

Take a trained registry system (feed-forward or recurrent), persist it as
a self-describing checkpoint, and serve per-user episodes as live
decision traffic:

* `save_policy` / `load_policy` / `fresh_system_state`
  (`repro_torch.serve.checkpoint`): the train -> serve hand-off;
* `DecisionEngine` / `ServeRequest` (`repro_torch.serve.engine`): the
  fixed slot pool, every live episode advanced by one tick;
* `poisson_requests` / `serve_workload` (`repro_torch.serve.traffic`):
  the reproducible synthetic traffic.

The launcher: ``python -m repro_torch.launch.serve_marl``.
"""
from repro_torch.serve.checkpoint import (
    fresh_system_state,
    load_policy,
    read_policy_meta,
    save_policy,
)
from repro_torch.serve.engine import DecisionEngine, ServeRequest
from repro_torch.serve.traffic import poisson_requests, serve_workload, workload_stats

__all__ = [
    "DecisionEngine",
    "ServeRequest",
    "fresh_system_state",
    "load_policy",
    "poisson_requests",
    "read_policy_meta",
    "save_policy",
    "serve_workload",
    "workload_stats",
]
