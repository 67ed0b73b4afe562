"""Greedy-policy evaluation, robust aggregates and the sweep (port of `repro.eval`).

  evaluator — greedy evaluator; standalone or interleaved in the Anakin runner
  stats     — rliable-style aggregates (mean/median/IQM + bootstrap CIs)
  sweep     — systems x envs over seeds, into ``results/port/BENCH_eval.json``
"""
from repro_torch.eval.evaluator import evaluate, make_evaluator
from repro_torch.eval.stats import aggregate, iqm, mean, median, stratified_bootstrap_ci
from repro_torch.eval.sweep import evaluate_on_env, run_sweep, to_markdown

__all__ = [
    "aggregate",
    "evaluate",
    "evaluate_on_env",
    "iqm",
    "make_evaluator",
    "mean",
    "median",
    "run_sweep",
    "stratified_bootstrap_ci",
    "to_markdown",
]
