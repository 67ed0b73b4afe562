"""Greedy-policy evaluation and robust aggregates (port of `repro.eval`).

  evaluator — greedy evaluator; standalone or interleaved in the Anakin runner
  stats     — rliable-style aggregates (mean/median/IQM + bootstrap CIs)
"""
from repro_torch.eval.evaluator import evaluate, make_evaluator
from repro_torch.eval.stats import aggregate, iqm, mean, median, stratified_bootstrap_ci

__all__ = [
    "aggregate",
    "evaluate",
    "iqm",
    "make_evaluator",
    "mean",
    "median",
    "stratified_bootstrap_ci",
]
