"""Greedy-policy evaluation (port of `repro.eval`)."""
from repro_torch.eval.evaluator import evaluate

__all__ = ["evaluate"]
