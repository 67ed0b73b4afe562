"""Continuous-batching LM serving (port of `repro.serving`)."""
from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
