"""PyTorch/CUDA port of the `repro` MARL library.

The JAX package `repro` stays the reference; this package mirrors its
module names (``repro_torch.nn.recurrent`` is the counterpart of
``repro.nn.recurrent``, and so on) and is held against it by the
``tests/test_torch_*.py`` parity tests.  It imports `torch` only: never
`jax`, and nothing from `repro`.

Importing it touches no GPU and builds no kernel.  Entry points take a
``device=`` argument that defaults to CUDA; with no device given and no
CUDA present they raise rather than fall back to the CPU (see
`resolve_device`).  Randomness comes from an explicit `torch.Generator`
on the run's device.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device``, or CUDA by default.

    Raises when no device is given and CUDA is unavailable, so a run never
    lands on the CPU without the caller asking for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
