"""Architecture registry: ``--arch <id>`` resolution for the archs the port runs.

`KNOWN_ARCH_IDS` is the JAX registry's list; `ARCH_IDS` the archs whose
configs the port carries: all ten, the same list.  llama3-405b and
kimi-k2-1t-a32b carry ``sharding="fsdp_tp"`` as the reference's do: the
dry run (`repro_torch.launch.dryrun`) shards them over a mesh; on one card
their published widths run cut in depth.  An unknown arch raises
`KeyError`.  What the port runs
of each family is `models.model.PORTED`.
"""
from __future__ import annotations

import importlib
from typing import Tuple

KNOWN_ARCH_IDS: Tuple[str, ...] = (
    "minitron-8b",
    "llava-next-mistral-7b",
    "internlm2-1.8b",
    "olmoe-1b-7b",
    "kimi-k2-1t-a32b",
    "granite-8b",
    "falcon-mamba-7b",
    "zamba2-2.7b",
    "musicgen-large",
    "llama3-405b",
)
ARCH_IDS: Tuple[str, ...] = KNOWN_ARCH_IDS  # every arch is ported


def _module(arch_id: str):
    if arch_id not in KNOWN_ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {KNOWN_ARCH_IDS}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    """The published configuration of ``arch_id``."""
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    """Reduced same-family variant for CPU smoke tests."""
    return _module(arch_id).SMOKE
