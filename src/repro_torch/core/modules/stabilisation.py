"""Replay stabilisation via policy fingerprints (port of `repro.core.modules.stabilisation`).

Independent-learner replay is non-stationary: old transitions were made
under other agents' older policies.  The fingerprint tells them apart by
appending a low-dimensional signature of the joint policy, ``(epsilon,
trainer_step)``, to each observation, both when acting and when training.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FingerPrintStabilisation:
    """Appends ``[eps, step * step_scale]`` to every agent's observation."""

    step_scale: float = 1e-4  # trainer steps are O(1e4)

    @property
    def size(self) -> int:
        return 2

    def augment(self, obs: Dict[str, torch.Tensor], eps: float, step: int):
        """``obs`` leaves ``(..., D)`` -> ``(..., D + 2)``.

        ``eps`` and ``step`` are host-side numbers, the same in every seed
        lane; the pair is rounded to float32 as the reference computes it.
        The pair is filled in on the device from scalars: a tensor made from
        a host list would be a copy that waits on the device.
        """
        eps32 = float(np.float32(eps))
        step32 = float(np.float32(step) * np.float32(self.step_scale))
        first = next(iter(obs.values()))
        tail = torch.cat([first.new_full((1,), eps32), first.new_full((1,), step32)])
        return {
            a: torch.cat([o, tail.expand(*o.shape[:-1], 2)], dim=-1) for a, o in obs.items()
        }
