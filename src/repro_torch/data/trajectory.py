"""Host-side helpers for MARL trajectories (counterpart of `repro.data.trajectory`).

Trajectory storage on the device is `repro_torch.core.buffer`'s; these
turn rollouts into numpy arrays for plots and evaluation summaries.
"""
from __future__ import annotations

import numpy as np

from repro_torch.tree import tree_map


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def batch_trajectories(trajs):
    """Stack a list of same-structured trajectory trees along a new leading axis (numpy).

    Leaves may be numpy arrays, tensors (copied to the host) or scalars.
    """
    return tree_map(lambda *xs: np.stack([_host(x) for x in xs], axis=0), *trajs)


def episode_returns(rewards: np.ndarray, dones: np.ndarray) -> np.ndarray:
    """Split a flat (T,) reward stream into per-episode returns using dones."""
    returns, acc = [], 0.0
    for r, d in zip(rewards, dones):
        acc += float(r)
        if d:
            returns.append(acc)
            acc = 0.0
    return np.asarray(returns)
