"""Value-decomposition mixing modules (port of `repro.core.modules.mixing`).

A mixer maps the per-agent chosen Q-values (and the global state) to the
joint ``Q_tot`` of the TD loss.  `AdditiveMixing` is VDN's sum;
`MonotonicMixing` is QMIX's state-conditioned hypernetwork with
non-negative mixing weights (so ``dQ_tot / dQ_i >= 0``).  The parameters
have the reference's keys, shapes and init order, and lane parameters
``(S, ...)`` apply to inputs ``(S, B, ...)`` as one batched product
(`repro_torch.nn.layers.affine`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import initializers
from repro_torch.nn.layers import affine


@dataclasses.dataclass(frozen=True)
class AdditiveMixing:
    """VDN: ``Q_tot = sum_i Q_i``.  Stateless."""

    def init(self, generator, num_agents: int, state_dim: int):
        del generator, num_agents, state_dim
        return {}

    def apply(self, params, agent_qs, state):
        """``agent_qs``: ``(..., N)``; ``state`` unused -> ``(...,)``."""
        del params, state
        return torch.sum(agent_qs, dim=-1)


@dataclasses.dataclass(frozen=True)
class MonotonicMixing:
    """QMIX: ``Q_tot = w2(s)^T elu(w1(s)^T q + b1(s)) + b2(s)`` with ``w1, w2 >= 0``."""

    embed_dim: int = 32
    hypernet_hidden: int = 64

    def init(self, generator, num_agents: int, state_dim: int):
        """The hypernetworks' weights, drawn in the reference's order."""
        lecun = initializers.lecun_normal()
        E, H = self.embed_dim, self.hypernet_hidden
        device = generator.device
        w1 = lecun(generator, (state_dim, num_agents * E))
        w2 = lecun(generator, (state_dim, E))
        b2_1 = lecun(generator, (state_dim, H))
        b2_2 = lecun(generator, (H, 1))
        return {
            "hyper_w1": w1,
            "hyper_b1": torch.zeros(state_dim, E, device=device),
            "hyper_w2": w2,
            # b2 is a 2-layer hypernetwork (as in the QMIX paper)
            "hyper_b2_1": b2_1,
            "hyper_b2_1b": torch.zeros(H, device=device),
            "hyper_b2_2": b2_2,
        }

    def apply(self, params, agent_qs, state):
        """``agent_qs``: ``(..., N)``; ``state``: ``(..., S_dim)`` -> ``(...,)``."""
        N, E = agent_qs.shape[-1], self.embed_dim
        w1 = torch.abs(affine(state, params["hyper_w1"])).unflatten(-1, (N, E))
        b1 = affine(state, params["hyper_b1"])
        hidden = torch.nn.functional.elu(
            torch.einsum("...n,...ne->...e", agent_qs, w1) + b1
        )
        w2 = torch.abs(affine(state, params["hyper_w2"]))
        b2 = affine(
            torch.relu(affine(state, params["hyper_b2_1"], params["hyper_b2_1b"])),
            params["hyper_b2_2"],
        )[..., 0]
        return torch.sum(hidden * w2, dim=-1) + b2
