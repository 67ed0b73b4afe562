"""System architectures: what each agent's policy and critic condition on.

Port of `repro.core.architectures` (paper Fig. 3):

  Decentralised — policy_i(o_i);    critic_i(o_i, a_i)
  Centralised   — policy_i(o_i);    critic_i(global_state, a_1..a_N)
  Networked     — policy_i(o_i);    critic_i(o_i ∪ o_j, a_j for j in N(i))

Architectures are pure input builders over tensors with any leading
batch shape, so wrapping modules compose by transforming what they return.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch


def one_hot_actions(actions: Dict[str, torch.Tensor], num_actions: Dict[str, int]):
    """Integer actions -> float32 one-hot rows, per agent."""
    return {
        a: torch.nn.functional.one_hot(actions[a].long(), num_actions[a]).float()
        for a in actions
    }


@dataclasses.dataclass(frozen=True)
class DecentralisedPolicyActor:
    """Fully independent agents (paper Fig. 3 left)."""

    def policy_input(self, obs, agent):
        return obs[agent]

    def critic_input(self, obs, actions, global_state, agent):
        return torch.cat([obs[agent], actions[agent]], dim=-1)


@dataclasses.dataclass(frozen=True)
class CentralisedQValueCritic:
    """CTDE: critics see the global state and every agent's action."""

    agent_order: Sequence[str] = ()

    def policy_input(self, obs, agent):
        return obs[agent]

    def critic_input(self, obs, actions, global_state, agent):
        order = self.agent_order or sorted(obs.keys())
        return torch.cat([global_state, *(actions[a] for a in order)], dim=-1)


@dataclasses.dataclass(frozen=True)
class NetworkedQValueCritic:
    """Information topology: critic_i sees its graph neighbourhood only.

    ``adjacency[i][j] = 1`` when agent j's obs and action flow into agent
    i's critic (the diagonal should be 1); rows follow ``agent_order``.
    """

    adjacency: tuple  # tuple of tuples of 0/1
    agent_order: Sequence[str] = ()

    def policy_input(self, obs, agent):
        return obs[agent]

    def critic_input(self, obs, actions, global_state, agent):
        order = list(self.agent_order or sorted(obs.keys()))
        i = order.index(agent)
        feats = []
        for j, other in enumerate(order):
            m = float(self.adjacency[i][j])
            feats.append(obs[other] * m)
            feats.append(actions[other] * m)
        return torch.cat(feats, dim=-1)
