"""Learned-communication modules for DIAL (port of `repro.core.modules.communication`).

The Discretise/Regularise Unit (DRU) of Foerster et al. 2016: in
centralised training the channel is continuous, ``sigmoid(m + noise)``,
so gradients flow between agents through it; in decentralised execution
the message is thresholded to a bit.  `BroadcastedCommunication` routes
each agent's outgoing message to every other agent (mean-pooled on one
shared channel, or concatenated).

The reference's `dru` draws its noise from a key; this one takes the
standard-normal draw itself (``noise``, shaped like the message), so the
caller decides where it comes from.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def dru(message, noise, noise_std: float, training: bool):
    """Discretise/Regularise Unit: ``sigmoid(message + noise * noise_std)`` in training,
    ``message > 0`` as float32 in execution (``noise`` unused, may be None)."""
    if training:
        return torch.sigmoid(message + noise * noise_std)
    return (message > 0).float()


@dataclasses.dataclass(frozen=True)
class BroadcastedCommunication:
    """Broadcast channel: every agent hears the others' messages."""

    channel_size: int = 1
    noise_std: float = 0.5
    shared: bool = True  # one shared channel: messages are mean-pooled

    def route(self, messages: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-agent outgoing ``(..., C)`` -> per-agent incoming (agents in sorted order)."""
        ids = sorted(messages)
        incoming = self.route_stacked(torch.stack([messages[a] for a in ids]))
        return {a: incoming[i] for i, a in enumerate(ids)}

    def route_stacked(self, stack):
        """`route` on the agents' messages stacked along axis 0: ``(N, ..., C)`` -> incoming."""
        n = stack.shape[0]
        if self.shared:
            return (stack.sum(0, keepdim=True) - stack) / max(n - 1, 1)
        # each agent hears the concatenation of the other agents' channels
        return torch.stack([
            torch.cat([stack[j] for j in range(n) if j != i], dim=-1) for i in range(n)
        ])

    def incoming_size(self, num_agents: int) -> int:
        """Width of an agent's incoming message."""
        return self.channel_size if self.shared else self.channel_size * (num_agents - 1)
