"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch
(counterpart of `repro.models.moe`).

GShard/Switch-style dispatch: tokens go in groups of ``cfg.moe_group_size``
(the last one padded with zero rows, whose outputs are dropped); each group
builds a (g, E, C) dispatch tensor with C = ceil(g * top_k / E *
capacity_factor) slots an expert.  A (token, choice) pair takes the next
free slot of its expert in priority order, choice rank first (every first
choice before any second choice), then token order; pairs past an
expert's capacity are dropped.  The selected gates are renormalised to sum
to one.  The dispatch, expert and combine products are plain einsums, as
in the reference, which computes them outside any Pallas kernel.

Returns the Switch load-balance loss and the router z-loss beside the
output, as the reference does; the weights that scale them join with MoE
training, which is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _trunc_normal


def init_moe(generator, cfg):
    """``router`` (d, E) float32; ``w_gate``, ``w_up`` (E, d, ff), ``w_down`` (E, ff, d)."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(ff)
    dtype = cfg.activation_dtype
    return {
        "router": _trunc_normal(generator, (d, E), s_in, torch.float32),
        "w_gate": _trunc_normal(generator, (E, d, ff), s_in, dtype),
        "w_up": _trunc_normal(generator, (E, d, ff), s_in, dtype),
        "w_down": _trunc_normal(generator, (E, ff, d), s_out, dtype),
    }


def expert_capacity(group_size: int, num_experts: int, top_k: int, factor: float) -> int:
    """Slots an expert in a group: ceil(g * k / E * factor), at least one."""
    return max(1, int(math.ceil(group_size * top_k / num_experts * factor)))


def top_k_routing(router_logits, top_k: int, capacity: int):
    """Dispatch and combine tensors from router logits (G, g, E) float32.

    Returns ``dispatch`` (G, g, E, C) bool (token -> slot), ``combine``
    (G, g, E, C) float32 (the dispatch weighted by the renormalised
    gate), and the scalars ``aux_loss`` and ``z_loss``.

    The reference walks the k choices, each time a cumulative sum over the
    group's tokens offset by the earlier choices' counts; one cumulative
    sum over the (choice, token) order gives the same slots.  A token's k
    choices name k different experts, so each (token, expert) cell receives
    at most one pair, and a scatter writes what the reference's one-hot
    sums add up.  Ties between experts go to the lower index, as in
    `lax.top_k`.
    """
    G, g, E = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    # top-k as `lax.top_k` orders it: descending, equal values by index (the
    # zero rows padding a group's tail tie on every expert)
    gate_vals, gate_idx = (t[..., :top_k] for t in torch.sort(probs, dim=-1, descending=True,
                                                                stable=True))
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # priority: choice rank first, then token order
    choice = F.one_hot(gate_idx.transpose(1, 2), E).reshape(G, top_k * g, E)
    slot = (torch.cumsum(choice, dim=1) - 1).reshape(G, top_k, g, E)
    slot = torch.gather(slot, 3, gate_idx.transpose(1, 2)[..., None])[..., 0].transpose(1, 2)
    keep = slot < capacity  # (G, g, k)
    cell = gate_idx * capacity + torch.clamp(slot, max=capacity - 1)
    dispatch = torch.zeros(G, g, E * capacity, dtype=torch.bool, device=probs.device)
    dispatch.scatter_(2, cell, keep)
    combine = torch.zeros(G, g, E * capacity, dtype=torch.float32, device=probs.device)
    combine.scatter_(2, cell, gate_vals * keep)

    # Switch load-balance loss: E * sum_e (frac_tokens_e * mean_prob_e)
    frac = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    aux_loss = E * torch.sum(frac * probs.mean(dim=(0, 1)))
    z_loss = torch.mean(torch.square(torch.logsumexp(router_logits, dim=-1)))
    shape = (G, g, E, capacity)
    return dispatch.reshape(shape), combine.reshape(shape), aux_loss, z_loss


def moe_ffn(params, x, cfg):
    """x: (B,S,d) -> (y (B,S,d), aux_loss, z_loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    tokens = B * S
    g = min(cfg.moe_group_size, tokens)
    pad = (-tokens) % g  # the ragged tail is padded; padded rows' outputs are dropped
    G = (tokens + pad) // g
    C = expert_capacity(g, E, k, cfg.capacity_factor)

    xg = F.pad(x.reshape(tokens, d), (0, 0, 0, pad)).reshape(G, g, d)
    logits = xg.float() @ params.router
    dispatch, combine, aux, z = top_k_routing(logits, k, C)

    dtype = x.dtype
    expert_in = torch.einsum("gtd,gtec->gecd", xg, dispatch.to(dtype))  # (G, E, C, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, params.w_gate))
    h = h * torch.einsum("gecd,edf->gecf", expert_in, params.w_up)
    expert_out = torch.einsum("gecf,efd->gecd", h, params.w_down)
    y = torch.einsum("gecd,gtec->gtd", expert_out, combine.to(dtype))
    return y.reshape(G * g, d)[:tokens].reshape(B, S, d), aux, z
