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
output, as the reference does; `model.forward_train` scales them by
``cfg.router_aux_weight`` and ``cfg.router_z_weight``.  Training
differentiates through the router logits, the renormalised gates in
``combine`` (the scatter's source) and the expert weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    einsum,
    is_dtensor,
    local_call,
    matmul,
    regroup,
    shard_index,
    sharded_dims,
    with_logical_constraint,
)
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


# `init_moe`'s logical axes (moe.py:36-41)
MOE_AXES = {
    "router": ("embed", None),
    "w_gate": ("expert", "embed", "expert_ffn"),
    "w_up": ("expert", "embed", "expert_ffn"),
    "w_down": ("expert", "expert_ffn", "embed"),
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
    `lax.top_k`.  On a DTensor each rank routes its own groups
    (`_sharded_routing`).
    """
    if is_dtensor(router_logits):
        dispatch, combine, frac, mean_prob, z_loss = _sharded_routing(router_logits, top_k,
                                                                      capacity)
    else:
        dispatch, combine, frac, mean_prob, z_loss = _routing(router_logits, top_k, capacity)
    # Switch load-balance loss: E * sum_e (frac_tokens_e * mean_prob_e)
    aux_loss = router_logits.shape[-1] * torch.sum(frac * mean_prob)
    return dispatch, combine, aux_loss, z_loss


def _routing(router_logits, top_k: int, capacity: int):
    """`top_k_routing`'s dispatch and combine, and beside them the load-balance
    loss's two means (each expert's share of first choices, its mean
    probability) and the z-loss."""
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

    frac = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    z_loss = torch.mean(torch.square(torch.logsumexp(router_logits, dim=-1)))
    shape = (G, g, E, capacity)
    return (dispatch.reshape(shape), combine.reshape(shape), frac, probs.mean(dim=(0, 1)),
            z_loss)


def _sharded_routing(router_logits, top_k: int, capacity: int):
    """`_routing` on a DTensor: each rank routes its groups (a group never
    spans ranks).  Each rank holds as many groups, so a mean over all groups
    is the sum of each rank's mean over the group shards: the three means
    come back as partial sums of the local means so divided (a pending
    average would hand each rank the whole gradient in the backward)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = router_logits.device_mesh
    names = mesh.mesh_dim_names
    dims = sharded_dims(router_logits)
    place = tuple(Shard(0) if dims.get(a) == 0 else Replicate() for a in names)
    shards = shard_index(mesh, [a for a in names if dims.get(a) == 0])[1]
    mean = [Partial() if isinstance(p, Shard) else Replicate() for p in place]

    def route(lg):
        dispatch, combine, *means = _routing(lg, top_k, capacity)
        return (dispatch, combine, *(m / shards for m in means))

    return local_call(route, mesh, (list(place), list(place), mean, mean, mean), (place,),
                      router_logits)


def moe_ffn(params, x, cfg):
    """x: (B,S,d) -> (y (B,S,d), aux_loss, z_loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    tokens = B * S
    g = min(cfg.moe_group_size, tokens)
    pad = (-tokens) % g  # the ragged tail is padded; padded rows' outputs are dropped
    G = (tokens + pad) // g
    C = expert_capacity(g, E, k, cfg.capacity_factor)

    xg = F.pad(regroup(x.reshape(tokens, d), G), (0, 0, 0, pad)).reshape(G, g, d)
    logits = matmul(xg.float(), params.router)
    dispatch, combine, aux, z = top_k_routing(logits, k, C)

    dtype = x.dtype
    expert_in = einsum("gtd,gtec->gecd", xg, dispatch.to(dtype))  # (G, E, C, d)
    expert_in = with_logical_constraint(expert_in, ("batch", "expert", None, "embed"))
    h = F.silu(einsum("gecd,edf->gecf", expert_in, params.w_gate))
    h = h * einsum("gecd,edf->gecf", expert_in, params.w_up)
    h = with_logical_constraint(h, ("batch", "expert", None, "expert_ffn"))
    expert_out = einsum("gecf,efd->gecd", h, params.w_down)
    expert_out = with_logical_constraint(expert_out, ("batch", "expert", None, "embed"))
    y = einsum("gecd,gtec->gtd", expert_out, combine.to(dtype))
    if is_dtensor(y):
        return _sharded_ungroup(y, tokens, (B, S, d)), aux, z
    return y.reshape(G * g, d)[:tokens].reshape(B, S, d), aux, z


def _sharded_ungroup(y, tokens: int, shape):
    """``y.reshape(G * g, d)[:tokens].reshape(B, S, d)`` for a DTensor ``y`` (G, g, d)
    whose groups may be sharded: each rank reshapes its own groups, which are
    its streams' tokens when the batch shards divide both G and B and no
    group is padded; otherwise the groups are gathered first."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = y.device_mesh
    names = mesh.mesh_dim_names
    B, S, d = shape
    rows = [a for a, dim in sharded_dims(y).items() if dim == 0]
    shards = shard_index(mesh, rows)[1]
    if y.shape[0] * y.shape[1] != tokens or B % shards:
        rows = []
    place = tuple(Shard(0) if a in rows else Replicate() for a in names)
    return local_call(lambda t: t.reshape(-1, S, d), mesh, list(place), (place,), y)
