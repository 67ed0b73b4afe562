"""The memory-core protocol for recurrent executors (port of `repro.nn.recurrent`).

Two interchangeable cores share the ``(carry, inputs) -> (carry, outputs)``
contract: `ScannedRNN` (GRU; its unroll is a Python loop over time) and
`LinearScannedRNN` (gated-linear; its unroll is one call of the
`repro_torch.kernels.recurrent_scan` op, the CUDA kernel on a GPU).
`reset_carry` is the one reset-masking rule, `window_start_carry` the
one rule for the memory a BPTT window opens with, and `burn_in_carry`
the R2D2 warm-up of that memory over a replayed window's prefix.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.recurrent_scan import linear_recurrent_scan
from repro_torch.nn.layers import Dense, GRUCell
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ScannedRNN:
    """A GRU memory core: ``step`` at act time, ``unroll`` for BPTT."""

    in_dim: int
    hidden_dim: int

    @property
    def cell(self) -> GRUCell:
        """The underlying GRU cell."""
        return GRUCell(self.in_dim, self.hidden_dim)

    def init(self, generator):
        """Initialise the cell parameters."""
        return self.cell.init(generator)

    def step(self, params, carry, x, reset=None):
        """One cell application; ``reset`` zeroes the incoming carry where True."""
        if reset is not None:
            carry = torch.where(reset[..., None], torch.zeros_like(carry), carry)
        h = self.cell.apply(params, carry, x)
        return h, h

    def unroll(self, params, carry, xs, resets=None):
        """``step`` over a leading time axis -> ``(final_carry, (T, ..., H))``."""
        hs = []
        for t in range(xs.shape[0]):
            carry, h = self.step(
                params, carry, xs[t], None if resets is None else resets[t]
            )
            hs.append(h)
        return carry, torch.stack(hs)


@dataclasses.dataclass(frozen=True)
class LinearScannedRNN:
    """A gated-linear (minGRU-style) core whose unroll is one fused scan.

        z_t = sigmoid(x_t W_z + c_z),  cand_t = tanh(x_t W_h + c_h)
        h_t = (1 - z_t) * h_{t-1} + z_t * cand_t

    Both gates depend on the input only, so ``h_t = a_t * h_{t-1} + b_t``
    with ``a = 1 - z, b = z * cand``, and the whole unroll is one call of
    `linear_recurrent_scan` with resets folded into the decay.  Params are
    one fused projection ``{"proj": Dense(in_dim, 2 * hidden_dim)}``.
    """

    in_dim: int
    hidden_dim: int

    @property
    def proj(self) -> Dense:
        """The fused gate+candidate input projection layer."""
        return Dense(self.in_dim, 2 * self.hidden_dim)

    def init(self, generator):
        """Initialise the projection parameters."""
        return {"proj": self.proj.init(generator)}

    def _gates(self, params, x):
        """Decay and forcing coefficients ``(a, b)`` for inputs ``x``."""
        g = self.proj.apply(params["proj"], x)
        z = torch.sigmoid(g[..., : self.hidden_dim])
        cand = torch.tanh(g[..., self.hidden_dim :])
        return 1.0 - z, z * cand

    def step(self, params, carry, x, reset=None):
        """One cell application, with the same reset rule as the unroll."""
        a, b = self._gates(params, x)
        if reset is not None:
            a = a * (1.0 - reset[..., None].to(a.dtype))
        h = a * carry + b
        return h, h

    def unroll(self, params, carry, xs, resets=None):
        """Whole-trajectory unroll through the recurrent-scan kernel."""
        a, b = self._gates(params, xs)
        # seed-lane params give lane-major products (`nn.layers.affine`);
        # the scan wants its (T, ..., H) operands laid out time-major
        # (replayed windows arrive time-major as strided views of the table)
        if resets is not None:
            resets = resets.contiguous()
        hs = linear_recurrent_scan(a.contiguous(), b.contiguous(), carry.contiguous(), resets)
        return hs[-1], hs


# ``recurrent_core`` names -> core classes ("gru" is the reference path).
CORES = {"gru": ScannedRNN, "linear": LinearScannedRNN}


def make_core(kind: str, in_dim: int, hidden_dim: int):
    """Build a memory core by registry name (``"gru"`` or ``"linear"``)."""
    try:
        cls = CORES[kind]
    except KeyError:
        raise ValueError(
            f"unknown recurrent core {kind!r}; choose from {sorted(CORES)}"
        ) from None
    return cls(in_dim, hidden_dim)


def reset_carry(carry, reset, initial=None):
    """Replace ``carry`` leaves by ``initial`` (default zeros) where ``reset``.

    ``reset`` is broadcast over each leaf's trailing dims.
    """
    if initial is None:
        initial = tree_map(torch.zeros_like, carry)

    def sel(fresh, old):
        r = reset.reshape(reset.shape + (1,) * (old.dim() - reset.dim()))
        return torch.where(r, fresh, old)

    return tree_map(sel, initial, carry)


def window_start_carry(extras, initial_carry, batch_shape, device):
    """The memory a BPTT window opens with: the stored carry of row 0.

    Callers without stored carries fall back to ``initial_carry``.
    """
    if "carry_in" in extras:
        return tree_map(lambda x: x[0], extras["carry_in"])
    return initial_carry(batch_shape, device)


def burn_in_carry(unroll, carry, xs, resets):
    """Warm a replayed window's start memory over its burn-in prefix, with no gradient.

    ``unroll`` is the caller's ``(carry, xs, resets) -> (carry, outputs)``
    closure (one agent's encoder -> core stack); ``xs`` / ``resets`` are
    the prefix rows, time-major.  The prefix runs under
    `torch.no_grad`, so nothing it launches is kept for a backward pass,
    and the carry comes back detached: training shapes the suffix only.
    A zero-length prefix hands back the (detached) carry as it is.
    """
    if tree_leaves(xs)[0].shape[0] > 0:
        with torch.no_grad():
            carry, _ = unroll(carry, xs, resets)
    return tree_map(lambda x: x.detach(), carry)
