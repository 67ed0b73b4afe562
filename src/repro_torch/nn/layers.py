"""Core layers for the MARL networks (counterpart of `repro.nn.layers`).

Each layer is a frozen dataclass with ``init(generator) -> params`` and a
pure ``apply(params, *inputs)``; params are nested dicts of tensors with
the JAX pytree's keys and its ``w: (in, out)`` layout (``y = x @ w + b``),
so weights cross between the packages with no transpose.

Every layer also runs several seed lanes at once (`repro_torch.lanes`):
params whose leaves lead with a lane axis ``(S, ...)`` apply to inputs
whose lane axis sits just before the last batch axis, ``(..., S, N, in)``,
as one batched product per layer (`affine`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.nn import initializers


def affine(x, w, b=None):
    """``x @ w + b``; with lane params ``w: (S, in, out)``, ``b: (S, out)`` per lane.

    Lane inputs are ``(..., S, N, in)``; the result is ``(..., S, N, out)``.
    """
    if w.dim() == 2:
        y = x @ w
        return y if b is None else y + b
    lead = x.shape[:-3]
    if lead:  # (..., S, N, in) -> (S, prod(...) * N, in) for one batched product
        x = x.movedim(-3, 0).reshape(w.shape[0], -1, x.shape[-1])
    y = torch.bmm(x, w) if b is None else torch.baddbmm(b[:, None], x, w)
    if lead:
        y = y.reshape(w.shape[0], *lead, -1, w.shape[-1]).movedim(0, -3)
    return y


@dataclasses.dataclass(frozen=True)
class Dense:
    """Affine layer ``y = x @ w (+ b)``."""

    in_dim: int
    out_dim: int
    use_bias: bool = True
    w_init: Callable = dataclasses.field(default_factory=initializers.lecun_normal)

    def init(self, generator):
        """Initialise ``{"w", ("b")}`` with `w_init` / zeros."""
        params = {"w": self.w_init(generator, (self.in_dim, self.out_dim))}
        if self.use_bias:
            params["b"] = torch.zeros(self.out_dim, device=generator.device)
        return params

    def apply(self, params, x):
        """Apply the affine map to the trailing dim of ``x``."""
        return affine(x, params["w"], params["b"] if self.use_bias else None)


@dataclasses.dataclass(frozen=True)
class MLP:
    """Plain multi-layer perceptron used by the policy/critic networks."""

    sizes: Sequence[int]  # [in, hidden..., out]
    activation: Callable = torch.relu
    activate_final: bool = False
    w_init: Callable = dataclasses.field(default_factory=initializers.orthogonal)

    def _layers(self):
        return [
            Dense(self.sizes[i], self.sizes[i + 1], w_init=self.w_init)
            for i in range(len(self.sizes) - 1)
        ]

    def init(self, generator):
        """Initialise one ``dense_{i}`` sub-tree per layer."""
        return {f"dense_{i}": l.init(generator) for i, l in enumerate(self._layers())}

    def apply(self, params, x):
        """Forward pass, activating between layers (and after, if asked)."""
        layers = self._layers()
        for i, layer in enumerate(layers):
            x = layer.apply(params[f"dense_{i}"], x)
            if i < len(layers) - 1 or self.activate_final:
                x = self.activation(x)
        return x


@dataclasses.dataclass(frozen=True)
class GRUCell:
    """Minimal GRU cell: r/z/n gate order, ``hn`` inside the reset product."""

    in_dim: int
    hidden_dim: int

    def init(self, generator):
        """Initialise input/hidden gate projections and their biases."""
        h = self.hidden_dim
        dev = generator.device
        return {
            "wi": initializers.lecun_normal()(generator, (self.in_dim, 3 * h)),
            "wh": initializers.orthogonal()(generator, (h, 3 * h)),
            "bi": torch.zeros(3 * h, device=dev),
            "bh": torch.zeros(3 * h, device=dev),
        }

    def apply(self, params, h, x):
        """h: (..., hidden), x: (..., in) -> new h."""
        gates_x = affine(x, params["wi"], params["bi"])
        gates_h = affine(h, params["wh"], params["bh"])
        xr, xz, xn = gates_x.chunk(3, dim=-1)
        hr, hz, hn = gates_h.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h
