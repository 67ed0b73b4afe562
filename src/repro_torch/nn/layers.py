"""Core layers for the MARL networks (counterpart of `repro.nn.layers`).

Each layer is a frozen dataclass with ``init(generator) -> params`` and a
pure ``apply(params, *inputs)``; params are nested dicts of tensors with
the JAX pytree's keys and its ``w: (in, out)`` layout (``y = x @ w + b``),
so weights cross between the packages with no transpose.

Every layer but `Embed` also runs several seed lanes at once
(`repro_torch.lanes`): params whose leaves lead with a lane axis
``(S, ...)`` apply to inputs whose lane axis sits just before the last
batch axis, ``(..., S, N, in)``, as one batched product per layer
(`affine`).  ``axes()`` gives the logical sharding axes of `init`'s tree,
as the reference's layers do (`repro_torch.distributed.sharding`).
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
    logical_axes: tuple = (None, None)

    def init(self, generator):
        """Initialise ``{"w", ("b")}`` with `w_init` / zeros."""
        params = {"w": self.w_init(generator, (self.in_dim, self.out_dim))}
        if self.use_bias:
            params["b"] = torch.zeros(self.out_dim, device=generator.device)
        return params

    def apply(self, params, x):
        """Apply the affine map to the trailing dim of ``x``."""
        return affine(x, params["w"], params["b"] if self.use_bias else None)

    def axes(self):
        """Logical sharding axes matching `init`'s tree."""
        out = {"w": self.logical_axes}
        if self.use_bias:
            out["b"] = (self.logical_axes[1],)
        return out


@dataclasses.dataclass(frozen=True)
class Embed:
    """Token-embedding table lookup (with the tied-output `attend`)."""

    vocab: int
    dim: int
    dtype: torch.dtype = torch.float32
    logical_axes: tuple = (None, None)

    def init(self, generator):
        """Initialise the ``(vocab, dim)`` table from a unit normal."""
        return {"embedding": initializers.normal(1.0)(generator, (self.vocab, self.dim),
                                                      self.dtype)}

    def apply(self, params, ids):
        """The table's rows for integer ``ids`` (any shape): ``(*ids.shape, dim)``."""
        return params["embedding"][ids]

    def attend(self, params, x):
        """Tied-output logits ``x @ embedding.T``."""
        return x @ params["embedding"].T

    def axes(self):
        """Logical sharding axes matching `init`'s tree."""
        return {"embedding": self.logical_axes}


def _per_lane(v):
    """A ``(dim,)`` feature vector as it is, or lane ones ``(S, dim)`` as ``(S, 1, dim)``."""
    return v if v.dim() == 1 else v[:, None]


@dataclasses.dataclass(frozen=True)
class RMSNorm:
    """Root-mean-square normalisation (no mean subtraction, float32 math)."""

    dim: int
    eps: float = 1e-6

    def init(self, generator):
        """Initialise the per-feature ``scale`` at ones."""
        return {"scale": torch.ones(self.dim, device=generator.device)}

    def apply(self, params, x):
        """Normalise the trailing dim by its RMS, rescale, and return ``x``'s dtype."""
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps)
        return (y * _per_lane(params["scale"])).to(x.dtype)

    def axes(self):
        """Logical sharding axes matching `init`'s tree."""
        return {"scale": (None,)}


@dataclasses.dataclass(frozen=True)
class LayerNorm:
    """Layer normalisation: mean and (population) variance over the trailing dim."""

    dim: int
    eps: float = 1e-5

    def init(self, generator):
        """Initialise ``scale`` at ones and ``bias`` at zeros."""
        dev = generator.device
        return {"scale": torch.ones(self.dim, device=dev),
                "bias": torch.zeros(self.dim, device=dev)}

    def apply(self, params, x):
        """Normalise the trailing dim, rescale and shift, and return ``x``'s dtype."""
        x32 = x.float()
        mean = torch.mean(x32, dim=-1, keepdim=True)
        centered = x32 - mean
        var = torch.mean(torch.square(centered), dim=-1, keepdim=True)
        y = centered * torch.rsqrt(var + self.eps)
        return (y * _per_lane(params["scale"]) + _per_lane(params["bias"])).to(x.dtype)

    def axes(self):
        """Logical sharding axes matching `init`'s tree."""
        return {"scale": (None,), "bias": (None,)}


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

    def axes(self):
        """Logical sharding axes matching `init`'s tree."""
        return {f"dense_{i}": l.axes() for i, l in enumerate(self._layers())}


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

    def axes(self):
        """Logical sharding axes matching `init`'s tree."""
        return {"wi": (None, None), "wh": (None, None), "bi": (None,), "bh": (None,)}


@dataclasses.dataclass(frozen=True)
class Sequential:
    """Compose layers in order, each reading its own ``layer_{i}`` params."""

    layers: Sequence

    def init(self, generator):
        """Initialise one ``layer_{i}`` sub-tree per layer, in order, from ``generator``."""
        return {f"layer_{i}": l.init(generator) for i, l in enumerate(self.layers)}

    def apply(self, params, x):
        """Apply each layer in sequence."""
        for i, layer in enumerate(self.layers):
            x = layer.apply(params[f"layer_{i}"], x)
        return x

    def axes(self):
        """Logical sharding axes matching `init`'s tree."""
        return {f"layer_{i}": l.axes() for i, l in enumerate(self.layers)}
