"""Weight initializers drawing from an explicit `torch.Generator`.

Counterparts of `repro.nn.initializers`.  The draws follow the same
distributions, not the same numbers: JAX's threefry and PyTorch's
generators never agree, so parity tests convert JAX-initialised weights
instead (`repro_torch.convert`).  Each initializer is
``init(generator, shape, dtype=torch.float32)``; tensors are made on the
generator's device.
"""
from __future__ import annotations

import math

import torch


def zeros(generator, shape, dtype=torch.float32):
    """All zeros (nothing drawn; the generator gives the device)."""
    return torch.zeros(shape, dtype=dtype, device=generator.device)


def ones(generator, shape, dtype=torch.float32):
    """All ones (nothing drawn; the generator gives the device)."""
    return torch.ones(shape, dtype=dtype, device=generator.device)


def normal(stddev: float = 1.0):
    """Gaussian with standard deviation ``stddev``, drawn in float32."""

    def init(generator, shape, dtype=torch.float32):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * stddev).to(dtype)

    return init


def truncated_normal(stddev: float = 1.0):
    """Gaussian truncated at two standard deviations, then scaled by ``stddev``."""

    def init(generator, shape, dtype=torch.float32):
        x = torch.empty(shape, device=generator.device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (x * stddev).to(dtype)

    return init


def lecun_normal(in_axis: int = -2):
    """Fan-in scaled normal truncated at two standard deviations."""

    def init(generator, shape, dtype=torch.float32):
        fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
        x = torch.empty(shape, device=generator.device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (x / math.sqrt(fan_in)).to(dtype)

    return init


def orthogonal(scale: float = 1.0):
    """Orthogonal init (QR of a Gaussian), the PPO-style policy default."""

    def init(generator, shape, dtype=torch.float32):
        if len(shape) < 2:
            raise ValueError("orthogonal init needs >=2D shape")
        n_rows, n_cols = shape[-2], shape[-1]
        a = torch.randn(
            max(n_rows, n_cols), min(n_rows, n_cols),
            generator=generator, device=generator.device,
        )
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (scale * q.expand(shape)).to(dtype).contiguous()

    return init
