"""Mamba1 block (counterpart of the Mamba1 half of `repro.models.ssm`).

`Mamba1` holds `init_mamba1`'s parameters under the JAX names and dtypes
(``ssm.py:31-71``); `mamba1_forward` is the full-sequence (prefill) block,
whose scan is `repro_torch.kernels.selective_scan` (the CUDA kernel on a
GPU, its plain version on the CPU), and `mamba1_decode` the single-token
step, which runs no kernel.  `selective_scan_chunked`, a JAX memory device
for training, is not ported; Mamba2 waits for its own slice.

Like the reference, this Mamba1 has no RMS norms on B, C or delta, which
the published Falcon-Mamba adds: the port computes what the JAX package
computes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.layers import Params, _trunc_normal, causal_depthwise_conv1d


def dt_rank(cfg) -> int:
    """Rank of the delta projection."""
    return max(1, cfg.d_model // 16)


def init_mamba1(generator, cfg):
    """A Mamba1 block's parameters: same names, shapes and dtypes as JAX.

    The draws follow the reference's distributions, not its numbers:
    S4D-real ``A_log = log(tile(1..N))``, ``dt_proj_b`` the inverse
    softplus of a log-uniform delta in [1e-3, 1e-1], ``conv_b`` zero and
    ``D`` one.
    """
    d, di, n, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    r = dt_rank(cfg)
    dtype = cfg.activation_dtype
    dev = generator.device
    A = torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    u = torch.rand(di, generator=generator, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": _trunc_normal(generator, (d, 2 * di), 1.0 / math.sqrt(d), dtype),
        "conv_w": _trunc_normal(generator, (di, K), 1.0 / math.sqrt(K), torch.float32),
        "conv_b": torch.zeros(di, dtype=torch.float32, device=dev),
        "x_proj": _trunc_normal(generator, (di, r + 2 * n), 1.0 / math.sqrt(di), dtype),
        "dt_proj_w": _trunc_normal(generator, (r, di), r**-0.5, torch.float32),
        "dt_proj_b": torch.log(torch.exp(dt) - 1.0),  # inverse softplus
        "A_log": torch.log(A),
        "D": torch.ones(di, dtype=torch.float32, device=dev),
        "out_proj": _trunc_normal(generator, (di, d), 1.0 / math.sqrt(di), dtype),
    }


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns into the
    # identity above its threshold (20), so it is not used here
    return torch.logaddexp(x, x.new_zeros(()))


class Mamba1(Params):
    """One Mamba1 mixer: `init_mamba1`'s parameters plus the config."""

    def __init__(self, tensors, cfg):
        super().__init__(tensors, trainable=False)  # Mamba1 training is not ported
        self.cfg = cfg

    def forward(self, x):
        """Full sequence; see `mamba1_forward`."""
        return mamba1_forward(self, x, self.cfg)

    def decode(self, x, conv_state, ssm_state):
        """One token; see `mamba1_decode`."""
        return mamba1_decode(self, x, conv_state, ssm_state, self.cfg)


def _split_proj(proj, cfg):
    # the x_proj output splits as [dt (r), B (N), C (N)] (ssm.py:145)
    r, n = dt_rank(cfg), cfg.ssm_state
    return proj.split([r, n, n], dim=-1)


def mamba1_forward(m, x, cfg):
    """Full-sequence (prefill) mamba1 block. x: (B,S,d).

    Returns (y, (conv_state, ssm_state)): the final states, which are the
    decode cache after prefill.
    """
    S = x.shape[1]
    xz = x @ m.in_proj  # (B,S,2di)
    xs, z = xz.chunk(2, dim=-1)

    # Prefill convolves in the model dtype, with the conv weights cast down,
    # then adds the float32 bias; the state it keeps is the *pre-conv* xs
    # in float32 (ssm.py:138-141).  Decode convolves in float32 instead.
    conv_out = causal_depthwise_conv1d(xs, m.conv_w.to(xs.dtype)).float() + m.conv_b
    new_conv_state = xs[:, S - (cfg.ssm_conv - 1):].float()
    xs = F.silu(conv_out).to(x.dtype)

    proj = xs @ m.x_proj  # (B,S,r+2n)
    dt_r, Bm, Cm = _split_proj(proj, cfg)
    # delta is float32; B and C stay in the model dtype until the scan casts them
    delta = _softplus(dt_r.float() @ m.dt_proj_w + m.dt_proj_b)
    A = -torch.exp(m.A_log)
    y, h_final = selective_scan(xs, delta, A, Bm.contiguous(), Cm.contiguous(), m.D)
    y = y * F.silu(z)  # the output gate runs in the model dtype (ssm.py:162)
    return y @ m.out_proj, (new_conv_state, h_final)


def mamba1_decode(m, x, conv_state, ssm_state, cfg):
    """Single-token decode. x: (B,1,d); conv_state: (B,K-1,di) float32;
    ssm_state: (B,di,N) float32. Returns (y, (conv_state, ssm_state))."""
    xz = x @ m.in_proj
    xs, z = xz.chunk(2, dim=-1)  # (B,1,di)
    # float32 conv with the float32 weights, unlike prefill (ssm.py:178-181)
    conv_out, new_conv_state = causal_depthwise_conv1d(
        xs.float(), m.conv_w, state=conv_state
    )
    xs = F.silu(conv_out + m.conv_b).to(x.dtype)  # (B,1,di)

    proj = xs @ m.x_proj
    dt_r, Bm, Cm = _split_proj(proj, cfg)
    delta = _softplus(dt_r.float() @ m.dt_proj_w + m.dt_proj_b)  # (B,1,di)
    A = -torch.exp(m.A_log)

    x_t = xs[:, 0].float()
    d_t = delta[:, 0]
    B_t = Bm[:, 0].float()
    C_t = Cm[:, 0].float()
    dA = torch.exp(d_t[..., None] * A)
    h = dA * ssm_state + (d_t * x_t)[..., None] * B_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C_t) + m.D * x_t
    # y is cast to x's dtype before the gate (ssm.py:197)
    y = y[:, None].to(x.dtype) * F.silu(z)
    return y @ m.out_proj, (new_conv_state, h)
