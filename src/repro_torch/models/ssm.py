"""Mamba1 and Mamba2 blocks (counterpart of `repro.models.ssm`).

`Mamba1` holds `init_mamba1`'s parameters under the JAX names and dtypes
(``ssm.py:31-71``); `mamba1_forward` is the full-sequence block, for
training and prefill, whose scan is `repro_torch.kernels.selective_scan`
(the CUDA kernels on a GPU, forward and backward; the plain version on the
CPU), and `mamba1_decode` the single-token step, which runs no kernel.
`selective_scan_chunked` is the reference's memory device for training
(``ssm.py:74-119``, its default branch): plain PyTorch, the outer loop over
chunks with each chunk under `torch.utils.checkpoint`, so only the carried
state crosses chunks.  The tests hold it against JAX's, and chip_smoke.py
uses it as the backward kernel's oracle where a step-by-step graph would
not fit.

`Mamba2` holds `init_mamba2`'s parameters (``ssm.py:205-245``);
`mamba2_forward` runs the SSD over chunks (`ssd_chunked`, plain PyTorch as
the reference's is jnp, and trained by autograd through it) and
`mamba2_decode` one token.  Both mixers' parameters are trainable.

Like the reference, this Mamba1 has no RMS norms on B, C or delta, which
the published Falcon-Mamba adds: the port computes what the JAX package
computes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    einsum,
    is_dtensor,
    local_call,
    matmul,
    sharded_dims,
    with_logical_constraint,
)
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


# `init_mamba1`'s logical axes (ssm.py:60-70)
MAMBA1_AXES = {
    "in_proj": ("embed", "dinner"),
    "conv_w": ("dinner", None),
    "conv_b": ("dinner",),
    "x_proj": ("dinner", None),
    "dt_proj_w": (None, "dinner"),
    "dt_proj_b": ("dinner",),
    "A_log": ("dinner", "state"),
    "D": ("dinner",),
    "out_proj": ("dinner", "embed"),
}


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns into the
    # identity above its threshold (20), so it is not used here
    return torch.logaddexp(x, x.new_zeros(()))


class Mamba1(Params):
    """One Mamba1 mixer: `init_mamba1`'s parameters plus the config."""

    def __init__(self, tensors, cfg):
        super().__init__(tensors)
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


def _scan_chunk(h, x, delta, A, B, C):
    """``selective_scan_chunked``'s body: a chunk's steps from state ``h``.

    The chunk's operands are cast to float32 here, chunk-locally, as the
    reference casts them (``ssm.py:97-103``).  Returns (h after the chunk,
    y (b, chunk, di) float32 without the D term).
    """
    x, delta, B, C = (t.float() for t in (x, delta, B, C))
    ys = []
    for t in range(x.shape[1]):
        d_t = delta[:, t]
        h = torch.exp(d_t[..., None] * A) * h + (d_t * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return h, torch.stack(ys, 1)


def selective_scan_chunked(x, delta, A, B, C, D, chunk: int):
    """The Mamba1 recurrence over chunks of ``chunk`` steps (``ssm.py:74-119``).

    x, delta: (b,S,di); A: (di,N); B, C: (b,S,N); D: (di,).  Returns (y
    (b,S,di) in x's dtype, h_final (b,di,N) float32), the function
    `selective_scan` computes.  A ragged tail is padded with delta = 0
    (decay 1, no input), which leaves the state as it was.  Each chunk runs
    under `torch.utils.checkpoint`: the backward keeps only the state
    entering each chunk and runs the chunk's steps again.
    """
    b, S, di = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x_p, delta_p, B_p, C_p = (F.pad(t, (0, 0, 0, pad)) for t in (x, delta, B, C))
    else:
        x_p, delta_p, B_p, C_p = x, delta, B, C
    h = torch.zeros(b, di, A.shape[-1], dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S + pad, chunk):
        part = [t[:, s0:s0 + chunk] for t in (x_p, delta_p, B_p, C_p)]
        h, y = checkpoint(_scan_chunk, h, part[0], part[1], A, part[2], part[3],
                          use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S] + x.float() * D
    return y.to(x.dtype), h


def mamba1_forward(m, x, cfg):
    """Full-sequence (training and prefill) mamba1 block. x: (B,S,d).

    Returns (y, (conv_state, ssm_state)): the final states, which are the
    decode cache after prefill.
    """
    S = x.shape[1]
    xz = matmul(x, m.in_proj)  # (B,S,2di)
    xs, z = xz.chunk(2, dim=-1)
    xs = with_logical_constraint(xs, ("batch", None, "dinner"))

    # Prefill convolves in the model dtype, with the conv weights cast down,
    # then adds the float32 bias; the state it keeps is the *pre-conv* xs
    # in float32 (ssm.py:138-141).  Decode convolves in float32 instead.
    conv_out = causal_depthwise_conv1d(xs, m.conv_w.to(xs.dtype)).float() + m.conv_b
    new_conv_state = xs[:, S - (cfg.ssm_conv - 1):].float()
    xs = F.silu(conv_out).to(x.dtype)

    proj = matmul(xs, m.x_proj)  # (B,S,r+2n)
    dt_r, Bm, Cm = _split_proj(proj, cfg)
    # delta is float32; B and C stay in the model dtype until the scan casts them
    delta = _softplus(matmul(dt_r.float(), m.dt_proj_w) + m.dt_proj_b)
    A = -torch.exp(m.A_log)
    y, h_final = selective_scan(xs, delta, A, Bm.contiguous(), Cm.contiguous(), m.D)
    y = y * F.silu(z)  # the output gate runs in the model dtype (ssm.py:162)
    return with_logical_constraint(matmul(y, m.out_proj), ("batch", None, "embed")), (
        new_conv_state, h_final)


def mamba1_decode(m, x, conv_state, ssm_state, cfg):
    """Single-token decode. x: (B,1,d); conv_state: (B,K-1,di) float32;
    ssm_state: (B,di,N) float32. Returns (y, (conv_state, ssm_state))."""
    xz = matmul(x, m.in_proj)
    xs, z = xz.chunk(2, dim=-1)  # (B,1,di)
    # float32 conv with the float32 weights, unlike prefill (ssm.py:178-181)
    conv_out, new_conv_state = causal_depthwise_conv1d(
        xs.float(), m.conv_w, state=conv_state
    )
    xs = F.silu(conv_out + m.conv_b).to(x.dtype)  # (B,1,di)

    proj = matmul(xs, m.x_proj)
    dt_r, Bm, Cm = _split_proj(proj, cfg)
    delta = _softplus(matmul(dt_r.float(), m.dt_proj_w) + m.dt_proj_b)  # (B,1,di)
    A = -torch.exp(m.A_log)

    x_t = xs[:, 0].float()
    d_t = delta[:, 0]
    B_t = Bm[:, 0].float()
    C_t = Cm[:, 0].float()
    dA = torch.exp(d_t[..., None] * A)
    h = dA * ssm_state + (d_t * x_t)[..., None] * B_t[:, None, :]
    y = einsum("bdn,bn->bd", h, C_t) + m.D * x_t
    # y is cast to x's dtype before the gate (ssm.py:197)
    y = y[:, None].to(x.dtype) * F.silu(z)
    return matmul(y, m.out_proj), (new_conv_state, h)


# ================================================================= Mamba 2


def init_mamba2(generator, cfg):
    """A Mamba2 block's parameters: same names, shapes and dtypes as JAX.

    The draws follow the reference's distributions, not its numbers:
    ``dt_bias`` the inverse softplus of a log-uniform delta in [1e-3,
    1e-1], ``A_log`` the log of a uniform in [1, 16), ``conv_b`` zero,
    ``D`` and ``norm_scale`` one.
    """
    d, di, n, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    h = cfg.ssm_heads
    dtype = cfg.activation_dtype
    dev = generator.device
    conv_dim = di + 2 * n
    u = torch.rand(h, generator=generator, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    A = 1.0 + 15.0 * torch.rand(h, generator=generator, device=dev)
    return {
        "in_proj": _trunc_normal(generator, (d, 2 * di + 2 * n + h), 1.0 / math.sqrt(d), dtype),
        "conv_w": _trunc_normal(generator, (conv_dim, K), 1.0 / math.sqrt(K), torch.float32),
        "conv_b": torch.zeros(conv_dim, dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.exp(dt) - 1.0),  # inverse softplus
        "A_log": torch.log(A),
        "D": torch.ones(h, dtype=torch.float32, device=dev),
        "norm_scale": torch.ones(di, dtype=torch.float32, device=dev),
        "out_proj": _trunc_normal(generator, (di, d), 1.0 / math.sqrt(di), dtype),
    }


# `init_mamba2`'s logical axes (ssm.py:235-244)
MAMBA2_AXES = {
    "in_proj": ("embed", "dinner"),
    "conv_w": ("dinner", None),
    "conv_b": ("dinner",),
    "dt_bias": (None,),
    "A_log": (None,),
    "D": (None,),
    "norm_scale": ("dinner",),
    "out_proj": ("dinner", "embed"),
}


class Mamba2(Params):
    """One Mamba2 mixer: `init_mamba2`'s parameters plus the config."""

    def __init__(self, tensors, cfg):
        super().__init__(tensors)
        self.cfg = cfg

    def forward(self, x):
        """Full sequence; see `mamba2_forward`."""
        return mamba2_forward(self, x, self.cfg)

    def decode(self, x, conv_state, ssm_state):
        """One token; see `mamba2_decode`."""
        return mamba2_decode(self, x, conv_state, ssm_state, self.cfg)


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Mamba2's SSD over chunks of ``chunk`` steps (``ssm.py:248-301``).

    x: (b,S,h,p); dt: (b,S,h) (after the softplus); A: (h,) negative; B,
    C: (b,S,n); D: (h,).  Returns (y (b,S,h,p) in x's dtype, the final
    state (b,h,n,p) float32).  Like the reference, each chunk is cast to
    float32 and a ragged tail is padded with dt = 0 (decay 1, no input),
    which leaves the state as it was.  The chunk-local terms of all chunks
    are computed at once and only the carried state runs chunk by chunk;
    the reference scans the whole chunk body.  Its intra-chunk decay
    ``exp(cum_i - cum_j)`` is masked to j <= i after the exp, which
    overflows to inf (and inf * 0 to NaN) above the diagonal once a
    chunk's decay passes exp(88); here the exponent is masked first, so
    the two agree wherever the reference is finite.  The gradient stays
    finite as well: a masked entry's exp is 0 and `masked_fill` hands its
    exponent no gradient.
    """
    b, S, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:  # dt = 0 padding: decay exp(0) = 1 and zero input, the state unchanged
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xc = x.float().reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = B.float().reshape(b, nc, chunk, n)
    Cc = C.float().reshape(b, nc, chunk, n)

    cum = torch.cumsum(dtc * A, dim=2).transpose(2, 3)  # (b,c,h,l), decreasing in l
    # intra-chunk: M[i, j] = C_i . B_j * exp(cum_i - cum_j) for j <= i
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, -math.inf)
    M = scores[:, :, None] * torch.exp(seg)  # (b,c,h,i,j)
    xdt = (xc * dtc[..., None]).transpose(2, 3)  # (b,c,h,l,p)
    y = (M @ xdt).transpose(2, 3)  # (b,c,l,h,p)
    # each chunk's input to the state it hands on, then the carry chunk by chunk
    decay_to_end = torch.exp(cum[..., -1:] - cum)  # (b,c,h,l)
    contrib = torch.einsum("bcjn,bchjp,bchj->bchnp", Bc, xdt, decay_to_end)
    chunk_decay = torch.exp(cum[..., -1])[..., None, None]  # (b,c,h,1,1)
    state = torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = chunk_decay[:, c] * state + contrib[:, c]
    # inter-chunk: the state entering each chunk, decayed to each position
    y_inter = torch.einsum("bcin,bchnp,bchi->bcihp", Cc, torch.stack(entering, 1), torch.exp(cum))
    y = y + y_inter + D[:, None] * xc
    return y.reshape(b, nc * chunk, h, p)[:, :S].to(x.dtype), state


def _ssd(x, dt, A, B, C, D, chunk: int):
    """`ssd_chunked`; on DTensors each rank runs it on its streams (batch
    shards kept, everything else gathered), as a stream's chunks never mix
    with another's."""
    if not is_dtensor(x):
        return ssd_chunked(x, dt, A, B, C, D, chunk)
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    rows = {a for a, d in sharded_dims(x).items() if d == 0}
    batch = tuple(Shard(0) if a in rows else Replicate() for a in mesh.mesh_dim_names)
    whole = tuple(Replicate() for _ in mesh.mesh_dim_names)
    return local_call(lambda *t: ssd_chunked(*t, chunk), mesh, (list(batch), list(batch)),
                      (batch, batch, whole, batch, batch, whole), x, dt, A, B, C, D)


def _rmsnorm_gated(x, z, scale, eps=1e-6):
    """RMSNorm of ``x * silu(z)``: the gate in float32 cast to x's dtype first."""
    x = x * F.silu(z.float()).to(x.dtype)
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _split_mamba2_proj(proj, cfg):
    # in_proj's output splits as [z (di), xBC (di + 2n), dt (h)] (ssm.py:311-316)
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return proj.split([di, di + 2 * n, h], dim=-1)


def mamba2_forward(m, x, cfg):
    """Full-sequence (training and prefill) mamba2 block. x: (B,S,d).

    Returns (y, (conv_state (B,K-1,di+2n), ssm_state (B,h,n,p))), both
    float32: the decode cache after prefill.
    """
    B_, S, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_mamba2_proj(matmul(x, m.in_proj), cfg)
    xBC = with_logical_constraint(xBC, ("batch", None, "dinner"))
    # the model-dtype conv plus the float32 bias, as mamba1's prefill; the
    # state kept is the pre-conv xBC of the last K-1 positions (ssm.py:329-333)
    conv_out = causal_depthwise_conv1d(xBC, m.conv_w.to(xBC.dtype)).float() + m.conv_b
    new_conv_state = xBC[:, S - (cfg.ssm_conv - 1):].float()
    xBC = F.silu(conv_out).to(x.dtype)

    xs = xBC[..., :di].reshape(B_, S, h, p)
    Bm, Cm = xBC[..., di:di + n], xBC[..., di + n:]
    delta = _softplus(dt.float() + m.dt_bias)
    A = -torch.exp(m.A_log)
    y, state = _ssd(xs, delta, A, Bm, Cm, m.D, cfg.ssm_chunk)
    y = _rmsnorm_gated(y.reshape(B_, S, di), z, m.norm_scale)
    return with_logical_constraint(matmul(y, m.out_proj), ("batch", None, "embed")), (
        new_conv_state, state)


def mamba2_decode(m, x, conv_state, ssm_state, cfg):
    """Single-token decode. x: (B,1,d); conv_state: (B,K-1,di+2n) float32;
    ssm_state: (B,h,n,p) float32. Returns (y, (conv_state, ssm_state))."""
    B_ = x.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_mamba2_proj(matmul(x, m.in_proj), cfg)
    # float32 conv with the float32 weights, unlike prefill (ssm.py:359-362)
    conv_out, new_conv_state = causal_depthwise_conv1d(xBC.float(), m.conv_w, state=conv_state)
    xBC = F.silu(conv_out + m.conv_b).to(x.dtype)  # (B,1,di+2n)

    xs = xBC[..., :di].reshape(B_, h, p).float()
    Bm = xBC[:, 0, di:di + n].float()
    Cm = xBC[:, 0, di + n:].float()
    delta = _softplus(dt[:, 0].float() + m.dt_bias)  # (B,h)
    A = -torch.exp(m.A_log)

    dA = torch.exp(delta * A)
    xdt = xs * delta[..., None]  # (B,h,p)
    new_ssm = dA[..., None, None] * ssm_state + einsum("bn,bhp->bhnp", Bm, xdt)
    y = einsum("bn,bhnp->bhp", Cm, new_ssm) + m.D[:, None] * xs
    y = _rmsnorm_gated(y.reshape(B_, 1, di).to(x.dtype), z, m.norm_scale)
    return matmul(y, m.out_proj), (new_conv_state, new_ssm)
