"""A Mamba1 language model in plain PyTorch: the reference for the falcon-mamba cells.

It computes what the port's Mamba1 stack computes (arXiv:2312.00752's
selective SSM as the port and its JAX original write it): per layer an
RMS norm, ``in_proj`` into ``x`` and the gate ``z``, a causal depthwise
convolution of ``x`` with a bias, SiLU, ``x_proj`` into the rank-``r``
step input and ``B``, ``C``, ``delta = softplus(dt @ dt_proj_w +
dt_proj_b)``, the scan ``h_t = exp(delta_t A) h_{t-1} + delta_t x_t B_t``,
``y_t = C_t h_t + D x_t``, the gate ``y * silu(z)`` and ``out_proj``,
added to the residual; then the final RMS norm and the unembedding.  The
published Falcon-Mamba also RMS-normalises B, C and delta inside the
mixer; the port does not, and neither does this reference (PERF.md lists
the departure).

Everything runs in float32 with TF32 off, step by step through the scan
(one fused multiply-add a step over a chunk of ``SCAN_CHUNK`` steps whose
decays and inputs are formed at once).  ``fp8`` lowers the precision of
every matrix product's operands for the controls (`mm`).  The weights are
inputs the benchmark makes (`make_weights`): a few large seeded draws on
the device, in the layout the program's `LM` takes, regenerated group by
group where the reference needs them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SCAN_CHUNK = 64
RMS_EPS = 1e-6

# (group, dtype key, init) of one Mamba1 layer's weights, then the model's own
LAYER_GROUPS = ("norm.scale", "mamba.in_proj", "mamba.conv_w", "mamba.conv_b", "mamba.x_proj",
                "mamba.dt_proj_w", "mamba.dt_proj_b", "mamba.A_log", "mamba.D",
                "mamba.out_proj")
MODEL_GROUPS = ("embed.embedding", "unembed.w", "final_norm.scale")


def dims(cfg: dict) -> dict:
    """d, di, N, K, r, V, L of a configuration file."""
    return {"d": cfg["hidden_size"], "di": cfg["intermediate_size"], "N": cfg["state_size"],
            "K": cfg["conv_kernel"], "r": cfg["time_step_rank"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"]}


def _dtype(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["torch_dtype"]]


def group_spec(cfg: dict, group: str):
    """``(shape, dtype, init)`` of a weight group; a layer group's shape leads with L."""
    m, wd = dims(cfg), _dtype(cfg)
    d, di, n, k, r, V, L = (m[x] for x in ("d", "di", "N", "K", "r", "V", "L"))
    f32 = torch.float32
    return {
        "norm.scale": ((L, d), f32, "ones"),
        "mamba.in_proj": ((L, d, 2 * di), wd, 1 / math.sqrt(d)),
        "mamba.conv_w": ((L, di, k), f32, 1 / math.sqrt(k)),
        "mamba.conv_b": ((L, di), f32, "zeros"),
        "mamba.x_proj": ((L, di, r + 2 * n), wd, 1 / math.sqrt(di)),
        "mamba.dt_proj_w": ((L, r, di), f32, r ** -0.5),
        "mamba.dt_proj_b": ((L, di), f32, "dt_bias"),
        "mamba.A_log": ((L, di, n), f32, "s4d"),
        "mamba.D": ((L, di), f32, "ones"),
        "mamba.out_proj": ((L, di, d), wd, 1 / math.sqrt(di)),
        "embed.embedding": ((V, d), wd, 1.0),
        "unembed.w": ((d, V), wd, 1 / math.sqrt(d)),
        "final_norm.scale": ((d,), f32, "ones"),
    }[group]


def draw_group(cfg: dict, group: str, seed: int, device) -> torch.Tensor:
    """One weight group, the same for the same ``seed`` whatever else is drawn.

    Normal draws scaled by their standard deviation, in the group's dtype;
    ``delta``'s bias is the inverse softplus of a log-uniform step in [1e-3,
    1e-1]; ``A_log`` is S4D-real's ``log(1..N)``.
    """
    shape, dtype, init = group_spec(cfg, group)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "s4d":
        n = shape[-1]
        a = torch.arange(1, n + 1, dtype=dtype, device=device).log()
        return a.expand(shape).contiguous()
    index = (LAYER_GROUPS + MODEL_GROUPS).index(group)
    g = torch.Generator(device).manual_seed((int(seed) * 1_000_003 + 7_919 * (index + 1)) % 2**63)
    if init == "dt_bias":
        u = torch.rand(shape, generator=g, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        return torch.log(torch.expm1(dt))
    return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(init)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every group, stacked over the layers: ``{group: tensor}``."""
    return {gname: draw_group(cfg, gname, seed, device) for gname in LAYER_GROUPS + MODEL_GROUPS}


def as_tree(stacked: dict, num_layers: int) -> dict:
    """The program's parameter tree (`LM.tree`'s layout) of views into ``stacked``."""
    layers = []
    for i in range(num_layers):
        layer: dict = {}
        for gname in LAYER_GROUPS:
            part, leaf = gname.split(".")
            layer.setdefault(part, {})[leaf] = stacked[gname][i]
        layers.append(layer)
    tree = {"layers": layers}
    for gname in MODEL_GROUPS:
        part, leaf = gname.split(".")
        tree.setdefault(part, {})[leaf] = stacked[gname]
    return tree


def leaf_names(num_layers: int) -> list[str]:
    """The leaves the checks read, in a fixed order: each layer's groups, then the model's."""
    return [f"{g}.{i}" for g in LAYER_GROUPS for i in range(num_layers)] + list(MODEL_GROUPS)


# ------------------------------------------------------------------ numerics


def mm(a, b, fp8: bool):
    """``a @ b`` in float32, or for the control with each operand rounded to float8 e4m3
    under a per-tensor scale (the rounding passes gradients straight through)."""
    if not fp8:
        return a @ b
    return _Fp8.apply(a) @ _Fp8.apply(b)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = 448.0 / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, g):
        return g


def rmsnorm(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + RMS_EPS) * scale


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(x, w, b):
    """Depthwise causal convolution over time: x (B, S, C), w (C, K), bias b (C,)."""
    K = w.shape[-1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    return sum(xp[:, k:k + S] * w[:, k] for k in range(K)) + b


def _scan_chunk(h, u, delta, A, B, C):
    """A chunk of the recurrence from state ``h``: (h after it, y without the D term)."""
    dA = torch.exp(delta[..., None] * A)
    dBu = (delta * u)[..., None] * B[:, :, None, :]
    hs = []
    for a_t, b_t in zip(dA.unbind(1), dBu.unbind(1)):
        h = torch.addcmul(b_t, a_t, h)
        hs.append(h)
    y = torch.einsum("bldn,bln->bld", torch.stack(hs, 1), C)
    return h, y


def selective_scan(u, delta, A, B, C, D, grad: bool):
    """y (B, S, di) and the last state (B, di, N); chunks re-run in the backward when ``grad``."""
    b, S, di = u.shape
    h = torch.zeros(b, di, A.shape[-1], dtype=u.dtype, device=u.device)
    ys = []
    for s0 in range(0, S, SCAN_CHUNK):
        part = [t[:, s0:s0 + SCAN_CHUNK] for t in (u, delta, B, C)]
        if grad:
            h, y = checkpoint(_scan_chunk, h, part[0], part[1], A, part[2], part[3],
                              use_reentrant=False)
        else:
            h, y = _scan_chunk(h, part[0], part[1], A, part[2], part[3])
        ys.append(y)
    return torch.cat(ys, 1) + u * D, h


def mamba_layer(w: dict, h, m: dict, fp8: bool):
    """One pre-norm Mamba1 layer on the residual ``h`` (B, S, d), the scan's chunks re-run in
    the backward: the new residual."""
    x = rmsnorm(h, w["norm.scale"])
    xs, z = mm(x, w["mamba.in_proj"], fp8).chunk(2, dim=-1)
    u = F.silu(causal_conv(xs, w["mamba.conv_w"], w["mamba.conv_b"]))
    dt, Bm, Cm = mm(u, w["mamba.x_proj"], fp8).split([m["r"], m["N"], m["N"]], dim=-1)
    delta = softplus(mm(dt, w["mamba.dt_proj_w"], fp8) + w["mamba.dt_proj_b"])
    y, _ = selective_scan(u, delta, -torch.exp(w["mamba.A_log"]), Bm, Cm, w["mamba.D"],
                          grad=True)
    return h + mm(y * F.silu(z), w["mamba.out_proj"], fp8)


def layer_weights(stacked: dict, i: int) -> dict:
    """Layer ``i``'s weights in float32."""
    return {g: stacked[g][i].float() for g in LAYER_GROUPS}


# ------------------------------------------------------------------- prefill


def _padded(x, mask):
    """Packed rows ``x`` (P, C) laid out as ``mask`` (R, S) has them, zeros elsewhere."""
    out = x.new_zeros(*mask.shape, x.shape[-1])
    out[mask] = x
    return out


def prefill_layer(w: dict, h, m: dict, fp8: bool, mask):
    """`mamba_layer` over prompts of different lengths: ``h`` (P, d) holds every prompt's
    positions one prompt after another, ``mask`` (R, S) is true where row r's prompt sits,
    flush right.  Matrix products run on the packed positions; the convolution and the
    scan on the padded rows, where zero inputs and ``delta = 0`` keep the state at exactly
    0 until a prompt starts.  Returns (new h, (conv states (R, K-1, di), SSM states))."""
    x = rmsnorm(h, w["norm.scale"])
    xs, z = mm(x, w["mamba.in_proj"], fp8).chunk(2, dim=-1)
    xs_rows = _padded(xs, mask)
    u = F.silu(causal_conv(xs_rows, w["mamba.conv_w"], w["mamba.conv_b"]))[mask]
    dt, Bm, Cm = mm(u, w["mamba.x_proj"], fp8).split([m["r"], m["N"], m["N"]], dim=-1)
    delta = softplus(mm(dt, w["mamba.dt_proj_w"], fp8) + w["mamba.dt_proj_b"])
    y, h_last = selective_scan(*(_padded(t, mask) for t in (u, delta)),
                               -torch.exp(w["mamba.A_log"]),
                               *(_padded(t, mask) for t in (Bm, Cm)), w["mamba.D"], grad=False)
    out = mm(y[mask] * F.silu(z), w["mamba.out_proj"], fp8)
    return h + out, (xs_rows[:, -(m["K"] - 1):].clone(), h_last)


@torch.no_grad()
def prefill(cfg: dict, stacked: dict, tokens, fp8: bool = False):
    """Prompts ``tokens``, a (B, S) tensor or a list of 1-D prompts of any lengths: (each
    prompt's last-position logits (B, V), conv states (L, B, K-1, di), SSM states
    (L, B, di, N)), all float32."""
    m = dims(cfg)
    rows = list(tokens)
    lengths = torch.tensor([len(t) for t in rows], device=rows[0].device)
    mask = torch.arange(int(lengths.max()), device=lengths.device) >= (lengths.max()
                                                                         - lengths)[:, None]
    h = F.embedding(torch.cat(rows), stacked["embed.embedding"]).float()
    convs, ssms = [], []
    for i in range(m["L"]):
        h, (conv, ssm) = prefill_layer(layer_weights(stacked, i), h, m, fp8, mask)
        convs.append(conv)
        ssms.append(ssm)
    hn = rmsnorm(h[lengths.cumsum(0) - 1], stacked["final_norm.scale"].float())
    return mm(hn, stacked["unembed.w"].float(), fp8), torch.stack(convs), torch.stack(ssms)


# ------------------------------------------------------------------ training


def _loss(params: dict, m: dict, tokens, labels, fp8: bool, loss_rows: int = 2048):
    """Mean next-token cross entropy; each layer re-run in the backward."""
    h = F.embedding(tokens, params["embed.embedding"])
    for i in range(m["L"]):
        w = {g: params[f"{g}.{i}"] for g in LAYER_GROUPS}
        h = checkpoint(lambda w_, h_: mamba_layer(w_, h_, m, fp8), w, h,
                       use_reentrant=False)
    hn = rmsnorm(h, params["final_norm.scale"]).reshape(-1, m["d"])
    labels = labels.reshape(-1)
    total = 0.0
    for r0 in range(0, hn.shape[0], loss_rows):
        logits = mm(hn[r0:r0 + loss_rows], params["unembed.w"], fp8)
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, labels[r0:r0 + loss_rows, None])[:, 0]
        total = total + (lse - gold).sum()
    return total / hn.shape[0]


def train(cfg: dict, seed: int, batches, hp: dict, device, fp8: bool = False):
    """Follow the program's first ``len(batches)`` AdamW steps in float32.

    Each parameter is kept in the dtype the configuration stores it in: the
    update is worked out in float32 and the result rounded once to that dtype,
    so an update under half a bfloat16 step leaves a bfloat16 weight where it was.

    ``batches`` are ``(tokens, labels)`` pairs (B, S); ``hp`` holds ``lr``,
    ``b1``, ``b2``, ``eps``, ``weight_decay`` and ``max_grad_norm`` (the global
    norm the gradients are clipped to first).  Returns ``{"grad1": {leaf: the clipped
    first gradient's norm}, "dparam": {leaf: the norm of the parameters' change after the
    steps}}``.
    """
    m = dims(cfg)
    names = leaf_names(m["L"])
    params = {}
    for gname in LAYER_GROUPS + MODEL_GROUPS:
        t = draw_group(cfg, gname, seed, device)
        if gname in LAYER_GROUPS:
            for i in range(m["L"]):
                params[f"{gname}.{i}"] = t[i].to(torch.float32, copy=True).requires_grad_()
        else:
            params[gname] = t.to(torch.float32, copy=True).requires_grad_()
        del t
    leaves = [params[n] for n in names]
    stored = [group_spec(cfg, n.rsplit(".", 1)[0] if n.count(".") == 2 else n)[1]
              for n in names]
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    out = {"grad1": {}, "dparam": {}}
    b1, b2, eps, lr, wd = hp["b1"], hp["b2"], hp["eps"], hp["lr"], hp["weight_decay"]
    for step, (tokens, labels) in enumerate(batches, start=1):
        loss = _loss(params, m, tokens, labels, fp8)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            factor = torch.clamp(hp["max_grad_norm"] / (norm + 1e-9), max=1.0)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for i, (p, g) in enumerate(zip(leaves, grads)):
                g = g * factor
                if step == 1:
                    out["grad1"][names[i]] = float(g.norm())
                mu[i].mul_(b1).add_(g, alpha=1 - b1)
                nu[i].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + eps) + wd * p
                p.sub_(lr * upd)
                if stored[i] != torch.float32:
                    p.copy_(p.to(stored[i]))
        del grads
    del mu, nu
    with torch.no_grad():
        for gname in LAYER_GROUPS + MODEL_GROUPS:
            p0 = draw_group(cfg, gname, seed, device)
            if gname in LAYER_GROUPS:
                for i in range(m["L"]):
                    out["dparam"][f"{gname}.{i}"] = float((params[f"{gname}.{i}"]
                                                           - p0[i].float()).norm())
            else:
                out["dparam"][gname] = float((params[gname] - p0.float()).norm())
            del p0
    return out
