#!/usr/bin/env python
"""The selective-scan backward kernel against its emulation, autograd and a float64 vjp.

    PYTHONPATH=src python scripts/scan_bwd_emulation.py

Needs the card.  At the shapes of ``tests/test_torch_cuda.py``'s emulation
test (and its inputs), float32, it prints for each gradient of
`selective_scan_bwd`: its largest magnitude; the kernel's largest
difference from `ref.selective_scan_bwd_blocked` (the kernel's chunk,
lanes and sum order written out) and from `ref.selective_scan_ref_vjp`
(autograd of the plain version), each also as a multiple of a 1e-5
elementwise allowance (abs + rel) and normwise (over the gradient's
largest magnitude plus one); and the kernel's, the emulation's and
autograd's largest differences from a float64 vjp of the same recurrence.
One JSON line a shape; the card's name and power limit first.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

NAMES = ("dx", "ddelta", "dA", "dB", "dC", "dD")
SHAPES = [(2, 37, 200, 16), (1, 64, 1024, 16), (2, 33, 130, 8), (3, 17, 64, 4), (1, 1, 40, 16),
          (2, 250, 200, 16), (2, 15, 130, 16), (2, 17, 130, 8), (3, 1, 40, 4)]
CHUNK = 16  # csrc/selective_scan_bwd.cu's kChunk; lanes_for(N) = 128 threads x 4 states / N


def inputs(b, S, di, N):
    """``tests/test_torch_cuda.py``'s draws for the shape (its ``_scan_inputs`` and cotangents)."""
    g = torch.Generator().manual_seed(S)
    t = dict(x=torch.randn(b, S, di, generator=g),
             delta=torch.randn(b, S, di, generator=g).abs() * 0.1,
             A=-(torch.randn(di, N, generator=g).abs() + 0.5),
             B=torch.randn(b, S, N, generator=g), C=torch.randn(b, S, N, generator=g),
             D=torch.randn(di, generator=g))
    g = torch.Generator().manual_seed(di)
    dy, dh = torch.randn(b, S, di, generator=g), torch.randn(b, di, N, generator=g)
    return [v.cuda() for v in t.values()], dy.cuda(), dh.cuda()


def vjp64(x, delta, A, B, C, D, dy, dh):
    """Autograd through the recurrence in float64."""
    with torch.enable_grad():
        leaves = [v.double().detach().requires_grad_() for v in (x, delta, A, B, C, D)]
        x_, d_, A_, B_, C_, D_ = leaves
        h = x_.new_zeros(x_.shape[0], x_.shape[2], A_.shape[-1])
        ys = []
        for t in range(x_.shape[1]):
            h = (torch.exp(d_[:, t, :, None] * A_) * h
                 + (d_[:, t] * x_[:, t])[..., None] * B_[:, t, None, :])
            ys.append(torch.einsum("bdn,bn->bd", h, C_[:, t]))
        y = torch.stack(ys, 1) + x_ * D_
        return torch.autograd.grad((y, h), leaves, (dy.double(), dh.double()))


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_bwd_emulation: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.selective_scan import ops, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    for b, S, di, N in SHAPES:
        t, dy, dh = inputs(b, S, di, N)
        got = ops.selective_scan_bwd(*t, dy, dh)
        emu = ref.selective_scan_bwd_blocked(*t, dy, dh, CHUNK, 512 // N)
        auto = ref.selective_scan_ref_vjp(*t, dy, dh)
        exact = vjp64(*t, dy, dh)
        row = {"shape": [b, S, di, N]}
        for name, k, e, a, x in zip(NAMES, got, emu, auto, exact):
            scale = float(x.abs().max())
            diff = lambda p, q: float((p.double() - q.double()).abs().max())
            elem = lambda q: float(((k - q).abs() / (1e-5 * (1 + q.abs()))).max())
            row[name] = {"max_abs": scale,
                         "emulation": diff(k, e), "emulation_x1e-5": elem(e),
                         "emulation_normwise": diff(k, e) / (1 + float(e.abs().max())),
                         "autograd": diff(k, a), "autograd_x1e-5": elem(a),
                         "float64": {"kernel": diff(k, x), "emulation": diff(e, x),
                                     "autograd": diff(a, x)}}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
