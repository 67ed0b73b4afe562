"""Serve a small model with batched requests through the continuous-batching engine.

Continuous batching: 8 requests with ragged prompt lengths stream through
a 2-slot engine; slots are refilled as requests finish.  Request 0's
output is held against sequential generation (prefill, then one decode
step a token).  The port of ``examples/continuous_batching.py``: the
internlm2 smoke config (float32, head_dim 32), random weights from seed
0.  On the card every prefill launches the flash kernel's float32
instance; the launches are counted and printed.

  PYTHONPATH=src python -m repro_torch.examples.continuous_batching [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' to run on the CPU")
    return p.parse_args(argv)


@torch.no_grad()
def sequential_generate(model, prompt, n: int, device) -> list:
    """Greedy tokens of one stream: a prefill, then ``n - 1`` decode steps."""
    tokens = torch.as_tensor(prompt[None, :], dtype=torch.int32, device=device)
    logits, cache = M.prefill(model, tokens, max_len=len(prompt) + n + 4)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        step = torch.tensor([[out[-1]]], dtype=torch.int32, device=device)
        logits, cache = M.decode_step(model, cache, step)
        out.append(int(torch.argmax(logits[0, 0])))
    return out


def main(argv=None) -> dict:
    """Serve the eight requests and check request 0; returns outputs, wall and launches."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("internlm2-1.8b")
    model = M.init_model(torch.Generator(device).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    launches0 = flash_attention.launches

    engine = ServingEngine(model, max_slots=2, prompt_capacity=24, max_new_tokens=8,
                           device=device)
    prompts = [
        rng.integers(0, cfg.vocab, (int(L),)).astype(np.int32)
        for L in rng.integers(6, 20, size=8)
    ]
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=8))

    t0 = time.time()
    finished = engine.run_until_drained()
    dt = time.time() - t0
    engine_launches = flash_attention.launches - launches0
    total_tokens = sum(len(r.output) for r in finished)
    print(f"served {len(finished)} requests / {total_tokens} tokens "
          f"in {dt:.1f}s on 2 slots")
    for r in sorted(finished, key=lambda r: r.uid)[:4]:
        print(f"  req {r.uid} (prompt {len(r.prompt):2d} toks) -> {r.output}")

    # parity with a sequential single-stream run
    ref = sequential_generate(model, prompts[0], 8, device)
    got = next(r.output for r in finished if r.uid == 0)
    assert got == ref, (got, ref)
    print("parity with sequential generation: OK")
    print(f"flash_attention kernel launches: {engine_launches} by the engine, "
          f"{flash_attention.launches - launches0 - engine_launches} by the sequential run")
    return {"outputs": {r.uid: list(r.output) for r in finished}, "reference": ref,
            "wall_s": dt, "tokens": total_tokens, "flash_launches": engine_launches,
            "flash_launches_total": flash_attention.launches - launches0}


if __name__ == "__main__":
    main()
