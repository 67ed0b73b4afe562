"""Batched serving launcher: prefill a batch of prompts, then greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --smoke --batch 4 --prompt-len 64 --gen 32 --device cpu

The counterpart of `repro.launch.serve`, for every arch in `ARCH_IDS`
(dense, moe and mamba1); an attention model's cache holds ``prompt_len +
gen`` tokens a stream.  Weights are random, drawn from ``--seed``; so are
the prompts.  It runs on CUDA unless ``--device`` says
otherwise, and raises when there is no GPU and no ``--device``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import model as M


@dataclasses.dataclass
class Generation:
    """Greedy tokens of a batch and what it took to make them."""

    tokens: torch.Tensor          # (B, gen): the prefill's token, then decode's
    prefill_logits: torch.Tensor  # (B, 1, V)
    logits: torch.Tensor          # (B, 1, V), of the last step
    prefill_s: float
    decode_s: float               # gen - 1 decode steps


def make_prompts(cfg, batch, prompt_len, seed, device):
    """Random prompts (batch, prompt_len) drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)), device=device)


def generate(model, prompts, gen: int) -> Generation:
    """Prefill ``prompts`` (B, S) into a cache of S + gen, then ``gen - 1`` greedy decode steps."""
    cuda = prompts.is_cuda

    def clock():
        if cuda:
            torch.cuda.synchronize(prompts.device)
        return time.perf_counter()

    t0 = clock()
    prefill_logits, cache = M.prefill(model, prompts, max_len=prompts.shape[1] + gen)
    t1 = clock()
    tok = torch.argmax(prefill_logits, dim=-1)  # (B, 1)
    out, logits = [tok], prefill_logits
    for _ in range(gen - 1):
        logits, cache = M.decode_step(model, cache, tok)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    t2 = clock()
    return Generation(torch.cat(out, dim=1), prefill_logits, logits, t1 - t0, t2 - t1)


def main(argv=None) -> Generation:
    """Parse the command line, serve one batch, print what it took."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS, required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = M.init_model(torch.Generator(device).manual_seed(args.seed), cfg)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed, device)

    B, S = prompts.shape
    run = generate(model, prompts, args.gen)
    print(f"prefill: {B}x{S} in {run.prefill_s * 1e3:.1f}ms")
    print(f"decode: {args.gen} tokens x {B} streams in {run.decode_s * 1e3:.1f}ms "
          f"({args.gen * B / max(run.decode_s, 1e-9):.0f} tok/s)")
    n_show = min(16, run.tokens.shape[1])
    print("sample stream 0:", run.tokens[0, :n_show].tolist())
    return run


if __name__ == "__main__":
    main()
