"""Batched serving launcher: prefill a batch of prompts, then greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
      --smoke --batch 4 --prompt-len 64 --gen 32 --device cpu

The counterpart of `repro.launch.serve`, for every arch in `ARCH_IDS`
(dense, moe, mamba1, the hybrid, vlm and audio); an attention cache holds
``prompt_len + gen`` positions a stream.  ``--prompt-len`` counts every
position of a prompt: a vlm prompt is its config's ``vision_tokens``
vision embeddings and ``prompt_len - vision_tokens`` text tokens; an audio
prompt is ``prompt_len`` frames of ``num_codebooks`` tokens.  Weights are
random, drawn from ``--seed``; so are the prompts.  It runs on CUDA unless
``--device`` says otherwise, and raises when there is no GPU and no
``--device``.
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

    tokens: torch.Tensor          # (B, gen), audio (B, gen, K): the prefill's, then decode's
    prefill_logits: torch.Tensor  # (B, 1, V), audio (B, 1, K, V)
    logits: torch.Tensor          # the same, of the last step
    prefill_s: float
    decode_s: float               # gen - 1 decode steps


def make_inputs(cfg, batch, prompt_len, seed, device) -> dict:
    """A random prompt batch drawn with numpy from ``seed``, as the reference's launcher draws it.

    ``tokens`` (batch, prompt_len), audio (batch, prompt_len, K); a vlm
    batch has text ``tokens`` (batch, prompt_len - V) and then
    ``vision_embeds`` (batch, V, d) in the model dtype, from the same
    generator (serve.py:37-47).
    """
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "audio":
        shape = (batch, prompt_len, cfg.num_codebooks)
    elif cfg.arch_type == "vlm":
        if prompt_len <= cfg.vision_tokens:
            raise ValueError(f"a {cfg.name} prompt of {prompt_len} positions leaves no text "
                             f"after its {cfg.vision_tokens} vision tokens")
        shape = (batch, prompt_len - cfg.vision_tokens)
    else:
        shape = (batch, prompt_len)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, shape), device=device)}
    if cfg.arch_type == "vlm":
        vision = rng.normal(size=(batch, cfg.vision_tokens, cfg.d_model))
        out["vision_embeds"] = torch.as_tensor(vision, dtype=torch.float32).to(
            device=device, dtype=cfg.activation_dtype)
    return out


def generate(model, prompts, gen: int, vision_embeds=None) -> Generation:
    """Prefill ``prompts`` into a cache of S + gen positions, then ``gen - 1`` greedy steps.

    ``prompts`` (B,T) tokens, audio (B,T,K); a vlm model also takes
    ``vision_embeds`` (B,V,d), and then S = V + T.
    """
    cuda = prompts.is_cuda
    S = prompts.shape[1] + (0 if vision_embeds is None else vision_embeds.shape[1])

    def clock():
        if cuda:
            torch.cuda.synchronize(prompts.device)
        return time.perf_counter()

    t0 = clock()
    prefill_logits, cache = M.prefill(model, prompts, max_len=S + gen,
                                      vision_embeds=vision_embeds)
    t1 = clock()
    tok = torch.argmax(prefill_logits, dim=-1)  # (B, 1), audio (B, 1, K)
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
    inputs = make_inputs(cfg, args.batch, args.prompt_len, args.seed, device)

    B, S = args.batch, args.prompt_len
    run = generate(model, inputs["tokens"], args.gen, inputs.get("vision_embeds"))
    print(f"prefill: {B}x{S} in {run.prefill_s * 1e3:.1f}ms")
    print(f"decode: {args.gen} tokens x {B} streams in {run.decode_s * 1e3:.1f}ms "
          f"({args.gen * B / max(run.decode_s, 1e-9):.0f} tok/s)")
    n_show = min(16, run.tokens.shape[1])
    print("sample stream 0:", run.tokens[0, :n_show].tolist())
    return run


if __name__ == "__main__":
    main()
