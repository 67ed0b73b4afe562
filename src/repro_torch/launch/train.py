"""LM training launcher: synthetic batches -> train_step, a few steps, checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --smoke --steps 3 --device cpu --ckpt-dir results/port/lm_ckpt --ckpt-every 1

The counterpart of `repro.launch.train`, for every family of `ARCH_IDS`.
Weights are random, drawn from ``--seed``; the batches are the reference's
draws from one numpy generator seeded the same (`make_batch`).  Every
``--ckpt-every`` steps with a ``--ckpt-dir`` it writes the parameters in
the JAX package's layout (``layers`` stacked along L), which
`repro.checkpoint.restore_checkpoint` reads against
`repro.models.model.init_model`'s tree, and `repro_torch.checkpoint`
against the reference's.  It runs on CUDA unless ``--device`` says
otherwise, and raises when there is no GPU and no ``--device``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import _stack_layers
from repro_torch.data import SyntheticTokenDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M


@dataclasses.dataclass
class TrainRun:
    """What a training run left behind and what it took."""

    model: M.LM
    opt_state: tuple
    losses: List[float]
    step_s: List[float]  # wall of each step, ended by reading its loss
    checkpoints: List[str] = dataclasses.field(default_factory=list)


def make_batch(cfg, ds, rng, device) -> dict:
    """One batch, drawn as the reference's launcher draws it (train.py:55-70).

    ``ds.sample(rng)`` first; a vlm batch then draws ``vision_embeds``
    (B, V, d) from the same generator, in the model dtype; an audio batch
    draws (B, S+1, K) codebook tokens from it and shifts them into
    ``tokens`` and ``labels`` (B, S, K), in place of the sampled ones.
    """
    host = ds.sample(rng)
    batch = {name: torch.as_tensor(host[name], device=device) for name in ("tokens", "labels")}
    B, S = host["tokens"].shape
    if cfg.arch_type == "vlm":
        vision = rng.normal(size=(B, cfg.vision_tokens, cfg.d_model))
        batch["vision_embeds"] = torch.as_tensor(vision, dtype=torch.float32).to(
            device=device, dtype=cfg.activation_dtype)
    if cfg.arch_type == "audio":
        toks = rng.integers(0, cfg.vocab, (B, S + 1, cfg.num_codebooks)).astype(np.int32)
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=device),
                 "labels": torch.as_tensor(toks[:, 1:], device=device)}
    return batch


def jax_layout(model: M.LM):
    """The parameters on the host, ``layers`` stacked along L: the JAX pytree's layout."""
    return _stack_layers(model.tree(lambda p: p.detach().cpu()))


def train(cfg, steps, batch, seq, lr=3e-4, seed=0, log_every=10, device=None,
          ckpt_dir=None, ckpt_every=100) -> TrainRun:
    """Initialise ``cfg`` from ``seed`` and take ``steps`` training steps.

    ``seq`` counts text tokens (a vlm batch adds ``cfg.vision_tokens``
    positions ahead of them; an audio batch has K codebooks a position).
    With ``ckpt_dir``, the parameters after every ``ckpt_every``-th step go
    to ``ckpt_dir/ckpt_{step:08d}.npz`` (`jax_layout`).
    """
    device = resolve_device(device)
    model = M.init_model(torch.Generator(device).manual_seed(seed), cfg)
    opt, train_step = make_train_step(cfg, lr)
    opt_state = opt.init(model.tree())
    ds = SyntheticTokenDataset(cfg.vocab, seq, batch, seed=seed)
    rng = np.random.default_rng(seed)

    run = TrainRun(model, opt_state, [], [])
    t0 = time.perf_counter()
    for step in range(steps):
        data = make_batch(cfg, ds, rng, device)
        start = time.perf_counter()
        run.model, run.opt_state, metrics = train_step(run.model, run.opt_state, data)
        run.losses.append(float(metrics["loss"]))  # waits for the step
        run.step_s.append(time.perf_counter() - start)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {run.losses[-1]:.4f} ({time.perf_counter() - t0:.1f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            run.checkpoints.append(save_checkpoint(ckpt_dir, step + 1, jax_layout(run.model)))
            print(f"  checkpoint -> {run.checkpoints[-1]}")
    return run


def main(argv=None) -> TrainRun:
    """Parse the command line, train, print the loss curve's ends."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS, required=True)
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"active={cfg.active_param_count()/1e6:.1f}M")
    run = train(cfg, args.steps, args.batch, args.seq, args.lr, args.seed,
                args.log_every, args.device, args.ckpt_dir, args.ckpt_every)
    first, last = np.mean(run.losses[:5]), np.mean(run.losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} ({'improved' if last < first else 'NO IMPROVEMENT'})")
    return run


if __name__ == "__main__":
    main()
