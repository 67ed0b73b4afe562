"""LM training launcher: synthetic tokens -> train_step, a few steps.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 3 --device cpu

The counterpart of `repro.launch.train`.  Weights are random, drawn from
``--seed``; the batches come from `SyntheticTokenDataset` with the same
seed.  It runs on CUDA unless ``--device`` says otherwise, and raises when
there is no GPU and no ``--device``.  The reference's ``--ckpt-dir`` /
``--ckpt-every`` are not ported: the port has no checkpoint module yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
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


def train(cfg, steps, batch, seq, lr=3e-4, seed=0, log_every=10, device=None) -> TrainRun:
    """Initialise ``cfg`` from ``seed`` and take ``steps`` training steps."""
    device = resolve_device(device)
    model = M.init_model(torch.Generator(device).manual_seed(seed), cfg)
    opt, train_step = make_train_step(cfg, lr)
    opt_state = opt.init(model.tree())
    ds = SyntheticTokenDataset(cfg.vocab, seq, batch, seed=seed)
    rng = np.random.default_rng(seed)

    losses, step_s = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        host = ds.sample(rng)
        data = {name: torch.as_tensor(host[name], device=device) for name in ("tokens", "labels")}
        start = time.perf_counter()
        model, opt_state, metrics = train_step(model, opt_state, data)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - start)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} ({time.perf_counter() - t0:.1f}s)")
    return TrainRun(model, opt_state, losses, step_s)


def main(argv=None) -> TrainRun:
    """Parse the command line, train, print the loss curve's ends."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS, required=True)
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"active={cfg.active_param_count()/1e6:.1f}M")
    run = train(cfg, args.steps, args.batch, args.seq, args.lr, args.seed,
                args.log_every, args.device)
    first, last = np.mean(run.losses[:5]), np.mean(run.losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} ({'improved' if last < first else 'NO IMPROVEMENT'})")
    return run


if __name__ == "__main__":
    main()
