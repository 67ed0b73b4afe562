"""End-to-end LM training: train an internlm2-family model for a few
hundred steps on the synthetic bigram corpus and assert the loss drops
toward the structural entropy floor.

The port of ``examples/lm_train.py``: the same 4-layer, 512-wide config
(float32, head_dim 64, vocab 8192), the same batches, and the port's
train step (clip, then AdamW in place).  On the card each step launches
the flash kernel's float32 instance and fused_xent's float32 route; the
launches are counted and printed.

  PYTHONPATH=src python -m repro_torch.examples.lm_train [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokenDataset, make_lm_batch
from repro_torch.examples import at_reference_sizes
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.fused_xent.ops import fused_softmax_xent
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M

SIZE_FLAGS = ("steps", "batch", "seq")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--device", default=None, help="default: CUDA; 'cpu' to run on the CPU")
    return p.parse_args(argv)


def demo_config():
    """The reference example's config: internlm2's smoke config at 4 x 512, vocab 8192."""
    return dataclasses.replace(
        get_smoke_config("internlm2-1.8b"),
        num_layers=4,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        d_ff=2048,
        vocab=8192,
        attn_chunk=64,
        xent_chunk=64,
        name="internlm2-demo-100m",
    )


def main(argv=None) -> dict:
    """Train; returns the losses, the step walls and the kernels' launches."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = demo_config()
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M")

    model = M.init_model(torch.Generator(device).manual_seed(0), cfg)
    opt, train_step = make_train_step(cfg, lr=1e-3)
    opt_state = opt.init(model.tree())

    ds = SyntheticTokenDataset(cfg.vocab, args.seq, args.batch, seed=0, structure=0.85)
    rng = np.random.default_rng(0)
    counts0 = (flash_attention.launches, fused_softmax_xent.launches,
               fused_softmax_xent.combine_launches)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = make_lm_batch(ds.sample(rng), device=device)
        model, opt_state, metrics = train_step(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if i % 20 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  ({time.time()-t0:.0f}s)")
    wall = time.time() - t0
    flash, xent, combine = (flash_attention.launches - counts0[0],
                            fused_softmax_xent.launches - counts0[1],
                            fused_softmax_xent.combine_launches - counts0[2])

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss: {first:.3f} -> {last:.3f}")
    print(f"{args.steps} steps in {wall:.1f}s; kernel launches: flash_attention {flash}, "
          f"fused_xent {xent}, its combine {combine}")
    if at_reference_sizes(args, parse_args, SIZE_FLAGS):
        assert last < first - 1.0, "expected the model to learn the bigram structure"
        print("learned the synthetic corpus structure.")
    else:
        print("not at the reference's sizes: the learning assertion is not made")
    return {"losses": losses, "wall_s": wall, "flash_launches": flash,
            "xent_launches": xent, "combine_launches": combine}


if __name__ == "__main__":
    main()
