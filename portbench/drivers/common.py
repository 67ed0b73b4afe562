"""What the drivers share: the window loop, the reference's float32, the gaps, the LM config."""
from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import time

import torch

from portbench.reference import mamba1_lm as ref


def model_config(cfg: dict):
    """The program's `ModelConfig` of a Mamba1 configuration file."""
    from repro_torch.models.config import ModelConfig

    m = ref.dims(cfg)
    if m["r"] != max(1, m["d"] // 16) or m["di"] % m["d"]:
        raise ValueError(f"{cfg['name']}: the program derives time_step_rank = hidden_size // "
                         f"16 and intermediate_size = expand * hidden_size")
    return ModelConfig(name=cfg["name"], arch_type="ssm", num_layers=m["L"], d_model=m["d"],
                       vocab=m["V"], ssm_state=m["N"], ssm_expand=m["di"] // m["d"],
                       ssm_conv=m["K"], mamba_version=1, dtype=cfg["torch_dtype"],
                       remat=cfg["remat"], source=cfg["source"])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mark(ctx, phase: str):
    """Print, to standard error, the seconds since the process started at the end of set-up's
    ``phase`` (after the device has finished it)."""
    sync(ctx.device)
    print(f"time setup.{phase}_s: {time.perf_counter() - ctx.t_start!r}", file=sys.stderr,
          flush=True)


def closed_loop(fn, seconds: float, device) -> tuple[int, float]:
    """Call ``fn(i)`` for i = 0, 1, ... back to back, each finished before the next, until
    ``seconds`` have passed: (calls, seconds they took together)."""
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        fn(n)
        sync(device)
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return n, elapsed


def free(device):
    """Return what the program held to the device before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def exact_float32():
    """Matrix products in full float32 (TF32 off) for the reference, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def norm_gap(prog: dict, want: dict, names) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of that leaf or of
    the median leaf, whichever is larger."""
    med = statistics.median(want[n] for n in names)
    return max(abs(prog[n] - want[n]) / max(want[n], med) for n in names)
