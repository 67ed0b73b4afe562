"""Where the time of Falcon-Mamba-7B serving goes on a CUDA GPU.

    PYTHONPATH=src python -m repro_torch.serving.breakdown

Builds the published config at full depth (random weights from a seed),
warms up with one prefill and one decode step, then times one prefill of
4 prompts of 2048 tokens and 8 greedy decode steps with the host clock
around synchronised work (the launcher's shapes in chip_smoke.py).  The same prefill and steps run
once more under `torch.profiler`, which gives the device's busy time per
phase (the sum of its kernels' times), its idle share of the profiled
wall, the device operations per phase and per decode token, and the
kernels that take the most device time; the selective-scan wrapper's
launch counter stands beside the profiler's count of its kernel.  Prints
one JSON object.
"""
from __future__ import annotations

import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.breakdown import _device_summary, _timed
from repro_torch.configs import get_config
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.launch.serve import make_prompts
from repro_torch.models import model as M

SCAN_KERNEL = "selective_scan_kernel"
ARCH, BATCH, PROMPT_LEN, DECODE_STEPS = "falcon-mamba-7b", 4, 2048, 8


def _decode(model, cache, tok, steps):
    for _ in range(steps):
        logits, cache = M.decode_step(model, cache, tok)
        tok = torch.argmax(logits, dim=-1)
    return cache, tok


def _profiled(fn, *args):
    """``fn(*args)`` under the profiler: its output and a device summary."""
    before = selective_scan.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall = _timed(fn, *args)
    summary = _device_summary(prof, wall, SCAN_KERNEL)
    summary[SCAN_KERNEL]["counter"] = selective_scan.launches - before
    return out, summary


def main():
    """Run the breakdown and print it as JSON."""
    device = resolve_device()
    cfg = get_config(ARCH)
    model = M.init_model(torch.Generator(device).manual_seed(0), cfg)
    prompts = make_prompts(cfg, BATCH, PROMPT_LEN, 0, device)

    (logits, cache), cold_prefill_s = _timed(M.prefill, model, prompts)
    tok = torch.argmax(logits, dim=-1)
    _, cold_step_s = _timed(_decode, model, cache, tok, 1)
    (logits, cache), prefill_s = _timed(M.prefill, model, prompts)
    _, decode_s = _timed(_decode, model, cache, tok, DECODE_STEPS)
    phases = {}
    (logits, cache), phases["prefill"] = _profiled(M.prefill, model, prompts)
    _, phases["decode"] = _profiled(_decode, model, cache, tok, DECODE_STEPS)
    phases["decode"]["kernel_launches_per_token_step"] = (
        phases["decode"]["kernel_launches"] / DECODE_STEPS
    )
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "gpu": gpu,
        "torch": torch.__version__,
        "arch": ARCH,
        "layers": cfg.num_layers,
        "batch": BATCH,
        "prompt_len": PROMPT_LEN,
        "cold": {"prefill_s": cold_prefill_s, "decode_step_s": cold_step_s},
        "steady": {
            "prefill_s": prefill_s,
            "decode_steps": DECODE_STEPS,
            "decode_ms_per_step": decode_s / DECODE_STEPS * 1e3,
            "decode_tok_per_s": BATCH * DECODE_STEPS / decode_s,
        },
        "profiled": phases,
    }, indent=1))


if __name__ == "__main__":
    main()
