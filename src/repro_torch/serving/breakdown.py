"""Where the time of LM serving goes on a CUDA GPU.

    PYTHONPATH=src python -m repro_torch.serving.breakdown [--arch falcon-mamba-7b]

Builds ``--arch``'s published config at full depth (random weights from a
seed; any arch of `ARCH_IDS`: falcon-mamba-7b by default, granite-8b,
minitron-8b, olmoe-1b-7b, internlm2-1.8b, zamba2-2.7b,
llava-next-mistral-7b, musicgen-large), warms up with one prefill and one
decode step, then times one prefill of 4 prompts of 2048 positions (a vlm
prompt: 4096, its vision tokens and then text; an audio prompt: 2048
frames of K codebooks) into a cache of 8 more and 8 greedy decode steps
with the host clock around synchronised work (the launcher's shapes in
chip_smoke.py).  The
same prefill and steps run once more under `torch.profiler`, which gives
the device's busy time per phase (the sum of its kernels' times), its
idle share of the profiled wall, the device operations per phase and per
decode step, and the kernels that take the most device time; the hand
kernel on the path (selective_scan for mamba1, flash_attention for dense
and moe) has its wrapper's launch counter beside the profiler's count of
its kernel.  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.breakdown import _device_summary, _timed
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.launch.serve import make_inputs
from repro_torch.models import model as M

BATCH, PROMPT_LEN, VLM_PROMPT_LEN, DECODE_STEPS = 4, 2048, 4096, 8
# the hand kernel on each family's serving path: (wrapper, the CUDA kernel's name)
PATH_KERNEL = {"mamba1": (selective_scan, "selective_scan_kernel"),
               **{fam: (flash_attention, "flash_attention_")
                  for fam in ("dense", "moe", "hybrid", "vlm", "audio")}}


def _decode(model, cache, tok, steps):
    for _ in range(steps):
        logits, cache = M.decode_step(model, cache, tok)
        tok = torch.argmax(logits, dim=-1)
    return cache, tok


def _profiled(op, kernel, fn, *args):
    """``fn(*args)`` under the profiler: its output and a device summary."""
    before = op.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall = _timed(fn, *args)
    summary = _device_summary(prof, wall, kernel)
    summary[kernel]["counter"] = op.launches - before
    return out, summary


def main(argv=None):
    """Run the breakdown and print it as JSON."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS, default="falcon-mamba-7b")
    args = p.parse_args(argv)
    device = resolve_device()
    cfg = get_config(args.arch)
    op, kernel = PATH_KERNEL[M.family(cfg)]
    model = M.init_model(torch.Generator(device).manual_seed(0), cfg)
    prompt_len = VLM_PROMPT_LEN if cfg.arch_type == "vlm" else PROMPT_LEN
    inputs = make_inputs(cfg, BATCH, prompt_len, 0, device)
    prompts, vision = inputs["tokens"], inputs.get("vision_embeds")
    max_len = prompt_len + DECODE_STEPS

    def prefill():
        return M.prefill(model, prompts, max_len, vision_embeds=vision)

    (logits, cache), cold_prefill_s = _timed(prefill)
    tok = torch.argmax(logits, dim=-1)
    _, cold_step_s = _timed(_decode, model, cache, tok, 1)
    (logits, cache), prefill_s = _timed(prefill)
    _, decode_s = _timed(_decode, model, cache, tok, DECODE_STEPS)
    phases = {}
    (logits, cache), phases["prefill"] = _profiled(op, kernel, prefill)
    _, phases["decode"] = _profiled(op, kernel, _decode, model, cache, tok, DECODE_STEPS)
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
        "arch": args.arch,
        "layers": cfg.num_layers,
        "batch": BATCH,
        "prompt_len": prompt_len,
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
