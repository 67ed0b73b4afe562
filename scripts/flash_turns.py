"""Time the flash-attention kernel and Zamba2-2.7B of several trees of this repository in turns.

    python scripts/flash_turns.py [--kernels-only] [--train-steps N] \
        build/cmp/parent . . build/cmp/parent

Each argument is the root of a checkout (for example a ``git archive`` of
another commit unpacked into a git-ignored directory).  For each, in the
order given, a fresh process imports that tree's ``chip_smoke`` and its
``repro_torch`` package and builds its ``flash_attention.cu`` into the
tree's own ``build/kernels/``; then, with that tree's code:

* parity: ``chip_smoke.flash_parity`` over the tree's ``FLASH_CASES`` and
  ``FRONTIER_FLASH_CASES`` (each case against the plain version by
  ``ref.kernel_errors``: elementwise within the allowance, a row within
  ``ROW_TOL``), the worst case of each head_dim and dtype kept;
* kernel timing: ``chip_smoke.flash_timing`` (CUDA events, warm L2, the
  median of eager calls; the plain version, SDPA and the bound beside it)
  at each shape of ``SHAPES``: the prefills of Zamba2-2.7B (hd 80, window
  4096), Kimi-K2 (hd 112), MusicGen-Large (hd 64) and Granite-8B (hd
  128), InternLM2-1.8B's training shape, and a smoke config's heads at hd
  32 over 4 x 2048;
* without ``--kernels-only``, Zamba2-2.7B end to end at its published
  config (bf16, random weights from a seed): the slice-12 launcher
  (``chip_smoke.attn_serve_launcher``: batch 4 x prompt 2048, 32 tokens)
  and ``PREFILLS`` more prefills of the same prompts, host clock around
  synchronised work; the slice-14 training run (``chip_smoke.family_train``,
  54 layers, batch 4 x 2048) at ``--train-steps`` steps (4 by default),
  the median step after the first; and ``python -m repro_torch.serving.breakdown --arch
  zamba2-2.7b`` in a process of its own, for the flash kernel's device
  time and share of the profiled prefill.

One JSON line a run, with the tree, the card's name and power limit
(``nvidia-smi``) and the flash kernels' registers, shared memory and
spills from the tree's build report; a run that fails (a case off its
plain version among them) gives a line with its error, the next tree
still runs, and the script exits non-zero at the end.  Needs a CUDA
device; compare two trees only within one call, on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (label, (B, Hq, Hkv, S, hd), window): bf16, causal
SHAPES = [("zamba2-2.7b prefill", (4, 32, 32, 2048, 80), 4096),
          ("kimi-k2 prefill", (4, 64, 8, 2048, 112), 0),
          ("musicgen-large prefill", (4, 32, 32, 2048, 64), 0),
          ("granite-8b prefill", (4, 32, 8, 2048, 128), 0),
          ("internlm2-1.8b training", (4, 16, 8, 4096, 128), 0),
          ("smoke heads", (4, 4, 2, 2048, 32), 0)]
PREFILLS = 3
ARCH = "zamba2-2.7b"

_RUN = r"""
import json, statistics, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
import chip_smoke
from repro_torch.kernels import build, ptxas_report
from repro_torch.kernels.flash_attention import ops as fops, ref as fref

shapes, kernels_only = {shapes!r}, {kernels_only!r}
out = {{"build_report": [k for k in ptxas_report(build("flash_attention.cu"))
                         if "bf16" in k["name"] or "wgmma" in k["name"]]}}
worst = {{}}
cases = chip_smoke.FLASH_CASES + chip_smoke.FRONTIER_FLASH_CASES
for case, e in chip_smoke.flash_parity(fops, fref, cases).items():  # raises on a miss
    key = case.split(" causal")[0].split()[-1] + " " + case.split()[-1]  # "hd=80 bfloat16"
    if key not in worst or e["elem"] > worst[key]["elem"]:
        worst[key] = {{"case": case, **e}}
out["parity_cases"], out["parity_worst"] = len(cases), worst
out["timing"] = [{{"label": label, **chip_smoke.flash_timing(fops, fref, shape, window)}}
                 for label, shape, window in shapes]
if not kernels_only:
    from repro_torch.kernels.fused_xent import ops as xops
    from repro_torch.kernels.selective_scan import ops as sops
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    model, r = chip_smoke.attn_serve_launcher(fops, {arch!r}, 4, 2048, 32)
    cfg = get_config({arch!r})
    prompts = serve.make_inputs(cfg, 4, 2048, 0, "cuda")["tokens"]
    more = [serve.generate(model, prompts, 2).prefill_s * 1e3 for _ in range({prefills})]
    out["serve"] = {{k: r[k] for k in ("prefill_ms", "cold_prefill_ms", "decode_ms_per_step",
                                       "launches", "peak_gb")}}
    out["serve"]["prefill_ms_more"] = more
    out["serve"]["prefill_ms_median"] = statistics.median([r["prefill_ms"], *more])
    del model
    torch.cuda.empty_cache()
    chip_smoke.FAMILY_TRAIN_STEPS = {steps}
    t = chip_smoke.family_train(sops, fops, xops, {arch!r}, {{}}, 2048)
    out["train"] = {{k: t[k] for k in ("step_s", "step_s_median", "tokens_per_s", "peak_gb",
                                       "launches", "losses")}}
    del t
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _python(root: str, args: list[str]) -> str:
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    out = subprocess.run([sys.executable, *args], cwd=root, env=env, capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return out.stdout


def breakdown(root: str) -> dict:
    """The serving breakdown of Zamba2-2.7B's prefill in ``root``: flash's device time."""
    text = _python(root, ["-m", "repro_torch.serving.breakdown", "--arch", ARCH])
    doc = json.loads(text[text.index("{"):])
    pre = doc["profiled"]["prefill"]
    flash = pre["flash_attention_"]
    return {"prefill_s": doc["steady"]["prefill_s"], "profiled_wall_s": pre["wall_s"],
            "device_busy_s": pre["device_busy_s"], "device_idle_share": pre["device_idle_share"],
            "kernel_launches": pre["kernel_launches"], "flash_launches": flash["profiler"],
            "flash_device_ms": flash["device_ms"],
            "flash_share_of_busy": flash["device_ms"] / 1e3 / pre["device_busy_s"]}


def run(tree: str, kernels_only: bool, train_steps: int) -> dict:
    """One run of ``tree``: each part in a process of its own."""
    root = os.path.abspath(tree)
    code = _RUN.format(root=root, src=os.path.join(root, "src"), shapes=SHAPES,
                       kernels_only=kernels_only, arch=ARCH, prefills=PREFILLS,
                       steps=train_steps)
    row = json.loads(_python(root, ["-c", code]).strip().splitlines()[-1])
    if not kernels_only:
        row["breakdown"] = breakdown(root)
    return row


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--kernels-only", action="store_true")
    p.add_argument("--train-steps", type=int, default=4)
    p.add_argument("trees", nargs="*", default=["."])
    args = p.parse_args(argv)
    gpu = card()
    rows = []
    for turn, tree in enumerate(args.trees):
        try:
            row = {"turn": turn, "tree": tree, "gpu": gpu,
                   **run(tree, args.kernels_only, args.train_steps)}
        except RuntimeError as e:  # a process that failed: the next tree still runs
            row = {"turn": turn, "tree": tree, "gpu": gpu, "error": str(e)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    failed = [r["tree"] for r in rows if "error" in r]
    if failed:
        raise SystemExit(f"runs that failed: {failed}")
    return rows


if __name__ == "__main__":
    main()
