#!/usr/bin/env python
"""Run the port's examples one after another, each in a process of its own, and time them.

    PYTHONPATH=src python scripts/run_examples.py [--names quickstart lm_train ...]
        [--device cpu] [--out results/port/examples]

Each example runs as ``python -m repro_torch.examples.<name>`` at its
defaults (the reference scripts' sizes), on CUDA unless ``--device`` says
otherwise.  Its wall time is taken from process start to exit, so it
includes the interpreter's start, CUDA's initialisation and any kernel
build the process makes.  Each example's output goes to ``<out>/<name>.log``;
a summary (wall, exit code, the last lines of output, the card's name and
power limit from ``nvidia-smi``) to ``<out>/examples.json``.  Exits
non-zero when any example fails.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ["continuous_batching", "lm_train", "quickstart", "distributed_ippo", "smax_vdn",
            "switch_game_dial"]
NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def card() -> str | None:
    """The first card's ``name, power.limit`` line, or None without nvidia-smi."""
    try:
        out = subprocess.run(NVIDIA_SMI, capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--names", nargs="+", choices=EXAMPLES, default=EXAMPLES)
    p.add_argument("--device", default=None)
    p.add_argument("--out", default="results/port/examples")
    args = p.parse_args(argv)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    flags = ["--device", args.device] if args.device else []
    gpu = card()
    print(f"card: {gpu}")
    runs = []
    for name in args.names:
        cmd = [sys.executable, "-m", f"repro_torch.examples.{name}", *flags]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        (out / f"{name}.log").write_text(r.stdout + ("\n--- stderr\n" + r.stderr
                                                     if r.stderr else ""))
        tail = r.stdout.strip().splitlines()[-12:]
        runs.append({"name": name, "command": " ".join(cmd[1:]), "returncode": r.returncode,
                     "wall_s": wall, "tail": tail,
                     "stderr_tail": r.stderr.strip().splitlines()[-12:]})
        print(f"example {name}: rc {r.returncode}, {wall:.1f} s wall [{gpu}]")
        for line in tail:
            print(f"  {line}")
        if r.returncode:
            print("\n".join(f"  ! {line}" for line in r.stderr.strip().splitlines()[-20:]))
    (out / "examples.json").write_text(json.dumps({"card": gpu, "runs": runs}, indent=1))
    return 1 if any(r["returncode"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
