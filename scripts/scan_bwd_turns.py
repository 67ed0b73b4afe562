"""Time the selective scan's backward kernel of several trees of this repository in turns.

    python scripts/scan_bwd_turns.py build/cmp/parent . . build/cmp/parent

Each argument is the root of a checkout (for example a ``git archive`` of
another commit unpacked into a git-ignored directory).  For each, in the
order given, a fresh process imports that tree's ``chip_smoke`` and its
``repro_torch`` package, builds its ``selective_scan_bwd.cu`` into the
tree's own ``build/kernels/`` and runs ``chip_smoke.scan_bwd_timing`` at
Falcon-Mamba-7B's training shape (4, 2048, 8192, 16) bf16: CUDA-event time
of eager calls (``ms``), of calls replayed from a CUDA graph (``device_ms``),
the plain version's time and the bound.  One JSON line a run, with the
tree, the card's name and power limit (``nvidia-smi``) and the kernels'
registers, shared memory and spills from the tree's build report.  Needs a
CUDA device; compare two trees only within one call, on one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
from repro_torch.kernels import build, ptxas_report
from repro_torch.kernels.selective_scan import ops
row = chip_smoke.scan_bwd_timing(ops)
row["build_report"] = ptxas_report(build("selective_scan_bwd.cu"))
print(json.dumps(row))
"""


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def run(tree: str) -> dict:
    """One timing of ``tree``'s backward kernel in a process of its own."""
    root = os.path.abspath(tree)
    code = _RUN.format(root=root, src=os.path.join(root, "src"))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> list[dict]:
    trees = (argv if argv is not None else sys.argv[1:]) or ["."]
    gpu = card()
    rows = []
    for turn, tree in enumerate(trees):
        row = {"turn": turn, "tree": tree, "gpu": gpu, **run(tree)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
