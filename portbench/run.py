"""Run one cell of BENCHMARK.json once and print its result as the last line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards: set-up
(weights and inputs from the seed, every shape warmed up), a window of
``--seconds``, then the check of what the window's path produced against
the plain reference.  With ``--trace 1`` the window runs under the
profiler and the line carries the per-layer metrics; without, the
end-to-end ones.  Exits non-zero with no result without enough CUDA
cards, and when the process holds JAX or the JAX package once the window
has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    # every build and kernel cache at a fixed place inside the checkout (the program's own
    # CUDA builds go to build/kernels/ there), and no library's JAX side
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = harness.Context(cell=cell, config=harness.config_of(bench, cell, ROOT),
                          traffic=harness.traffic_of(cell), limits=harness.limits_of(cell),
                          seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          t_start=T_START, device=torch.device("cuda"))
    out = harness.driver(ctx.traffic["driver"]).run(ctx)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    line = harness.result_line(bench, cell, out, ctx.trace, device)
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {found} after the window; no result", file=sys.stderr)
        return 3
    print(f"time check_s: {out.check_s!r}", file=sys.stderr)
    if out.trace is not None:
        print(f"time trace_reduce_s: {out.trace.reduce_s!r}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
