"""The readings the correctness limits are set from; no benchmark run runs this.

    python3 portbench/controls.py --workload <name> --seeds <n> ... \
        [--control-seeds <n> ...] [--faults <name> ...] [--seconds 1] --out <file.json>

For each of ``--seeds``: a sound run of the cell (its set-up, a short
window, its check), whose readings give the lower end of each limit.  For
each of ``--control-seeds``: the control (the reference computed one
precision below the configuration's, in the program's place) and each
fault of ``--faults`` (`faults.FAULTS`, planted in the program under a
whole run), whose readings give the upper end.  One process, one card;
the readings go to ``--out`` as JSON, a line a reading to standard output.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from portbench import faults, harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    traffic = harness.traffic_of(cell)
    driver = harness.driver(traffic["driver"])
    limits = {k: float("inf") for k in harness.limits_of(cell)}

    def ctx(seed):
        return harness.Context(cell=cell, config=harness.config_of(bench, cell, ROOT),
                               traffic=traffic, limits=limits, seed=seed,
                               seconds=args.seconds, trace=False, t_start=time.perf_counter(),
                               device=torch.device("cuda"))

    out = {"workload": cell["name"], "device": torch.cuda.get_device_name(0), "sound": {},
           "control": {}, "faults": {}}

    def note(kind, seed, readings):
        print(json.dumps({"kind": kind, "seed": seed, **readings}), flush=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))

    for seed in args.seeds:
        run = driver.run(ctx(seed))
        out["sound"][seed] = {k: v for k, (v, _) in run.checks.items()}
        out["sound"][seed]["rate"] = run.metrics
        note("sound", seed, out["sound"][seed])
    for seed in args.control_seeds:
        out["control"][seed] = driver.control(ctx(seed))
        note("control", seed, out["control"][seed])
        for name in args.faults:
            with faults.FAULTS[traffic["driver"]][name]():
                run = driver.run(ctx(seed))
            out["faults"].setdefault(name, {})[seed] = {k: v for k, (v, _) in run.checks.items()}
            note(f"fault {name}", seed, out["faults"][name][seed])
    return 0


if __name__ == "__main__":
    sys.exit(main())
