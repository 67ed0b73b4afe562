"""Print the port's dry-run records as PERF.md's table: one row an arch, one
cell a shape, each cell ``peak GiB a device on 16x16 / 2x16x16, the dominant
term, the useful-FLOPs ratio``.

  python scripts/dryrun_table.py results/port/dryrun_baseline.json results/port/dryrun_multipod.json

The records come from ``python -m repro_torch.launch.dryrun --all [--multi-pod] --json``;
the figures are dry-run estimates at H100 SXM5 datasheet constants.
"""
import json
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SHORT = {"compute": "comp", "memory": "mem", "collective": "coll"}


def main(single, multi):
    recs = {}
    for path in (single, multi):
        with open(path) as f:
            for r in json.load(f):
                recs[(r["arch"], r["shape"], r["mesh"])] = r
    archs = list(dict.fromkeys(a for a, _, _ in recs))
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    for arch in archs:
        cells = []
        for shape in SHAPES:
            one, two = recs.get((arch, shape, "16x16")), recs.get((arch, shape, "2x16x16"))
            if one is None or two is None:
                cells.append("missing")
                continue
            peaks = "/".join(f"{r['bytes_per_device']['peak_est'] / 2**30:.1f}" for r in (one, two))
            doms = "/".join(dict.fromkeys(SHORT[r["roofline"]["dominant"]] for r in (one, two)))
            useful = "/".join(dict.fromkeys(f"{r['roofline']['useful_ratio']:.2f}"
                                            for r in (one, two)))
            cells.append(f"{peaks} GiB, {doms}, {useful}")
        print(f"| {arch} | " + " | ".join(cells) + " |")
    fit = sum(r["bytes_per_device"]["peak_est"] <= 80e9 for r in recs.values())
    print(f"\n{len(recs)} records; {fit} with peak_est <= 80 GB a device; trace seconds "
          f"{sum(r['compile_s'] for r in recs.values()):.0f} in all")


if __name__ == "__main__":
    main(*sys.argv[1:3])
