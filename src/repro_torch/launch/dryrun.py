"""Dry run of the multi-card LM path: trace every (arch x shape) step once on
the production mesh of H100s, with no parameter allocated and no card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]

The counterpart of `repro.launch.dryrun`, which lowers and compiles each
step for 256 or 512 forced host devices.  Here rank 0 of a fake world of
256 (16 x 16) or 512 (2 x 16 x 16) ranks runs the step eagerly under
`FakeTensorMode`: the parameters, optimizer state, batch and cache are
DTensors laid out by the config's rules (`repro_torch.launch.steps`)
whose local shards are fake tensors, every kernel wrapper takes its fake
route, and collectives move nothing.  Each pair is traced at its
published width and depth, every layer.

The record has the reference's keys:

* ``compile_s`` — seconds to build the inputs and trace the step (there
  is no compile);
* ``bytes_per_device`` — one rank's bytes: ``arguments``, the local
  shards of the parameters, optimizer state, batch and cache;
  ``outputs``, of what the step returns; ``aliased``, the outputs that
  are arguments updated in place (a train step's parameters and moments,
  a decode step's KV cache), where XLA's are donated buffers; ``peak_est``,
  the most bytes live at once during the step by torch's `MemTracker` over
  the fake tensors, arguments included; ``temps`` = peak_est - arguments -
  outputs + aliased, by XLA's identity.  XLA plans its buffers ahead and
  reports the plan; this is what eager PyTorch would hold, with the
  caching allocator's rounding and fragmentation left out;
* ``cost`` — ``flops`` and ``bytes accessed`` of one rank
  (`repro_torch.roofline.op_cost`);
* ``roofline`` — `repro_torch.roofline.analysis`'s row at H100 rates.

Nothing here touches CUDA: the mesh is on ``"cpu"``, on this machine and
on one with a card alike.  The figures are estimates for 256 and 512
H100s from one traced rank, not measurements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import enter_mesh, set_active_rules
from repro_torch.launch.mesh import make_mesh, make_production_mesh, num_chips
from repro_torch.launch.steps import (
    abstract_cache,
    abstract_opt_state,
    abstract_params,
    input_specs,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    shape_config,
)
from repro_torch.models.config import INPUT_SHAPES, get_input_shape
from repro_torch.models.model import model_flops_per_token
from repro_torch.roofline.analysis import roofline_terms
from repro_torch.roofline.op_cost import OpCost
from repro_torch.tree import tree_leaves


def _local(x):
    from torch.distributed.tensor import DTensor

    return x._local_tensor if isinstance(x, DTensor) else x


def _bytes(tree) -> int:
    """One rank's bytes of the tensors in ``tree`` (a DTensor's local shard)."""
    seen, total = set(), 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor) and id(_local(x)) not in seen:
            seen.add(id(_local(x)))
            total += _local(x).numel() * _local(x).element_size()
    return total


def _aliased(outputs, arguments) -> int:
    """Bytes of ``outputs`` that are tensors of ``arguments`` (updated in place)."""
    ids = {id(_local(x)) for x in tree_leaves(arguments) if isinstance(x, torch.Tensor)}
    return _bytes([x for x in tree_leaves(outputs)
                   if isinstance(x, torch.Tensor) and id(_local(x)) in ids])


def _peak_bytes(tracker) -> int:
    """The most bytes `MemTracker` saw live at once on this rank's device."""
    return int(max(v["Total"] for v in tracker.get_tracker_snapshot("peak").values()))


def _step_tokens(shape):
    """(tokens a step, model-flops factor): 6N a token for train, 2N for forward only."""
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len, 1.0
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len, 1.0 / 3.0
    return shape.global_batch, 1.0 / 3.0


# ModelConfig fields the port keeps for the reference's overrides but reads nowhere:
# the flash op and its plain version already visit only the causally live key blocks,
# which is what the reference's ``attn_causal_skip`` switches on
NOOP_OVERRIDES = ("attn_causal_skip",)


def noop_overrides(cfg, overrides) -> list:
    """The overrides that change a field in `NOOP_OVERRIDES` of ``cfg``: no-ops in the port."""
    return sorted(k for k, v in (overrides or {}).items()
                  if k in NOOP_OVERRIDES and getattr(cfg, k) != v)


def dryrun_pair(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    verbose=True,
    overrides: dict | None = None,
    mesh_shape: tuple | None = None,
    input_shape=None,
):
    """Trace one (arch, shape) step on the production mesh. Returns a result-record dict.

    `overrides` replaces ModelConfig fields (the §Perf hillclimb hook), e.g.
    {"grad_accum": 8, "sharding": "fsdp_tp_sp"}; an override that changes a
    field the port reads nowhere (`NOOP_OVERRIDES`) is named in the record's
    ``noop_overrides``, a key the reference's record does not have, and the
    step traced is what the other overrides alone give.  ``mesh_shape`` (2 or 3
    dims) replaces the production mesh's shape and ``input_shape`` (an
    `InputShape`) the named one, for small worlds and steps.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    shape = get_input_shape(shape_name) if input_shape is None else input_shape
    cfg = shape_config(get_config(arch), shape)
    noops = noop_overrides(cfg, overrides)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        mesh = make_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):])
    chips = num_chips(mesh)

    t0 = time.time()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    model, _ = abstract_params(cfg, mesh, fake)
    batch = input_specs(cfg, shape, mesh, fake)
    arguments = [model.tree(), batch]
    with torch.no_grad():
        if shape.kind == "train":
            opt, train_step = make_train_step(cfg)
            opt_state = abstract_opt_state(cfg, opt, model, fake)
            arguments.append(opt_state)
        elif shape.kind == "decode":
            cache = abstract_cache(cfg, shape, mesh, fake)
            arguments.append(cache)
    tracker = MemTracker()
    with fake, enter_mesh(mesh), set_active_rules(cfg.sharding):
        tracker.track_external(*[x for x in tree_leaves(arguments) if isinstance(x, torch.Tensor)])
        with tracker, OpCost() as counter:
            if shape.kind == "train":
                _, opt_state, metrics = train_step(model, opt_state, batch)
                outputs = [model.tree(), opt_state, metrics]
            elif shape.kind == "prefill":
                outputs = list(make_prefill_step(cfg)(model, batch))
            else:
                outputs = list(make_serve_step(cfg)(model, cache, batch))
    compile_s = time.time() - t0

    args_b, out_b = _bytes(arguments), _bytes(outputs)
    aliased = _aliased(outputs, arguments)
    peak = _peak_bytes(tracker)
    tokens, factor = _step_tokens(shape)
    model_flops = model_flops_per_token(cfg) * tokens * factor
    report = roofline_terms(arch, shape_name, chips, counter.cost, model_flops)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, mesh.shape)),
        "chips": chips,
        "compile_s": round(compile_s, 1),
        "bytes_per_device": {
            "arguments": args_b,
            "outputs": out_b,
            "temps": peak - args_b - out_b + aliased,
            "aliased": aliased,
            "peak_est": peak,
        },
        "cost": {"flops": counter.cost.flops, "bytes accessed": counter.cost.bytes},
        "roofline": report.row(),
    }
    if noops:
        rec["noop_overrides"] = noops
    if verbose:
        bpd = rec["bytes_per_device"]
        r = rec["roofline"]
        print(
            f"[OK] {arch:24s} {shape_name:12s} mesh={rec['mesh']:9s} "
            f"compile={rec['compile_s']:6.1f}s "
            f"peak/dev={bpd['peak_est']/2**30:7.2f}GiB "
            f"compute={r['compute_s']*1e3:9.3f}ms "
            f"memory={r['memory_s']*1e3:9.3f}ms "
            f"coll={r['collective_s']*1e3:9.3f}ms "
            f"dom={r['dominant']:10s} useful={r['useful_ratio']:5.2f}"
        )
        sys.stdout.flush()
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS)
    p.add_argument("--shape", choices=[s.name for s in INPUT_SHAPES])
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    pairs = []
    if args.all:
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                pairs.append((a, s.name))
    else:
        if not (args.arch and args.shape):
            p.error("need --arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]

    records, failures = [], []
    for a, s in pairs:
        try:
            records.append(dryrun_pair(a, s, multi_pod=args.multi_pod))
        except Exception as e:  # noqa: BLE001 — report every failure at the end
            failures.append((a, s, f"{type(e).__name__}: {e}"))
            print(f"[FAIL] {a} {s}: {type(e).__name__}: {str(e)[:200]}")
            sys.stdout.flush()

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    print(f"\n{len(records)} ok, {len(failures)} failed")
    if failures:
        for a, s, err in failures:
            print(f"  FAIL {a} {s}: {err[:300]}")
        sys.exit(1)


if __name__ == "__main__":
    main()
