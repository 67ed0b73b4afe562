"""Closed-loop language-model training through the program's `launch.steps.make_train_step`.

Traffic parameters: ``batch`` x ``seq_len`` positions a step, ``pool_batches``
distinct batches of the seeded token streams made on the device in
set-up (the window cycles through them), ``checked_steps`` steps run in
set-up through the window's own call and followed by the reference,
``optimizer`` (the step's ``lr``; the clip, Adam and decay constants the
reference follows), ``trace_seconds`` (the traced window's length at most).

Compared, each against the cell's limit: each leaf's first gradient as the
optimizer got it, read from Adam's second moment after step 1
(``grad1_gap``), and each leaf's change over the checked steps
(``dparam_gap``), both as `common.norm_gap` over the leaves whose reference
gradient is not nought (over a thousandth of the median leaf's).  The
steps' losses are not compared: no control or fault separates them from
sound runs (PERF.md §2).
"""
from __future__ import annotations

import time

import torch

from portbench import counts, peaks, tokens, trace
from portbench.drivers import common
from portbench.harness import Outcome
from portbench.reference import mamba1_lm as ref

TOKEN_SEED_SALT = 0x5EED_70C5


def _leaf(tree, name: str):
    parts = name.split(".")
    if len(parts) == 3:  # a layer's group: "<part>.<leaf>.<layer>"
        return tree["layers"][int(parts[2])][parts[0]][parts[1]]
    return tree[parts[0]][parts[1]]


def first_gradient_norms(opt_state, names, b2: float) -> dict:
    """Each leaf's gradient norm as the optimizer got it in its first step: Adam's second
    moment after one step is (1 - b2) g^2."""
    nu = opt_state[1].nu
    sums = torch.stack([_leaf(nu, n).float().sum() for n in names])
    return dict(zip(names, torch.sqrt(sums / (1 - b2)).tolist()))


def change_norms(params, cfg: dict, seed: int, device, names) -> dict:
    """Each leaf's distance from its initial value (the seed's draw, made again)."""
    m = ref.dims(cfg)
    out = []
    for gname in ref.LAYER_GROUPS + ref.MODEL_GROUPS:
        p0 = ref.draw_group(cfg, gname, seed, device)
        if gname in ref.LAYER_GROUPS:
            out += [(_leaf(params, f"{gname}.{i}").float() - p0[i].float()).norm()
                    for i in range(m["L"])]
        else:
            out.append((_leaf(params, gname).float() - p0.float()).norm())
        del p0
    by_group = torch.stack(out).tolist()
    order = [f"{g}.{i}" for g in ref.LAYER_GROUPS for i in range(m["L"])] + list(ref.MODEL_GROUPS)
    got = dict(zip(order, by_group))
    return {n: got[n] for n in names}


def compare(got: dict, want: dict, names) -> dict:
    """``grad1_gap`` and ``dparam_gap`` (`common.norm_gap` over the leaves whose reference
    gradient is over a thousandth of the median leaf's) of ``got`` against the reference's
    ``want``."""
    median = sorted(want["grad1"].values())[len(names) // 2]
    kept = [n for n in names if want["grad1"][n] >= 1e-3 * median]
    return {"grad1_gap": common.norm_gap(got["grad1"], want["grad1"], kept),
            "dparam_gap": common.norm_gap(got["dparam"], want["dparam"], kept)}


def batches_of(cfg: dict, tr: dict, seed: int, device) -> list[dict]:
    """The pool of distinct (tokens, labels) batches, int32, made on the device."""
    B, S = tr["batch"], tr["seq_len"]
    rows = tokens.token_rows(tr["pool_batches"] * B, S + 1, cfg["vocab_size"],
                             (seed ^ TOKEN_SEED_SALT) % 2**63, device)
    return [{"tokens": rows[i * B:(i + 1) * B, :-1].int().contiguous(),
             "labels": rows[i * B:(i + 1) * B, 1:].int().contiguous()}
            for i in range(tr["pool_batches"])]


def run(ctx) -> Outcome:
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    m = ref.dims(cfg)
    B, T = tr["batch"], tr["seq_len"]
    hp = tr["optimizer"]
    names = ref.leaf_names(m["L"])
    mcfg = common.model_config(cfg)

    # set-up: the benchmark's weights and tokens, then the checked steps through the window's call
    common.mark(ctx, "import")
    stacked = ref.make_weights(cfg, ctx.seed, dev)
    model = M.LM(ref.as_tree(stacked, m["L"]), mcfg)
    del stacked
    opt, step = S.make_train_step(mcfg, hp["lr"])
    state = {"model": model, "opt": opt.init(model.tree())}
    del model
    pool = batches_of(cfg, tr, ctx.seed, dev)
    checked = tr["checked_steps"]
    common.mark(ctx, "inputs")

    def train_step(i):
        state["model"], state["opt"], metrics = step(state["model"], state["opt"],
                                                      pool[i % len(pool)])
        return metrics

    grad1 = None
    for i in range(checked):
        train_step(i)
        if i == 0:
            grad1 = first_gradient_norms(state["opt"], names, hp["b2"])
    common.sync(dev)
    t_cap = time.perf_counter()
    dparam = change_norms(state["model"].tree(), cfg, ctx.seed, dev, names)
    capture_s = time.perf_counter() - t_cap
    setup_s = time.perf_counter() - ctx.t_start - capture_s

    def window(seconds):
        return common.closed_loop(lambda n: train_step(checked + n), seconds, dev)

    if ctx.trace:
        (steps, elapsed), tr_out = trace.traced(lambda: window(min(ctx.seconds,
                                                                   tr["trace_seconds"])))
    else:
        (steps, elapsed), tr_out = window(ctx.seconds), None
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    positions = steps * B * T
    checked_batches = [(pool[i]["tokens"].long(), pool[i]["labels"].long())
                       for i in range(checked)]
    del state, pool
    common.free(dev)

    t_check = time.perf_counter()
    with common.exact_float32():
        want = ref.train(cfg, ctx.seed, checked_batches, hp, dev)
    readings = compare({"grad1": grad1, "dparam": dparam}, want, names)
    checks = {k: (v, ctx.limits[k]) for k, v in readings.items()}
    flops = counts.mamba1_train_flops_per_position(cfg)
    window_info = {
        "seconds": elapsed, "steps": steps, "positions": positions,
        "model_flops": flops * positions, "peak_flops": peaks.BF16_FLOPS_PER_S,
        "calls": {"selective_scan_bwd": [(B, T, m["di"], m["N"])] * (steps * m["L"]),
                  "fused_xent": [(B * T, m["d"], m["V"])] * steps},
    }
    return Outcome(metrics={"train_tokens_per_s": positions / elapsed, "setup_s": setup_s},
                   checks=checks, attempted=steps, failed=0, memory_peak_bytes=memory_peak,
                   window=window_info, trace=tr_out, check_s=time.perf_counter() - t_check)


def control(ctx) -> dict:
    """The readings of the reference computed with float8 products in the program's place."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    names = ref.leaf_names(ref.dims(cfg)["L"])
    pool = batches_of(cfg, tr, ctx.seed, dev)[: tr["checked_steps"]]
    batches = [(b["tokens"].long(), b["labels"].long()) for b in pool]
    with common.exact_float32():
        want = ref.train(cfg, ctx.seed, batches, tr["optimizer"], dev)
        got = ref.train(cfg, ctx.seed, batches, tr["optimizer"], dev, fp8=True)
    return compare(got, want, names)
