"""Closed-loop prompt prefill through the program's `models.model.prefill`.

Traffic parameters: batches of ``batch`` requests whose prompts share a
length; a pass is ``pass_batches`` lengths, the quantiles of a
log-uniform law on [``min_len``, ``max_len``] rounded up to a multiple of
``multiple``, in an order each pass draws from the seed (every seed runs
the same lengths).  The prompts are seeded token streams made on the
device in set-up, and set-up prefills every length once.  A request's
time to first token runs from the moment its batch is issued to the
moment the host holds the greedy first token.

Compared once the window has closed, on one request of every length the
window served (the first batch of that length; its row drawn from the
seed so that the judged rows take every place in a batch): the widest gap
by which a served first token's logit lies below the reference's best
(``token_gap``), and the worst layer's relative distance of the conv and
SSM states the prefill left for those requests from the reference's
(``state_gap``).  The reference prefills the judged prompts in one call.
"""
from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from portbench import counts, peaks, tokens, trace
from portbench.drivers import common
from portbench.harness import Outcome
from portbench.reference import mamba1_lm as ref

TOKEN_SEED_SALT = 0x9E3779B1


def lengths_of(tr: dict) -> list[int]:
    """The pass's prompt lengths: log-uniform quantiles, rounded up to ``multiple``."""
    lo, hi, n, k = tr["min_len"], tr["max_len"], tr["pass_batches"], tr["multiple"]
    return [min(hi, k * math.ceil(math.exp(math.log(lo) + (i + 0.5) / n * math.log(hi / lo)) / k))
            for i in range(n)]


def prompts_of(cfg: dict, tr: dict, seed: int, device) -> list:
    """A pass's prompt batches (B, length) int32, made on the device from the seed."""
    lengths, B = lengths_of(tr), tr["batch"]
    rows = tokens.token_rows(len(lengths) * B, max(lengths), cfg["vocab_size"],
                             (seed ^ TOKEN_SEED_SALT) % 2**63, device)
    return [rows[j * B:(j + 1) * B, :n].int().contiguous() for j, n in enumerate(lengths)]


def judged_rows(tr: dict, seed: int) -> list[int]:
    """The row judged in each length's batch: consecutive lengths take consecutive rows
    from one drawn from the seed."""
    first = random.Random(seed + 1).randrange(tr["batch"])
    return [(first + j) % tr["batch"] for j in range(tr["pass_batches"])]


def state_gap(conv, ssm, want_conv, want_ssm) -> float:
    """The worst layer's relative distance of one request's conv and SSM states (L, ...)."""
    def rel(a, b):
        a, b = a.float().flatten(1), b.float().flatten(1)
        return ((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max()
    return float(torch.maximum(rel(conv, want_conv), rel(ssm, want_ssm)))


def token_gaps(want_logits, served) -> list[float]:
    """How far each served token's logit lies below the reference's best, a request."""
    best = want_logits.max(-1).values
    served = torch.as_tensor(served, device=want_logits.device)
    return (best - want_logits.gather(-1, served[:, None])[:, 0]).tolist()


def judge(cfg: dict, stacked: dict, prompts: list, kept: dict) -> tuple[list, list]:
    """The reference over the judged requests ``kept`` ({length index: (row, served token,
    conv state, SSM state)}): their token gaps and state gaps."""
    order = sorted(kept)
    with common.exact_float32():
        logits, conv, ssm = ref.prefill(cfg, stacked, [prompts[j][kept[j][0]].long()
                                                      for j in order])
    gaps_tok = token_gaps(logits, [kept[j][1] for j in order])
    gaps_state = [state_gap(kept[j][2], kept[j][3], conv[:, i], ssm[:, i])
                  for i, j in enumerate(order)]
    return gaps_tok, gaps_state


def run(ctx) -> Outcome:
    from repro_torch.models import model as M

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    m = ref.dims(cfg)
    B = tr["batch"]
    mcfg = common.model_config(cfg)
    lengths = lengths_of(tr)
    common.mark(ctx, "import")
    stacked = ref.make_weights(cfg, ctx.seed, dev)
    program = {"model": M.LM(ref.as_tree(stacked, m["L"]), mcfg)}
    del stacked
    prompts = prompts_of(cfg, tr, ctx.seed, dev)
    common.mark(ctx, "inputs")
    rng = random.Random(ctx.seed)

    def serve(j):
        logits, cache = M.prefill(program["model"], prompts[j])
        return torch.argmax(logits[:, -1], dim=-1).cpu(), cache

    for j in range(len(lengths)):
        serve(j)
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    # judged once the window has closed: a row of each length's first batch in the window
    rows = judged_rows(tr, ctx.seed)
    served_log, kept = [], {}  # (batch index, time to first token); batch -> judged request

    def window(seconds):
        order = []

        def one(n):
            if not order:
                order.extend(rng.sample(range(len(lengths)), len(lengths)))
            j = order.pop(0)
            t0 = time.perf_counter()
            served, cache = serve(j)
            served_log.append((j, time.perf_counter() - t0))
            if j not in kept:
                r = rows[j]
                kept[j] = (r, int(served[r]), cache["conv"][:, r].clone(),
                           cache["ssm"][:, r].clone())

        return common.closed_loop(one, seconds, dev)

    if ctx.trace:
        (n, elapsed), tr_out = trace.traced(lambda: window(min(ctx.seconds, tr["trace_seconds"])))
    else:
        (n, elapsed), tr_out = window(ctx.seconds), None
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    batches = [j for j, _ in served_log]
    positions = sum(B * lengths[j] for j in batches)
    ttft = np.repeat([t for _, t in served_log], B)
    program.clear()
    common.free(dev)

    t_check = time.perf_counter()
    gaps_tok, gaps_state = judge(cfg, ref.make_weights(cfg, ctx.seed, dev), prompts, kept)
    check_s = time.perf_counter() - t_check
    checks = {"token_gap": (max(gaps_tok), ctx.limits["token_gap"]),
              "state_gap": (max(gaps_state), ctx.limits["state_gap"])}
    window_info = {
        "seconds": elapsed, "requests": n * B, "positions": positions,
        "model_flops": sum(counts.mamba1_prefill_flops(cfg, B, lengths[j]) for j in batches),
        "calls": {"selective_scan": [(B, lengths[j], m["di"], m["N"])
                                     for j in batches for _ in range(m["L"])]},
        "peak_flops": peaks.BF16_FLOPS_PER_S,
    }
    return Outcome(metrics={"prefill_tokens_per_s": positions / elapsed,
                            "ttft_ms.p95": float(np.percentile(ttft * 1e3, 95)),
                            "setup_s": setup_s},
                   checks=checks, attempted=n * B, failed=0, memory_peak_bytes=memory_peak,
                   window=window_info, trace=tr_out, check_s=check_s)


def control(ctx) -> dict:
    """The readings of the reference computed with float8 products in the program's place:
    the gap of the token it puts first, and its states' distance."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    prompts = prompts_of(cfg, tr, ctx.seed, dev)
    stacked = ref.make_weights(cfg, ctx.seed, dev)
    judged = [p[r].long() for p, r in zip(prompts, judged_rows(tr, ctx.seed))]
    with common.exact_float32():
        c_logits, c_conv, c_ssm = ref.prefill(cfg, stacked, judged, fp8=True)
    kept = {j: (r, int(c_logits[j].argmax()), c_conv[:, j], c_ssm[:, j])
            for j, r in enumerate(judged_rows(tr, ctx.seed))}
    del c_logits, c_conv, c_ssm
    gaps_tok, gaps_state = judge(cfg, stacked, prompts, kept)
    return {"token_gap": max(gaps_tok), "state_gap": max(gaps_state)}
