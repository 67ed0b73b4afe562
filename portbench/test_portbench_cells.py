"""CPU tests of every cell's whole run at a small size: the program against the plain
reference comes out correct, the control (the reference one precision lower in the
program's place) and each fault planted underneath come out not correct.

The sizes are the cells' shapes cut down (the widths of a smoke model, a few envs); the
limits are the cells' own (`limits/`), so a fault must fail them at this size too.
"""
from __future__ import annotations

import json
import pathlib
import time

import pytest
import torch

from portbench import faults, harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = harness.load_benchmark(ROOT)
SMALL_MAMBA1 = dict(hidden_size=64, intermediate_size=128, time_step_rank=4, vocab_size=256,
                    num_hidden_layers=2)
SMALL = {"mamba1-fm7b-l32": SMALL_MAMBA1, "mamba1-fm7b": SMALL_MAMBA1,
         "ippo-spread": dict(rollout_len=32)}
SMALL_TRAFFIC = {
    "lm_train": dict(batch=2, seq_len=64, pool_batches=6),
    "lm_prefill": dict(batch=2, min_len=16, max_len=256, multiple=16, pass_batches=6),
    "anakin": dict(lanes=2, envs=64, cycles_per_call=2),
}
SEED = 2**31 + 11


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _context(cell: dict) -> harness.Context:
    cfg = dict(harness.config_of(BENCH, cell, ROOT), **SMALL[cell["config"]])
    traffic = harness.traffic_of(cell)
    traffic = dict(traffic, **SMALL_TRAFFIC[traffic["driver"]])
    return harness.Context(cell=cell, config=cfg, traffic=traffic, limits=harness.limits_of(cell),
                           seed=SEED, seconds=0.05, trace=False, t_start=time.perf_counter(),
                           device=torch.device("cpu"))


def _run(cell):
    ctx = _context(cell)
    out = harness.driver(ctx.traffic["driver"]).run(ctx)
    line = harness.result_line(BENCH, cell, out, False, {"platform": "cpu"})
    return line


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_portbench_cell_correct_on_cpu(cell, one_thread):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in harness.end_to_end_of(BENCH, cell)}
    json.dumps(line)


FAULT_CASES = [(cell, name) for cell in BENCH["workloads"]
               for name in faults.FAULTS[harness.traffic_of(cell)["driver"]]]


# an altered action shows only in the actions' counts, whose z grows as the root of the draws
FAULT_TRAFFIC = {"token": dict(lanes=1, envs=2048, cycles_per_call=1)}


@pytest.mark.parametrize("cell,fault", FAULT_CASES,
                         ids=[f"{c['name']}-{f}" for c, f in FAULT_CASES])
def test_portbench_fault_not_correct(cell, fault, one_thread):
    driver = harness.traffic_of(cell)["driver"]
    ctx = _context(cell)
    if driver == "anakin":
        ctx.traffic.update(FAULT_TRAFFIC.get(fault, {}))
    with faults.FAULTS[driver][fault]():
        out = harness.driver(driver).run(ctx)
    line = harness.result_line(BENCH, cell, out, False, {"platform": "cpu"})
    assert not line["correct"], line["checks"]


# float8's error in the states grows with depth: at 2 layers it reads near the limit, and the
# 64-layer cell's limit wants 16
CONTROL_CONFIG = {"mamba1-fm7b-l32": dict(num_hidden_layers=8),
                  "mamba1-fm7b": dict(num_hidden_layers=16)}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_portbench_control_not_correct(cell, one_thread):
    ctx = _context(cell)
    ctx.config.update(CONTROL_CONFIG.get(cell["config"], {}))
    readings = harness.driver(ctx.traffic["driver"]).control(ctx)
    assert any(v > ctx.limits[k] for k, v in readings.items()), readings


def test_portbench_reference_prefill_packs_prompts_of_any_length(one_thread):
    """Prompts of different lengths prefilled together read what each does alone."""
    from portbench.reference import mamba1_lm as ref

    cfg = dict(harness.config_of(BENCH, harness.find_cell(BENCH, "fm7b-prefill-mixed"), ROOT),
               **SMALL_MAMBA1, torch_dtype="float32")
    stacked = ref.make_weights(cfg, SEED, "cpu")
    prompts = [torch.randint(0, 256, (n,), generator=torch.Generator().manual_seed(n))
               for n in (5, 70, 33)]
    logits, conv, ssm = ref.prefill(cfg, stacked, prompts)
    for i, p in enumerate(prompts):
        one = ref.prefill(cfg, stacked, p[None])
        for got, want in zip((logits[i], conv[:, i], ssm[:, i]), (one[0][0], one[1][:, 0],
                                                                   one[2][:, 0])):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
