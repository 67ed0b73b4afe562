"""The port's telemetry (`repro_torch.obs`, `repro_torch.roofline`) against the JAX package.

* sinks round-trip (tensors too), CSV schema drift raises, and
  `SeedAggregator` on the same numpy input equals `repro.obs`'s bitwise;
* the runners' tap is a pure observer: a tapped run is bitwise the
  untapped one (params, optimizer state, metrics) for ippo, rec_ippo
  (linear core), vdn, seed lanes with interleaved evaluation, the async
  runner and the sharded runner (one gloo rank), as tests/test_bench.py
  pins the reference's;
* the launcher's ``run.json`` passes `repro.bench.schema.check_run_record`
  but for the JAX-only provenance field named below;
* `op_cost` counts the flops of a 2-layer MLP forward + backward step,
  and of that step looped, exactly as `repro.roofline.hlo_cost.module_cost`
  counts the jitted JAX function's; it takes a hand kernel's own cost
  (recurrent_scan) in place of its plain loop's ops, and counts the
  collective bytes of torch.distributed calls;
* `profile_trace`, `RetraceCounter` and `measure_phase_timing` work on
  the CPU.

CPU, float32; every parity here is exact.
"""
import csv
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.bench.schema import check_run_record  # noqa: E402
from repro.obs import SeedAggregator as JaxSeedAggregator  # noqa: E402
from repro.roofline.hlo_cost import module_cost as hlo_module_cost  # noqa: E402
from repro_torch.core import make_anakin  # noqa: E402
from repro_torch.core.system import train_distributed  # noqa: E402
from repro_torch.distributed.impala import train_async  # noqa: E402
from repro_torch.kernels.recurrent_scan import linear_recurrent_scan  # noqa: E402
from repro_torch.launch import train_marl  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    ConsoleSink,
    CsvSink,
    JsonlSink,
    MetricTap,
    MultiLogger,
    RetraceCounter,
    SeedAggregator,
    host_values,
    measure_phase_timing,
    profile_trace,
    provenance,
    roofline_summary,
)
from repro_torch.roofline import OpCost, module_cost  # noqa: E402
from repro_torch.systems.registry import make_pair  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = "cpu"
# check_run_record's provenance wants jax_version; the port names torch_version
JAX_ONLY_PROVENANCE = {"provenance.jax_version must be a non-empty string"}
PPO_SMALL = dict(hidden_sizes=(16, 16), rollout_len=8, epochs=1, num_minibatches=2)
VDN_SMALL = dict(hidden_sizes=(16, 16), buffer_capacity=500, min_replay=32, batch_size=16)


class CaptureSink:
    """A test double recording every (metrics, step) write."""

    def __init__(self):
        self.rows = []
        self.closed = False

    def write(self, metrics, step=None):
        self.rows.append((dict(metrics), step))

    def close(self):
        self.closed = True


# ------------------------------------------------------------------ sinks


def test_jsonl_sink_round_trips(tmp_path):
    path = tmp_path / "metrics.jsonl"
    sink = JsonlSink(path)
    rows = [
        {"reward": 1.5, "sps": 1000.0, "updates": 3},
        {"reward": np.float32(-2.25), "sps": torch.tensor(2000.0), "updates": torch.tensor(4)},
    ]
    for i, row in enumerate(rows):
        sink.write(row, step=i)
    sink.close()
    back = [json.loads(line) for line in path.read_text().splitlines()]
    assert back == [
        {"step": 0, "reward": 1.5, "sps": 1000.0, "updates": 3},
        {"step": 1, "reward": -2.25, "sps": 2000.0, "updates": 4},
    ]


def test_csv_sink_round_trips_and_rejects_schema_drift(tmp_path):
    path = tmp_path / "metrics.csv"
    sink = CsvSink(path)
    sink.write({"reward": 1.5, "updates": 3}, step=10)
    sink.write({"reward": torch.tensor(-0.5)}, step=20)  # a missing column is logged empty
    with pytest.raises(ValueError, match="not in the header"):
        sink.write({"reward": 1.0, "surprise": 2.0}, step=30)
    sink.close()
    with open(path) as f:
        back = list(csv.DictReader(f))
    assert [r["step"] for r in back] == ["10", "20"]
    assert [float(r["reward"]) for r in back] == [1.5, -0.5]
    assert [r["updates"] for r in back] == ["3", ""]


def test_console_and_multi_logger(capsys):
    a, b = CaptureSink(), CaptureSink()
    logger = MultiLogger(ConsoleSink(), a, b)
    logger.write({"reward": torch.tensor(1.23456), "updates": 7}, step=5)
    logger.close()
    assert capsys.readouterr().out.splitlines() == ["step=5  reward=1.235  updates=7"]
    assert a.rows == b.rows and a.closed and b.closed


@pytest.mark.parametrize("metrics", [
    {"reward": np.array([1.0, 3.0, 5.0], np.float32), "iteration": 7, "tag": "x"},
    {"m": np.arange(6.0, dtype=np.float32).reshape(2, 3) / 7},
    {"updates": np.array([3, 4], np.int32), "ret": np.float32(0.1)},
    {"r": np.random.default_rng(0).normal(size=(8, 4, 3)).astype(np.float32)},
], ids=["lanes", "trailing", "ints", "wide"])
def test_seed_aggregator_equals_reference_bitwise(metrics):
    ours, ref = CaptureSink(), CaptureSink()
    SeedAggregator(ours).write(metrics, step=3)
    JaxSeedAggregator(ref).write(metrics, step=3)
    assert ours.rows == ref.rows
    as_tensors = CaptureSink()
    SeedAggregator(as_tensors).write(
        {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v
         for k, v in metrics.items()}, step=3)
    assert as_tensors.rows == ref.rows


def test_metric_tap_counts_and_reports_sps():
    sink = CaptureSink()
    tap = MetricTap(sink, log_every=8, steps_per_iteration=4)
    tap(7, 2, {"reward": 0.5})
    tap(np.int32(15), 4, {"reward": 1.5})
    assert tap.emits == 2
    (r0, s0), (r1, s1) = sink.rows
    assert (s0, s1) == (8, 16) and (r0["iteration"], r1["iteration"]) == (8, 16)
    assert r0["sps"] > 0 and r1["updates"] == 4 and r1["reward"] == 1.5
    with pytest.raises(ValueError, match="log_every"):
        MetricTap(sink, log_every=0, steps_per_iteration=1)


def test_host_values_is_exact_in_one_copy():
    tree = {"f": torch.tensor([1.1, -2.5e-8]), "i": torch.tensor([3, -7], dtype=torch.int32),
            "b": torch.tensor([True, False]), "n": 5, "s": (torch.tensor(0.3),)}
    out = host_values(tree)
    assert out["n"] == 5
    for got, want in zip(tree_leaves(out), tree_leaves(tree)):
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.numpy().dtype
            np.testing.assert_array_equal(got, want.numpy())


# ------------------------------------------------- the tap: a pure observer


def _assert_bitwise(a, b):
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    assert len(leaves_a) == len(leaves_b)
    for x, y in zip(leaves_a, leaves_b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name,overrides,num_seeds,eval_every", [
    ("ippo", PPO_SMALL, None, 0),
    ("rec_ippo", dict(PPO_SMALL, recurrent_core="linear"), None, 0),
    ("vdn", VDN_SMALL, None, 0),
    ("ippo", PPO_SMALL, 3, 16),
], ids=["ippo", "rec_ippo-linear", "vdn", "ippo-lanes-eval"])
def test_tapped_anakin_bitwise_matches_untapped(name, overrides, num_seeds, eval_every):
    _, system = make_pair(name, "matrix_game", **overrides)
    kw = dict(eval_every=eval_every, eval_episodes=4, eval_num_envs=4, num_seeds=num_seeds,
              device=CPU)
    off = make_anakin(system, 32, 4, **kw)(7)
    rows = []
    on = make_anakin(system, 32, 4, log_every=8, log_callback=lambda *r: rows.append(r),
                     **kw)(7)
    assert [r[0] for r in rows] == [7, 15, 23, 31]  # global iteration index across eval blocks
    lead = () if num_seeds is None else (num_seeds,)
    assert all(np.shape(r[2]["reward"]) == lead for r in rows)
    assert all(isinstance(v, np.ndarray) for r in rows for v in r[2].values())
    assert int(np.max(rows[-1][1])) > 0  # the update count rode along
    _assert_bitwise((off[0].train, off[1:]), (on[0].train, on[1:]))


def test_tapped_async_bitwise_matches_untapped():
    _, system = make_pair("ippo", "matrix_game", **PPO_SMALL)
    off = train_async(system, 3, 32, 4, 2, param_sync_every=2, device=CPU)
    rows = []
    on = train_async(system, 3, 32, 4, 2, param_sync_every=2, device=CPU, log_every=2,
                     log_callback=lambda *r: rows.append(r))
    assert [r[0] for r in rows] == [1, 3]  # learner ticks of 8 steps
    assert {"queue_depth", "staleness", "reward"} <= set(rows[0][2])
    _assert_bitwise((off[0].train, off[1]), (on[0].train, on[1]))


def _ippo_system():
    return make_pair("ippo", "matrix_game", distributed_axis="data", **PPO_SMALL)[1]


def test_tapped_sharded_bitwise_matches_untapped(tmp_path):
    """A spawned one-rank world with the tap vs the same rank run here without it."""
    import torch.distributed as dist

    from repro_torch.core.system import run_executor
    from repro_torch.distributed import collective

    rows = []
    params, metrics = train_distributed(_ippo_system, 0, 16, 4, 1, backend="gloo", device=CPU,
                                        timeout_s=120, log_every=8,
                                        log_callback=lambda *r: rows.append(r))
    assert [r[0] for r in rows] == [7, 15]  # the rank's rows reach this process
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with collective.bind_axis("data"):
            off = run_executor(_ippo_system(), 0, 0, 16, 4, device=CPU)
    finally:
        dist.destroy_process_group()
    _assert_bitwise(off["params"], params)
    timed = {"wall_s"}  # each run's own wall time
    _assert_bitwise({k: v for k, v in off["metrics"].items() if k not in timed},
                    {k: v for k, v in metrics.items() if k not in timed})


# ------------------------------------------------------------- run records


def test_launcher_run_record_passes_the_reference_schema(tmp_path):
    out = train_marl.main([
        "--system", "ippo", "--env", "matrix_game", "--iterations", "16", "--num-envs", "4",
        "--set", "rollout_len=8", "--set", "hidden_sizes=(16, 16)", "--log-every", "8",
        "--log-dir", str(tmp_path / "runs"), "--run-id", "r0", "--device", CPU,
    ])
    with open(out["run_record"]) as f:
        doc = json.load(f)
    assert set(check_run_record(doc)) == JAX_ONLY_PROVENANCE
    assert doc["provenance"]["framework"] == "torch"
    assert doc["provenance"]["torch_version"] == torch.__version__
    assert set(doc["timing"]["phases"]) == {"rollout_seconds", "update_seconds"}
    assert doc["metrics"]["telemetry_rows"] == 2
    rows = (tmp_path / "runs" / "r0" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["iteration"] for r in rows] == [8, 16]


def test_provenance_names_the_device():
    prov = provenance(CPU)
    assert prov["backend"] == "cpu" and prov["num_devices"] == 1
    assert {"git_sha", "torch_version", "cuda_version", "nvcc_version", "device_kind",
            "gpu", "power_limit", "timestamp"} <= set(prov)


# ---------------------------------------------------------------- op cost

B, IN, HID, OUT, LOOPS = 32, 8, 16, 4, 5


def _mlp_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, IN)).astype(np.float32)
    y = rng.normal(size=(B, OUT)).astype(np.float32)
    params = [rng.normal(size=s).astype(np.float32)
              for s in [(IN, HID), (HID,), (HID, OUT), (OUT,)]]
    return params, x, y


def _jax_step(p, x, y):
    def loss(p):
        h = jax.nn.relu(x @ p[0] + p[1])
        return jnp.mean((h @ p[2] + p[3] - y) ** 2)

    return [a - 0.1 * g for a, g in zip(p, jax.grad(loss)(p))]


def _torch_step(p, x, y):
    p = [t.detach().requires_grad_() for t in p]
    h = torch.relu(x @ p[0] + p[1])
    loss = torch.mean((h @ p[2] + p[3] - y) ** 2)
    return [a.detach() - 0.1 * g for a, g in zip(p, torch.autograd.grad(loss, p))]


@pytest.mark.parametrize("loops", [1, LOOPS])
def test_op_cost_flops_equal_hlo_cost(loops):
    params, x, y = _mlp_data()

    def jax_fn(p, x, y):
        return jax.lax.fori_loop(0, loops, lambda i, p: _jax_step(p, x, y), p)

    text = jax.jit(jax_fn).lower(params, x, y).compile().as_text()
    want = hlo_module_cost(text).flops

    def torch_fn(p, x, y):
        for _ in range(loops):
            p = _torch_step(p, x, y)
        return p

    got = module_cost(torch_fn, [torch.from_numpy(a) for a in params], torch.from_numpy(x),
                      torch.from_numpy(y))
    assert got.flops == want == loops * 2 * B * (2 * IN * HID + 3 * HID * OUT)
    assert got.bytes > 0
    summary = roofline_summary(torch_fn, [torch.from_numpy(a) for a in params],
                               torch.from_numpy(x), torch.from_numpy(y))
    assert summary["hlo_flops"] == want
    assert set(summary) >= {"hlo_flops", "hlo_bytes", "collective_bytes", "collectives"}


def test_op_cost_takes_the_scan_kernels_own_cost():
    T, Bt, H = 12, 3, 5
    g = torch.Generator().manual_seed(0)
    a = torch.rand(T, Bt, H, generator=g).requires_grad_()
    b = torch.randn(T, Bt, H, generator=g)
    h0 = torch.randn(Bt, H, generator=g)
    reset = torch.rand(T, Bt, generator=g) < 0.2
    with OpCost() as counter:
        linear_recurrent_scan(a, b, h0, reset).sum().backward()
    scan = counter.cost.custom_ops["recurrent_scan"]
    D = Bt * H
    # forward (with h0) and the reverse adjoint scan (without): a, b, out
    # float32 read/written once each, the reset mask in bytes
    assert scan["calls"] == 2
    assert scan["bytes"] == (3 * T * D * 4 + D * 4 + T * Bt) + (3 * T * D * 4 + T * Bt)
    assert scan["flops"] == 2 * (2 * T * D)
    # the plain loop's T steps of elementwise ops are not counted on top
    plain = module_cost(lambda: linear_recurrent_scan(a, b, h0, reset))
    assert plain.bytes == 3 * T * D * 4 + D * 4 + T * Bt


def test_op_cost_counts_collective_bytes(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        x = torch.ones(10)
        with OpCost() as counter:
            dist.all_reduce(x)
            dist.broadcast(x, 0)
    finally:
        dist.destroy_process_group()
    assert counter.cost.collectives["all-reduce"] == counter.cost.collectives["broadcast"] == 40
    assert counter.cost.collective_bytes == 80


# ---------------------------------------------------------- profiler hooks


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(tmp_path / "trace") as info:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert "skipped" not in info
    assert info["trace_dir"] == str(tmp_path / "trace")
    with open(info["trace_file"]) as f:
        assert "traceEvents" in json.load(f)


def test_retrace_counter_reads_the_kernel_builds():
    from repro_torch.kernels import BUILD_EVENTS

    with RetraceCounter() as rc:
        pass
    assert rc.summary() == {"jaxpr_traces": 0, "backend_compiles": 0, "kernel_loads": 0,
                            "compile_seconds": 0.0}
    with RetraceCounter() as rc:
        BUILD_EVENTS.update(builds=1, loads=1, build_seconds=2.5)  # what a build records
    BUILD_EVENTS.subtract(builds=1, loads=1, build_seconds=2.5)
    assert rc.summary() == {"jaxpr_traces": 0, "backend_compiles": 1, "kernel_loads": 1,
                            "compile_seconds": 2.5}


@pytest.mark.parametrize("name,overrides", [("ippo", PPO_SMALL), ("vdn", VDN_SMALL)])
def test_measure_phase_timing(name, overrides):
    _, system = make_pair(name, "matrix_game", **overrides)
    phases = measure_phase_timing(system, num_envs=4, eval_episodes=2, repeats=1, device=CPU)
    assert set(phases) == {"rollout_seconds", "update_seconds", "eval_seconds"}
    assert all(v > 0 for v in phases.values())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0), (False, 5),
                                           (True, 40)])
def test_op_cost_takes_the_attention_kernels_own_cost(causal, window):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import _live_pairs

    B, Hq, Hkv, S, hd = 1, 4, 2, 13, 8
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, Hq, S, hd, generator=g)
    k, v = torch.randn(2, B, Hkv, S, hd, generator=g)
    qpos, kpos = torch.arange(S)[:, None], torch.arange(S)[None, :]
    mask = (kpos <= qpos if causal else torch.ones(S, S, dtype=torch.bool))
    if window:
        mask &= kpos > qpos - window
    assert _live_pairs(S, causal, window) == int(mask.sum())
    cost = module_cost(lambda: flash_attention(q, k, v, causal=causal, window=window))
    assert cost.custom_ops["flash_attention"] == {
        "calls": 1, "flops": 4.0 * hd * int(mask.sum()) * B * Hq,
        "bytes": 4.0 * (2 * B * Hq * S * hd + 2 * B * Hkv * S * hd)}
    assert cost.bytes == cost.custom_ops["flash_attention"]["bytes"]


def test_op_cost_takes_the_loss_and_ssm_kernels_own_cost():
    from repro_torch.kernels.fused_xent import fused_softmax_xent
    from repro_torch.kernels.selective_scan import selective_scan

    g = torch.Generator().manual_seed(0)
    T, d, V = 6, 8, 11
    x, w = torch.randn(T, d, generator=g), torch.randn(d, V, generator=g)
    labels = torch.randint(0, V, (T,), generator=g, dtype=torch.int32)
    xent = module_cost(fused_softmax_xent, x, w, labels).custom_ops["fused_xent"]
    assert xent == {"calls": 1, "flops": 2.0 * T * d * V,
                    "bytes": 4.0 * (T * d + d * V) + 4 * T + 4 * T}
    b, S, di, N = 2, 5, 3, 4
    args = (torch.randn(b, S, di, generator=g), torch.rand(b, S, di, generator=g),
            -torch.rand(di, N, generator=g), torch.randn(b, S, N, generator=g),
            torch.randn(b, S, N, generator=g), torch.randn(di, generator=g))
    scan = module_cost(selective_scan, *args).custom_ops["selective_scan"]
    assert scan == {"calls": 1, "flops": float(b * S * di * (6 * N + 3)),
                    "bytes": float(b * S * di * 12 + 2 * b * S * N * 4 + di * N * 4 + di * 4
                                   + b * di * N * 4)}
