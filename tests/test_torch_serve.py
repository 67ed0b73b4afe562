"""The port's decision-serving engine, traffic and policy checkpoints against the JAX package.

* admission and recycling order, queue overflow, bad configs and the
  carry zeroed on admission and at the episode boundary, as
  tests/test_serve.py pins them for the reference;
* greedy served actions equal the JAX `DecisionEngine`'s bitwise on
  matrix_game for ippo, rec_ippo (GRU) and rec_ippo (linear core), with
  converted params and the JAX resets injected (`convert.reset_from_jax`);
* served greedy returns equal the port evaluator's for the same resets,
  bitwise, at two pool sizes; sample mode differs from greedy;
* `poisson_requests`' arrival ticks and uids equal the reference's
  exactly, and `workload_stats` is equal on the same tick log;
* a policy directory round-trips (per-seed lanes too) and serves as the
  policy it was saved from; a directory the JAX package wrote loads in the
  port and serves the JAX engine's actions.

Everything is float32 on the CPU; every comparison is bitwise.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serve import DecisionEngine as JaxEngine  # noqa: E402
from repro.serve import ServeRequest as JaxRequest  # noqa: E402
from repro.serve import poisson_requests as jax_poisson  # noqa: E402
from repro.serve import save_policy as jax_save_policy  # noqa: E402
from repro.serve import workload_stats as jax_workload_stats  # noqa: E402
from repro.systems.registry import make_pair as jax_make_pair  # noqa: E402
from repro_torch.convert import params_from_jax, reset_from_jax  # noqa: E402
from repro_torch.core import train_anakin  # noqa: E402
from repro_torch.eval import evaluate  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    DecisionEngine,
    ServeRequest,
    load_policy,
    poisson_requests,
    read_policy_meta,
    save_policy,
    serve_workload,
    workload_stats,
)
from repro_torch.systems.registry import make_pair, smoke_overrides  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

HORIZON = 10  # matrix_game's episode length
CPU = "cpu"


def _tiny(name, **extra):
    """A registry (env, system) pair of the port at the smoke operating point."""
    return make_pair(name, "matrix_game", **smoke_overrides(name), **extra)


def _init(system, seed=0):
    return system.init_train(torch.Generator(CPU).manual_seed(seed))


def _engine(system, train, **kw):
    return DecisionEngine(system, train, warmup=False, device=CPU, **kw)


# ------------------------------------------------------------- admission


def test_admission_and_recycle_order_is_deterministic():
    _, system = _tiny("vdn")
    engine = _engine(system, _init(system), max_slots=2)
    for i in range(5):
        engine.submit(ServeRequest(uid=i, seed=100 + i))
    finished = engine.run_until_drained()
    # FIFO queue x lowest free slot first: 0, 1 start; 2, 3 recycle those
    # slots in order; 4 takes the first slot to free again
    assert [r.uid for r in finished] == [0, 1, 2, 3, 4]
    assert [r.slot for r in finished] == [0, 1, 0, 1, 0]
    assert all(r.done and r.length == HORIZON for r in finished)
    assert engine.idle() and engine.num_live == 0


def test_queue_overflow_waits_for_free_slots():
    _, system = _tiny("vdn")
    engine = _engine(system, _init(system), max_slots=1)
    for i in range(3):
        engine.submit(ServeRequest(uid=i, seed=i))
    engine.tick()
    assert engine.num_live == 1 and len(engine.queue) == 2
    assert [r.uid for r in engine.run_until_drained()] == [0, 1, 2]


def test_engine_rejects_bad_config():
    _, system = _tiny("vdn")
    train = _init(system)
    with pytest.raises(ValueError):
        _engine(system, train, max_slots=0)
    with pytest.raises(ValueError):
        _engine(system, train, mode="argmax")


def test_engine_needs_a_device_without_cuda():
    _, system = _tiny("vdn")
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecisionEngine(system, _init(system), warmup=False)


# ---------------------------------------------------------- carry hygiene


def _hidden_rows(engine):
    """Every hidden leaf stacked to (leaves, max_slots, H): rows by slot."""
    return torch.stack(tree_leaves(engine.carry.hidden))


def test_recurrent_carry_zeroed_on_admission_and_at_boundary():
    _, system = _tiny("rec_ippo")
    engine = _engine(system, _init(system), max_slots=2)
    engine.submit(ServeRequest(uid=0, seed=1))
    for _ in range(3):
        engine.tick()
    hidden = _hidden_rows(engine)
    # every pool row was stepped (free slots burn the step too)
    assert hidden[:, 0].abs().sum() > 0 and hidden[:, 1].abs().sum() > 0

    # admission zeroes exactly the admitted slot's memory (slot 1), leaving
    # the live episode's (slot 0) as it was
    engine.submit(ServeRequest(uid=1, seed=2))
    engine._admit()
    after = _hidden_rows(engine)
    assert torch.equal(after[:, 1], torch.zeros_like(after[:, 1]))
    assert torch.equal(after[:, 0], hidden[:, 0])

    # at the boundary (LAST) the retiring slot's carry is zeroed in the tick
    for _ in range(HORIZON - 3):
        engine.tick()
    assert engine.slots[0] is None
    boundary = _hidden_rows(engine)
    assert torch.equal(boundary[:, 0], torch.zeros_like(boundary[:, 0]))
    assert boundary[:, 1].abs().sum() > 0  # uid 1 still running


# ------------------------------------------------------- parity with JAX


def _jax_reset(system, key):
    """The JAX env's reset of one episode, as a batch of one."""
    return jax.vmap(system.env.reset)(key[None])


@pytest.mark.parametrize("name,extra", [
    ("ippo", {}),
    ("rec_ippo", {"recurrent_core": "gru"}),
    ("rec_ippo", {"recurrent_core": "linear"}),
], ids=["ippo", "rec_ippo-gru", "rec_ippo-linear"])
def test_served_greedy_actions_bitwise_match_jax_engine(name, extra):
    from repro.bench.throughput import smoke_overrides as jax_smoke

    _, jsys = jax_make_pair(name, "matrix_game", **jax_smoke(name), **extra)
    _, tsys = _tiny(name, **extra)
    jtrain = jsys.init_train(jax.random.key(3))
    keys = jax.random.split(jax.random.key(11), 5)

    jeng = JaxEngine(jsys, jtrain, max_slots=2, record_actions=True, warmup=False)
    teng = _engine(tsys, params_from_jax(jtrain), max_slots=2, record_actions=True)
    for i in range(5):
        jeng.submit(JaxRequest(uid=i, key=keys[i]))
        teng.submit(ServeRequest(uid=i, reset=reset_from_jax(_jax_reset(jsys, keys[i]))))
    jdone = sorted(jeng.run_until_drained(), key=lambda r: r.uid)
    tdone = sorted(teng.run_until_drained(), key=lambda r: r.uid)
    assert [r.slot for r in tdone] == [r.slot for r in jdone]
    for jr, tr in zip(jdone, tdone):
        assert len(tr.actions) == len(jr.actions) == HORIZON
        for jd, td in zip(jr.actions, tr.actions):
            for a in tsys.spec.agent_ids:
                assert int(td[a]) == int(jd[a])
        assert np.float32(tr.episode_return) == np.float32(jr.episode_return)
        for a in tsys.spec.agent_ids:
            assert np.float32(tr.agent_returns[a]) == np.float32(jr.agent_returns[a])


@pytest.mark.parametrize("name", ["ippo", "rec_ippo"])
def test_served_greedy_episodes_bitwise_match_evaluator(name):
    """Served returns == `repro_torch.eval.evaluate`'s for the same resets, bit for bit."""
    _, system = _tiny(name)
    train = _init(system, 3)
    B, seed = 4, 7
    ev = evaluate(system, train, seed, num_episodes=B, num_envs=B, device=CPU)
    # the evaluator's resets: one batched draw from the generator of `seed`
    state, ts = system.env.reset(B, torch.device(CPU), torch.Generator(CPU).manual_seed(seed))
    row = lambda tree, i: tree_map(lambda x: x[i:i + 1], tree)

    for max_slots in (B, 2):
        engine = _engine(system, train, max_slots=max_slots)
        for i in range(B):
            engine.submit(ServeRequest(uid=i, reset=(row(state, i), row(ts, i))))
        finished = sorted(engine.run_until_drained(), key=lambda r: r.uid)
        served = torch.tensor([r.episode_return for r in finished])
        assert torch.equal(served, ev.episode_return)
        for a in system.spec.agent_ids:
            assert torch.equal(torch.tensor([float(r.agent_returns[a]) for r in finished]),
                               ev.agent_returns[a])
        assert [r.length for r in finished] == ev.episode_length.tolist()


def test_sample_mode_actions_differ_from_greedy():
    _, system = _tiny("ippo")
    train = _init(system)
    streams = {}
    for mode in ("greedy", "sample"):
        engine = _engine(system, train, max_slots=2, mode=mode, record_actions=True)
        for i in range(4):
            engine.submit(ServeRequest(uid=i, seed=50 + i))
        finished = sorted(engine.run_until_drained(), key=lambda r: r.uid)
        streams[mode] = [[int(d[a]) for d in r.actions]
                         for r in finished for a in system.spec.agent_ids]
    assert streams["greedy"] != streams["sample"]


# ------------------------------------------------------- traffic + stats


@pytest.mark.parametrize("args", [(4, 3, 0.5, 9), (8, 4, 0.2, 0), (3, 2, 0.3, 1)])
def test_poisson_arrivals_equal_the_reference(args):
    *shape, seed = args
    ours = poisson_requests(*shape, seed=seed)
    ref = jax_poisson(*shape, seed=seed)
    assert [r.arrival_tick for r in ours] == [r.arrival_tick for r in ref]
    assert [r.uid for r in ours] == [r.uid for r in ref] == list(range(len(ref)))
    again = poisson_requests(*shape, seed=seed)
    assert [r.seed for r in ours] == [r.seed for r in again]
    assert len({r.seed for r in ours}) == len(ours)  # every episode its own reset seed


def test_poisson_requests_reject_bad_rate():
    with pytest.raises(ValueError):
        poisson_requests(2, 2, 0.0)


def test_workload_stats_equal_the_reference():
    rng = np.random.default_rng(0)
    log = [{"seconds": float(s), "live": int(n)}
           for s, n in zip(rng.uniform(1e-4, 5e-3, 40), rng.integers(1, 9, 40))]
    finished = [ServeRequest(uid=i, episode_return=float(r))
                for i, r in enumerate(rng.normal(size=7))]
    assert workload_stats(log, finished) == jax_workload_stats(log, finished)
    with pytest.raises(ValueError):
        workload_stats([], [])


def test_serve_workload_serves_every_request():
    _, system = _tiny("vdn")
    engine = _engine(system, _init(system), max_slots=2)
    requests = poisson_requests(3, 2, 0.3, seed=1)
    stats = serve_workload(engine, requests)
    assert stats["episodes"] == len(requests)
    assert stats["decisions"] == len(requests) * HORIZON
    assert stats["decisions_per_sec"] > 0
    assert stats["latency"]["p99_ms"] >= stats["latency"]["p50_ms"] > 0


# ----------------------------------------------------- policy round trip


def _equal_trees(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_policy_round_trip_serves_identically(tmp_path):
    _, system = _tiny("rec_ippo")
    st, _ = train_anakin(system, 0, 32, 4, device=CPU)
    d = str(tmp_path / "pol")
    save_policy(d, "rec_ippo", "matrix_game", st.train,
                config_overrides=smoke_overrides("rec_ippo"), step=32)
    meta = read_policy_meta(d)
    assert (meta["system"], meta["env"], meta["tree"]) == ("rec_ippo", "matrix_game",
                                                           "train_state")
    assert meta["provenance"]["framework"] == "torch"
    _, system2, train2 = load_policy(d, device=CPU)
    _equal_trees(st.train, train2)
    before = evaluate(system, st.train, 5, num_episodes=4, num_envs=4, device=CPU)
    after = evaluate(system2, train2, 5, num_episodes=4, num_envs=4, device=CPU)
    assert torch.equal(before.episode_return, after.episode_return)


def test_policy_per_seed_lanes(tmp_path):
    _, system = _tiny("ippo")
    st, _ = train_anakin(system, 0, 32, 4, num_seeds=2, device=CPU)
    d = str(tmp_path / "pol")
    save_policy(d, "ippo", "matrix_game", st.train, config_overrides=smoke_overrides("ippo"),
                num_seeds=2, step=32)
    for s in range(2):
        _, _, lane = load_policy(d, seed=s, device=CPU)
        _equal_trees(tree_map(lambda x, s=s: x[s], st.train.params), lane.params)
    with pytest.raises(ValueError):
        load_policy(d, seed=2, device=CPU)


def test_policy_meta_rejects_foreign_directories(tmp_path):
    d = tmp_path / "not_a_policy"
    d.mkdir()
    (d / "policy.json").write_text(json.dumps({"format": "something-else"}))
    with pytest.raises(ValueError):
        read_policy_meta(str(d))


def test_jax_written_policy_loads_and_serves_as_jax(tmp_path):
    """A directory the JAX package saved restores in the port and serves its actions."""
    from repro.bench.throughput import smoke_overrides as jax_smoke

    _, jsys = jax_make_pair("rec_ippo", "matrix_game", **jax_smoke("rec_ippo"))
    jtrain = jsys.init_train(jax.random.key(2))
    d = str(tmp_path / "jax_pol")
    jax_save_policy(d, "rec_ippo", "matrix_game", jtrain,
                    config_overrides=jax_smoke("rec_ippo"), step=32)
    _, tsys, train = load_policy(d, device=CPU)
    _equal_trees(params_from_jax(jtrain), train)

    keys = jax.random.split(jax.random.key(4), 3)
    jeng = JaxEngine(jsys, jtrain, max_slots=3, record_actions=True, warmup=False)
    teng = _engine(tsys, train, max_slots=3, record_actions=True)
    for i in range(3):
        jeng.submit(JaxRequest(uid=i, key=keys[i]))
        teng.submit(ServeRequest(uid=i, reset=reset_from_jax(_jax_reset(jsys, keys[i]))))
    for jr, tr in zip(jeng.run_until_drained(), teng.run_until_drained()):
        assert [{a: int(v) for a, v in d.items()} for d in tr.actions] == \
            [{a: int(v) for a, v in d.items()} for d in jr.actions]


def test_batched_admission_draws_each_requests_own_reset():
    """One batched reset of the tick's admissions = each request's reset of its own."""
    _, system = make_pair("ippo", "spread", **smoke_overrides("ippo"))
    engine = _engine(system, _init(system), max_slots=5)
    seeds = [11, 12, 13, 14]
    given = system.env.reset(1, torch.device(CPU), torch.Generator(CPU).manual_seed(99))
    for i, s in enumerate(seeds):
        engine.submit(ServeRequest(uid=i, seed=s))
    engine.submit(ServeRequest(uid=4, reset=given))  # joined in its place
    engine._admit()
    alone = [system.env.reset(1, torch.device(CPU), torch.Generator(CPU).manual_seed(s))
             for s in seeds] + [given]
    for slot, (state, ts) in enumerate(alone):
        for pooled, one in zip(tree_leaves((engine._env_state, engine._ts)),
                               tree_leaves((state, ts))):
            if isinstance(one, torch.Tensor):
                assert torch.equal(pooled[slot:slot + 1], one)
