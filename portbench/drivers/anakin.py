"""Whole rollout-and-update cycles of a feed-forward PPO system through the Anakin runner.

Traffic parameters: ``lanes`` seed lanes of ``envs`` env copies each;
``cycles_per_call`` cycles a call; ``trace_seconds`` (the traced window's
length at most).  A cycle is ``rollout_len`` iterations (the
configuration's) ending in the update.  A call is one run of the program's
`core.system.make_anakin` program of ``cycles_per_call`` cycles, from the
benchmark's initial parameters (`System.init_train` hands them over) and
the call's own lane seeds; the train state, the Adam moments and the envs
carry from cycle to cycle within it, as in a user's run.  Set-up makes
one call, which warms every shape; the window makes whole calls.  An env
step is one env copy of one lane advanced once.

The first cycle of set-up's call is checked once the window has closed:
its stored rollout, its update's loss, and the parameters and Adam
moments it left, against `reference.ippo_spread` (the readings are named
there and in `compare`).  The benchmark copies them, and the lane
generators' states (from which the update's shuffles are replayed), as
that first `System.update` is entered and left.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from portbench import counts, peaks, trace
from portbench.drivers import common
from portbench.harness import Outcome
from portbench.reference import ippo_spread as ref


def cycle_seed(seed: int, cycle: int) -> int:
    """The first lane's seed of cycle ``cycle``; lane ``s`` takes it plus ``s``."""
    return (int(seed) * 1_000_003 + 8_191 * cycle) % 2**62


def make_system(cfg: dict, recorder: dict):
    """The program's system on the configuration's env, taking the benchmark's initial
    parameters; its first update, while ``recorder`` is armed, leaves there copies of the
    lane generators' states and the rollout it was given (``gen_states``, ``roll``) and of
    what it returned (`program_outputs`: ``outputs``)."""
    from repro_torch.envs.spread import Spread
    from repro_torch.systems.registry import make_system as program_system
    from repro_torch.tree import tree_map

    env = Spread(num_agents=cfg["num_agents"], horizon=cfg["horizon"], dt=cfg["dt"],
                 damping=cfg["damping"], accel=cfg["accel"],
                 collision_radius=cfg["collision_radius"])
    ppo = {k: cfg[k] for k in ("learning_rate", "gamma", "gae_lambda", "clip_eps", "value_coef",
                               "entropy_coef", "epochs", "num_minibatches", "max_grad_norm",
                               "rollout_len", "shared_weights")}
    system = program_system(cfg["system"], env, hidden_sizes=tuple(cfg["hidden_sizes"]), **ppo)
    init_train, update = system.init_train, system.update

    def bench_init(generator):
        params = ref.draw_lane(cfg, generator.initial_seed(), generator.device)
        return init_train(generator)._replace(params=params, target_params=params)

    def noted_update(train, buffer, generator):
        if not recorder.pop("armed", False):
            return update(train, buffer, generator)
        recorder["gen_states"] = [g.get_state() for g in generator]
        recorder["roll"] = tree_map(torch.clone, buffer.storage)
        train, buffer, metrics = update(train, buffer, generator)
        recorder["outputs"] = {k: {n: v.clone() for n, v in x.items()} if isinstance(x, dict)
                               else x.clone() for k, x in program_outputs(train, metrics).items()}
        return train, buffer, metrics

    return dataclasses.replace(system, init_train=bench_init, update=noted_update)


def reference_outputs(cfg: dict, params0: dict, roll, gen_states, device,
                      tf32: bool = False) -> dict:
    """The reference's cycle from ``params0`` over the stored rollout ``roll``: its
    rollout readings (`ref.check_rollout`), log-probs and values, the update's mean loss,
    parameters and second moments.  ``tf32`` computes it with TF32 products (the control)."""
    with common.exact_float32():
        readings, (logp, value) = ref.check_rollout(cfg, params0, roll, tf32)
        loss, params, nu = ref.update(cfg, params0, roll, logp, value, gen_states, device,
                                      tf32=tf32)
    return {"readings": readings, "logp": logp, "value": value, "loss": loss,
            "params": params, "nu": nu}


def program_outputs(train, metrics) -> dict:
    """What the program's update produced: its mean loss a lane, its parameters and Adam's
    second moments."""
    return {"loss": metrics["loss"], "params": ref.leaves(train.params),
            "nu": ref.leaves(train.opt_state[1].nu)}


def compare(got: dict, want: dict, params0: dict, lanes: int) -> dict:
    """``loss_gap`` (each lane's mean minibatch loss, relative), ``grad_gap`` (each leaf's
    root of Adam's second moment: the gradients' size over the update) and ``dparam_gap``
    (each leaf's change), the last two as `common.norm_gap` a lane over the leaves whose
    reference gradient is not nought, the worst lane."""
    p0 = ref.leaves(params0)
    out = {"loss_gap": float(((got["loss"] - want["loss"]) / want["loss"]).abs().max())}

    def per_lane(x):  # {leaf: (S, ...)} -> [{leaf: norm}] a lane
        norms = {k: v.flatten(1).norm(dim=1).tolist() for k, v in x.items()}
        return [{k: n[s] for k, n in norms.items()} for s in range(lanes)]

    g_got, g_want = (per_lane({k: v.sqrt() for k, v in x["nu"].items()}) for x in (got, want))
    d_got, d_want = (per_lane({k: x["params"][k] - p0[k] for k in p0}) for x in (got, want))
    out["grad_gap"] = out["dparam_gap"] = 0.0
    for s in range(lanes):
        vals = sorted(g_want[s].values())
        kept = [k for k in p0 if g_want[s][k] >= 1e-3 * vals[len(vals) // 2]]
        out["grad_gap"] = max(out["grad_gap"], common.norm_gap(g_got[s], g_want[s], kept))
        out["dparam_gap"] = max(out["dparam_gap"], common.norm_gap(d_got[s], d_want[s], kept))
    return out


def run(ctx) -> Outcome:
    from repro_torch.core.system import make_anakin

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    S, N, T, per_call = tr["lanes"], tr["envs"], cfg["rollout_len"], tr["cycles_per_call"]
    recorder = {"armed": True}
    program = make_anakin(make_system(cfg, recorder), T * per_call, N, num_seeds=S, device=dev)
    common.mark(ctx, "import")
    program(cycle_seed(ctx.seed, 0))
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    def window(seconds):
        return common.closed_loop(lambda n: program(cycle_seed(ctx.seed, 1 + n)), seconds, dev)

    if ctx.trace:
        (calls, elapsed), tr_out = trace.traced(lambda: window(min(ctx.seconds,
                                                                   tr["trace_seconds"])))
    else:
        (calls, elapsed), tr_out = window(ctx.seconds), None
    cycles = calls * per_call
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    common.free(dev)

    t_check = time.perf_counter()
    lane_seeds = [cycle_seed(ctx.seed, 0) + s for s in range(S)]
    params0 = ref.draw_params(cfg, lane_seeds, dev)
    want = reference_outputs(cfg, params0, recorder["roll"], recorder["gen_states"], dev)
    readings = dict(want["readings"], **compare(recorder["outputs"], want, params0, S))
    checks = {k: (v, ctx.limits[k]) for k, v in readings.items()}
    check_s = time.perf_counter() - t_check
    tf32 = torch.backends.cuda.matmul.allow_tf32
    flops = counts.ppo_cycle_flops(ref.obs_dim(cfg), cfg["hidden_sizes"], cfg["num_actions"],
                                   cfg["num_agents"], S, N, T, cfg["epochs"],
                                   cfg["num_minibatches"])
    window_info = {"seconds": elapsed, "cycles": cycles, "model_flops": flops * cycles,
                   "peak_flops": peaks.TF32_FLOPS_PER_S if tf32 else peaks.F32_FLOPS_PER_S}
    return Outcome(metrics={"env_steps_per_s": cycles * S * N * T / elapsed, "setup_s": setup_s},
                   checks=checks, attempted=cycles, failed=0, memory_peak_bytes=memory_peak,
                   window=window_info, trace=tr_out, check_s=check_s)


def control(ctx) -> dict:
    """The readings of the reference computed one precision lower in the program's place,
    over the first cycle of the program's rollout: TF32 products, and the env in bfloat16."""
    from repro_torch.core.system import make_anakin

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    S = tr["lanes"]
    recorder = {"armed": True}
    program = make_anakin(make_system(cfg, recorder), cfg["rollout_len"], tr["envs"],
                          num_seeds=S, device=dev)
    program(cycle_seed(ctx.seed, 0))
    params0 = ref.draw_params(cfg, [cycle_seed(ctx.seed, 0) + s for s in range(S)], dev)
    roll = recorder["roll"]
    want = reference_outputs(cfg, params0, roll, recorder["gen_states"], dev)
    got = reference_outputs(cfg, params0, roll, recorder["gen_states"], dev, tf32=True)
    out = compare(got, want, params0, S)
    out["policy_gap"] = max(float((got[k][a] - want[k][a]).abs().amax())
                            for k in ("logp", "value") for a in want[k])
    out["env_gap"] = ref.env_control(cfg, roll)
    return out
