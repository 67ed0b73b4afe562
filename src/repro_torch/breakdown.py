"""Where the time of a MARL training path goes on a CUDA GPU.

    PYTHONPATH=src python -m repro_torch.breakdown [--num-envs 256] \\
        [--system rec_ippo] [--env matrix_game] [--num-seeds 0] [--device cuda] \\
        [--runner anakin|async] [--num-actors 1] [--param-sync-every 1]

Builds ``--system`` on ``--env`` from the registries at its config's
defaults (rec-IPPO with the linear core on matrix_game unless told
otherwise; a ``rec_`` system gets the linear core unless ``--set``
says otherwise), with ``--num-seeds`` seed lanes if asked; each ``--set
FIELD=VALUE`` changes one field of the system's config (``--set
use_comm=False --set recurrent_core=linear`` is DIAL's fused re-run).

A rollout system (the PPO family, DIAL and RIAL) runs one rollout and
update to warm up (kernel build, cuBLAS handles, the caching allocator),
then times one more rollout (the acting iterations) and its update with
the host clock around synchronised work.  A replay system (the
off-policy family, and rec-MADQN over its sequence table) updates after
every iteration once its table is ready:
it fills the table, warms up for `REPLAY_ITERATIONS` iterations, then
times that many iterations whole, and that many acting steps and that
many updates apart.  Then the acting phase and the update phase run again
under `torch.profiler`, which gives the device's busy time per phase (the
sum of its kernels' times), its idle share, the kernel launches per phase
and the kernels that take the most device time.  For the recurrent-scan
kernel it sets the profiler's count beside the wrapper's own launch
counter and beside the trace's kernel events grouped by grid size (one
grid per unroll width).  Last, one acting iteration and one update run
under a dispatch counter: the tensor-making aten ops each dispatches
(views left out).  It exists to count a path's device ops without the
card, where a prediction of the card's numbers starts: ``--device cpu``
runs all of it on the CPU, where only these counts and the host times
mean anything (on the card the profiler's kernels per phase are
1.04-1.12 times the count).  Prints one JSON object.

``--runner async`` breaks down the async actor/learner runner
(`repro_torch.distributed.impala`) instead, with ``--num-actors`` and
``--param-sync-every``: a tick (the system's unroll of every actor, then
the learner's consumption) splits into the actors (sync and unrolls), the
queue (pushes and pops) and the learner (observe and the gated updates).
One tick warms up, `ASYNC_TICKS` are timed phase by phase with the host
clock around synchronised work, one more runs each phase under the
profiler (device busy time, idle share, launches), and one more under the
dispatch counter.
"""
from __future__ import annotations

import argparse
import ast
import collections
import json
import os
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import resolve_device
from repro_torch.core.buffer import BufferState, SeqBufferState
from repro_torch.core.system import (
    _one_iteration,
    _step_phase,
    _training_env,
    init_system_state,
    seed_generators,
)
from repro_torch.distributed.impala import default_unroll_len, make_async
from repro_torch.envs import REGISTRY as ENVS
from repro_torch.kernels.recurrent_scan import linear_recurrent_scan
from repro_torch.systems.registry import REGISTRY as SYSTEMS
from repro_torch.systems.registry import make_pair

SCAN_KERNEL = "linear_scan_kernel"
REPLAY_ITERATIONS = 64  # a replay system's iterations warmed up, then timed, then profiled
ASYNC_TICKS = 4  # the async runner's ticks timed after one of warm-up

def _rollout(system, tenv, st, steps):
    with torch.no_grad():
        for _ in range(steps):
            st, _ = _step_phase(system, tenv, st)
    return st


def _update(system, st, count=1):
    for _ in range(count):
        train, buffer, _ = system.update(st.train, st.buffer, st.key)
        st = st._replace(train=train, buffer=buffer)
    return st


def _iterations(system, tenv, st, count):
    """``count`` whole iterations: act, write the table, update once it is ready."""
    for _ in range(count):
        st, _, _ = _one_iteration(system, tenv, st)
    return st


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed(fn, *args):
    _sync()
    t0 = time.perf_counter()
    out = fn(*args)
    _sync()
    return out, time.perf_counter() - t0


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched that make a tensor (views left out)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        made = out if isinstance(out, (tuple, list)) else (out,)
        if not func.is_view and any(isinstance(x, torch.Tensor) for x in made):
            self.count += 1
        return out


def _dispatched_ops(fn, *args):
    """``fn(*args)`` under `_OpCounter`: its output and the ops it dispatched."""
    with _OpCounter() as counter:
        out = fn(*args)
    return out, counter.count


def _trace_kernels(prof):
    """Kernel events in the exported trace: all, and the recurrent scan's by grid."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    grids = collections.Counter(
        str(e.get("args", {}).get("grid")) for e in kernels
        if SCAN_KERNEL in e.get("name", "")
    )
    return len(kernels), dict(grids)


def _profiled(fn, *args):
    """``fn(*args)`` under the profiler; its output and device summary."""
    before = linear_recurrent_scan.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall = _timed(fn, *args)
    summary = _device_summary(prof, wall, SCAN_KERNEL)
    summary["trace_kernel_events"], by_grid = _trace_kernels(prof)
    summary[SCAN_KERNEL].update(
        counter=linear_recurrent_scan.launches - before, trace_by_grid=by_grid
    )
    return out, summary


def _device_summary(prof, wall_s, *names):
    """Busy time, launches and top kernels of the device events in ``prof``.

    Under each key of ``names``: the launches and device time of the
    kernels whose name contains it.
    """
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    summary = {
        "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / wall_s if busy_us else None,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [
            {"name": e.key[:80], "count": e.count, "device_ms": e.self_device_time_total / 1e3}
            for e in top
        ],
    }
    for name in names:
        named = [e for e in kernels if name in e.key]
        summary[name] = {
            "profiler": sum(e.count for e in named),
            "device_ms": sum(e.self_device_time_total for e in named) / 1e3,
        }
    return summary


def _rollout_breakdown(system, tenv, st, steps, env_steps):
    """A rollout system: warm-up rollout and update, a timed one, a profiled one."""
    st, warm_act_s = _timed(_rollout, system, tenv, st, steps)
    st, warm_update_s = _timed(_update, system, st)
    st, act_s = _timed(_rollout, system, tenv, st, steps)
    st, update_s = _timed(_update, system, st)
    phases = {}
    st, phases["act"] = _profiled(_rollout, system, tenv, st, steps)
    st, phases["update"] = _profiled(_update, system, st)
    return {
        "rollout_len": steps,
        "warmup": {"act_s": warm_act_s, "update_s": warm_update_s},
        "steady": {
            "act_s": act_s,
            "act_ms_per_iteration": act_s / steps * 1e3,
            "update_s": update_s,
            "env_steps_per_s": env_steps * steps / (act_s + update_s),
        },
        "profiled": phases,
        "state": st,
    }


def _replay_breakdown(system, tenv, st, count, env_steps):
    """A replay system: fill, warm up, time whole iterations and each phase, profile each phase."""
    fill_iterations = 0
    while not system.can_sample(st.buffer):
        st, _, _ = _one_iteration(system, tenv, st)
        fill_iterations += 1
    st, warm_s = _timed(_iterations, system, tenv, st, count)
    st, iterations_s = _timed(_iterations, system, tenv, st, count)
    st, act_s = _timed(_rollout, system, tenv, st, count)
    st, update_s = _timed(_update, system, st, count)
    phases = {}
    st, phases["act"] = _profiled(_rollout, system, tenv, st, count)
    st, phases["update"] = _profiled(_update, system, st, count)
    for p in phases.values():
        p["kernel_launches_per_step"] = p["kernel_launches"] / count
        p["device_busy_ms_per_step"] = p["device_busy_s"] / count * 1e3
        p["wall_ms_per_step"] = p["wall_s"] / count * 1e3
    return {
        "iterations": count,
        "fill_iterations": fill_iterations,
        "warmup": {"iterations_s": warm_s},
        "steady": {
            "iterations_s": iterations_s,
            "iteration_ms": iterations_s / count * 1e3,
            "act_ms_per_step": act_s / count * 1e3,
            "update_ms_per_update": update_s / count * 1e3,
            "env_steps_per_s": env_steps * count / iterations_s,
        },
        "profiled": phases,
        "state": st,
    }


def _async_phases(program):
    """A tick of ``program`` as its three phases: actors, queue, learner."""

    def actors(st):
        return program.act(program.sync(st))

    def queue(st, chunks):
        return program.pop(program.push(st, chunks))

    def learner(st, items):
        st, staleness = program.learn(st, items)
        return st._replace(tick=st.tick + 1), staleness

    return actors, queue, learner


def _async_tick(phases, st, run):
    """One tick, each phase through ``run(fn, *args) -> (out, reading)``: ``(state, readings)``."""
    actors, queue, learner = phases
    (st, chunks, _), r_act = run(actors, st)
    (st, items), r_queue = run(queue, st, chunks)
    (st, _), r_learn = run(learner, st, items)
    return st, {"actors": r_act, "queue": r_queue, "learner": r_learn}


def _async_breakdown(program, st, ticks, env_steps):
    """The async runner: a warm-up tick, ``ticks`` timed by phase, one profiled, one counted."""
    phases = _async_phases(program)
    (st, _), warm_s = _timed(program.tick, st)
    timed = {"actors": 0.0, "queue": 0.0, "learner": 0.0}
    for _ in range(ticks):
        st, t = _async_tick(phases, st, _timed)
        for k in timed:
            timed[k] += t[k]
    tick_s = sum(timed.values()) / ticks
    st, profiled = _async_tick(phases, st, _profiled)
    st, ops = _async_tick(phases, st, _dispatched_ops)
    return {
        "unroll_len": program.unroll_len,
        "ticks": ticks,
        "warmup": {"tick_s": warm_s},
        "steady": {
            **{f"{k}_s_per_tick": v / ticks for k, v in timed.items()},
            "tick_s": tick_s,
            "env_steps_per_s": env_steps * program.unroll_len / tick_s,
            "learner_updates": st.updates,
            "dropped": st.dropped,
        },
        "profiled": profiled,
        "dispatched_ops": {f"{k}_tick": v for k, v in ops.items()},
        "state": st,
    }


def main(argv=None):
    """Run the breakdown and print it as JSON."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--system", choices=sorted(SYSTEMS), default="rec_ippo")
    parser.add_argument("--env", choices=sorted(ENVS), default="matrix_game")
    parser.add_argument("--num-seeds", type=int, default=0, help="seed lanes (0: one run)")
    parser.add_argument("--device", default=None, help="default: CUDA, raising without it")
    parser.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE",
                        help="a config field of the system, e.g. recurrent_core=gru or "
                             "use_comm=False (repeatable)")
    parser.add_argument("--runner", choices=("anakin", "async"), default="anakin")
    parser.add_argument("--num-actors", type=int, default=1, help="async: actor replicas")
    parser.add_argument("--param-sync-every", type=int, default=1,
                        help="async: ticks between snapshot refreshes")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    overrides = {"recurrent_core": "linear"} if args.system.startswith("rec_") else {}
    for item in args.set:
        field, _, value = item.partition("=")
        try:
            overrides[field] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[field] = value  # a bare word: a string such as gru
    _, system = make_pair(args.system, args.env, **overrides)
    if args.runner == "async":
        if args.num_seeds:
            raise ValueError("--num-seeds is an anakin option")
        unroll = default_unroll_len(system)
        program = make_async(system, unroll, args.num_envs, args.num_actors,
                             param_sync_every=args.param_sync_every, device=device)
        st, init_s = _timed(program.init_state, 0)
        out = _async_breakdown(program, st, ASYNC_TICKS,
                               args.num_envs * args.num_actors)
        out.pop("state")
        phases = out["profiled"]
        head = {"runner": "async", "num_actors": args.num_actors,
                "param_sync_every": args.param_sync_every}
        _print_result(args, device, init_s, head, out, phases)
        return
    tenv = _training_env(system.env)
    lanes = args.num_seeds or None
    generator = (torch.Generator(device).manual_seed(0) if lanes is None
                 else seed_generators(0, lanes, device))
    st, init_s = _timed(init_system_state, system, generator, args.num_envs, tenv)
    env_steps = args.num_envs * (lanes or 1)
    if isinstance(st.buffer, (BufferState, SeqBufferState)):
        out = _replay_breakdown(system, tenv, st, REPLAY_ITERATIONS, env_steps)
    else:  # DIAL's rollout_len None is the env's horizon
        steps = (SYSTEMS[args.system].config_cls(**overrides).rollout_len
                 or int(system.env.horizon))
        out = _rollout_breakdown(system, tenv, st, steps, env_steps)
    phases = out["profiled"]
    st = out.pop("state")
    st, act_ops = _dispatched_ops(_rollout, system, tenv, st, 1)
    st, update_ops = _dispatched_ops(_update, system, st)
    out["dispatched_ops"] = {"act_iteration": act_ops, "update": update_ops}
    _print_result(args, device, init_s, {"runner": "anakin"}, out, phases)


def _print_result(args, device, init_s, head, out, phases):
    """Print the breakdown as one JSON object, with the card's name and power limit."""
    gpu = "not measured (no CUDA device)"
    if device.type == "cuda":
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "gpu": gpu,
        "torch": torch.__version__,
        "system": args.system,
        "env": args.env,
        "num_seeds": args.num_seeds,
        "num_envs": args.num_envs,
        **head,
        "init_s": init_s,
        **out,
        # every phase together, as training runs them
        "device_idle_share": 1 - sum(p["device_busy_s"] for p in phases.values())
        / sum(p["wall_s"] for p in phases.values()) if device.type == "cuda" else None,
    }, indent=1))


if __name__ == "__main__":
    main()
