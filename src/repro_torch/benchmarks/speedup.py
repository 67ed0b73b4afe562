"""The 10-100x speedup claim on the port: env-steps/sec across execution modes.

Counterpart of the root's ``benchmarks/speedup.py``, under its row names.
Rungs of the same MADQN system on the same environment:
  acme-style   — the paper's Block-1 python loop (one env step + one update
                 per python iteration, python-paced)
  anakin-jit   — the Anakin runner (`train_anakin`), 1 env
  anakin-vmap  — the Anakin runner over N env copies in one batch
  seed-vmap    — N independent seeds as lanes of one batch vs N serial
                 runs of the per-seed program (`repro_torch.bench`)

Reported: environment steps per second and speedup over the python loop.
Every rung is warm (untimed calls pay the first-use costs: the CUDA
context, cuBLAS handles, the allocator's growth, and one call past
``min_replay`` those of the first update) and runs from a synchronised
device to its last op; the reference times its loop rungs cold, with
their jit compilation inside (docs/PORT_BENCH.md).
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.bench.throughput import measure_seed_vectorization, timed
from repro_torch.core.system import run_environment_loop, train_anakin
from repro_torch.envs import Spread
from repro_torch.eval import make_evaluator
from repro_torch.systems.madqn import make_madqn
from repro_torch.systems.offpolicy import OffPolicyConfig

CFG = OffPolicyConfig(
    buffer_capacity=10_000, min_replay=200, batch_size=32, eps_decay_steps=5_000
)


def bench(fast: bool = False, device=None):
    """The speedup rows: ``(name, us_per_step, derived)``."""
    device = resolve_device(device)
    env = Spread(num_agents=3, horizon=25)
    system = make_madqn(env, CFG)
    seed = 0
    rows = []

    # --- faithful python loop (paper Block 1)
    n_eps = 3 if fast else 10
    run_environment_loop(system, seed, num_episodes=1, device=device)  # warm
    _, dt = timed(device, lambda: run_environment_loop(system, seed, num_episodes=n_eps,
                                                        device=device))
    steps_loop = n_eps * env.horizon
    sps_loop = steps_loop / dt
    rows.append(("speedup/acme_python_loop", dt / steps_loop * 1e6, f"{sps_loop:.0f} steps/s"))

    # --- anakin, 1 env
    iters = 300 if fast else 2_000
    train_anakin(system, seed, 10, 1, device=device)  # warm
    # the warm calls stop short of min_replay: one more, with enough envs to
    # pass it, pays the first update's costs outside every timed call
    warm_envs = 64
    train_anakin(system, seed, -(-CFG.min_replay // warm_envs) + 1, warm_envs, device=device)
    _, dt = timed(device, lambda: train_anakin(system, seed, iters, 1, device=device))
    sps_1 = iters / dt
    rows.append(
        ("speedup/anakin_jit_1env", dt / iters * 1e6,
         f"{sps_1:.0f} steps/s = {sps_1 / sps_loop:.1f}x python loop")
    )

    # --- anakin, env copies in one batch
    for n_envs in (16, 64):
        train_anakin(system, seed, 5, n_envs, device=device)
        (st, _), dt = timed(device, lambda: train_anakin(system, seed, iters, n_envs,
                                                          device=device))
        sps = iters * n_envs / dt
        rows.append(
            (f"speedup/anakin_vmap_{n_envs}env", dt / iters * 1e6,
             f"{sps:.0f} steps/s = {sps / sps_loop:.1f}x python loop")
        )

    # --- the batched greedy evaluator (repro_torch.eval): the same story for
    # eval.  Baseline is an eval-mode python loop (training=False: no dataset
    # writes, no updates) so the ratio is eval-vs-eval, not eval-vs-training.
    train = st.train
    _, dt = timed(device, lambda: run_environment_loop(
        system, seed, num_episodes=n_eps, training=False, train_state=train, device=device))
    sps_eval_loop = n_eps * env.horizon / dt
    rows.append(
        ("speedup/python_eval_loop", 1e6 / sps_eval_loop,
         f"{sps_eval_loop:.0f} steps/s")
    )

    n_eval_envs = 16 if fast else 64
    n_episodes = n_eval_envs * (2 if fast else 4)
    eval_fn = make_evaluator(system, n_episodes, n_eval_envs)
    eval_fn(train, seed)  # warm
    _, dt = timed(device, lambda: eval_fn(train, seed))
    eval_steps = n_episodes * env.horizon
    sps_eval = eval_steps / dt
    rows.append(
        (f"speedup/fused_eval_{n_eval_envs}env", dt / eval_steps * 1e6,
         f"{sps_eval:.0f} steps/s = {sps_eval / sps_eval_loop:.1f}x python eval loop")
    )

    # --- seeds as lanes (repro_torch.bench): N runs in one batch
    n_seeds = 4 if fast else 8
    sv_iters = 64 if fast else 512
    sv = measure_seed_vectorization(system, n_seeds, sv_iters, 16, device=device)
    rows.append(
        (f"speedup/seed_vmap_{n_seeds}seeds",
         1e6 / sv["vmapped_steps_per_sec"],
         f"{sv['vmapped_steps_per_sec']:.0f} steps/s = "
         f"{sv['speedup']:.1f}x serial per-seed training")
    )
    return rows
