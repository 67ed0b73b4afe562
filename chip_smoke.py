"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It uses the port (``src/repro_torch``)
only, never JAX, and exits non-zero on the first phase that fails:

1. build: compile the recurrent-scan CUDA kernel from the checkout's
   sources into ``build/kernels/``;
2. kernel parity: the kernel against its plain PyTorch versions on the
   card, forward at 1e-5 and the gradients da/db/dh0 at 1e-4, at the
   training path's shapes (T=128, H=64, B=64 and 256) and a ragged one,
   under four reset patterns;
3. kernel timing at the path's shapes (CUDA events, warm, median);
4. train: rec-IPPO with the linear core on matrix_game at PPOConfig's
   defaults, 256 envs for 256 iterations (2 PPO updates), then a greedy
   evaluation of 32 episodes; the kernel's launch count over that run must
   be what the update's structure predicts;
5. slice parity: one more PPO update from the trained state on the card
   and on the CPU (the plain path), with the same minibatch shuffle.

Lines before the last: the card's name and power limit, and one JSON
object listing the kernels.  The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12  # the same sheet: float32 outside the tensor cores
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
SLICE_TOL = 1e-4  # full update on the card vs the CPU: 16 Adam steps, other sum orders
PATH_SHAPES = [(128, 64, 64), (128, 256, 64)]  # (T, B, H): minibatch and bootstrap unrolls
RAGGED = (33, 5, 7)  # D = 35: not a multiple of 32 (a warp) or of the block
PATTERNS = ["none", "all", "mid_window", "random"]


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _inputs(T, B, H, pattern, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.sigmoid(torch.randn(T, B, H, generator=g))
    b = torch.randn(T, B, H, generator=g) * 0.1
    h0 = torch.randn(B, H, generator=g)
    reset = {
        "none": None,
        "all": torch.ones(T, B, dtype=torch.bool),
        "mid_window": (torch.arange(T) == T // 2)[:, None].expand(T, B).contiguous(),
        "random": torch.rand(T, B, generator=g) < 0.3,
    }[pattern]
    dev = torch.device("cuda")
    return a.to(dev), b.to(dev), h0.to(dev), None if reset is None else reset.to(dev)


def _err(x, y):
    return float((x - y).abs().max()) if x.numel() else 0.0


def _within(x, y, tol):
    return bool(((x - y).abs() <= tol + tol * y.abs()).all())


def kernel_parity(ops, ref):
    """Forward, adjoint and gradients of the op against the plain versions."""
    worst = {"forward": 0.0, "reverse": 0.0, "grad": 0.0}
    for T, B, H in PATH_SHAPES + [RAGGED]:
        for i, pattern in enumerate(PATTERNS):
            a, b, h0, reset = _inputs(T, B, H, pattern, seed=i)
            out = ops.linear_recurrent_scan(a, b, h0, reset)
            want = ref.linear_recurrence_ref(a, b, h0, reset)
            rev = ops._scan(a, b, reset, None, reverse=True)
            flat_r = None if reset is None else reset.reshape(T, B)
            rev_want = ref.scan_ref(
                a.reshape(T, -1), b.reshape(T, -1), flat_r, None, reverse=True
            ).reshape(T, B, H)
            g = torch.randn(T, B, H, generator=torch.Generator().manual_seed(9)).cuda()
            leaves = [x.clone().requires_grad_(True) for x in (a, b, h0)]
            grads = torch.autograd.grad(
                (ops.linear_recurrent_scan(*leaves, reset) * g).sum(), leaves
            )
            leaves_ref = [x.clone().requires_grad_(True) for x in (a, b, h0)]
            grads_ref = torch.autograd.grad(
                (ref.linear_recurrence_ref(*leaves_ref, reset) * g).sum(), leaves_ref
            )
            torch.cuda.synchronize()
            case = f"T={T} B={B} H={H} reset={pattern}"
            _require(_within(out, want, FWD_TOL), f"forward differs: {case}")
            _require(_within(rev, rev_want, FWD_TOL), f"reverse scan differs: {case}")
            for name, x, y in zip(("da", "db", "dh0"), grads, grads_ref):
                _require(_within(x, y, GRAD_TOL), f"{name} differs: {case}")
                worst["grad"] = max(worst["grad"], _err(x, y))
            worst["forward"] = max(worst["forward"], _err(out, want))
            worst["reverse"] = max(worst["reverse"], _err(rev, rev_want))
    return worst


def _time_ms(fn, reps=25, inner=10):
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls a rep."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_timing(ops, ref):
    """Kernel, plain-version and bound times at the path's shapes."""
    rows = []
    for T, B, H in PATH_SHAPES:
        a, b, h0, reset = _inputs(T, B, H, "random", seed=0)
        D = B * H
        flat = (a.reshape(T, D), b.reshape(T, D), reset, h0.reshape(D))
        # each input read once, the output written once: a, b, out (T, D)
        # float32, h0 (D,) float32, the reset mask (T, B) bytes
        nbytes = 3 * T * D * 4 + D * 4 + T * B
        flops = 2 * T * D  # one multiply-add per element and step
        for direction in ("forward", "reverse"):
            rev = direction == "reverse"
            h = None if rev else flat[3]
            ms = _time_ms(lambda: ops._launch(*flat[:3], h, rev))
            plain_ms = _time_ms(lambda: ref.scan_ref(*flat[:3], h, reverse=rev), reps=20, inner=1)
            bytes_moved = nbytes - (D * 4 if rev else 0)
            bounds = {
                "bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
                "operations": flops / F32_FLOPS_PER_S * 1e3,
            }
            bound_by = max(bounds, key=bounds.get)
            rows.append({
                "T": T, "B": B, "H": H, "direction": direction, "ms": ms,
                "plain_ms": plain_ms, "bytes": bytes_moved, "flops": flops,
                "bound_ms": bounds[bound_by], "bound_by": bound_by,
            })
    return rows


def train_and_evaluate(ops):
    """The port's main path: rec-IPPO (linear core) Anakin training + greedy eval."""
    from repro_torch.core import train_anakin
    from repro_torch.envs import MatrixGame
    from repro_torch.eval import evaluate
    from repro_torch.systems import PPOConfig, make_rec_ippo

    cfg = PPOConfig(recurrent_core="linear")
    system = make_rec_ippo(MatrixGame(), cfg)
    num_envs, num_iterations = 256, 256
    ops.linear_recurrent_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = train_anakin(system, 0, num_iterations, num_envs, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = evaluate(system, state.train, 0, num_episodes=32, num_envs=32, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = ops.linear_recurrent_scan.launches

    updates = num_iterations // cfg.rollout_len
    n_agents, n_mb = 2, cfg.num_minibatches
    # per update: one bootstrap critic unroll per agent, then per minibatch
    # an actor and a critic unroll per agent, forward and backward
    expected = updates * (n_agents + cfg.epochs * n_mb * n_agents * 2 * 2)
    _require(int(state.train.steps) == updates, f"train.steps = {int(state.train.steps)}")
    _require(metrics["loss"].shape == (updates,), f"losses {tuple(metrics['loss'].shape)}")
    for k, v in metrics.items():
        _require(bool(torch.isfinite(v).all()), f"non-finite training metric {k}")
    _require(launches == expected, f"recurrent_scan launched {launches}x, expected {expected}")
    _require(ev.episode_return.shape == (32,), "eval returns shape")
    _require(bool(torch.isfinite(ev.episode_return).all()), "non-finite eval return")
    _require(bool((ev.episode_length == MatrixGame().horizon).all()), "eval episode lengths")
    return system, state, {
        "train_s": train_s,
        "eval_s": eval_s,
        "env_steps_per_s": num_envs * num_iterations / train_s,
        "losses": [float(x) for x in metrics["loss"]],
        "eval_return_mean": float(ev.episode_return.mean()),
        "launches": launches,
        "launches_per_update": launches // updates,
    }


def slice_parity(system, state):
    """One PPO update from the trained state, on the card and on the CPU."""
    from repro_torch.convert import params_from_jax, params_to_jax
    from repro_torch.core.buffer import RolloutState
    from repro_torch.systems import onpolicy
    from repro_torch.tree import tree_leaves

    B = state.buffer.storage.discount.shape[1]
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(0))
    shuffle = onpolicy._env_permutation
    onpolicy._env_permutation = lambda n, g: perm.to(g.device)
    try:
        results = []
        for dev in ("cuda", "cpu"):
            train = params_from_jax(params_to_jax(state.train), dev)
            storage = params_from_jax(params_to_jax(state.buffer.storage), dev)
            gen = torch.Generator(dev)
            full = RolloutState(storage, storage.discount.shape[0])
            new, _, m = system.update(train, full, gen)
            results.append((new.params, float(m["loss"])))
    finally:
        onpolicy._env_permutation = shuffle
    (gpu, gpu_loss), (cpu, cpu_loss) = results
    diffs = [_err(g.cpu(), c) for g, c in zip(tree_leaves(gpu), tree_leaves(cpu))]
    worst = max(diffs)
    _require(worst <= SLICE_TOL, f"update on the card differs from the CPU by {worst}")
    _require(abs(gpu_loss - cpu_loss) <= SLICE_TOL * (1 + abs(cpu_loss)), "update loss differs")
    return worst, abs(gpu_loss - cpu_loss)


def main():
    """Run every phase; any failure raises and exits non-zero."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.recurrent_scan import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _gpu_line()
    tag = f"[{gpu}]"
    print(f"gpu: {gpu}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = build("recurrent_scan.cu")
    print(f"build: recurrent_scan.cu -> {os.path.relpath(lib)} in {time.perf_counter() - t0:.2f} s")

    worst = kernel_parity(ops, ref)
    print(
        f"kernel parity: max abs err forward {worst['forward']:.3e} (tol {FWD_TOL}), "
        f"reverse {worst['reverse']:.3e} (tol {FWD_TOL}), grads {worst['grad']:.3e} "
        f"(tol {GRAD_TOL}) over shapes {PATH_SHAPES + [RAGGED]} x resets {PATTERNS}"
    )

    rows = kernel_timing(ops, ref)
    for r in rows:
        print(
            f"kernel timing: recurrent_scan {r['direction']} T={r['T']} B={r['B']} H={r['H']}: "
            f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.1f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} ({r['bytes']} B, "
            f"{r['flops']} flop) {tag}"
        )

    system, state, run = train_and_evaluate(ops)
    print(
        f"train: rec_ippo linear matrix_game, 256 envs x 256 iterations in "
        f"{run['train_s']:.2f} s = {run['env_steps_per_s']:.0f} env steps/s; "
        f"losses {run['losses']}; recurrent_scan launches {run['launches']} "
        f"({run['launches_per_update']} per update) {tag}"
    )
    print(f"eval: 32 greedy episodes in {run['eval_s']:.2f} s, mean return "
          f"{run['eval_return_mean']:.3f} {tag}")

    param_err, loss_err = slice_parity(system, state)
    print(f"slice parity: one update on the card vs the CPU, max abs param diff "
          f"{param_err:.3e}, loss diff {loss_err:.3e} (tol {SLICE_TOL})")

    main_row = next(r for r in rows if (r["B"], r["direction"]) == (64, "forward"))
    print(json.dumps({"kernels": [{
        "name": "recurrent_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/recurrent_scan.cu",
        "replaces": "src/repro/kernels/recurrent_scan/kernel.py:72",
        "launches": run["launches"],
        "max_abs_err": max(worst.values()),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": "T=128 B=64 H=64 forward (the minibatch unroll)",
        "by_shape": rows,
        "gpu": gpu,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
