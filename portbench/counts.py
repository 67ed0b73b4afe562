"""The benchmark's own counts of work: model flops and each kernel's least time.

Everything here is worked out from shapes and the configuration alone, so
that a change to the program cannot move the yardstick.  A kernel's bound
is the larger of its bytes over HBM bandwidth and its operations at the
unit's rate (`peaks`); each input byte is read once and each output byte
written once.
"""
from __future__ import annotations

from portbench import peaks
from portbench.reference.mamba1_lm import dims as mamba1_dims


def mamba1_layer_params(cfg: dict) -> int:
    """Parameters of one Mamba1 layer that multiply an activation (biases and norms left out)."""
    m = mamba1_dims(cfg)
    d, di, n, k, r = m["d"], m["di"], m["N"], m["K"], m["r"]
    return d * 2 * di + di * k + di * (r + 2 * n) + r * di + di * n + di + di * d


def mamba1_train_flops_per_position(cfg: dict) -> float:
    """6 N a trained position: every layer and the output head, no recomputation
    (the input embedding is a lookup and does no multiply)."""
    m = mamba1_dims(cfg)
    return 6.0 * (m["L"] * mamba1_layer_params(cfg) + m["d"] * m["V"])


def mamba1_prefill_flops(cfg: dict, batch: int, positions: int) -> float:
    """2 N a prefilled position through the layers, and the head at each prompt's last one."""
    m = mamba1_dims(cfg)
    return (2.0 * m["L"] * mamba1_layer_params(cfg) * batch * positions
            + 2.0 * m["d"] * m["V"] * batch)


def _bound_s(nbytes: float, operations_s: float) -> float:
    return max(nbytes / peaks.HBM_BYTES_PER_S, operations_s)


def selective_scan_bound_s(b: int, S: int, di: int, N: int) -> float:
    """The forward scan's least time: x, y bf16 and delta float32 a (b, t, d); B, C bf16 a
    (b, t, n); A float32 (d, n), D (d,), h_final float32 (b, d, n); one exp(delta A) a
    (b, t, d, n) on the special-function units, 6 N + 3 float32 operations a (b, t, d)."""
    nbytes = b * S * di * (2 + 4 + 2) + 2 * b * S * N * 2 + di * N * 4 + di * 4 + b * di * N * 4
    exps = b * S * di * N
    flops = b * S * di * (6 * N + 3)
    return _bound_s(nbytes, max(exps / peaks.SFU_EXP_PER_S, flops / peaks.F32_FLOPS_PER_S))


def selective_scan_bwd_bound_s(b: int, S: int, di: int, N: int) -> float:
    """The backward scan's least time: x, dy, dx bf16 and delta, ddelta float32 a (b, t, d);
    B, C, dB, dC bf16 a (b, t, n); A, dA float32 (d, n); dh_final float32 (b, d, n); D, dD;
    two exponentials a (b, t, d, n) (the states rebuilt forward, the adjoint carried back)
    and 12 N + 6 float32 operations a (b, t, d)."""
    nbytes = (b * S * di * (3 * 2 + 8) + 4 * b * S * N * 2 + 2 * di * N * 4 + b * di * N * 4
              + 2 * di * 4)
    exps = 2 * b * S * di * N
    flops = b * S * di * (12 * N + 6)
    return _bound_s(nbytes, max(exps / peaks.SFU_EXP_PER_S, flops / peaks.F32_FLOPS_PER_S))


def fused_xent_bound_s(T: int, d: int, V: int) -> float:
    """The fused loss's least time: 2 T d V bf16 operations; x (T, d) and W (d, V) bf16 read,
    the labels and the (T,) float32 losses."""
    nbytes = T * d * 2 + d * V * 2 + T * 4 + T * 4
    return _bound_s(nbytes, 2.0 * T * d * V / peaks.BF16_FLOPS_PER_S)


def mlp_weights(sizes) -> int:
    """Weights of a dense stack ``sizes = (in, hidden..., out)`` (biases left out)."""
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def ppo_cycle_flops(obs_dim: int, hidden, num_actions: int, agents: int, lanes: int,
                    envs: int, rollout: int, epochs: int, minibatches: int) -> float:
    """Actor and critic multiply flops of one feed-forward PPO cycle (IPPO: each agent's
    critic reads its own observation).

    Acting: both networks forward for every agent of every env at each of the
    ``rollout`` iterations, 2 P a row; the last values: the critic once more.
    The update: ``epochs`` passes over the minibatched rows, forward and backward,
    6 P a row.
    """
    p_actor = mlp_weights((obs_dim, *hidden, num_actions))
    p_critic = mlp_weights((obs_dim, *hidden, 1))
    rows = lanes * envs * agents
    act = rollout * rows * 2 * (p_actor + p_critic) + rows * 2 * p_critic
    used = (rollout * envs // minibatches) * minibatches * lanes * agents
    return float(act + epochs * used * 6 * (p_actor + p_critic))
