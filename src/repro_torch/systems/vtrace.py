"""V-trace off-policy corrected returns (port of `repro.systems.vtrace`; IMPALA, Espeholt et al. 2018).

The async actor/learner runner (`repro_torch.distributed.impala`) lets
actors collect trajectories under a stale parameter snapshot, so the PPO
family's GAE, which assumes the behaviour policy is the current one, is
biased once ``param_sync_every > 1``.  V-trace repairs this with
truncated importance sampling: the ratios ``rho_t = min(clip_rho,
pi(a_t|x_t) / mu(a_t|x_t))`` correct each TD error toward the current
policy's value, and the traces ``c_t = lam * min(clip_c, pi / mu)`` decay
how far a correction reaches back:

    vs_t - V(x_t) = delta_t + d_t * c_t * (vs_{t+1} - V(x_{t+1}))
    delta_t       = rho_t * (r_t + d_t * V(x_{t+1}) - V(x_t))

with ``d_t = gamma * discount_t``.  The value targets are ``vs_t``, the
policy-gradient advantages ``rho_t * (r_t + d_t * vs_{t+1} - V(x_t))``.
On-policy (``rho = c = 1``) at ``lam = 1`` both are GAE's advantages and
returns.  The reverse recursion is a Python loop over T, as the port's
GAE is; it has the recurrent-scan kernel's form (``a = d * c``, ``b =
delta``, reversed), which a later change may route it through.
"""
from __future__ import annotations

import torch


def vtrace_advantages(curr_logp, behaviour_logp, values, last_value, rewards, discounts,
                      clip_rho: float = 1.0, clip_c: float = 1.0, lam: float = 1.0):
    """V-trace policy-gradient advantages and value targets for one agent.

    Per-step inputs are time-major ``(T, B)`` tensors (``(T, S, B)`` with
    seed lanes): the taken action's log-probability under the current and
    the behaviour policy, the current critic's values, the rewards and the
    discounted continuation ``gamma * discount_t`` (zero at terminal rows);
    ``last_value`` is the ``(B,)`` bootstrap V(x_T).  Returns
    ``(pg_advantages, vs)``, in the places GAE's ``(adv, ret)`` take.
    """
    ratio = torch.exp(curr_logp - behaviour_logp)
    rho = torch.clamp(ratio, max=clip_rho)
    c = lam * torch.clamp(ratio, max=clip_c)
    v_next = torch.cat([values[1:], last_value[None]])
    delta = rho * (rewards + discounts * v_next - values)
    errors = torch.empty_like(values)
    err = torch.zeros_like(last_value)
    for t in reversed(range(values.shape[0])):
        err = delta[t] + discounts[t] * c[t] * err
        errors[t] = err
    vs = values + errors
    vs_next = torch.cat([vs[1:], last_value[None]])
    return rho * (rewards + discounts * vs_next - values), vs
