"""IPPO on MPE simple-spread in plain PyTorch: the reference for the ippo-spread cells.

One cycle of the feed-forward IPPO the port runs (PPO with a decentralised
critic on each agent's own observation, weights shared by the agents,
seed lanes side by side): ``rollout_len`` steps of every env under the
initial policy with auto-reset, then GAE and ``epochs`` passes of
``num_minibatches`` shuffled row minibatches, each one global-norm clip and
one Adam step a lane.

The rollout the program stored is judged row by row: each observation
against the state it came from, each transition, reward, discount and step
type against the env's law, each reset state against the reset's law, each
stored log-prob and value against the networks, and the sampled actions'
counts against the policy's probabilities.  The env's reset draws and the
policy's action draws are the program's; the reference reads them as it
reads a served token, and the update's minibatch shuffles are replayed from
the lane generators' states as the update began.  Then the reference runs
the update itself, in float32 with TF32 off, from its own values and
log-probs, and is compared with the program's parameters and moments after
it.  The initial parameters are inputs the benchmark makes (`draw_params`).
"""
from __future__ import annotations

import math

import torch

DIRS = ((0.0, 0.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))
NETS = ("actor", "critic")


def net_sizes(cfg: dict) -> dict:
    """Layer sizes of the actor and the critic."""
    obs = obs_dim(cfg)
    return {"actor": (obs, *cfg["hidden_sizes"], cfg["num_actions"]),
            "critic": (obs, *cfg["hidden_sizes"], 1)}


def obs_dim(cfg: dict) -> int:
    a = cfg["num_agents"]
    return 4 + 2 * a + 2 * (a - 1)


def draw_lane(cfg: dict, seed: int, device) -> dict:
    """One lane's initial parameters, in the program's layout, from its seed alone:
    weights normal with variance one over the fan-in, biases zero."""
    g = torch.Generator(device).manual_seed((int(seed) * 2_654_435_761 + 97) % 2**63)
    lane = {}
    for net in NETS:
        sizes = net_sizes(cfg)[net]
        lane[net] = {"shared": {
            f"dense_{i}": {"w": torch.randn(a, b, generator=g, device=device) / math.sqrt(a),
                           "b": torch.zeros(b, device=device)}
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}}
    return lane


def draw_params(cfg: dict, lane_seeds, device) -> dict:
    """Every lane's initial parameters, stacked along a leading lane axis."""
    return _stack([draw_lane(cfg, s, device) for s in lane_seeds])


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def leaves(params: dict) -> dict:
    """``{"actor.dense_0.w": (S, ...), ...}`` of a parameter tree."""
    return {f"{net}.{layer}.{k}": v for net in NETS
            for layer, group in params[net]["shared"].items() for k, v in group.items()}


def _tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Bmm(torch.autograd.Function):
    """``a @ b`` with every operand rounded to TF32, forward and backward: the control."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = _tf32(a), _tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def mlp(net: dict, x, tf32: bool = False):
    """A lane-batched ReLU stack: x (S, R, in) -> (S, R, out); ``tf32`` rounds the products'
    operands to TF32."""
    layers = [net[f"dense_{i}"] for i in range(len(net))]
    for i, layer in enumerate(layers):
        if tf32:
            x = _Tf32Bmm.apply(x, layer["w"]) + layer["b"][:, None]
        else:
            x = torch.baddbmm(layer["b"][:, None], x, layer["w"])
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


# ------------------------------------------------------------------------ env


def observe(pos, vel, lm):
    """Each agent's observation (..., A, obs): own position and velocity, the landmarks and
    the other agents relative to it."""
    A = pos.shape[-2]
    out = []
    for i in range(A):
        own = pos[..., i, :]
        rel_lm = (lm - own[..., None, :]).flatten(-2)
        others = torch.cat([pos[..., :i, :], pos[..., i + 1:, :]], dim=-2)
        out.append(torch.cat([own, vel[..., i, :], rel_lm,
                              (others - own[..., None, :]).flatten(-2)], -1))
    return torch.stack(out, -2)


def unpack_state(state, A: int):
    """A global state (..., 6A) as positions, velocities, landmarks (..., A, 2)."""
    pos, vel, lm = state.split(2 * A, dim=-1)
    return (x.unflatten(-1, (A, 2)) for x in (pos, vel, lm))


def env_step(cfg: dict, pos, vel, lm, actions):
    """Simple-spread's law: new position and velocity, and the shared reward, in the dtype
    of ``pos``."""
    dirs = torch.tensor(DIRS, device=pos.device, dtype=pos.dtype)
    f = dirs[actions.long()] * cfg["accel"]
    vel = vel * (1.0 - cfg["damping"]) + f * cfg["dt"]
    pos = torch.clamp(pos + vel * cfg["dt"], -1.5, 1.5)
    cover = -torch.linalg.vector_norm(pos[..., :, None, :] - lm[..., None, :, :], dim=-1
                                      ).amin(-2).sum(-1)
    dag = torch.linalg.vector_norm(pos[..., :, None, :] - pos[..., None, :, :], dim=-1)
    A = pos.shape[-2]
    other = ~torch.eye(A, dtype=torch.bool, device=pos.device)
    coll = ((dag < cfg["collision_radius"]) & other).sum((-1, -2))
    return pos, vel, cover - coll / 2.0


def env_control(cfg: dict, roll) -> float:
    """The control of ``env_gap``: the env's law computed in bfloat16 from the stored states
    against float32, the widest gap of a position, a velocity, a reward or an observation."""
    A = cfg["num_agents"]
    pos, vel, lm = unpack_state(roll.state, A)
    acts = torch.stack([roll.actions[a] for a in _agents(cfg)], -1)
    low = [x.bfloat16() for x in (pos, vel, lm)]
    pairs = list(zip(env_step(cfg, *low, acts), env_step(cfg, pos, vel, lm, acts)))
    pairs.append((observe(*low), observe(pos, vel, lm)))
    return max(float((a.float() - b).abs().amax()) for a, b in pairs)


# -------------------------------------------------------------------- rollout


def _agents(cfg):
    return [f"agent_{i}" for i in range(cfg["num_agents"])]


def check_rollout(cfg: dict, params: dict, roll, tf32: bool = False) -> tuple[dict, dict]:
    """Judge the stored rollout ``roll`` (leaves (T, S, N, ...)).

    Returns the readings ``env_gap`` (the largest error of an observation, a
    transition or a reward against the env's law; infinite where a discount, a
    step type, a reset or the chain of states breaks it), ``policy_gap`` (the
    largest error of a stored log-prob or value) and ``action_z`` (the largest
    |z| of an action's count in a lane against the policy's probabilities), and
    the reference's own log-probs and values ``{agent: (T, S, N)}``.
    """
    ids, A = _agents(cfg), cfg["num_agents"]
    T = roll.discount.shape[0]
    inf = float("inf")
    pos, vel, lm = unpack_state(roll.state, A)
    npos, nvel, nlm = unpack_state(roll.next_state, A)
    acts = torch.stack([roll.actions[a] for a in ids], -1)  # (T, S, N, A)
    obs = torch.stack([roll.obs[a] for a in ids], -2)
    nobs = torch.stack([roll.next_obs[a] for a in ids], -2)
    t = torch.arange(T, device=pos.device)[:, None, None] % cfg["horizon"]
    done = t + 1 >= cfg["horizon"]
    p2, v2, rew = env_step(cfg, pos, vel, lm, acts)
    live = ~done[..., None, None]
    errs = [(obs - observe(pos, vel, lm)).abs().amax(),
            (nobs - observe(npos, nvel, nlm)).abs().amax(),
            ((npos - p2).abs() * live).amax(), ((nvel - v2).abs() * live).amax(),
            ((nlm - lm).abs() * live).amax(),
            max((roll.rewards[a] - rew).abs().amax() for a in ids)]
    env_gap = max(float(e) for e in errs)
    first, mid = 0, 1
    reset_ok = bool(((nvel == 0) | live).all() & ((npos.abs() <= 1) | live).all()
                    & ((nlm.abs() <= 1) | live).all())
    start_ok = bool((vel[0] == 0).all() & (pos[0].abs() <= 1).all() & (lm[0].abs() <= 1).all())
    chain_ok = bool((roll.state[1:] == roll.next_state[:-1]).all())
    disc_ok = bool((roll.discount == (~done).float()).all())
    step_ok = bool((roll.step_type == torch.where(t == 0, first, mid)).all())
    if not (reset_ok and start_ok and chain_ok and disc_ok and step_ok):
        env_gap = inf

    actor, critic = params["actor"]["shared"], params["critic"]["shared"]
    S = pos.shape[1]
    logp, value, policy_gap, z = {}, {}, 0.0, 0.0
    for a in ids:
        x = roll.obs[a].movedim(1, 0).reshape(S, -1, roll.obs[a].shape[-1])  # (S, T*N, obs)
        lp_all = torch.log_softmax(mlp(actor, x, tf32), -1)
        act = roll.actions[a].movedim(1, 0).reshape(S, -1).long()
        lp = lp_all.gather(-1, act[..., None])[..., 0]
        v = mlp(critic, x, tf32)[..., 0]
        back = lambda y: y.reshape(S, T, -1).movedim(0, 1)  # noqa: E731
        logp[a], value[a] = back(lp), back(v)
        policy_gap = max(policy_gap, float((logp[a] - roll.extras["logp"][a]).abs().amax()),
                         float((value[a] - roll.extras["value"][a]).abs().amax()))
        p = lp_all.exp()  # (S, R, K)
        counts = torch.nn.functional.one_hot(act, p.shape[-1]).sum(1).double()
        var = (p * (1 - p)).sum(1).double()
        z = max(z, float(((counts - p.sum(1).double()) / var.clamp_min(1e-12).sqrt())
                         .abs().amax()))
    return {"env_gap": env_gap, "policy_gap": policy_gap, "action_z": z}, (logp, value)


# --------------------------------------------------------------------- update


def _gae(cfg, rewards, discount, values, last_values):
    """Advantages and returns of one agent over (T, S, N)."""
    disc = discount * cfg["gamma"]
    adv = torch.empty_like(values)
    gae, v_next = torch.zeros_like(last_values), last_values
    for t in reversed(range(values.shape[0])):
        delta = rewards[t] + disc[t] * v_next - values[t]
        gae = delta + disc[t] * cfg["gae_lambda"] * gae
        adv[t] = gae
        v_next = values[t]
    return adv, adv + values


def _surrogate(cfg, lp_all, lp, logp_old, adv, v, returns):
    """The clipped PPO objective of one agent's minibatch, a lane: (S,)."""
    ratio = torch.exp(lp - logp_old)
    mean = adv.mean(1, keepdim=True)
    std = ((adv - mean).square().mean(1, keepdim=True)).sqrt()
    adv = (adv - mean) / (std + 1e-8)
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - cfg["clip_eps"],
                                                 1 + cfg["clip_eps"]) * adv)
    ent = -(lp_all.exp() * lp_all).sum(-1)
    return (pg + cfg["value_coef"] * (v - returns).square() - cfg["entropy_coef"] * ent).mean(1)


def update(cfg: dict, params: dict, roll, logp: dict, value: dict, gen_states, device,
           tf32: bool = False):
    """The cycle's update from ``params``: (each lane's mean minibatch loss (S,), the
    parameters after it, Adam's second moments after it).

    The minibatch shuffles come from lane generators set to ``gen_states``, one
    ``randperm`` of the rows a lane an epoch.  ``tf32`` computes every product with TF32
    operands (the control).
    """
    ids = _agents(cfg)
    T, S, N = roll.discount.shape
    last_obs = {a: roll.next_obs[a][-1] for a in ids}  # (S, N, obs)
    critic0 = params["critic"]["shared"]
    flat = {}
    for a in ids:
        last_v = mlp(critic0, last_obs[a], tf32)[..., 0]
        adv, ret = _gae(cfg, roll.rewards[a], roll.discount, value[a], last_v)
        rows = lambda x: x.movedim(1, 0).reshape(S, T * N, *x.shape[3:])  # noqa: E731
        flat[a] = {"obs": rows(roll.obs[a]), "act": rows(roll.actions[a]).long(),
                   "logp": rows(logp[a]), "adv": rows(adv), "ret": rows(ret)}
    gens = []
    for st in gen_states:
        g = torch.Generator(device)
        g.set_state(st)
        gens.append(g)
    p = {k: v.clone() for k, v in leaves(params).items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    mb = T * N // cfg["num_minibatches"]
    lane = torch.arange(S, device=device)[:, None]
    losses, count = [], 0
    b1, b2, eps, lr = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"], cfg["learning_rate"]
    for _ in range(cfg["epochs"]):
        perm = torch.stack([torch.randperm(T * N, generator=g, device=device) for g in gens])
        for i in range(cfg["num_minibatches"]):
            idx = perm[:, i * mb:(i + 1) * mb]
            leaf = {k: v.detach().requires_grad_() for k, v in p.items()}
            tree = _tree(leaf)
            loss = 0.0
            for a in ids:
                d = {k: x[lane, idx] for k, x in flat[a].items()}
                lp_all = torch.log_softmax(mlp(tree["actor"]["shared"], d["obs"], tf32), -1)
                lp = lp_all.gather(-1, d["act"][..., None])[..., 0]
                v = mlp(tree["critic"]["shared"], d["obs"], tf32)[..., 0]
                loss = loss + _surrogate(cfg, lp_all, lp, d["logp"], d["adv"], v, d["ret"])
            grads = dict(zip(leaf, torch.autograd.grad(loss.sum(), list(leaf.values()))))
            losses.append(loss.detach())
            count += 1
            with torch.no_grad():
                norm = torch.sqrt(sum(g.flatten(1).square().sum(1) for g in grads.values()))
                factor = torch.clamp(cfg["max_grad_norm"] / (norm + 1e-9), max=1.0)
                bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
                for k in p:
                    g = grads[k] * factor.view(-1, *([1] * (grads[k].dim() - 1)))
                    mu[k] = b1 * mu[k] + (1 - b1) * g
                    nu[k] = b2 * nu[k] + (1 - b2) * g.square()
                    p[k] = p[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
    return torch.stack(losses).mean(0), p, nu


def _tree(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        net, layer, name = k.split(".")
        out.setdefault(net, {"shared": {}})["shared"].setdefault(layer, {})[name] = v
    return out
