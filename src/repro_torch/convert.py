"""Carry weights and state between the JAX package and the port.

`params_from_jax` turns a tree of arrays (numpy arrays, or anything
`numpy.asarray` accepts, such as JAX arrays) into a tree of tensors;
`params_to_jax` turns tensors back into numpy arrays, which JAX functions
accept as they are.  Dicts, lists and tuples keep their type.  A
NamedTuple of the reference (``TrainState``, ``AdamState``, ``Carry``,
``Transition``, ...) becomes the port's NamedTuple of the same name, found
by name so this module never imports the reference; NamedTuples of the
port keep their type on the way back.  Both packages store ``w`` as
``(in, out)``, so no leaf is transposed.  bfloat16 leaves cross as their
16-bit patterns: numpy has no bfloat16 of its own, and JAX hands them over
as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses.

`replay_train_from_jax` / `replay_train_to_jax` carry the `TrainState` of
the replay family (both builders: Q nets and mixer, or actor and critic
dicts; target params; the ``chain(clip, adamw)`` state, one a group for
MADDPG), whose update count is a Python int in the port.
The same two carry rec-MADQN's and DIAL's train states, whose update
count is a Python int as well.  `buffer_from_jax` / `buffer_to_jax` carry
a replay table and `seq_buffer_from_jax` / `seq_buffer_to_jax` a
sequence-replay table, whose cursors are Python ints in the port too.
Seed lanes (the reference's vmapped states) cross with their leading lane
axis.  `reset_from_jax` carries a batch of env resets; a PRNG key in an
env state (switch_game's and robot_warehouse's, which draw inside
``step``) becomes the generator the caller passes.

`queue_from_jax` / `queue_to_jax` carry the async runner's trajectory
queue (`QueueState`, cursors Python ints in the port).  `ranks_from_jax`
splits a tree whose leaves lead with a device (or vmapped rank) axis into
one tree a rank: the sharded runner's per-rank train states.  V-trace's
inputs are plain arrays and cross with `params_from_jax`.

`lm_params_from_jax` / `lm_params_to_jax` carry a language model of any
family (dense; MoE with its router and stacked experts; Mamba1; a hybrid's
Mamba2 layers and ``shared_attn`` block; vlm; audio with its K tables and
K heads): the JAX package stacks its layers along a leading L axis, the
port keeps one module per layer.  `lm_opt_state_from_jax` /
`lm_opt_state_to_jax` carry the LM optimizer state of
`launch.steps.make_optimizer` (the ``chain`` tuple of ``()`` and
``AdamState(count, mu, nu)``, with ``mu`` and ``nu`` shaped like the
parameters, every leaf of every family) the same way.  A decode cache (``pos`` beside ``kv``'s ``k``
and ``v``, or Mamba1's ``conv`` and ``ssm``) is stacked along L in both
packages, so `lm_cache_from_jax` / `lm_cache_to_jax` carry it leaf by leaf
as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.buffer import BufferState, QueueState, SeqBufferState
from repro_torch.core.types import Carry, EvalMetrics, SystemState, TrainState, Transition
from repro_torch.envs.api import TimeStep
from repro_torch.envs.lbf import LbfState
from repro_torch.envs.matrix_game import MatrixGameState
from repro_torch.envs.robot_warehouse import RwareState
from repro_torch.envs.smax_lite import SmaxState
from repro_torch.envs.speaker_listener import SLState
from repro_torch.envs.spread import SpreadState
from repro_torch.envs.switch_game import SwitchState
from repro_torch.envs.wrappers import EpisodeStatsState
from repro_torch.models.model import LM
from repro_torch.optim.optimizers import AdamState
from repro_torch.tree import tree_leaves, tree_map

NAMEDTUPLES = {
    cls.__name__: cls
    for cls in (
        AdamState, Carry, EpisodeStatsState, EvalMetrics, LbfState, MatrixGameState,
        RwareState, SLState, SmaxState, SpreadState, SwitchState, SystemState, TimeStep,
        TrainState, Transition,
    )
}


def _convert(tree, leaf, named):
    if isinstance(tree, dict):
        return {k: _convert(v, leaf, named) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = named(type(tree))
        return cls(*(_convert(x, leaf, named) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(x, leaf, named) for x in tree)
    if tree is None:
        return None
    return leaf(tree)


def _port_namedtuple(cls):
    try:
        return NAMEDTUPLES[cls.__name__]
    except KeyError:
        raise TypeError(f"no port counterpart for NamedTuple {cls.__name__}") from None


def _to_tensor(x):
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16, from JAX
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # JAX's bfloat16 for numpy; only a JAX caller needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree, device="cpu"):
    """A tree of arrays -> the same tree of tensors on ``device``."""
    return _convert(tree, lambda x: _to_tensor(x).to(device), _port_namedtuple)


def params_to_jax(tree):
    """A tree of tensors -> the same tree of numpy arrays (on the host)."""
    return _convert(tree, _to_numpy, lambda cls: cls)


def _is_key(x) -> bool:
    """Whether ``x`` is an array of JAX PRNG keys (its dtype reads ``key<impl>``)."""
    return str(getattr(x, "dtype", "")).startswith("key<")


def reset_from_jax(reset, device="cpu", generator=None):
    """A ``jax.vmap``-ed env reset ``(state, TimeStep)`` -> one batched port reset.

    The vmap gives every leaf the leading env axis the port's batched envs
    carry, so the state (a `SpreadState`, `LbfState`, ... or a stack of
    them under `EpisodeStats`) and the first `TimeStep` cross as they are;
    a state's PRNG keys become ``generator``.
    """
    state, timestep = _convert(
        reset, lambda x: generator if _is_key(x) else _to_tensor(x).to(device), _port_namedtuple
    )
    tensors = [x for x in tree_leaves((state, timestep)) if isinstance(x, torch.Tensor)]
    sizes = {x.shape[0] if x.dim() else None for x in tensors}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"a vmap-ed reset leads every leaf with one env axis; got {sizes}")
    return state, timestep


def _host_count(x) -> int:
    """A JAX count (scalar, or one a lane, all equal) -> one Python int."""
    arr = np.asarray(x)
    if arr.size == 0 or (arr != arr.flat[0]).any():
        raise ValueError(f"expected one count, equal in every lane; got {arr}")
    return int(arr.flat[0])


def _jax_count(n: int, lanes):
    """A Python int -> the reference's int32 count (``(lanes,)`` with seed lanes)."""
    return np.full(() if lanes is None else (lanes,), n, np.int32)


def replay_train_from_jax(train, device="cpu"):
    """A replay-family JAX `TrainState` -> the port's (``steps`` a Python int)."""
    return params_from_jax(train._replace(steps=()), device)._replace(
        steps=_host_count(train.steps))


def replay_train_to_jax(train, lanes=None):
    """The port's replay-family `TrainState` -> numpy arrays (``steps`` int32, one a lane)."""
    return params_to_jax(train._replace(steps=()))._replace(steps=_jax_count(train.steps, lanes))


def buffer_from_jax(state, device="cpu") -> BufferState:
    """A JAX replay table (``BufferState``; vmapped over lanes or not) -> the port's."""
    lanes = None if np.ndim(state.size) == 0 else int(np.shape(state.size)[0])
    return BufferState(params_from_jax(state.storage, device), _host_count(state.insert_pos),
                       _host_count(state.size), lanes)


def buffer_to_jax(state: BufferState):
    """The port's replay table -> the reference's fields as numpy arrays."""
    return BufferState(params_to_jax(state.storage), _jax_count(state.insert_pos, state.lanes),
                       _jax_count(state.size, state.lanes))


def seq_buffer_from_jax(state, device="cpu") -> SeqBufferState:
    """A JAX sequence-replay table (``SeqBufferState``; vmapped over lanes or not) -> the port's."""
    lanes = None if np.ndim(state.size) == 0 else int(np.shape(state.size)[0])
    return SeqBufferState(params_from_jax(state.storage, device),
                          params_from_jax(state.acc, device), _host_count(state.t),
                          _host_count(state.insert_pos), _host_count(state.size), lanes)


def seq_buffer_to_jax(state: SeqBufferState):
    """The port's sequence-replay table -> the reference's fields as numpy arrays."""
    count = lambda n: _jax_count(n, state.lanes)
    return SeqBufferState(params_to_jax(state.storage), params_to_jax(state.acc),
                          count(state.t), count(state.insert_pos), count(state.size))


def queue_from_jax(state, device="cpu") -> QueueState:
    """A JAX trajectory queue (``QueueState``) -> the port's (``head`` and ``size`` Python ints)."""
    return QueueState(params_from_jax(state.storage, device), int(state.head), int(state.size))


def queue_to_jax(state: QueueState):
    """The port's trajectory queue -> the reference's fields as numpy arrays (int32 cursors)."""
    return QueueState(params_to_jax(state.storage), np.int32(state.head), np.int32(state.size))


def ranks_from_jax(tree, device="cpu", convert=params_from_jax) -> list:
    """A tree whose leaves lead with a rank axis -> one converted tree a rank.

    ``convert`` carries one rank's tree (`replay_train_from_jax` for the
    replay family's train states).
    """
    ranks = {np.shape(x)[0] for x in tree_leaves(_convert(tree, np.asarray, lambda cls: cls))}
    if len(ranks) != 1:
        raise ValueError(f"leaves lead with different rank axes: {sorted(ranks)}")
    return [convert(_convert(tree, lambda x, r=r: np.asarray(x)[r], lambda cls: cls), device)
            for r in range(ranks.pop())]


def _unstack_layers(tree, num_layers):
    """``tree["layers"]`` stacked along L -> a list of L per-layer trees."""
    stacked = tree["layers"]
    layers = [tree_map(lambda x, i=i: x[i].clone(), stacked) for i in range(num_layers)]
    return {**tree, "layers": layers}


def _stack_layers(tree):
    """``tree["layers"]`` a list of per-layer trees -> stacked along L."""
    layers = tree["layers"]
    return {**tree, "layers": tree_map(lambda *xs: torch.stack(xs), layers[0], *layers[1:])}


def lm_params_from_jax(params, cfg, device="cpu") -> LM:
    """JAX LM params (``layers`` stacked along L) -> the port's `LM`.

    The other groups cross as they are: a hybrid's ``shared_attn`` block,
    an audio model's (K, V, d) embeddings and (K, d, V) heads.
    """
    return LM(_unstack_layers(params_from_jax(params, device), cfg.num_layers), cfg)


def lm_params_to_jax(model: LM):
    """The port's `LM` -> JAX LM params, ``layers`` stacked along L."""
    return params_to_jax(_stack_layers(model.tree()))


# attention; mamba1 (or a hybrid without a shared block); a hybrid's mamba2 + shared K/V
_CACHE_KEYS = ({"pos", "kv"}, {"pos", "conv", "ssm"}, {"pos", "conv", "ssm", "kv"})


def _check_cache(cache):
    if set(cache) not in _CACHE_KEYS:
        raise ValueError(f"not an LM decode cache: keys {sorted(cache)}")
    return cache


def lm_cache_from_jax(cache, device="cpu"):
    """A JAX LM decode cache -> the port's (the same keys and layout)."""
    return params_from_jax(_check_cache(cache), device)


def lm_cache_to_jax(cache):
    """The port's LM decode cache -> JAX's, as numpy arrays."""
    return params_to_jax(_check_cache(cache))


def _map_adam(state, fn):
    """Apply ``fn`` to ``mu`` and ``nu`` of every `AdamState` in a chain state."""
    return tuple(
        s._replace(mu=fn(s.mu), nu=fn(s.nu)) if isinstance(s, AdamState) else s
        for s in state
    )


def lm_opt_state_from_jax(state, cfg, device="cpu"):
    """JAX LM optimizer state (layers stacked along L) -> the port's."""
    return _map_adam(
        params_from_jax(state, device), lambda t: _unstack_layers(t, cfg.num_layers)
    )


def lm_opt_state_to_jax(state):
    """The port's LM optimizer state -> JAX's, layers stacked along L."""
    return params_to_jax(_map_adam(state, _stack_layers))
