"""The port's batched matrix_game and wrapper stack against the JAX package.

Both packages play the same action sequences (numpy draws) through
``EpisodeStats(AutoReset(MatrixGame()))`` across several episode
boundaries: step types, rewards, discounts, observations, global states
and the published episode statistics must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.envs.matrix_game import PENALTY as JAX_PENALTY  # noqa: E402
from repro.envs.matrix_game import MatrixGame as JaxMatrixGame  # noqa: E402
from repro.envs.wrappers import AutoReset as JaxAutoReset  # noqa: E402
from repro.envs.wrappers import EpisodeStats as JaxEpisodeStats  # noqa: E402
from repro_torch.envs import AutoReset, EpisodeStats, MatrixGame, StepType  # noqa: E402
from repro_torch.envs.matrix_game import PENALTY  # noqa: E402
from repro_torch.envs.wrappers import replace_reset_keys  # noqa: E402


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("payoff", ["climbing", "penalty"])
def test_wrapped_episodes_match(payoff):
    N, horizon, steps = 4, 5, 13  # crosses two auto-reset boundaries
    jgame = JaxMatrixGame(horizon=horizon, payoff=None if payoff == "climbing" else JAX_PENALTY)
    tgame = MatrixGame(horizon=horizon) if payoff == "climbing" else MatrixGame(PENALTY, horizon)
    jenv, tenv = JaxEpisodeStats(JaxAutoReset(jgame)), EpisodeStats(AutoReset(tgame))
    jstate, jts = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), N))
    tstate, tts = tenv.reset(N, "cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(0)
    ids = tgame.agent_ids
    for t in range(steps):
        for a in ids:
            _eq(tts.observation[a], jts.observation[a])
        _eq(tts.step_type, jts.step_type)
        _eq(tenv.global_state(tstate), jax.vmap(jenv.global_state)(jstate))
        acts = {a: rng.integers(0, tgame.num_actions, N).astype(np.int32) for a in ids}
        jstate, jts = jstep(jstate, acts)
        tstate, tts = tenv.step(tstate, {a: torch.from_numpy(x) for a, x in acts.items()})
        _eq(tts.step_type, jts.step_type)
        _eq(tts.discount, jts.discount)
        for a in ids:
            _eq(tts.reward[a], jts.reward[a])
            _eq(tstate.last_returns[a], jstate.last_returns[a])
            _eq(tstate.returns[a], jstate.returns[a])
        _eq(tstate.length, jstate.length)
        _eq(tstate.last_length, jstate.last_length)
        if (t + 1) % horizon == 0:  # the merged boundary: FIRST, terminal reward
            assert (tts.step_type == StepType.FIRST).all()
            assert (tts.discount == 0).all()
    assert tts.step_type.dtype == torch.int32 and tts.discount.dtype == torch.float32


def test_replace_reset_keys_reaches_the_autoreset_layer():
    state, _ = EpisodeStats(AutoReset(MatrixGame())).reset(2, "cpu")
    gen = torch.Generator().manual_seed(0)
    assert replace_reset_keys(state, gen).inner.key is gen
    with pytest.raises(TypeError):
        replace_reset_keys(MatrixGame().reset(2, "cpu")[0], gen)
