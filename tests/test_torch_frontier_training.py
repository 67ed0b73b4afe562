"""Llama-3.1-405B and Kimi-K2 training on the port: their smoke configs against JAX.

On each smoke config in float32, with the weights of
``repro.models.model.init_model(jax.random.key(0), cfg)`` converted
across (tests/test_torch_lm_training.py's helpers): ``forward_train``'s
loss, metrics and every gradient, and one ``make_train_step`` (params and
Adam state) from a state one JAX step left, at 1e-5.  Their published
widths do not train on one card (PERF.md §4); tests/test_torch_frontier_serving.py
holds their configs and serving.
"""
import pytest

pytest.importorskip("torch")

from test_torch_lm_training import check_forward_train, check_train_step  # noqa: E402

LLAMA, KIMI = "llama3-405b", "kimi-k2-1t-a32b"
ARCHS = (LLAMA, KIMI)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches(arch):
    metrics = check_forward_train(arch)
    assert ("router_aux" in metrics) == (arch == KIMI)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches(arch):
    check_train_step(arch)
