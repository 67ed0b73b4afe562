"""LM training of the hybrid family (Zamba2) on the CPU, against the JAX package.

On the ``zamba2-2.7b`` smoke config in float32, with the weights of
``repro.models.model.init_model(jax.random.key(0), cfg)`` converted across
(tests/test_torch_lm_training.py's helpers): ``forward_train``'s loss,
metrics and every gradient leaf at 1e-5, where the shared block runs twice,
so its gradients sum two invocations; and one ``make_train_step`` (params
and Adam state) at 1e-5.  Split from tests/test_torch_lm_training_ssm.py.
"""

import pytest

pytest.importorskip("torch")

from test_torch_lm_training import check_forward_train, check_train_step  # noqa: E402

HYBRID = "zamba2-2.7b"


def test_hybrid_forward_train_matches():
    check_forward_train(HYBRID)


@pytest.mark.parametrize("arch", [HYBRID])
def test_one_train_step_matches(arch):
    check_train_step(arch)
