"""LM training of the mamba1 family on the CPU, against the JAX package.

On the ``falcon-mamba-7b`` smoke config in float32,
with the weights of ``repro.models.model.init_model(jax.random.key(0), cfg)``
converted across (this file reuses tests/test_torch_lm_training.py's
helpers):

* ``forward_train``'s loss, metrics and every gradient leaf at 1e-5, mamba1
  against both JAX branches: ``use_pallas=False`` (``selective_scan_chunked``)
  and ``use_pallas=True`` (the Pallas kernel in interpret mode, its backward
  the vjp of the oracle);
* one ``make_train_step`` (params and Adam state) at 1e-5.

tests/test_torch_lm_training_hybrid.py holds the hybrid family,
tests/test_torch_lm_training_scans.py the scans' backward, and
tests/test_torch_mamba2_family.py the pure-SSM mamba2 family.
"""

import pytest

pytest.importorskip("torch")

from test_torch_lm_training import check_forward_train, check_train_step  # noqa: E402

MAMBA = "falcon-mamba-7b"


@pytest.mark.parametrize("use_pallas,remat", [(False, True), (True, False)])
def test_mamba1_forward_train_matches_both_reference_branches(use_pallas, remat):
    check_forward_train(MAMBA, {"use_pallas": use_pallas}.items(), {"remat": remat}.items())


@pytest.mark.parametrize("arch", [MAMBA])
def test_one_train_step_matches(arch):
    check_train_step(arch)
