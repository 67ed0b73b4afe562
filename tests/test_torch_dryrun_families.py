"""The port's dry run on small fake worlds: the ssm, hybrid, vlm and audio families.

The cases of `test_torch_dryrun.py` (its helpers) for the other families,
every shape kind and both meshes among them, and Llama-3.1-405B's
sub-quadratic long_500k variant on (2, 4, 4).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import check_record  # noqa: E402

CASES = [
    ("falcon-mamba-7b", "long_500k", (4, 4)),
    ("zamba2-2.7b", "prefill_32k", (4, 4)),
    ("zamba2-2.7b", "train_4k", (4, 4)),
    ("llava-next-mistral-7b", "train_4k", (4, 4)),
    ("musicgen-large", "decode_32k", (4, 4)),
    ("llama3-405b", "long_500k", (2, 4, 4)),
]


@pytest.mark.parametrize("arch,shape,mesh", CASES)
def test_family_smoke_configs_trace_on_small_fake_worlds(arch, shape, mesh):
    check_record(arch, shape, mesh)

