"""Overrides that are no-ops in the port are named in the dry-run record.

``attn_causal_skip`` is kept in `ModelConfig` for the reference's hillclimb
overrides (A4, B3, C2, C3), but no code of the port reads it: the flash op
already runs only the causally live blocks.  `dryrun_pair` names it under
``noop_overrides`` when an override changes it, and the traced step is the
one without it (the same flops, bytes, arguments and outputs); a record whose overrides
change no such field keeps the reference's keys only.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import hillclimb  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from test_torch_dryrun import run  # noqa: E402



def test_record_names_attn_causal_skip_as_a_noop():
    plain = run("internlm2-1.8b", "decode_32k", (2, 2))
    skip = run("internlm2-1.8b", "decode_32k", (2, 2), attn_causal_skip=True)
    assert "noop_overrides" not in plain
    assert skip["noop_overrides"] == ["attn_causal_skip"]
    assert skip["cost"] == plain["cost"]
    for key in ("arguments", "outputs", "aliased"):  # a trace's peak depends on what ran before
        assert skip["bytes_per_device"][key] == plain["bytes_per_device"][key]


def test_hillclimb_experiments_that_set_it_are_the_ones_named():
    setting = sorted(label for pair in hillclimb.EXPERIMENTS.values()
                     for _, _, label, overrides in pair if overrides.get("attn_causal_skip"))
    assert [label.split("-")[0] for label in setting] == ["A4", "B3", "C2", "C3"]
    assert dryrun.NOOP_OVERRIDES == ("attn_causal_skip",)
