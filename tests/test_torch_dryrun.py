"""The port's dry run (`repro_torch.launch.dryrun`) on small fake worlds: dense and moe.

A smoke config of each family traced at the dry run's four kinds of step,
cut in size (`SHAPES`), on a fake (4, 4) world and on (2, 4, 4); the
record's keys are the reference's (`repro/launch/dryrun.py`'s record, read
from its source, and `repro.roofline.analysis.RooflineReport.row`'s
keys).  This file holds the dense and moe cases and the helpers;
`test_torch_dryrun_families.py` the ssm, hybrid, vlm and audio ones, and
`test_torch_dryrun_units.py` the imports, the kernels' fake routes,
`op_cost` on DTensors and the overrides.  Each trace's time is mostly
DTensor's sharding propagation, which is cold for every new shape.
"""
import ast
import dataclasses
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the dry run's four shapes cut in size, kinds and names kept (long_500k: a window
# of 128 positions, `shape_config`'s sub-quadratic variant)
SHAPES = {s.name: s for s in (InputShape("train_4k", 256, 16, "train"),
                              InputShape("prefill_32k", 512, 8, "prefill"),
                              InputShape("decode_32k", 512, 16, "decode"),
                              InputShape("long_500k", 1024, 1, "decode"))}
# (arch, shape, mesh) cases: dense and moe, both meshes
CASES = [
    ("internlm2-1.8b", "train_4k", (4, 4)),
    ("internlm2-1.8b", "decode_32k", (2, 4, 4)),
    ("olmoe-1b-7b", "train_4k", (2, 4, 4)),
    ("olmoe-1b-7b", "decode_32k", (4, 4)),
]
# the blockings at the cut shapes: one or two chunks a sequence
BLOCKS = dict(attn_chunk=128, xent_chunk=128, ssm_chunk=64, moe_group_size=128,
              long_context_window=128)


def smoke(arch, **extra):
    """Overrides that turn ``arch``'s published config into its smoke widths and depth."""
    cfg = registry._module(arch).SMOKE
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields = {k: v for k, v in fields.items() if k not in ("name", "source")}
    return {**fields, **BLOCKS, **extra}


def run(arch, shape, mesh, **extra):
    return dryrun.dryrun_pair(arch, shape, verbose=False, overrides=smoke(arch, **extra),
                              mesh_shape=mesh, input_shape=SHAPES[shape])


def _reference_record_keys():
    """Keys of the reference dry run's record and of its ``bytes_per_device``."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "rec" for t in node.targets)):
            keys = [k.value for k in node.value.keys]
            inner = node.value.values[keys.index("bytes_per_device")]
            return set(keys), {k.value for k in inner.keys}
    raise AssertionError("no record in the reference dry run")


def check_record(arch, shape, mesh, **extra):
    """Trace one case and hold its record to the reference's keys and identities."""
    rec = run(arch, shape, mesh, **extra)
    assert rec["mesh"] == "x".join(map(str, mesh))
    assert rec["chips"] == (16 if len(mesh) == 2 else 32)
    top, per_device = _reference_record_keys()
    assert set(rec) == top and set(rec["bytes_per_device"]) == per_device
    jax = pytest.importorskip("jax")
    del jax
    from repro.roofline.analysis import RooflineReport

    ref = RooflineReport(arch, shape, 1, 1.0, 1.0, {}, 1.0)
    assert set(rec["roofline"]) == set(ref.row())
    bpd = rec["bytes_per_device"]
    assert bpd["arguments"] > 0 and bpd["peak_est"] >= bpd["arguments"]
    assert bpd["temps"] == bpd["peak_est"] - bpd["arguments"] - bpd["outputs"] + bpd["aliased"]
    assert rec["cost"]["flops"] > 0 and rec["roofline"]["useful_ratio"] > 0
    assert rec["roofline"]["xla_cost_flops_per_device"] is None


@pytest.mark.parametrize("arch,shape,mesh", CASES)
def test_smoke_configs_trace_on_small_fake_worlds(arch, shape, mesh):
    check_record(arch, shape, mesh)
