"""Pieces of the port's dry run: its imports, the kernels' fake routes, `op_cost`
on DTensors, and the hillclimb overrides.

* In a fresh process the dry run imports no ``jax`` and nothing of
  ``repro``, and initialises no CUDA.
* Each LM kernel's fake route adds only its outputs to the peak `MemTracker`
  tracks, so the plain versions' temporaries never count.
* `op_cost` counts one device's local work on a fake (1, 4) world: a
  matmul whose weight is sharded over ``model`` costs a quarter of the
  unsharded one, a replicated one the same.
* A world torn down for one of another size takes DTensor's caches with it,
  so no mesh of the old world's groups comes back out of them.
* hillclimb's overrides take effect (``shard_kv_seq`` shards the cache,
  ``save_layer_outputs`` saves a train step's collectives), its
  experiments are the reference's, a train step traces under pair A's
  sequence parallelism (``fsdp_tp_sp``) with microbatches smaller than the
  data axis (``grad_accum=2``: 4 streams on 4 data ranks, 2 a microbatch),
  and off a mesh ``attn_causal_skip`` and ``save_layer_outputs`` change
  nothing.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_dryrun import ROOT, SHAPES, run, smoke  # noqa: E402


def test_dry_run_imports_no_jax_and_touches_no_cuda():
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.models.config import InputShape\n"
        f"dryrun.dryrun_pair('olmoe-1b-7b', 'prefill_32k', verbose=False, "
        f"overrides={smoke('olmoe-1b-7b')!r}, mesh_shape=(2, 2), "
        f"input_shape={SHAPES['prefill_32k']!r})\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]


def _fake_peak(fn, *shapes_dtypes):
    """(peak bytes over the inputs, output bytes) of ``fn`` on fake inputs (`MemTracker`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_flatten

    fake = FakeTensorMode()
    with fake:
        args = [torch.empty(s, dtype=d) if d is not torch.int64 else torch.zeros(s, dtype=d)
                for s, d in shapes_dtypes]
    tracker = MemTracker()
    with fake:
        tracker.track_external(*args)
        base = sum(a.numel() * a.element_size() for a in args)
        with tracker:
            out = fn(*args)
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    peak = max(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
    return peak - base, sum(t.numel() * t.element_size() for t in outs)


def test_kernel_fake_routes_add_only_their_outputs():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_xent import fused_softmax_xent
    from repro_torch.kernels.selective_scan import selective_scan

    bf, f32 = torch.bfloat16, torch.float32
    # 32k positions: the plain version's (S x S) scores would be 8 GB a head
    peak, out = _fake_peak(lambda q, k, v: flash_attention(q, k, v),
                           ((1, 8, 32768, 128), bf), ((1, 2, 32768, 128), bf),
                           ((1, 2, 32768, 128), bf))
    assert peak == out == 8 * 32768 * 128 * 2
    peak, out = _fake_peak(fused_softmax_xent, ((4096, 1024), bf), ((1024, 128256), bf),
                           ((4096,), torch.int64))
    assert peak == out == 4096 * 4
    peak, out = _fake_peak(selective_scan, ((2, 4096, 512), bf), ((2, 4096, 512), f32),
                           ((512, 16), f32), ((2, 4096, 16), bf), ((2, 4096, 16), bf),
                           ((512,), f32))
    assert peak == out == 2 * 4096 * 512 * 2 + 2 * 512 * 16 * 4


def test_op_cost_counts_one_device_of_a_sharded_matmul():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import enter_mesh, matmul
    from repro_torch.roofline.op_cost import OpCost

    mesh = make_mesh((1, 4), ("data", "model"))
    fake = FakeTensorMode()

    def cost(w_local, placement):
        with fake:
            x = DTensor.from_local(torch.empty(64, 1024), mesh, [Replicate(), Replicate()],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(*w_local), mesh, [Replicate(), placement],
                                   run_check=False, shape=torch.Size((1024, 4096)),
                                   stride=(4096, 1))
            with enter_mesh(mesh), OpCost() as counter:
                matmul(x, w)
        return counter.cost.flops

    full = 2 * 64 * 1024 * 4096
    assert cost((1024, 1024), Shard(1)) == full / 4
    assert cost((1024, 4096), Replicate()) == full


def test_rebuilt_world_leaves_no_stale_meshes_in_dtensor_caches():
    # DTensor's caches compare meshes by shape and names: a mesh of a rebuilt world
    # equal to one of the old must not be handed the old one's (destroyed) groups
    from torch.distributed.tensor import DTensor, Partial, Shard, distribute_tensor
    from torch.distributed.tensor._redistribute import _gen_transform_infos

    def step(shape, axes):
        mesh = make_mesh(shape, axes)
        x = distribute_tensor(torch.ones(8, 8), mesh, [Shard(0)] * len(shape))
        y = DTensor.from_local(torch.ones(8, 8), mesh, [Partial()] * len(shape))
        return tuple((x + y).to_local().shape)

    assert step((1, 4), ("data", "model")) == (2, 8)
    assert _gen_transform_infos.cache_info().currsize > 0
    make_mesh((2, 4), ("data", "model"))
    assert _gen_transform_infos.cache_info().currsize == 0
    assert step((2, 4), ("data", "model")) == (1, 8)
    assert step((1, 4), ("data", "model")) == (2, 8)


def test_hillclimb_overrides_take_effect():
    # one kv head: replicated over "model" unless the cache's sequence takes that axis
    plain = run("internlm2-1.8b", "decode_32k", (2, 2), num_kv_heads=1)
    seq = run("internlm2-1.8b", "decode_32k", (2, 2), num_kv_heads=1, shard_kv_seq=True)
    assert seq["bytes_per_device"]["arguments"] < plain["bytes_per_device"]["arguments"]
    # save_layer_outputs: the backward re-runs none of the forward's collectives
    train = run("internlm2-1.8b", "train_4k", (2, 2))
    saved = run("internlm2-1.8b", "train_4k", (2, 2), save_layer_outputs=True)
    moved = [sum(r["roofline"]["collectives_per_device"].values()) for r in (train, saved)]
    assert moved[1] < moved[0]


@pytest.mark.parametrize("field", ["attn_causal_skip", "save_layer_outputs"])
def test_mesh_only_fields_change_nothing_off_a_mesh(field):
    """``attn_causal_skip`` changes nothing in the port (the flash op already skips
    dead blocks); ``save_layer_outputs`` saves collectives' outputs, and off a mesh
    a layer runs none: loss, gradients and prefill bitwise as without either."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    cfg = registry._module("internlm2-1.8b").SMOKE
    tokens = torch.randint(0, cfg.vocab, (2, 48), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens}
    model = M.init_model(torch.Generator().manual_seed(0), cfg)
    other = M.LM(model.tree(), dataclasses.replace(cfg, **{field: True}))
    (m1, g1), (m2, g2) = steps._grads(model, batch), steps._grads(other, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
    assert torch.equal(M.prefill(model, tokens)[0], M.prefill(other, tokens)[0])


def _reference_experiments():
    """The root ``benchmarks/hillclimb.py``'s ``EXPERIMENTS``, read from its source."""
    import ast

    tree = ast.parse((ROOT / "benchmarks" / "hillclimb.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if getattr(target, "id", None) == "EXPERIMENTS":
                out.update(ast.literal_eval(node.value))
            elif (isinstance(target, ast.Subscript)
                  and getattr(target.value, "id", None) == "EXPERIMENTS"):
                out[ast.literal_eval(target.slice)] = ast.literal_eval(node.value)
    return out


def test_hillclimb_runs_the_reference_experiments():
    from repro_torch.benchmarks import hillclimb

    assert hillclimb.EXPERIMENTS == _reference_experiments()


def test_sequence_parallel_microbatched_train_step_traces():
    shape = InputShape("train_4k", 256, 4, "train")
    rec = dryrun.dryrun_pair("internlm2-1.8b", "train_4k", verbose=False, mesh_shape=(4, 4),
                             input_shape=shape,
                             overrides=smoke("internlm2-1.8b", sharding="fsdp_tp_sp", grad_accum=2))
    assert rec["bytes_per_device"]["peak_est"] > rec["bytes_per_device"]["arguments"] > 0
    assert rec["cost"]["flops"] > 0
