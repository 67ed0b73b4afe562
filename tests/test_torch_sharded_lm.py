"""The LM sharded over a (2, 2) mesh equals the unsharded port.

One spawned 4-rank gloo world on the CPU (a module fixture,
`collective.run_world`) lays out a tiny dense-GQA, MoE and Mamba1 config
under ``fsdp_tp`` over a ``("data", "model")`` mesh of (2, 2)
(`launch.steps.shard_params` / `shard_batch`, the cache from `init_cache`
under the mesh) and runs, on every rank, the sharded and the unsharded
model from the same seed:

* ``prefill`` of a (4, 32) prompt and one ``decode_step``: logits within
  1e-5 of the unsharded port, and for the dense config a decode over a
  cache sharded on its sequence (``shard_kv_seq``), whose softmax partials
  are combined across the model axis;
* one train step (also with ``grad_accum=2``): the loss and every
  gradient within 1e-5, and the
  parameters after the clipped AdamW step within 1e-4 (Adam's normalised
  step moves a near-zero gradient component by up to the learning rate,
  3e-4, whatever its size, so reduction-order noise of 1e-8 in a gradient
  can move a parameter by ~1e-5).

The attention configs have 4 query heads and 1 kv head: the kv head does
not divide the 2-wide model axis, so it stays replicated while the query
heads are sharded, and each rank must hand the kernels the kv head its
query heads read (handing it every kv head would map local query head i
to kv head i, wrong and silent).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import collective  # noqa: E402

ARCHS = {
    "dense": ("internlm2-1.8b", {"num_kv_heads": 1}),
    # two microbatches: each rank cuts its own rows (`steps._microbatches`)
    "dense_accum": ("internlm2-1.8b", {"num_kv_heads": 1, "grad_accum": 2}),
    "moe": ("olmoe-1b-7b", {"num_kv_heads": 1}),
    "mamba1": ("falcon-mamba-7b", {}),
}
B, S = 4, 32
TOL, PARAM_TOL = 1e-5, 1e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _case(mesh, arch, overrides):
    """Errors of the sharded model against the unsharded one, for one config."""
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    cfg = dataclasses.replace(registry._module(arch).SMOKE, sharding="fsdp_tp", **overrides)
    model = M.init_model(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    batch = {"tokens": tokens, "labels": torch.randint(0, cfg.vocab, (B, S), generator=gen)}
    out = {}

    metrics, grads = steps._grads(model, batch)
    serving = cfg.grad_accum == 1 and _unsharded_serving(model, tokens)
    sharded = steps.shard_params(model, mesh)
    kv_seq = dataclasses.replace(cfg, shard_kv_seq=True)
    with sh.enter_mesh(mesh), sh.set_active_rules(cfg.sharding):
        sbatch = steps.shard_batch(batch, mesh)
        if serving:
            _serving(out, serving, sharded, kv_seq, sbatch)
        smetrics, sgrads = steps._grads(sharded, sbatch)
        out["loss"] = abs(smetrics["loss"].item() - metrics["loss"].item())
        out["grads"] = max((g.full_tensor() - r).abs().max().item()
                           for (_, g), (_, r) in zip(_flat(sgrads), _flat(grads)))
        opt, train_step = steps.make_train_step(cfg)
        sharded, _, _ = train_step(sharded, opt.init(sharded.tree()), sbatch)
    opt, train_step = steps.make_train_step(cfg)
    model, _, _ = train_step(model, opt.init(model.tree()), batch)
    out["params"] = max((p.full_tensor() - r).abs().max().item()
                        for (_, p), (_, r) in zip(_flat(sharded.tree()), _flat(model.tree())))
    return out


def _unsharded_serving(model, tokens):
    """The unsharded port's prefill logits and next decode step's logits (off the mesh)."""
    from repro_torch.models import model as M

    logits, cache = M.prefill(model, tokens, max_len=S + 2)
    return logits, M.decode_step(model, cache, tokens[:, :1])[0]


def _serving(out, reference, sharded, kv_seq, sbatch):
    """Prefill and one decode step of the sharded model against ``reference``, into ``out``."""
    from repro_torch.models import model as M

    logits, step_logits = reference
    got, scache = M.prefill(sharded, sbatch["tokens"], max_len=S + 2)
    out["prefill"] = (got.full_tensor() - logits).abs().max().item()
    got, _ = M.decode_step(sharded, scache, sbatch["tokens"][:, :1])
    out["decode"] = (got.full_tensor() - step_logits).abs().max().item()
    if kv_seq.num_heads:
        seq_model = M.LM(sharded.tree(), kv_seq)
        got, scache = M.prefill(seq_model, sbatch["tokens"], max_len=S + 2)
        out["kv_seq_cache_sharded"] = any(getattr(p, "dim", None) == 2
                                          for p in scache["kv"]["k"].placements)
        got, _ = M.decode_step(seq_model, scache, sbatch["tokens"][:, :1])
        out["decode_kv_seq"] = (got.full_tensor() - step_logits).abs().max().item()


def _world(rank, world_size, device):
    from torch.distributed.device_mesh import init_device_mesh

    del rank, world_size, device
    torch.set_num_threads(1)  # four ranks share the cores
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    return {name: _case(mesh, arch, overrides) for name, (arch, overrides) in ARCHS.items()}


@pytest.fixture(scope="module")
def results():
    return collective.run_world(_world, 4, "gloo", "cpu", timeout_s=300.0)


@pytest.mark.parametrize("family", ["dense", "mamba1", "moe"])
def test_sharded_prefill_and_decode_equal_the_unsharded_port(results, family):
    for rank_out in results:
        out = rank_out[family]
        assert out["prefill"] <= TOL and out["decode"] <= TOL, out


def test_decode_over_a_sequence_sharded_cache_combines_softmax_partials(results):
    for rank_out in results:
        out = rank_out["dense"]
        assert out["kv_seq_cache_sharded"]
        assert out["decode_kv_seq"] <= TOL, out


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_sharded_train_step_equals_the_unsharded_port(results, family):
    for rank_out in results:
        out = rank_out[family]
        assert out["loss"] <= TOL and out["grads"] <= TOL, out
        assert out["params"] <= PARAM_TOL, out
