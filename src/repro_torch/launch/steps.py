"""Step factories and abstract inputs for the LM (counterpart of
`repro.launch.steps`).

The dry run (`repro_torch.launch.dryrun`) traces exactly one step a
(arch, input shape) pair, on fake DTensors laid out over a mesh:

  train_4k     -> train_step   (fwd + bwd + AdamW update)
  prefill_32k  -> prefill_step (full-prompt forward, returns decode cache)
  decode_32k   -> serve_step   (ONE token against a seq_len KV cache)
  long_500k    -> serve_step   (sub-quadratic variants; see shape_config)

`abstract_params`, `abstract_opt_state`, `input_specs` and
`abstract_cache` build those inputs under `FakeTensorMode`: DTensors whose
local shards are fake tensors, so no parameter, moment, token or cache
entry is ever allocated.  `shard_params`, `shard_batch` and the cache from
`init_cache` under `enter_mesh` lay real tensors out the same way.

``make_train_step(cfg, lr) -> (opt, train_step)`` as in the reference
(``steps.py:61-66, 166-200``), with one difference of form: where the JAX
step is a pure function of a params pytree (which the reference's launcher
jits with the params and optimizer state donated), ``train_step(model,
opt_state, batch)`` takes the `LM` module and writes the updated
parameters into it, and the new Adam moments into ``opt_state``'s
tensors, in place and a leaf at a time (`optim.clip_adamw_in_place`: the
values of the chain's update and `optim.apply_updates`), so no second copy
of the weights or the moments is alive.  It returns ``(model, opt_state,
metrics)``; the optimizer state is the reference's ``chain`` tuple over the
parameter tree of `LM.tree`.  It trains every family the port runs: the
batch is `model.forward_train`'s (a vlm batch's ``vision_embeds`` split
into microbatches like the tokens), and the metrics are
`forward_train`'s (an MoE model's ``router_aux`` and ``router_z``
averaged over microbatches like the rest).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import optim
from repro_torch.distributed.sharding import (
    NamedSharding,
    argmax,
    enter_mesh,
    is_dtensor,
    layer_slice,
    local_call,
    local_shape,
    with_logical_constraint,
    logical_to_spec,
    rules_for,
    set_active_rules,
    tree_shardings,
)
from repro_torch.models import model as M
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.tree import tree_map


# ----------------------------------------------------------- config per shape


def shape_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt an arch config to an input shape.

    long_500k decode requires sub-quadratic attention: SSM/hybrid archs are
    natively O(1)/token; attention archs get their sliding-window variant
    (cfg.long_context_window) so the KV cache is O(window), not O(seq).
    """
    if shape.name == "long_500k" and cfg.arch_type != "ssm" and cfg.attn_window == 0:
        cfg = dataclasses.replace(cfg, attn_window=cfg.long_context_window)
    return cfg


# ------------------------------------------------------------- abstract trees


def _fake_dtensor(shape, dtype, sharding: NamedSharding):
    """A DTensor of global ``shape`` whose local shard is an empty (fake) tensor."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    local = torch.empty(local_shape(shape, sharding.spec, mesh), dtype=dtype,
                        device=mesh.device_type)
    stride = torch.empty(shape, dtype=dtype, device="meta").stride()
    return DTensor.from_local(local, mesh, sharding.placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def param_shardings(cfg: ModelConfig, mesh, tree):
    """The `NamedSharding` of each leaf of a parameter ``tree`` (`LM.tree`'s layout)."""
    return tree_shardings(M.model_axes(cfg), mesh, rules_for(cfg.sharding), tree)


class _OnMeta(torch.overrides.TorchFunctionMode):
    """Every tensor a factory makes goes to the meta device: shapes, no data."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def param_shapes(cfg: ModelConfig):
    """`init_model`'s parameter tree as meta tensors: shapes and dtypes, nothing drawn."""
    with _OnMeta():
        return M.init_model(torch.Generator(), cfg).tree()


def abstract_params(cfg: ModelConfig, mesh, fake_mode):
    """The model with every parameter a fake DTensor laid out by ``cfg.sharding``.

    Returns ``(model, shardings)``; the shapes are `param_shapes`'.
    """
    shapes = param_shapes(cfg)
    with fake_mode:
        shardings = param_shardings(cfg, mesh, shapes)
        tree = _tree_zip(lambda t, sh: _fake_dtensor(t.shape, t.dtype, sh), shapes, shardings)
        return M.LM(tree, cfg), shardings


def _tree_zip(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_zip(fn, v, other[i]) for i, v in enumerate(tree)]
    return fn(tree, other)


def shard_params(model, mesh):
    """``model``'s parameters laid out by ``cfg.sharding`` over ``mesh``, as a new `LM`.

    Every rank holds the whole model first (the same seed draws the same
    weights) and keeps its shards (`distribute_tensor` slices, no copy
    from another rank).
    """
    from torch.distributed.tensor import distribute_tensor

    cfg = model.cfg
    tree = model.tree()
    shardings = param_shardings(cfg, mesh, tree)
    return M.LM(_tree_zip(lambda t, sh: distribute_tensor(t, mesh, sh.placements),
                          tree, shardings), cfg)


MAX_GRAD_NORM, WEIGHT_DECAY = 1.0, 0.1


def make_optimizer(cfg: ModelConfig, lr: float = 3e-4):
    """Global-norm clipping at 1.0, then AdamW with weight decay 0.1."""
    del cfg
    return optim.chain(
        optim.clip_by_global_norm(MAX_GRAD_NORM),
        optim.adamw(lr, weight_decay=WEIGHT_DECAY),
    )


def abstract_opt_state(cfg: ModelConfig, opt, model, fake_mode):
    """The optimizer state of fake DTensor parameters: each moment takes its
    parameter's placements (`zeros_like`), the step count is a replicated
    scalar, as the reference's ``steps.py:68-99`` lays them out."""
    del cfg
    with fake_mode:
        return opt.init(model.tree())


def batch_sharding(mesh, batch: int | None = None) -> NamedSharding:
    """Batch-dim sharding over (pod, data), dropping non-dividing axes."""
    shape = (batch,) if batch is not None else None
    return NamedSharding(mesh, logical_to_spec(("batch",), rules_for("tp"), mesh, shape=shape))


def _batch_shapes(cfg: ModelConfig, shape: InputShape):
    """``{name: (shape, dtype)}`` of the step's model inputs (steps.py:110-142)."""
    B, S = shape.global_batch, shape.seq_len
    tok, emb = torch.int32, cfg.activation_dtype
    K = cfg.num_codebooks
    if shape.kind == "decode":
        return {"tokens": ((B, 1, K) if K else (B, 1), tok)}
    train = shape.kind == "train"
    if cfg.arch_type == "audio":
        out = {"tokens": ((B, S, K), tok)}
        if train:
            out["labels"] = ((B, S, K), tok)
    elif cfg.arch_type == "vlm":
        T = S - cfg.vision_tokens
        out = {"tokens": ((B, T), tok), "vision_embeds": ((B, cfg.vision_tokens, cfg.d_model), emb)}
        if train:
            out["labels"] = ((B, T), tok)
    else:
        out = {"tokens": ((B, S), tok)}
        if train:
            out["labels"] = ((B, S), tok)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape, mesh, fake_mode):
    """The step's model inputs as fake DTensors, their batch dim laid out by
    `batch_sharding`."""
    bs = batch_sharding(mesh, shape.global_batch)
    with fake_mode:
        return {name: _fake_dtensor(shp, dtype, bs)
                for name, (shp, dtype) in _batch_shapes(cfg, shape).items()}


def shard_batch(batch, mesh):
    """A batch of real tensors laid out by `batch_sharding` (each rank keeps its rows)."""
    from torch.distributed.tensor import distribute_tensor

    return {name: distribute_tensor(x, mesh, batch_sharding(mesh, x.shape[0]).placements)
            for name, x in batch.items()}


def abstract_cache(cfg: ModelConfig, shape: InputShape, mesh, fake_mode):
    """The decode cache of capacity ``shape.seq_len`` as fake DTensors laid out
    by `model.cache_axes` (`init_cache` under the mesh)."""
    with fake_mode, enter_mesh(mesh), set_active_rules(cfg.sharding):
        return M.init_cache(cfg, shape.global_batch, shape.seq_len, mesh.device_type)


def _grad(p):
    # a parameter the loss does not reach has a zero gradient, as in JAX
    return torch.zeros_like(p) if p.grad is None else p.grad


def _replicated(x):
    # a DTensor loss or metric as the whole value (a pending partial sum reduced)
    return x.full_tensor() if is_dtensor(x) else x


def _grads(model, batch):
    """(metrics, gradient tree) of `forward_train` on ``batch``."""
    loss, metrics = M.forward_train(model, batch)
    _replicated(loss).backward()
    grads = model.tree(_grad)
    for p in model.parameters():
        p.grad = None
    return {k: _replicated(v.detach()) for k, v in metrics.items()}, grads


def _microbatches(x, k: int):
    """``x`` (B, ...) as k microbatches (k, B / k, ...).  On a DTensor each rank
    cuts its own rows, so microbatch i holds the i-th k-th of every rank's
    rows (the same step: every microbatch is as large, and their gradients
    are averaged)."""
    if not is_dtensor(x):
        return x.reshape((k, x.shape[0] // k) + x.shape[1:])
    from torch.distributed.tensor import Shard

    # a microbatch too small to split over every batch shard keeps only the
    # shards that divide it (the rest of its rows gathered), as its spec would
    x = with_logical_constraint(x, ("batch",), shape=(x.shape[0] // k,) + x.shape[1:])
    place = tuple(x.placements)
    out = [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in place]
    return local_call(lambda t: t.reshape((k, t.shape[0] // k) + t.shape[1:]),
                      x.device_mesh, out, (place,), x)


def make_train_step(cfg: ModelConfig, lr: float = 3e-4):
    """The optimizer and one step of training; see the module docstring.

    With ``cfg.grad_accum = k > 1`` the batch is split into k microbatches
    along its leading dim (`_microbatches`); their gradients are summed in float32, each
    divided by k, and the metrics are averaged.
    """
    opt = make_optimizer(cfg, lr)
    k = max(cfg.grad_accum, 1)

    def train_step(model, opt_state, batch):
        if k == 1:
            metrics, grads = _grads(model, batch)
        else:
            micro = {name: _microbatches(x, k) for name, x in batch.items()}
            grads, per_micro = None, []
            for i in range(k):
                m, g = _grads(model, {name: layer_slice(x, i) for name, x in micro.items()})
                g = tree_map(lambda x: x.float() / k, g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                per_micro.append(m)
            metrics = {name: torch.stack([m[name] for m in per_micro]).mean()
                       for name in per_micro[0]}
        opt_state = optim.clip_adamw_in_place(model.tree(), grads, opt_state, MAX_GRAD_NORM,
                                              lr, weight_decay=WEIGHT_DECAY)
        return model, opt_state, metrics

    return opt, train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(model, batch) -> (last-position logits, cache)``: `model.prefill`."""
    del cfg

    def prefill_step(model, batch):
        return M.prefill(model, batch["tokens"], vision_embeds=batch.get("vision_embeds"))

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(model, cache, batch) -> (next tokens, cache)``: one greedy decode step."""
    del cfg

    def serve_step(model, cache, batch):
        logits, cache = M.decode_step(model, cache, batch["tokens"])
        # greedy next token (serving returns tokens, not logits)
        return argmax(logits).to(torch.int32), cache

    return serve_step
