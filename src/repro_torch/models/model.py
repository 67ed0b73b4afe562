"""LM backbone (counterpart of `repro.models.model`).

`PORTED` says what the port runs of each family: ``dense``, ``moe``,
``mamba1``, ``mamba2`` (a pure-SSM stack of mamba2 layers, which no config
of the repo uses), ``hybrid`` (zamba2: mamba2 layers and one shared
attention block), ``vlm`` and ``audio`` train and serve.  `_require_ported`
is the one gate: a family outside it raises `NotImplementedError` naming
its own.  A pure mamba2 model runs the hybrid's layer loops with no shared
block, and its cache is the hybrid's without ``kv``.  vlm and audio
run the dense layers (`core_kind`): a vlm prompt puts its precomputed
vision embeddings ahead of the text, an audio model sums K codebook
embeddings a position and has a head a codebook.

  init_model(generator, cfg)                  -> LM (an nn.Module)
  forward_train(model, batch)                 -> (loss, metrics)
  init_cache(cfg, batch, max_len, device)     -> cache dict
  prefill(model, tokens, max_len=None, *, vision_embeds=None)
                                              -> (last-position logits, cache)
  decode_step(model, cache, tokens)           -> (logits, cache)
  model_axes(cfg), cache_axes(cfg)            -> logical axes of the parameters, the cache

Under a mesh (`repro_torch.distributed.sharding.enter_mesh`) the same code
runs on DTensors laid out by those axes; off a mesh every sharding call is
a no-op (docs/PORT_DISTRIBUTED.md).

Every parameter is trainable; `prefill` and `decode_step` run under
`torch.no_grad`, so serving builds no autograd graph.

Where the JAX package stacks the layers along a leading L dim and scans
them, the port keeps one module per layer in an `nn.ModuleList` and loops;
`repro_torch.convert` unstacks and restacks.  The decode cache keeps the
JAX layout, ``pos`` (B,) int32 beside ``kv``: ``k`` and ``v`` (L, B, C,
n_kv, hd) for the attention families; ``conv`` (L, B, K-1, di) float32 and
``ssm`` (L, B, di, N) float32 for mamba1; ``conv`` (L, B, K-1, di + 2N),
``ssm`` (L, B, h, N, p), both float32, and ``kv`` with one slot per
shared-block invocation for the hybrid; so the serving engine's slot merge
reads as the reference's does.  A decode step writes the new K/V into the
cache it is given, in place (the reference returns a new cache; copying a
cache of a GB every step would cost more than the step); the conv and SSM
states come back as new tensors, the input's left as they were.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    assign,
    einsum,
    layer_slice,
    matmul,
    sharded_zeros,
    with_logical_constraint,
)
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (
    ATTENTION_AXES,
    attention_decode,
    attention_full,
    attention_prefill,
    init_attention,
    init_kv_cache,
    kv_cache_axes,
    place_kv_in_cache,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    EMBED_AXES,
    MLP_AXES,
    RMSNORM_AXES,
    UNEMBED_AXES,
    Params,
    _detach,
    chunked_softmax_xent,
    embed,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    init_unembed,
    mlp,
    rmsnorm,
)
from repro_torch.models.ssm import (
    MAMBA1_AXES,
    MAMBA2_AXES,
    Mamba1,
    Mamba2,
    init_mamba1,
    init_mamba2,
)

# family -> what the port runs of it
PORTED = {fam: ("training", "serving")
          for fam in ("dense", "moe", "mamba1", "mamba2", "hybrid", "vlm", "audio")}


def family(cfg: ModelConfig) -> str:
    """``cfg``'s family as the reference names it; ssm by its mamba version."""
    return f"mamba{cfg.mamba_version}" if cfg.arch_type == "ssm" else cfg.arch_type


def core_kind(cfg: ModelConfig) -> str:
    """The layer code a family runs (model.py:44-53): dense, moe, mamba1 or mamba2."""
    if cfg.arch_type in ("dense", "vlm", "audio"):
        return "dense"
    if cfg.arch_type == "moe":
        return "moe"
    if cfg.arch_type == "ssm":
        return f"mamba{cfg.mamba_version}"
    if cfg.arch_type == "hybrid":
        return "mamba2"
    raise ValueError(cfg.arch_type)


def _require_ported(cfg: ModelConfig, what: str | None = None):
    """Raise unless the port runs ``what`` (training, serving; None: either)."""
    fam = family(cfg)
    runs = PORTED.get(fam, ())
    if not runs or (what is not None and what not in runs):
        ported = ", ".join(f"{k} {' and '.join(v)}" for k, v in PORTED.items())
        raise NotImplementedError(
            f"{cfg.name}: {what or 'the model'} of the {fam!r} family is not ported to "
            f"PyTorch yet; the port runs {ported}"
        )


class Block(nn.Module):
    """One layer, or the hybrid's shared block, under the JAX pytree's keys.

    dense (and vlm, audio): ``norm1``, ``attn``, ``norm2``, ``mlp``; moe:
    ``norm1``, ``attn``, ``norm2``, ``moe``; mamba1 and mamba2: ``norm``
    and the ``mamba`` mixer (`Mamba1` or `Mamba2`); the shared block:
    ``norm1``, ``attn``, ``norm2``, ``mlp``.
    """

    def __init__(self, tree, cfg: ModelConfig):
        super().__init__()
        self.groups = tuple(tree)
        for name, group in tree.items():
            if name == "mamba":
                mixer = Mamba1 if core_kind(cfg) == "mamba1" else Mamba2
                self.add_module(name, mixer(group, cfg))
            else:
                self.add_module(name, Params(group))

    def tree(self, leaf=_detach):
        """The layer's parameters under the JAX pytree's keys."""
        return {name: getattr(self, name).tree(leaf) for name in self.groups}


class LM(nn.Module):
    """The whole model: embedding, the layers (and a hybrid's shared block),
    final norm and unembedding."""

    def __init__(self, tree, cfg: ModelConfig):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        self.layers = nn.ModuleList(Block(t, cfg) for t in tree["layers"])
        for name in ("embed", "unembed", "final_norm"):
            self.add_module(name, Params(tree[name]))
        self.shared_attn = Block(tree["shared_attn"], cfg) if "shared_attn" in tree else None

    def tree(self, leaf=_detach):
        """The parameters under the JAX pytree's keys, ``layers`` a list.

        Each leaf is ``leaf(parameter)``, as in `Params.tree`.
        """
        out = {
            "layers": [layer.tree(leaf) for layer in self.layers],
            **{name: getattr(self, name).tree(leaf)
               for name in ("embed", "unembed", "final_norm")},
        }
        if self.shared_attn is not None:
            out["shared_attn"] = self.shared_attn.tree(leaf)
        return out


def _attn_block(generator, cfg: ModelConfig, ffn: str):
    d = cfg.d_model
    block = {
        "norm1": {"scale": init_rmsnorm(d, generator.device)},
        "attn": init_attention(generator, cfg),
        "norm2": {"scale": init_rmsnorm(d, generator.device)},
    }
    if ffn == "mlp":
        block["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.activation_dtype)
    else:
        block["moe"] = moe_lib.init_moe(generator, cfg)
    return block


def _init_block(generator, cfg: ModelConfig):
    kind = core_kind(cfg)
    if kind in ("dense", "moe"):
        return _attn_block(generator, cfg, "mlp" if kind == "dense" else "moe")
    init_mixer = init_mamba1 if kind == "mamba1" else init_mamba2
    return {"norm": {"scale": init_rmsnorm(cfg.d_model, generator.device)},
            "mamba": init_mixer(generator, cfg)}


def init_model(generator, cfg: ModelConfig) -> LM:
    """A randomly initialised model on ``generator``'s device.

    An audio model has ``embed.embedding`` (K, V, d) and ``unembed.w`` (K,
    d, V), a table and a head a codebook (model.py:144-176); a hybrid with
    ``shared_attn`` has the ``shared_attn`` block (model.py:89-99).
    """
    _require_ported(cfg)
    d, dtype, V = cfg.d_model, cfg.activation_dtype, cfg.vocab
    K = cfg.num_codebooks
    tree = {"layers": [_init_block(generator, cfg) for _ in range(cfg.num_layers)]}
    if K:
        tree["embed"] = {"embedding": torch.stack(
            [init_embedding(generator, V, d, dtype) for _ in range(K)])}
        tree["unembed"] = {"w": torch.stack([init_unembed(generator, d, V, dtype)
                                             for _ in range(K)])}
    else:
        tree["embed"] = {"embedding": init_embedding(generator, V, d, dtype)}
        tree["unembed"] = {"w": init_unembed(generator, d, V, dtype)}
    tree["final_norm"] = {"scale": init_rmsnorm(d, generator.device)}
    if cfg.arch_type == "hybrid" and cfg.shared_attn:
        tree["shared_attn"] = _attn_block(generator, cfg, "mlp")
    return LM(tree, cfg)


def _block_axes(cfg: ModelConfig, kind: str):
    if kind in ("dense", "moe"):
        ffn = {"mlp": MLP_AXES} if kind == "dense" else {"moe": moe_lib.MOE_AXES}
        return {"norm1": RMSNORM_AXES, "attn": ATTENTION_AXES, "norm2": RMSNORM_AXES, **ffn}
    return {"norm": RMSNORM_AXES, "mamba": MAMBA1_AXES if kind == "mamba1" else MAMBA2_AXES}


def model_axes(cfg: ModelConfig):
    """Logical axes of `init_model`'s parameters, keyed as `LM.tree` (model.py:117).

    Leaf for leaf the reference's axes once ``layers`` is unstacked: each
    layer's tuples lack the stacked layer dim's leading None.
    """
    block = _block_axes(cfg, core_kind(cfg))
    out = {"layers": [block] * cfg.num_layers}
    if cfg.num_codebooks:
        out["embed"] = {"embedding": ("codebooks", "vocab", "embed")}
        out["unembed"] = {"w": ("codebooks", "embed", "vocab")}
    else:
        out["embed"], out["unembed"] = EMBED_AXES, UNEMBED_AXES
    out["final_norm"] = RMSNORM_AXES
    if cfg.arch_type == "hybrid" and cfg.shared_attn:
        out["shared_attn"] = _block_axes(cfg, "dense")
    return out


def _embed_tokens(model: LM, tokens, vision_embeds=None):
    """tokens: (B,S) int (audio: (B,S,K)) -> (B,S,d) in the model dtype.

    Audio sums the K codebooks' embeddings, in codebook order; a vlm
    prompt's ``vision_embeds`` (B,V,d), cast to the text's dtype, go ahead
    of the text (model.py:207-226), so its S is V + the text's length.
    Decode embeds text alone.
    """
    cfg = model.cfg
    if cfg.arch_type == "audio":
        tables = model.embed.embedding  # (K, V, d)
        h = embed(tables[0], tokens[..., 0])
        for k in range(1, tables.shape[0]):
            h = h + embed(tables[k], tokens[..., k])
        return h
    h = embed(model.embed.embedding, tokens)
    if vision_embeds is not None:
        h = torch.cat([vision_embeds.to(h.dtype), h], dim=1)
    return h


def _logits(model: LM, h):
    """The final norm and the unembedding: (B,S,V), or (B,S,K,V) with K codebooks."""
    h = rmsnorm(model.final_norm.scale, h)
    if model.cfg.num_codebooks:
        return einsum("bsd,kdv->bskv", h, model.unembed.w)
    return matmul(h, model.unembed.w)


# ---------------------------------------------------------------- training


def _dense_layer(layer: Block, h, positions, cfg: ModelConfig):
    """One dense layer (or the shared block): pre-norm attention, then the
    pre-norm SwiGLU MLP."""
    h = h + attention_full(layer.attn, rmsnorm(layer.norm1.scale, h), positions, cfg)
    return h + mlp(layer.mlp, rmsnorm(layer.norm2.scale, h))


def _moe_layer(layer: Block, h, positions, cfg: ModelConfig):
    """One MoE layer: pre-norm attention, then the pre-norm MoE FFN.

    Returns (h, aux_loss, z_loss).
    """
    h = h + attention_full(layer.attn, rmsnorm(layer.norm1.scale, h), positions, cfg)
    y, aux, z = moe_lib.moe_ffn(layer.moe, rmsnorm(layer.norm2.scale, h), cfg)
    return h + y, aux, z


def _mamba_layer(layer: Block, h, positions, cfg: ModelConfig, shared):
    """One mamba1 or mamba2 layer, then ``shared`` (the hybrid's shared block
    at this layer, or None)."""
    y, _ = layer.mamba(rmsnorm(layer.norm.scale, h))
    h = h + y
    if shared is not None:
        h = _dense_layer(shared, h, positions, cfg)
    return h


def _collective_ops():
    ops = torch.ops._c10d_functional
    return {ops.all_reduce.default, ops.all_gather_into_tensor.default,
            ops.reduce_scatter_tensor.default, ops.all_to_all_single.default,
            ops.wait_tensor.default}


def _keep_collectives():
    """The checkpoint contexts of ``cfg.save_layer_outputs``: a layer's backward
    keeps what its forward's collectives returned, so it re-runs no all-reduce or
    all-gather (the reference saves the post-collective sublayer outputs,
    model.py:235-253).  Off a mesh a layer runs no collective, and this is
    plain remat."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    keep = _collective_ops()

    def policy(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        return CheckpointPolicy.MUST_SAVE if op in keep else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _run_layers_train(model: LM, h):
    """All layers over the whole sequence (model.py:259-322): (h, (aux, z)).

    ``aux`` and ``z`` are the MoE router's losses summed over the layers
    and divided by L (zero in the other families).  A hybrid runs its shared
    block after every ``attn_every``-th layer; its parameters are one set,
    so their gradients sum over the invocations.  With ``cfg.remat`` each
    layer, with the shared block it runs, is one `torch.utils.checkpoint`
    (the reference's `jax.checkpoint` of the scan body): only its input is
    kept, and the backward runs its forward again; with
    ``cfg.save_layer_outputs`` it also keeps the outputs of the layer's
    collectives (`_keep_collectives`).
    """
    cfg = model.cfg
    positions = torch.arange(h.shape[1], device=h.device)
    kind = core_kind(cfg)
    aux = z = torch.zeros((), dtype=torch.float32, device=h.device)

    def run(fn, *args):
        if cfg.remat and cfg.save_layer_outputs:
            return checkpoint(fn, *args, use_reentrant=False, context_fn=_keep_collectives)
        if cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    for idx, layer in enumerate(model.layers):
        if kind == "dense":
            h = run(_dense_layer, layer, h, positions, cfg)
        elif kind == "moe":
            h, a, zl = run(_moe_layer, layer, h, positions, cfg)
            aux, z = aux + a, z + zl
        else:
            runs_shared = (model.shared_attn is not None and cfg.attn_every
                           and (idx + 1) % cfg.attn_every == 0)
            h = run(_mamba_layer, layer, h, positions, cfg,
                    model.shared_attn if runs_shared else None)
        h = with_logical_constraint(h, ("batch", "seq", "embed"))
    L = len(model.layers)
    return h, (aux / L, z / L)


def forward_train(model: LM, batch):
    """Next-token loss (model.py:325-358). Returns (loss, metrics dict).

    batch keys: ``tokens`` and ``labels``, (B,S) int, or (B,S,K) for audio;
    a vlm batch also ``vision_embeds`` (B,V,d), which go ahead of the text,
    and the loss reads the T text predictions from positions V-1 ..
    V+T-2.  An audio model's loss is the mean of its K codebooks' losses,
    each against its own head; an MoE model's adds
    ``router_aux_weight * aux + router_z_weight * z`` and reports both.
    The metric keys are the reference's.
    """
    cfg = model.cfg
    _require_ported(cfg, "training")
    vision = batch["vision_embeds"] if cfg.arch_type == "vlm" else None
    h = _embed_tokens(model, batch["tokens"], vision)
    h = with_logical_constraint(h, ("batch", "seq", "embed"))
    h, (aux, z) = _run_layers_train(model, h)
    h = rmsnorm(model.final_norm.scale, h)
    w, labels = model.unembed.w, batch["labels"]
    if vision is not None:
        V, T = vision.shape[1], labels.shape[1]
        h = h[:, V - 1:V - 1 + T]
    if cfg.num_codebooks:
        losses = [chunked_softmax_xent(h, w[k], labels[..., k].contiguous(), cfg.xent_chunk)
                  for k in range(cfg.num_codebooks)]
        lm_loss = torch.stack(losses).mean()
    else:
        lm_loss = chunked_softmax_xent(h, w, labels, cfg.xent_chunk)
    loss, metrics = lm_loss, {"lm_loss": lm_loss}
    if cfg.arch_type == "moe":
        loss = loss + cfg.router_aux_weight * aux + cfg.router_z_weight * z
        metrics.update(router_aux=aux, router_z=z)
    metrics["loss"] = loss
    return loss, metrics


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS per token = 6 * N, the useful-compute term of the roofline."""
    return 6.0 * cfg.flops_param_count()


# ------------------------------------------------------------------ serving


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """An empty decode cache for ``batch`` streams of up to ``max_len`` tokens.

    The conv and SSM states have no sequence axis; a hybrid's ``kv`` has
    one slot per shared-block invocation (model.py:387-405).
    """
    _require_ported(cfg, "serving")
    axes = cache_axes(cfg)
    cache = {"pos": sharded_zeros((batch,), axes["pos"], dtype=torch.int32, device=device)}
    kind = core_kind(cfg)
    if kind in ("dense", "moe"):
        cache["kv"] = init_kv_cache(cfg, batch, max_len, device)
        return cache
    L, K, di, n = cfg.num_layers, cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "mamba1":
        cache["conv"] = sharded_zeros((L, batch, K - 1, di), axes["conv"], **f32)
        cache["ssm"] = sharded_zeros((L, batch, di, n), axes["ssm"], **f32)
        return cache
    cache["conv"] = sharded_zeros((L, batch, K - 1, di + 2 * n), axes["conv"], **f32)
    cache["ssm"] = sharded_zeros((L, batch, cfg.ssm_heads, n, cfg.ssm_head_dim), axes["ssm"],
                                 **f32)
    if _shared_invocations(cfg):
        cache["kv"] = init_kv_cache(cfg, batch, max_len, device,
                                    n_layers=cfg.num_attn_invocations)
    return cache


def cache_axes(cfg: ModelConfig):
    """Logical axes of `init_cache`'s leaves (model.py:409)."""
    kind = core_kind(cfg)
    axes = {"pos": ("batch",)}
    if kind in ("dense", "moe"):
        axes["kv"] = kv_cache_axes(cfg)
    elif kind == "mamba1":
        axes["conv"] = (None, "batch", None, "dinner")
        axes["ssm"] = (None, "batch", "dinner", None)
    else:
        axes["conv"] = (None, "batch", None, "dinner")
        axes["ssm"] = (None, "batch", None, None, None)
        if _shared_invocations(cfg):
            axes["kv"] = kv_cache_axes(cfg)
    return axes


def _shared_invocations(cfg: ModelConfig) -> int:
    """Invocations of a hybrid's shared block, 0 where there is none."""
    return cfg.num_attn_invocations if cfg.shared_attn else 0


def _shared_slot(cfg: ModelConfig, idx: int):
    """The shared block's invocation after layer ``idx``, or None where it does not run.

    It runs after every ``attn_every`` layers; invocation ``inv`` keeps its
    K/V in cache slot ``inv`` (model.py:482, 499 in decode; 597, 623 in prefill).
    """
    n_inv = _shared_invocations(cfg)
    if not n_inv or (idx + 1) % cfg.attn_every:
        return None
    return min((idx + 1) // cfg.attn_every - 1, n_inv - 1)


def _ffn(layer: Block, h, cfg: ModelConfig):
    """The layer's pre-norm feed-forward: SwiGLU (dense) or the MoE FFN."""
    x = rmsnorm(layer.norm2.scale, h)
    if core_kind(cfg) == "moe":
        return moe_lib.moe_ffn(layer.moe, x, cfg)[0]
    return mlp(layer.mlp, x)


def _attention_prefill(block: Block, h, positions, kv, slot, cfg: ModelConfig):
    """A pre-norm attention layer (or the shared block) over a whole prompt.

    Its K/V go to cache slot ``slot``; returns the residual stream after
    attention and the feed-forward.
    """
    y, k, v = attention_prefill(block.attn, rmsnorm(block.norm1.scale, h), positions, cfg)
    h = h + y
    C = kv["k"].shape[2]
    assign(layer_slice(kv["k"], slot), place_kv_in_cache(k, C))
    assign(layer_slice(kv["v"], slot), place_kv_in_cache(v, C))
    return h + _ffn(block, h, cfg)


def _attention_decode(block: Block, h, kv, slot, pos, cfg: ModelConfig):
    """A pre-norm attention layer (or the shared block) for one token a stream.

    Its new K/V are written into cache slot ``slot`` in place.
    """
    y, _ = attention_decode(block.attn, rmsnorm(block.norm1.scale, h),
                            {"k": layer_slice(kv["k"], slot), "v": layer_slice(kv["v"], slot)},
                            pos, cfg)
    h = h + y
    return h + _ffn(block, h, cfg)


@torch.no_grad()
def prefill(model: LM, tokens, max_len=None, *, vision_embeds=None):
    """Process whole prompts: (last-position logits, cache).

    ``tokens`` (B,T) int, or (B,T,K) for audio; a vlm prompt also takes
    ``vision_embeds`` (B,V,d), which go ahead of the text, so its S is V +
    T (S = T otherwise).  The logits are (B,1,V), audio (B,1,K,V), in the
    model dtype, for the last position only.  An attention model's cache
    holds each layer's K/V laid out for ``max_len`` positions (default S;
    model.py:547-583); a mamba model's cache holds each layer's final conv
    and SSM states and, in a hybrid, each shared-block invocation's K/V
    (model.py:584-647).  ``pos = S``.
    """
    cfg = model.cfg
    _require_ported(cfg, "serving")
    if (vision_embeds is not None) != (cfg.arch_type == "vlm"):
        raise ValueError(f"{cfg.name}: vision_embeds (B, V, d) go with a vlm prompt, and "
                         f"only with one")
    h = with_logical_constraint(_embed_tokens(model, tokens, vision_embeds),
                                ("batch", None, "embed"))
    B, S = h.shape[:2]
    cache = init_cache(cfg, B, max_len or S, h.device)
    positions = torch.arange(S, device=h.device)
    if core_kind(cfg) in ("dense", "moe"):
        for i, layer in enumerate(model.layers):
            h = _attention_prefill(layer, h, positions, cache["kv"], i, cfg)
    else:
        convs, ssms = [], []
        for i, layer in enumerate(model.layers):
            y, (conv_s, ssm_s) = layer.mamba(rmsnorm(layer.norm.scale, h))
            h = h + y
            convs.append(conv_s)
            ssms.append(ssm_s)
            slot = _shared_slot(cfg, i)
            if slot is not None:
                h = _attention_prefill(model.shared_attn, h, positions, cache["kv"], slot, cfg)
        cache["conv"] = torch.stack(convs)
        cache["ssm"] = torch.stack(ssms)
    cache["pos"].fill_(S)
    # the norm is per position, so only the last one is normalised
    return _logits(model, h[:, -1:]), cache


@torch.no_grad()
def decode_step(model: LM, cache, tokens):
    """One token per stream: (logits, new cache).

    ``tokens`` (B,1) int, audio (B,1,K); the logits are (B,1,V), audio
    (B,1,K,V).  ``pos`` advances by one (model.py:523) in a new tensor.
    The new K/V are written into ``cache["kv"]``'s tensors in place and
    returned in the new cache; the conv and SSM states of a mamba model
    come back as new tensors, the input's left as they were.
    """
    cfg = model.cfg
    _require_ported(cfg, "serving")
    h = with_logical_constraint(_embed_tokens(model, tokens), ("batch", None, "embed"))
    pos = cache["pos"]
    new_cache = dict(cache)
    if core_kind(cfg) in ("dense", "moe"):
        for i, layer in enumerate(model.layers):
            h = _attention_decode(layer, h, cache["kv"], i, pos, cfg)
    else:
        convs, ssms = [], []
        for i, layer in enumerate(model.layers):
            y, (conv_s, ssm_s) = layer.mamba.decode(
                rmsnorm(layer.norm.scale, h), layer_slice(cache["conv"], i),
                layer_slice(cache["ssm"], i)
            )
            h = h + y
            convs.append(conv_s)
            ssms.append(ssm_s)
            slot = _shared_slot(cfg, i)
            if slot is not None:
                h = _attention_decode(model.shared_attn, h, cache["kv"], slot, pos, cfg)
        new_cache["conv"] = torch.stack(convs)
        new_cache["ssm"] = torch.stack(ssms)
    new_cache["pos"] = pos + 1
    return _logits(model, h), new_cache
