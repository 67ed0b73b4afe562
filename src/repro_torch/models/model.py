"""LM backbone (counterpart of `repro.models.model`).

`PORTED` says what the port runs of each family: ``dense`` trains and
serves, ``moe`` and ``mamba1`` serve; `_require_ported` is the one gate,
and other families (or another use of these) raise `NotImplementedError`
naming theirs.

  init_model(generator, cfg)                 -> LM (an nn.Module)
  forward_train(model, batch)                -> (loss, metrics), dense
  init_cache(cfg, batch, max_len, device)    -> cache dict
  prefill(model, tokens, max_len=None)       -> (last-position logits, cache)
  decode_step(model, cache, tokens)          -> (logits, cache)

A dense model's parameters are trainable, an moe or mamba1 model's
frozen; `prefill` and `decode_step` run under `torch.no_grad` either way,
so serving builds no autograd graph.

Where the JAX package stacks the layers along a leading L dim and scans
them, the port keeps one module per layer in an `nn.ModuleList` and loops;
`repro_torch.convert` unstacks and restacks.  The decode cache keeps the
JAX layout, ``pos`` (B,) int32 beside ``kv``: ``k`` and ``v`` (L, B, C,
n_kv, hd) for dense and moe, or ``conv`` (L, B, K-1, di) float32 and
``ssm`` (L, B, di, N) float32 for mamba1, so the serving engine's slot
merge reads as the reference's does.  An attention model's decode step
writes the new K/V into the cache it is given, in place (the reference
returns a new cache; copying a cache of a GB every step would cost more
than the step); a mamba1 step leaves its input cache as it was.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (
    attention_decode,
    attention_full,
    attention_prefill,
    init_attention,
    init_kv_cache,
    place_kv_in_cache,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
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
from repro_torch.models.ssm import Mamba1, init_mamba1

# family -> what the port runs of it
PORTED = {"dense": ("training", "serving"), "moe": ("serving",), "mamba1": ("serving",)}


def family(cfg: ModelConfig) -> str:
    """``cfg``'s family as the reference names it; ssm by its mamba version."""
    return f"mamba{cfg.mamba_version}" if cfg.arch_type == "ssm" else cfg.arch_type


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
    """One layer under the JAX pytree's keys.

    dense: ``norm1``, ``attn``, ``norm2``, ``mlp``, trainable; moe:
    ``norm1``, ``attn``, ``norm2``, ``moe``, frozen; mamba1: ``norm`` and
    the ``mamba`` mixer, frozen.
    """

    def __init__(self, tree, cfg: ModelConfig):
        super().__init__()
        self.groups = tuple(tree)
        fam = family(cfg)
        if fam in ("dense", "moe"):
            ffn = "mlp" if fam == "dense" else "moe"
            for name in ("norm1", "attn", "norm2", ffn):
                self.add_module(name, Params(tree[name], trainable=fam == "dense"))
        else:
            self.norm = Params(tree["norm"], trainable=False)
            self.mamba = Mamba1(tree["mamba"], cfg)

    def tree(self, leaf=_detach):
        """The layer's parameters under the JAX pytree's keys."""
        return {name: getattr(self, name).tree(leaf) for name in self.groups}


class LM(nn.Module):
    """The whole model: embedding, the layers, final norm and unembedding."""

    def __init__(self, tree, cfg: ModelConfig):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        trains = "training" in PORTED[family(cfg)]
        self.layers = nn.ModuleList(Block(t, cfg) for t in tree["layers"])
        for name in ("embed", "unembed", "final_norm"):
            self.add_module(name, Params(tree[name], trains))

    def tree(self, leaf=_detach):
        """The parameters under the JAX pytree's keys, ``layers`` a list.

        Each leaf is ``leaf(parameter)``, as in `Params.tree`.
        """
        return {
            "layers": [layer.tree(leaf) for layer in self.layers],
            **{name: getattr(self, name).tree(leaf)
               for name in ("embed", "unembed", "final_norm")},
        }


def _init_block(generator, cfg: ModelConfig):
    d, dev = cfg.d_model, generator.device
    fam = family(cfg)
    if fam in ("dense", "moe"):
        block = {
            "norm1": {"scale": init_rmsnorm(d, dev)},
            "attn": init_attention(generator, cfg),
            "norm2": {"scale": init_rmsnorm(d, dev)},
        }
        if fam == "dense":
            block["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.activation_dtype)
        else:
            block["moe"] = moe_lib.init_moe(generator, cfg)
        return block
    return {"norm": {"scale": init_rmsnorm(d, dev)}, "mamba": init_mamba1(generator, cfg)}


def init_model(generator, cfg: ModelConfig) -> LM:
    """A randomly initialised model on ``generator``'s device."""
    _require_ported(cfg)
    d, dtype = cfg.d_model, cfg.activation_dtype
    dev = generator.device
    tree = {
        "layers": [_init_block(generator, cfg) for _ in range(cfg.num_layers)],
        "embed": {"embedding": init_embedding(generator, cfg.vocab, d, dtype)},
        "final_norm": {"scale": init_rmsnorm(d, dev)},
        "unembed": {"w": init_unembed(generator, d, cfg.vocab, dtype)},
    }
    return LM(tree, cfg)


def _embed_tokens(model: LM, tokens):
    """tokens: (B,S) int -> (B,S,d) in the model dtype."""
    return embed(model.embed.embedding, tokens)


def _logits(model: LM, h):
    return rmsnorm(model.final_norm.scale, h) @ model.unembed.w


# ---------------------------------------------------------------- training


def _dense_layer(layer: Block, h, positions, cfg: ModelConfig):
    """One dense layer: pre-norm attention, then the pre-norm SwiGLU MLP."""
    h = h + attention_full(layer.attn, rmsnorm(layer.norm1.scale, h), positions, cfg)
    return h + mlp(layer.mlp, rmsnorm(layer.norm2.scale, h))


def _run_layers_train(model: LM, h):
    """All layers over the whole sequence (model.py:259-322, dense branch).

    With ``cfg.remat`` each layer is a `torch.utils.checkpoint` (the
    reference's `jax.checkpoint` of the scan body): only its input is kept,
    and the backward runs its forward again.
    """
    cfg = model.cfg
    positions = torch.arange(h.shape[1], device=h.device)
    for layer in model.layers:
        if cfg.remat:
            h = checkpoint(_dense_layer, layer, h, positions, cfg, use_reentrant=False)
        else:
            h = _dense_layer(layer, h, positions, cfg)
    return h


def forward_train(model: LM, batch):
    """Mean next-token loss. batch keys: ``tokens``, ``labels`` (B,S) int.

    Returns (loss, metrics dict).  The dense family only: the reference's
    moe, vlm and audio branches and SSM training are not ported.
    """
    cfg = model.cfg
    _require_ported(cfg, "training")
    h = _embed_tokens(model, batch["tokens"])
    h = _run_layers_train(model, h)
    h = rmsnorm(model.final_norm.scale, h)
    lm_loss = chunked_softmax_xent(h, model.unembed.w, batch["labels"], cfg.xent_chunk)
    return lm_loss, {"lm_loss": lm_loss, "loss": lm_loss}


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS per token = 6 * N, the useful-compute term of the roofline."""
    return 6.0 * cfg.flops_param_count()


# ------------------------------------------------------------------ serving


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """An empty decode cache for ``batch`` streams of up to ``max_len`` tokens.

    A mamba1 cache has no sequence axis and ignores ``max_len``.
    """
    _require_ported(cfg, "serving")
    cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=device)}
    if family(cfg) in ("dense", "moe"):
        cache["kv"] = init_kv_cache(cfg, batch, max_len, device)
        return cache
    L, K, di, n = cfg.num_layers, cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
    cache["conv"] = torch.zeros(L, batch, K - 1, di, dtype=torch.float32, device=device)
    cache["ssm"] = torch.zeros(L, batch, di, n, dtype=torch.float32, device=device)
    return cache


def _ffn(layer: Block, h, cfg: ModelConfig):
    """The layer's pre-norm feed-forward: SwiGLU (dense) or the MoE FFN."""
    x = rmsnorm(layer.norm2.scale, h)
    if family(cfg) == "moe":
        return moe_lib.moe_ffn(layer.moe, x, cfg)[0]
    return mlp(layer.mlp, x)


@torch.no_grad()
def prefill(model: LM, tokens, max_len=None):
    """Process whole prompts ``tokens`` (B,S): (last-position logits, cache).

    The logits are (B,1,V) in the model dtype, for the last position only.
    An attention model's cache holds each layer's K/V laid out for
    ``max_len`` tokens (default S; model.py:547-583); a mamba1 cache holds
    each layer's final conv and SSM states (model.py:641-647).  ``pos = S``.
    """
    cfg = model.cfg
    _require_ported(cfg, "serving")
    B, S = tokens.shape
    h = _embed_tokens(model, tokens)
    cache = init_cache(cfg, B, max_len or S, h.device)
    if family(cfg) in ("dense", "moe"):
        kv = cache["kv"]
        C = kv["k"].shape[2]
        positions = torch.arange(S, device=h.device)
        for i, layer in enumerate(model.layers):
            y, k, v = attention_prefill(layer.attn, rmsnorm(layer.norm1.scale, h), positions, cfg)
            h = h + y
            h = h + _ffn(layer, h, cfg)
            kv["k"][i] = place_kv_in_cache(k, C)
            kv["v"][i] = place_kv_in_cache(v, C)
    else:
        convs, ssms = [], []
        for layer in model.layers:
            y, (conv_s, ssm_s) = layer.mamba(rmsnorm(layer.norm.scale, h))
            h = h + y
            convs.append(conv_s)
            ssms.append(ssm_s)
        cache["conv"] = torch.stack(convs)
        cache["ssm"] = torch.stack(ssms)
    cache["pos"].fill_(S)
    # the norm is per position, so only the last one is normalised
    return _logits(model, h[:, -1:]), cache


@torch.no_grad()
def decode_step(model: LM, cache, tokens):
    """One token per stream. tokens: (B,1) int -> (logits (B,1,V), new cache).

    ``pos`` advances by one (model.py:523) in a new tensor.  An attention
    model writes each layer's new K/V into ``cache["kv"]``'s tensors in
    place and returns them in the new cache; a mamba1 model leaves the
    input cache as it was.
    """
    cfg = model.cfg
    _require_ported(cfg, "serving")
    h = _embed_tokens(model, tokens)
    new_cache = dict(cache)
    if family(cfg) in ("dense", "moe"):
        kv = cache["kv"]
        for i, layer in enumerate(model.layers):
            y, _ = attention_decode(
                layer.attn, rmsnorm(layer.norm1.scale, h),
                {"k": kv["k"][i], "v": kv["v"][i]}, cache["pos"], cfg,
            )
            h = h + y
            h = h + _ffn(layer, h, cfg)
    else:
        convs, ssms = [], []
        for i, layer in enumerate(model.layers):
            y, (conv_s, ssm_s) = layer.mamba.decode(
                rmsnorm(layer.norm.scale, h), cache["conv"][i], cache["ssm"][i]
            )
            h = h + y
            convs.append(conv_s)
            ssms.append(ssm_s)
        new_cache["conv"] = torch.stack(convs)
        new_cache["ssm"] = torch.stack(ssms)
    new_cache["pos"] = cache["pos"] + 1
    return _logits(model, h), new_cache
