"""LM backbone (counterpart of `repro.models.model`).

`PORTED` says what the port runs of each family: ``dense`` trains,
``mamba1`` serves; `_require_ported` is the one gate, and other families
(or the other use of these two) raise `NotImplementedError` naming theirs.

  init_model(generator, cfg)        -> LM (an nn.Module), dense or mamba1
  forward_train(model, batch)       -> (loss, metrics), dense
  init_cache(cfg, batch, device)    -> cache dict, mamba1
  prefill(model, tokens)            -> (last-position logits, cache), mamba1
  decode_step(model, cache, tokens) -> (logits, new cache), mamba1

A dense model's parameters are trainable, a mamba1 model's frozen;
`prefill` and `decode_step` run under `torch.no_grad` either way, so
serving builds no autograd graph.

Where the JAX package stacks the layers along a leading L dim and scans
them, the port keeps one module per layer in an `nn.ModuleList` and loops;
`repro_torch.convert` unstacks and restacks.  The decode cache keeps the
JAX layout: ``conv`` (L, B, K-1, di) float32, ``ssm`` (L, B, di, N)
float32 and ``pos`` (B,) int32, so the serving engine's slot merge reads
as the reference's does.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attention_full, init_attention
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

PORTED = {"dense": "training", "mamba1": "serving"}  # family -> what the port runs


def family(cfg: ModelConfig) -> str:
    """``cfg``'s family as the reference names it; ssm by its mamba version."""
    return f"mamba{cfg.mamba_version}" if cfg.arch_type == "ssm" else cfg.arch_type


def _require_ported(cfg: ModelConfig, what: str | None = None):
    """Raise unless the port runs ``what`` (training, serving; None: either)."""
    fam = family(cfg)
    runs = PORTED.get(fam)
    if runs is None or what not in (None, runs):
        ported = ", ".join(f"{k} {v}" for k, v in PORTED.items())
        raise NotImplementedError(
            f"{cfg.name}: {what or 'the model'} of the {fam!r} family is not ported to "
            f"PyTorch yet; the port runs {ported}"
        )


class Block(nn.Module):
    """One layer under the JAX pytree's keys.

    dense: ``norm1``, ``attn``, ``norm2``, ``mlp``, trainable; mamba1:
    ``norm`` and the ``mamba`` mixer, frozen.
    """

    def __init__(self, tree, cfg: ModelConfig):
        super().__init__()
        self.groups = tuple(tree)
        if family(cfg) == "dense":
            for name in ("norm1", "attn", "norm2", "mlp"):
                self.add_module(name, Params(tree[name]))
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
        trains = PORTED[family(cfg)] == "training"
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
    if family(cfg) == "dense":
        return {
            "norm1": {"scale": init_rmsnorm(d, dev)},
            "attn": init_attention(generator, cfg),
            "norm2": {"scale": init_rmsnorm(d, dev)},
            "mlp": init_mlp(generator, d, cfg.d_ff, cfg.activation_dtype),
        }
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


def init_cache(cfg: ModelConfig, batch: int, device):
    """An empty decode cache for ``batch`` streams."""
    _require_ported(cfg, "serving")
    L, K, di, n = cfg.num_layers, cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
    return {
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
        "conv": torch.zeros(L, batch, K - 1, di, dtype=torch.float32, device=device),
        "ssm": torch.zeros(L, batch, di, n, dtype=torch.float32, device=device),
    }


@torch.no_grad()
def prefill(model: LM, tokens):
    """Process whole prompts ``tokens`` (B,S): (last-position logits, cache).

    The logits are (B,1,V) in the model dtype, for the last position only;
    the cache holds each layer's final conv and SSM states, and
    ``pos = S`` (model.py:641-647).
    """
    _require_ported(model.cfg, "serving")
    B, S = tokens.shape
    h = _embed_tokens(model, tokens)
    convs, ssms = [], []
    for layer in model.layers:
        y, (conv_s, ssm_s) = layer.mamba(rmsnorm(layer.norm.scale, h))
        h = h + y
        convs.append(conv_s)
        ssms.append(ssm_s)
    # the norm is per position, so only the last one is normalised
    logits = _logits(model, h[:, -1:])
    cache = {
        "pos": torch.full((B,), S, dtype=torch.int32, device=h.device),
        "conv": torch.stack(convs),
        "ssm": torch.stack(ssms),
    }
    return logits, cache


@torch.no_grad()
def decode_step(model: LM, cache, tokens):
    """One token per stream. tokens: (B,1) int -> (logits (B,1,V), new cache).

    The input cache is left as it was; ``pos`` advances by one
    (model.py:523).
    """
    _require_ported(model.cfg, "serving")
    h = _embed_tokens(model, tokens)
    convs, ssms = [], []
    for i, layer in enumerate(model.layers):
        y, (conv_s, ssm_s) = layer.mamba.decode(
            rmsnorm(layer.norm.scale, h), cache["conv"][i], cache["ssm"][i]
        )
        h = h + y
        convs.append(conv_s)
        ssms.append(ssm_s)
    new_cache = dict(cache)
    new_cache["conv"] = torch.stack(convs)
    new_cache["ssm"] = torch.stack(ssms)
    new_cache["pos"] = cache["pos"] + 1
    return _logits(model, h), new_cache
