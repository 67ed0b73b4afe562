"""LM backbone for serving (counterpart of `repro.models.model`).

The ``mamba1`` kind of `core_kind` only; other families raise
`NotImplementedError` naming theirs.

  init_model(generator, cfg)        -> LM (an nn.Module)
  init_cache(cfg, batch, device)    -> cache dict
  prefill(model, tokens)            -> (last-position logits, cache)
  decode_step(model, cache, tokens) -> (logits, new cache)

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

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Params,
    embed,
    init_embedding,
    init_rmsnorm,
    init_unembed,
    rmsnorm,
)
from repro_torch.models.ssm import Mamba1, init_mamba1


def core_kind(cfg: ModelConfig) -> str:
    """The per-layer core of ``cfg``'s family, as the reference names it."""
    if cfg.arch_type in ("dense", "vlm", "audio"):
        return "dense"
    if cfg.arch_type == "moe":
        return "moe"
    if cfg.arch_type == "ssm":
        return f"mamba{cfg.mamba_version}"
    if cfg.arch_type == "hybrid":
        return "mamba2"
    raise ValueError(cfg.arch_type)


def _require_ported(cfg: ModelConfig):
    kind = core_kind(cfg)
    if kind != "mamba1":
        raise NotImplementedError(
            f"{cfg.name}: the {kind!r} core ({cfg.arch_type} family) is not ported "
            "to PyTorch yet; the port runs mamba1"
        )


class Block(nn.Module):
    """One core layer: pre-norm and a Mamba1 mixer."""

    def __init__(self, tree, cfg: ModelConfig):
        super().__init__()
        self.norm = Params(tree["norm"])
        self.mamba = Mamba1(tree["mamba"], cfg)

    def tree(self):
        """The layer's parameters under the JAX pytree's keys."""
        return {"norm": self.norm.tree(), "mamba": self.mamba.tree()}


class LM(nn.Module):
    """The whole model: embedding, the layers, final norm and unembedding."""

    def __init__(self, tree, cfg: ModelConfig):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        self.layers = nn.ModuleList(Block(t, cfg) for t in tree["layers"])
        self.embed = Params(tree["embed"])
        self.unembed = Params(tree["unembed"])
        self.final_norm = Params(tree["final_norm"])

    def tree(self):
        """The parameters under the JAX pytree's keys, ``layers`` a list."""
        return {
            "layers": [layer.tree() for layer in self.layers],
            "embed": self.embed.tree(),
            "unembed": self.unembed.tree(),
            "final_norm": self.final_norm.tree(),
        }


def init_model(generator, cfg: ModelConfig) -> LM:
    """A randomly initialised model on ``generator``'s device."""
    _require_ported(cfg)
    d, dtype = cfg.d_model, cfg.activation_dtype
    dev = generator.device
    layers = [
        {"norm": {"scale": init_rmsnorm(d, dev)}, "mamba": init_mamba1(generator, cfg)}
        for _ in range(cfg.num_layers)
    ]
    tree = {
        "layers": layers,
        "embed": {"embedding": init_embedding(generator, cfg.vocab, d, dtype)},
        "unembed": {"w": init_unembed(generator, d, cfg.vocab, dtype)},
        "final_norm": {"scale": init_rmsnorm(d, dev)},
    }
    return LM(tree, cfg)


def _embed_tokens(model: LM, tokens):
    """tokens: (B,S) int -> (B,S,d) in the model dtype."""
    return embed(model.embed.embedding, tokens)


def _unembed_weight(model: LM):
    return model.unembed.w


def _logits(model: LM, h):
    return rmsnorm(model.final_norm.scale, h) @ _unembed_weight(model)


def init_cache(cfg: ModelConfig, batch: int, device):
    """An empty decode cache for ``batch`` streams."""
    _require_ported(cfg)
    L, K, di, n = cfg.num_layers, cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
    return {
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
        "conv": torch.zeros(L, batch, K - 1, di, dtype=torch.float32, device=device),
        "ssm": torch.zeros(L, batch, di, n, dtype=torch.float32, device=device),
    }


def prefill(model: LM, tokens):
    """Process whole prompts ``tokens`` (B,S): (last-position logits, cache).

    The logits are (B,1,V) in the model dtype, for the last position only;
    the cache holds each layer's final conv and SSM states, and
    ``pos = S`` (model.py:641-647).
    """
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


def decode_step(model: LM, cache, tokens):
    """One token per stream. tokens: (B,1) int -> (logits (B,1,V), new cache).

    The input cache is left as it was; ``pos`` advances by one
    (model.py:523).
    """
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
