"""Seeded synthetic token streams, made on the device.

The process of the program's `data.SyntheticTokenDataset`: a stream's
first token is drawn from a Zipf unigram (exponent ``zipf_a``), and each
next token follows a fixed random bigram rule ``t -> perm[t]`` with
probability ``structure``, else is a fresh unigram draw.  Here every
draw comes from one `torch.Generator` on the card, all rows at once.
"""
from __future__ import annotations

import torch


def token_rows(rows: int, length: int, vocab: int, seed: int, device,
               zipf_a: float = 1.2, structure: float = 0.8) -> torch.Tensor:
    """``(rows, length)`` int64 token ids, the same for the same arguments."""
    g = torch.Generator(device).manual_seed(seed)
    perm = torch.randperm(vocab, generator=g, device=device)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    unigram = (ranks ** -zipf_a).float()
    draws = torch.multinomial(unigram, rows * length, replacement=True,
                              generator=g).view(rows, length)
    follow = torch.rand(rows, length, generator=g, device=device) < structure
    toks = torch.empty(rows, length, dtype=torch.int64, device=device)
    toks[:, 0] = draws[:, 0]
    for t in range(1, length):
        toks[:, t] = torch.where(follow[:, t], perm[toks[:, t - 1]], draws[:, t])
    return toks
