"""Synthetic LM token pipeline (counterpart of `repro.data.tokens`).

Deterministic synthetic token streams with a Zipfian unigram distribution
plus a learnable bigram structure (token t+1 follows token t through a
fixed permutation, with noise), so a model trained on it shows a falling
loss.  A copy of the reference's numpy code: the same seed and the same
numpy generator give the same batches as `repro.data.tokens.
SyntheticTokenDataset`.  `make_lm_batch` puts a host batch on a device,
or lays it out on a `DeviceMesh` by a batch sharding, as the reference
places it on its mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticTokenDataset:
    """Batches of ``batch_size`` streams of ``seq_len`` next-token pairs."""

    vocab: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    structure: float = 0.8  # prob. that next token follows the bigram rule

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # fixed random permutation defines the bigram rule  t -> perm[t]
        self.perm = rng.permutation(self.vocab)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        self.unigram = probs / probs.sum()

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + 1)
        while True:
            yield self.sample(rng)

    def sample(self, rng: np.random.Generator) -> dict:
        """One batch: ``tokens`` and ``labels`` (batch_size, seq_len) int32."""
        b, s = self.batch_size, self.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=b, p=self.unigram)
        follow = rng.random((b, s)) < self.structure
        noise = rng.choice(self.vocab, size=(b, s), p=self.unigram)
        for t in range(s):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, noise[:, t])
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }


def make_lm_batch(host_batch: dict, sharding=None, device=None):
    """Put a host-side numpy batch on the device, each array a tensor of its dtype.

    Without ``sharding`` each array goes to ``device`` (CUDA by default,
    raising without one; `repro_torch.resolve_device`).  With a
    `repro_torch.distributed.sharding.NamedSharding` each becomes a DTensor
    on the sharding's mesh laid out by its spec (``distribute_tensor``:
    rank 0's copy of the host batch is scattered, each rank keeping its
    shard), as the reference places the batch on its mesh.
    """
    if sharding is None:
        from repro_torch import resolve_device

        device = resolve_device(device)
        return {k: torch.as_tensor(v, device=device) for k, v in host_batch.items()}
    from torch.distributed.tensor import distribute_tensor

    mesh = sharding.mesh
    return {k: distribute_tensor(torch.as_tensor(v, device=mesh.device_type), mesh,
                                 sharding.placements)
            for k, v in host_batch.items()}
