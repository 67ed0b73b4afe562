"""MusicGen codebook-interleaving utilities (counterpart of `repro.models.audio`).

MusicGen decodes K EnCodec codebooks with a *delay* interleave: codebook k
is shifted right by k steps, so that at generation step t the model
predicts codebook k's token for frame t - k.  `apply_delay_pattern` and
`revert_delay_pattern` are exact inverses over the valid region;
shifted-in slots hold ``pad_id``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def apply_delay_pattern(tokens, pad_id: int):
    """tokens: (B, S, K) -> delayed (B, S, K): codebook k shifted right by k."""
    S, K = tokens.shape[1], tokens.shape[2]
    cols = [F.pad(tokens[:, :S - k, k], (k, 0), value=pad_id) for k in range(K)]
    return torch.stack(cols, dim=-1)


def revert_delay_pattern(tokens, pad_id: int):
    """Inverse of `apply_delay_pattern`; the trailing slots become ``pad_id``."""
    K = tokens.shape[2]
    cols = [F.pad(tokens[:, k:, k], (0, k), value=pad_id) for k in range(K)]
    return torch.stack(cols, dim=-1)
