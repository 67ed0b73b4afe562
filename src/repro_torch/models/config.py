"""Model configuration (counterpart of `repro.models.config`).

`ModelConfig` carries the fields that the ported code reads, under the JAX
config's names and defaults; a field joins when code that reads it is
ported.  ``use_pallas`` is not carried over: the port picks a kernel or its
plain version by the device a tensor lies on.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One LM architecture: family, widths, depth and numerics."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab: int

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1

    # --- numerics ---
    dtype: str = "bfloat16"

    # citation for the assigned config
    source: str = ""

    @property
    def activation_dtype(self) -> torch.dtype:
        """The dtype of activations and of the large weight matrices."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def d_inner(self) -> int:
        """Mamba's expanded width."""
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Approximate parameter count, by the JAX config's formula.

        Like the reference it leaves out ``conv_b`` and ``dt_proj_b``
        (``2 * d_inner`` per layer).  Only the families the port runs are
        counted.
        """
        if (self.arch_type, self.mamba_version) != ("ssm", 1):
            raise NotImplementedError(
                f"param_count: the {self.arch_type!r} family is not ported yet"
            )
        d, L, v = self.d_model, self.num_layers, self.vocab
        di, n = self.d_inner, self.ssm_state
        dt_rank = max(1, d // 16)
        per_layer = (
            d * 2 * di          # in_proj
            + di * self.ssm_conv
            + di * (dt_rank + 2 * n)  # x_proj
            + dt_rank * di      # dt_proj
            + di * n + di       # A_log, D
            + di * d            # out_proj
            + d
        )
        return int(2 * v * d + L * per_layer)
