"""Model configuration (counterpart of `repro.models.config`).

`ModelConfig` carries the fields that the ported code reads, under the JAX
config's names and defaults; a field joins when code that reads it is
ported.  ``use_pallas`` is not carried over: the port picks a kernel or its
plain version by the device a tensor lies on.  The parameter counts follow
the reference's formulas.  `InputShape` and `INPUT_SHAPES` are the dry
run's four (arch, input shape) shapes (config.py:181-200).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One LM architecture: family, widths, depth and numerics."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim; 0 -> d_ff
    capacity_factor: float = 1.25
    moe_group_size: int = 512  # tokens per dispatch group
    router_aux_weight: float = 0.01  # the load-balance loss's weight in the training loss
    router_z_weight: float = 1e-3  # the router z-loss's

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64  # mamba2 head size
    ssm_chunk: int = 128    # chunk length of mamba2's SSD
    mamba_version: int = 1

    # --- hybrid (zamba2-style shared attention) ---
    attn_every: int = 0  # apply the shared attention block after every N core layers
    shared_attn: bool = False

    # --- attention variants ---
    attn_window: int = 0  # 0 = full causal; >0 = sliding window size
    # window used when constructing the long_500k variant of an attention
    # arch (dense/vlm/audio/hybrid); see launch.steps.shape_config
    long_context_window: int = 8192
    rope_theta: float = 10000.0
    attn_chunk: int = 512  # query rows per block of the attention backward

    # --- multimodal ---
    num_codebooks: int = 0   # audio: EnCodec codebooks
    vision_tokens: int = 0   # vlm: number of patch-embedding tokens prepended

    # --- distribution ---
    sharding: str = "tp"  # "tp" | "fsdp_tp" | "fsdp_tp_sp" (distributed.sharding)
    grad_accum: int = 1  # microbatches per train step (activation memory / k)
    # save post-collective layer outputs under remat so backward does not
    # re-run forward all-reduces (communication-avoiding remat policy): each
    # layer's checkpoint keeps the outputs of the collectives it ran
    save_layer_outputs: bool = False
    # The reference's switch from the scanned full-row attention sweep to
    # the causally-live key blocks (~2x attention FLOP reduction).  It
    # changes nothing in the port: the flash kernel and its plain version
    # already visit only the live (query, key) pairs (kernels/
    # flash_attention/ops.py `_live_pairs`); kept so that hillclimb's
    # overrides apply.
    attn_causal_skip: bool = False
    # flash-decoding-style KV cache sharding: shard the cache's sequence dim
    # over the model axis (softmax combines via two small all-reduces) —
    # the lever for GQA archs whose n_kv < model-axis size, where head
    # sharding can't apply and replicated 32k caches blow past HBM
    shard_kv_seq: bool = False

    # --- numerics / training ---
    dtype: str = "bfloat16"
    remat: bool = True
    xent_chunk: int = 512  # sequence chunk of the loss's backward

    # citation for the assigned config
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.arch_type == "moe" and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def activation_dtype(self) -> torch.dtype:
        """The dtype of activations and of the large weight matrices."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def d_inner(self) -> int:
        """Mamba's expanded width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        """Mamba2's heads: ``d_inner / ssm_head_dim``."""
        return max(1, self.d_inner // self.ssm_head_dim)

    @property
    def num_attn_invocations(self) -> int:
        """Shared-attention invocations in a hybrid stack."""
        if not self.attn_every:
            return 0
        return self.num_layers // self.attn_every

    def _attn_params(self) -> int:
        hd, nq, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        return self.d_model * hd * (nq + 2 * nkv) + nq * hd * self.d_model

    def _shared_block_params(self) -> int:
        """The hybrid's shared block: attention, SwiGLU MLP and two norms."""
        return self._attn_params() + 3 * self.d_model * self.d_ff + 2 * self.d_model

    def param_count(self) -> int:
        """Approximate parameter count, by the JAX config's formula.

        Like the reference, the mamba1 count leaves out ``conv_b`` and
        ``dt_proj_b`` (``2 * d_inner`` per layer), the mamba2 count
        ``conv_b``, ``dt_bias`` and ``norm_scale`` (``d_inner + 2 *
        ssm_state``, ``ssm_heads`` and ``d_inner`` per layer), and no count
        has the final norm's ``d_model`` scales.  The shared block of a
        hybrid counts once; an audio model has a table and a head a codebook.
        """
        d, L, v = self.d_model, self.num_layers, self.vocab
        emb = 2 * v * d * (self.num_codebooks or 1)
        if self.arch_type in ("dense", "vlm", "audio"):
            per_layer = self._attn_params() + 3 * d * self.d_ff + 2 * d
            return int(emb + L * per_layer)
        if self.arch_type == "moe":
            moe = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
            return int(emb + L * (self._attn_params() + moe + 2 * d))
        di, n = self.d_inner, self.ssm_state
        if self.mamba_version == 1:
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
            return int(emb + L * per_layer)
        h = self.ssm_heads
        per_layer = (
            d * (2 * di + 2 * n + h)  # in_proj (z, x, B, C, dt)
            + (di + 2 * n) * self.ssm_conv
            + h + h                   # A_log, D
            + di * d
            + d
        )
        hybrid = self.arch_type == "hybrid" and self.shared_attn
        return int(emb + L * per_layer + (self._shared_block_params() if hybrid else 0))

    def active_param_count(self) -> int:
        """Parameters touched per token (an MoE layer activates top_k of num_experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        d = self.d_model
        moe_active = self.top_k * 3 * d * self.moe_d_ff + d * self.num_experts
        return int(2 * self.vocab * d
                   + self.num_layers * (self._attn_params() + moe_active + 2 * d))

    def flops_param_count(self) -> int:
        """Parameters as counted by 6·N·D: a weight-shared block (zamba2's
        shared attention) counts once per invocation, so that 6·N·D is the
        compute done rather than the parameters stored."""
        n = self.active_param_count()
        if self.arch_type == "hybrid" and self.shared_attn and self.attn_every:
            n += self._shared_block_params() * (self.num_attn_invocations - 1)
        return int(n)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One dry-run input shape: tokens a stream, streams, and the step it feeds."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)


def get_input_shape(name: str) -> InputShape:
    """The `INPUT_SHAPES` entry named ``name``."""
    for s in INPUT_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
