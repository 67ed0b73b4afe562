"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It uses the port (``src/repro_torch``)
only, never JAX, and exits non-zero on the first phase that fails:

1. build: compile the CUDA kernels (``recurrent_scan.cu``,
   ``selective_scan.cu``, ``selective_scan_bwd.cu``, ``flash_attention.cu``,
   ``fused_xent.cu``) from the checkout's sources into ``build/kernels/``,
   one nvcc each, in parallel, and print each kernel's registers, shared memory and spills
   from the compiler's ``-Xptxas -v`` report.

rec-IPPO (linear core), the first slice:

2. kernel parity: recurrent_scan against its plain PyTorch versions on the
   card (the sequential ones and `chunked_scan_ref`, the chunked design's
   algebra), forward at 1e-5 and the gradients da/db/dh0 at 1e-4, at the
   training path's shapes (T=128, H=64, B=64 and 256), a ragged one and
   the chunked design's edges (T = 15, 17, 129 around 16-step chunks and
   128-step windows, D = 35), under four reset patterns and resets on the
   first and the last step of every chunk, in both directions;
3. kernel timing at the path's shapes (CUDA events, warm, median): calls
   launched eagerly (``ms``, which the host's cost of a launch bounds from
   below), and the device time of the same calls replayed from a CUDA
   graph (``device_ms``); each with the bound and its share of it;
4. train: rec-IPPO with the linear core on matrix_game at PPOConfig's
   defaults, 256 envs for 256 iterations (2 PPO updates), then a greedy
   evaluation of 32 episodes; the kernel's launch count over that run must
   be what the update's structure predicts;
5. slice parity: one more PPO update from the trained state on the card
   and on the CPU (the plain path), with the same minibatch shuffle.

Falcon-Mamba-7B greedy serving, the second slice:

6. kernel parity: selective_scan against its plain version at the
   prefill shape (4, 2048, 8192, 16), the engine's admission shape
   (1, 64, 8192, 16), a ragged one (3, 37, 200, 16) and the staged
   design's edges (S = 1, 15, 17 around its 16-step stage, di = 130 and
   200, N = 4 and 8 with an odd b * S); float32 inputs at 1e-4, and
   bfloat16 x/B/C (what prefill passes) with the float32 state at 1e-4
   and y at 2e-2;
7. kernel timing at the two path shapes, both rulers as in 3, with the
   bound and their shares of it;
8. launcher: the published config (64 layers, bf16, random weights from a
   seed) serves a batch of 4 prompts of 2048 tokens for 32 tokens; the
   prefill must launch the scan exactly once a layer;
9. engine: the same model behind the continuous-batching engine, 4 slots,
   8 requests of 16-64 prompt tokens, 16 new tokens each;
10. slice parity: full width cut to 2 layers in float32, the same weights
    on the card and on the CPU: prefill logits and caches at 1e-4, then 4
    decode steps on equal tokens; the engine on the card equals
    sequential generation.

InternLM2-1.8B dense LM training, the third slice:

11. kernel parity: flash_attention against its plain version (forward) on
    tests/test_kernels.py's sweep (ragged S 200, window 96, GQA, head_dim
    80, bf16), at the training shape (4, 16/8, 4096, 128) bf16, non-causal
    on a ragged S, and at the bf16 wgmma design's tile edges (S = 127, 129,
    200 around 128-row query tiles, causal and not; windows that start
    inside a 128-key tile); 2e-5 in float32, in bf16 2**-6 of the attention
    of |v| an element and 1e-2 of a query row's norm.  fused_xent against
    its plain version on tests/test_kernels.py's sweep (V = 77, ragged T),
    at the bf16 design's edges (T = 129, V = 255 and 257 around 256-wide
    vocab tiles, d and V that are not multiples of 8), at 1e-4 in float32
    and 2e-2 a token in bf16 (both round the logits to bf16) with 1e-4 a
    token on average, and at the training shape (16,384, 2048, 92,544)
    bf16;
12. kernel timing at the training shapes, with PyTorch's
    scaled_dot_product_attention timed beside flash_attention as a
    yardstick and the cuBLAS product ``x @ w`` beside fused_xent as context
    for its GEMM part (``gemm_ms``; it does not compute the loss); the port
    calls neither;
13. train: the launcher (`repro_torch.launch.train.main`) at the published
    config (24 layers, bf16, remat) for 6 steps of batch 4 x 4096 tokens;
    losses finite, 48 flash_attention launches a step (remat runs each
    layer's forward twice), 1 fused_xent launch and 1 launch of its
    combine kernel (bf16 cuts the vocab into splits); then one more step
    under torch.profiler;
14. slice parity: full width cut to 2 layers in float32, batch 1 x 256,
    the same weights on the card and on the CPU: the loss, every gradient
    and the parameters after one train step at 1e-4.

Feed-forward IPPO and MAPPO, and rec-MAPPO, the sixth slice (the paper's
headline loop):

15. train: ippo on spread, mappo on lbf and rec-MAPPO (linear core) on
    spread at PPOConfig's defaults and the registry's env defaults, 8
    seeds as lanes of one batch x 256 envs x 256 iterations (2 updates a
    lane), a greedy evaluation of 32 episodes a lane every 128 iterations,
    2 runs each: losses (8, 2) and eval returns (8, 2, 32) finite, env
    steps/s (median, min, max), rec-MAPPO's recurrent_scan launches what
    one lane's updates need;
16. the same 8 ippo seeds one run after another: the batched/serial
    ratio;
17. tests/test_onpolicy.py's IPPO milestone on matrix_game (150 updates x
    16 envs): within 10% of 4.994 with at least half the recorded
    improvement;
18. slice parity: one ippo, one mappo and one rec-MAPPO (linear core,
    through recurrent_scan on the card) update of 2 seed lanes x 256 envs
    on spread from the same state on the card and on the CPU: the first
    minibatch's loss and gradients and the params after its step at 1e-4;
19. the MARL launcher (`repro_torch.launch.train_marl.main`), ippo on lbf
    with 8 seeds, on the card.

The replay family (MADQN-fp, VDN, QMIX, MADDPG, MAD4PG), the seventh
slice; no kernel lies on its path:

20. train: vdn on spread, qmix on lbf, madqn-fp on matrix_game and mad4pg
    on continuous spread at the registry's defaults (OffPolicyConfig,
    MaddpgConfig), 8 seed lanes x 256 envs x 256 iterations with a greedy
    evaluation of 32 episodes a lane every 128, 2 runs each, and maddpg on
    continuous spread once: an update every iteration from the one that
    fills the table to min_replay, losses and eval returns finite, env
    steps/s (median, min, max);
21. the same 8 vdn seeds one run after another: the batched/serial ratio;
22. tests/test_system.py's value milestone for vdn (FAST_CFG on
    matrix_game, 3,000 iterations x 8 envs): the last 200 iterations' mean
    reward above the first 200's by 2 and above 3;
23. slice parity: the first replay update of vdn (spread), qmix (lbf) and
    mad4pg (continuous spread), 2 seed lanes x 256 envs, on the card and
    on the CPU with the same sample indices: losses, gradients and the
    params after it at 1e-4; the params after 8 updates are a reading.

The rest of the support matrix (rec-MADQN, DIAL, RIAL; switch_game,
speaker_listener, smax_lite, robot_warehouse), the eighth slice:

24. kernel parity: recurrent_scan against its plain versions (as in 2)
    at the new paths' shapes, H = 64: T = 4 and 8 (rec-MADQN's burn-in
    and suffix) and 6 (DIAL's fused re-run), B = 32 windows and 256 envs
    x 8 lanes, and with the 3 agents of a shared stack folded in (B =
    768 and 6144); its time at rec-MADQN's suffix (T=8, B=768) beside
    its bound;
25. train: rec_madqn (linear core) on spread and dial on switch_game (2
    runs each), rec_madqn (GRU, per-agent stacks) on speaker_listener,
    rial and the fused no-channel dial (linear core) on switch_game, vdn
    on smax_lite and ippo on robot_warehouse, at the registry's
    defaults, 8 seed lanes x 256 envs x 256 iterations with a greedy
    evaluation of 32 episodes a lane every 128: updates a lane from the
    dataset's fill, losses and eval returns finite, env steps/s (median,
    min, max), the last greedy team return, and recurrent_scan launched
    5 times a rec-MADQN update and 3 times a fused DIAL update;
26. slice parity: the first update of rec-MADQN (linear core, through
    the kernel) on spread and of DIAL on switch_game, 2 seed lanes x 256
    envs, on the card and on the CPU with the same window indices and
    DRU noise: loss, gradients and params after it at 1e-4;
27. the reference's milestones on the card at their own configs:
    tests/test_seq_replay.py:279 (rec-MADQN, climbing game, 5,000
    iterations x 8 envs), tests/test_marl_modules.py:98 and :105 (DIAL
    not diverging over 60 updates, RIAL improving over 120).

The distributed runners (the async actor/learner runner with V-trace, and
the sharded runner on torch.distributed), the ninth slice; recurrent_scan
lies on rec-IPPO's updates under them and on V-trace's actor re-run:

28. train: the async runner on ippo/spread at PPOConfig's defaults (a
    chunk is one 128-step rollout) at 1, 2 and 4 actors of 256 envs x 256
    iterations each (3 runs at 4 actors), beside anakin on the same config
    before and after: env steps/s, updates, queue depth, staleness,
    dropped chunks; rec-IPPO (linear core, matrix_game) through it at 2
    actors, without V-trace and with it at param_sync_every 2, its
    recurrent_scan launches what its updates' unrolls need (130 and 132
    an update); vdn/spread at 2 actors, unroll 8; V-trace ippo at
    param_sync_every 4 with its staleness trace 0, 1, 2, 3, 0, ...;
29. pins: at one actor, a sync every tick and anakin's cadence the async
    run equals anakin on the card (ippo, rec-IPPO linear, vdn at unroll
    1; max difference held at 1e-5); a V-trace ippo update with stale
    behaviour log-probs on the card vs the CPU (held as in 18);
30. the sharded runner at one rank on NCCL (ippo/spread, madqn/
    matrix_game, each run twice in one spawned rank, beside anakin), two
    gloo ranks sharing cuda:0 (Adam moments equal bitwise, each rank's
    own params), and the MARL launcher's --runner async on the card.

Telemetry, run records and the train -> checkpoint -> serve / eval
workflow, the tenth slice; recurrent_scan lies on rec-IPPO's updates in
its training runs, not on the served tick (a memory core's ``step``):

31. train: ippo and rec-IPPO (linear core) on matrix_game, and ippo on
    spread, through the launcher (`repro_torch.launch.train_marl.main`)
    at serve_marl's defaults (512 iterations x 8 envs, the smoke
    operating point) with --log-every, --log-dir, --run-id, --profile and
    --save-checkpoint: the run record's sections, its provenance naming
    the card and its power limit, the profiler's trace of one update
    cycle written, the streamed rows, rec-IPPO's recurrent_scan launches
    over the call what its updates need (the run's, the two profiled
    update cycles', the phase timing's), and `roofline_summary` counting
    the kernel's calls and bytes of one update;
32. taps: ippo/spread and rec-IPPO (linear)/matrix_game at 8 seed lanes x
    256 envs x 64 iterations, the tap every 16 iterations on and off, in
    turns: params, optimizer state and metrics equal bitwise; the tap's
    cost in wall time;
33. serve: each checkpoint restored and served at 2 and 8 slots to 8
    streams x 4 episodes at 0.2 requests a tick: p50 / p99 ms a decision,
    decisions/s, mean return; the device's idle share over 32 ticks of a
    full pool from torch.profiler; greedy served returns equal the
    evaluator's for its resets; the first 64 ticks' actions (2 slots) on
    the card equal the CPU's but for near ties (top-two CPU logits within
    1e-5), counted; ippo/spread at 256 slots to 256 streams, the same;
34. sweep: `repro_torch.launch.eval_marl` on ippo, vdn, rec_ippo and
    maddpg x matrix_game and spread, 2 seeds, 8 training iterations, into
    results/port/: all 8 cells, maddpg x matrix_game with the registry's
    reason.

Dense and MoE serving (Granite-8B, OLMoE-1B-7B, Minitron-8B), the
eleventh slice; flash_attention lies on every prefill and every engine
admission (its new shapes join 11's parity: Granite's 32/8 heads at S =
16, 37, 64 and 2048, OLMoE's 16/16 at 50):

35. launcher: Granite-8B and OLMoE-1B-7B at their published configs (36
    and 16 layers, bf16, random weights from a seed), batch 4 x prompt
    2048, 32 tokens; Minitron-8B (its 256k vocab) at batch 1 x 512, 8
    tokens: prefill and decode walls beside their bounds, tok/s, peak
    memory, flash_attention launched once a layer by the prefill and never
    by decode; OLMoE's routed assignments dropped over capacity at prefill
    and at decode (a recorded run, untimed);
36. engine: Granite-8B behind the continuous-batching engine, 4 slots, 8
    requests of 16-64 prompt tokens x 16 new tokens, one flash launch a
    layer an admission;
37. slice parity: Granite-8B's full width cut to 2 layers in float32, the
    same weights on the card and the CPU: prefill logits and the KV cache
    at 1e-4, then 4 decode steps on equal tokens; the engine on the card
    equals sequential generation;
38. kernel timing: flash_attention at Granite's prefill shape (4, 32/8,
    2048, 128) bf16 causal, beside SDPA and its bound.

The hybrid, vlm and audio families (Zamba2-2.7B, LLaVA-NeXT-Mistral-7B,
MusicGen-Large), the twelfth slice; flash_attention lies on every prefill
and every engine admission, Zamba2's head_dim 80 on the kernel's WMMA
instance (its new shapes join 11's parity: Zamba2's 32/32 heads at hd 80,
window 4096, at S = 16, 37, 64 and 4 x 2048, and a window of 1024 inside
S = 2048; MusicGen's 32/32 at hd 64, 4 x 2048; LLaVA's 32/8 at 4 x 4096
and at a ragged 2,917):

39. launcher: the three published configs (54, 32 and 48 layers, bf16,
    random weights from a seed): Zamba2 at batch 4 x prompt 2048, LLaVA
    at batch 4 x 4096 positions (2,880 vision embeddings + 1,216 text
    tokens), MusicGen at batch 4 x 2048 frames of 4 codebooks, 32 tokens
    each: prefill and decode walls beside their bounds, tok/s, peak
    memory, flash_attention launched 9 (Zamba2's shared-block
    invocations), 32 and 48 times by the prefill and never by decode;
    parameters = the config's count plus what the reference's formula
    leaves out;
40. engine: Zamba2-2.7B behind the continuous-batching engine, 4 slots,
    8 requests of 16-64 prompt tokens x 16 new tokens, 9 flash launches
    an admission;
41. slice parity: each family at full width in float32 (Zamba2 cut to 4
    layers with the shared block after every 2, a prompt of 300 over 3
    SSD chunks; LLaVA and MusicGen to 2 layers, LLaVA's vision tokens to
    64), the same weights on the card and the CPU: prefill logits and
    every cache leaf at 1e-4, then 4 decode steps on equal tokens;
    Zamba2's engine on the card equals sequential generation;
42. kernel timing: flash_attention at the three new prefill shapes, bf16
    causal, beside its plain version, SDPA and its bound.

The throughput benchmark and the paper-figure harness, the thirteenth
slice; recurrent_scan lies on the fused_recurrent rung (rec-IPPO with the
linear core), no other rung runs it:

43. bench: `repro_torch.bench.run_bench` for ippo and rec_ippo on
    matrix_game at 256 envs and the launcher's smoke operating point, cut
    in run length only (64 iterations, 2 seeds, 1 loop episode): every
    rung's steps/s, each best-of rung's three repeats, the shard_map
    rung's warm rank loop beside its call's wall (one NCCL rank);
44. the document passes the port's `check_speed_schema` (and its file
    `validate_path`), with a fused_recurrent block on rec_ippo and none
    on ippo, and async_actors at 1 / 2 / 4;
45. recurrent_scan launched over the bench what the fused rung's updates
    need (a warm and 3 timed calls of iterations / rollout updates, each
    a bootstrap unroll an agent and an actor and a critic unroll an agent
    a minibatch, forward and backward), the rest of the phase adding
    none;
46. the figure harness: ``repro_torch.benchmarks.run --fast --only
    speedup`` (MADQN on spread: the Block-1 loop, anakin at 1 / 16 / 64
    envs, the eval loop against the batched evaluator, 4 seed lanes).

Training of the moe, mamba1, hybrid, vlm and audio families (OLMoE-1B-7B,
Falcon-Mamba-7B, Zamba2-2.7B, LLaVA-NeXT-Mistral-7B, MusicGen-Large), the
fourteenth slice; selective_scan (forward) and its new backward kernel lie
on every Falcon-Mamba step, flash_attention on every attention layer and
shared-block invocation, fused_xent on every loss (MusicGen: one a
codebook):

47. kernel parity: selective_scan_bwd against autograd of the plain
    version with a nonzero h_final cotangent, at (2, 256, 1024, N) for N =
    4, 8, 16, at S = 250 and 37 (not multiples of its 16-step chunk, di =
    200 not one of its 32-lane block), float32 and bf16, and at (1, 512,
    8192, 16) against `selective_scan_chunked`'s autograd: float32
    gradients at 1e-4, bf16 at 2e-2; its time at Falcon-Mamba's training
    shape (4, 2048, 8192, 16) bf16, both rulers as in 3, beside the plain
    version and its bound;
48. train: each family at its published width through
    `repro_torch.launch.train.train`, bf16, remat, 3 steps of batch 4 x
    2048 tokens (LLaVA: 2,880 vision embeddings + 1,216 text tokens;
    MusicGen: 2048 frames of 4 codebooks), depth cut where 80 GB forces it
    (OLMoE 8 of 16 layers, Falcon-Mamba 32 of 64, LLaVA 16 of 32; Zamba2's
    54 and MusicGen's 48 whole): losses finite, every parameter changed,
    selective_scan launched twice a mamba1 layer a step and its backward
    once, flash_attention twice an attention layer or shared-block
    invocation a step, fused_xent once a step (MusicGen 4 times), every
    parameter finite (Zamba2's SSD gradient at full width among them); step
    walls, positions/s, peak memory;
49. slice parity: each family at full width cut to 2 layers (Zamba2 with
    its shared block after the second; LLaVA with 64 vision embeddings),
    float32, batch 1 x 256, one train step on the card and on the CPU: the
    metrics and every parameter after it at 1e-4;
50. checkpoints: `launch.train.main --smoke --ckpt-dir --ckpt-every 1` for
    every arch of ``ARCH_IDS``, 2 steps: the last checkpoint restores to
    the model's parameters exactly.

Lines before the last: the card's name and power limit, and one JSON
object listing the kernels.  The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12  # the same sheet: float32 outside the tensor cores
# exponentials: 16 SFU results per clock per SM, 132 SMs, 1.98 GHz boost
SFU_EXP_PER_S = 16 * 132 * 1.98e9
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
SLICE_TOL = 1e-4  # an update on the card vs the CPU: other sum orders
PATH_SHAPES = [(128, 64, 64), (128, 256, 64)]  # (T, B, H): minibatch and bootstrap unrolls
RAGGED = (33, 5, 7)  # D = 35: not a multiple of 32 (a warp) or of the block
# the chunked design's edges: T around its 16-step chunks and 128-step windows
SCAN_EDGE_SHAPES = [(15, 5, 7), (17, 5, 7), (129, 5, 7)]
PATTERNS = ["none", "all", "mid_window", "random", "chunk_first", "chunk_last"]

ARCH = "falcon-mamba-7b"
SCAN_TOL = 1e-4  # docs/KERNELS.md's selective-scan pin: float32 y, and the float32 state
SCAN_BF16_Y_TOL = 2e-2  # y rounded to bf16: one bf16 step is 2**-8 relative
SCAN_PATH_SHAPES = [(4, 2048, 8192, 16), (1, 64, 8192, 16)]  # (b, S, di, N): prefill, admission
SCAN_RAGGED = (3, 37, 200, 16)  # S not a chunk multiple, di not a block multiple
# the staged design's edges: S = 1 and around its 16-step stage, di not a
# multiple of a block's lanes, N = 4 and 8 with an odd b * S
SCAN_EDGES = [(1, 1, 200, 16), (3, 15, 130, 16), (3, 17, 200, 16), (3, 17, 130, 8),
              (1, 15, 200, 8), (3, 15, 200, 4), (1, 17, 130, 4)]
LM_TOL = 1e-4  # 2 layers at full width in float32: other sum orders on the card

DENSE_ARCH = "internlm2-1.8b"
BF16_FLOPS_PER_S = 989e12  # the same sheet: dense bf16 on the tensor cores
# flash_attention and fused_xent: the tolerances and their reasons are in
# each kernel's ref.py (`kernel_errors`)
# (B, Hq, Hkv, S, hd, causal, window, dtype): tests/test_kernels.py:19-27, the
# training shape, non-causal calls on a ragged S, and the bf16 wgmma design's
# edges (128-row query tiles, 128-key tiles, windows starting inside a tile)
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, 0, torch.float32),
    (1, 4, 4, 128, 32, True, 0, torch.float32),
    (2, 8, 2, 200, 64, True, 0, torch.float32),
    (1, 4, 1, 256, 64, True, 96, torch.float32),
    (1, 2, 2, 128, 128, True, 0, torch.bfloat16),
    (1, 6, 3, 160, 80, True, 64, torch.float32),
    (1, 6, 3, 160, 80, True, 64, torch.bfloat16),
    (4, 16, 8, 4096, 128, True, 0, torch.bfloat16),
    (1, 4, 2, 200, 64, False, 0, torch.float32),
    (1, 4, 2, 200, 64, False, 0, torch.bfloat16),
    (1, 4, 2, 200, 64, False, 50, torch.float32),
    (1, 4, 2, 127, 128, True, 0, torch.bfloat16),
    (1, 4, 2, 127, 128, False, 0, torch.bfloat16),
    (1, 4, 2, 129, 128, True, 0, torch.bfloat16),
    (1, 4, 2, 129, 64, False, 0, torch.bfloat16),
    (2, 8, 2, 200, 128, True, 0, torch.bfloat16),
    (1, 4, 2, 200, 128, False, 0, torch.bfloat16),
    (1, 2, 1, 300, 128, True, 70, torch.bfloat16),
    (1, 2, 2, 384, 64, True, 200, torch.bfloat16),
    # the attention serving path: Granite's 32/8 heads (n_rep 4) at the engine's short
    # prompts (under one 128-row query tile) and the launcher's 2048, OLMoE's 16/16;
    # then every launcher prefill as it runs: Granite's and OLMoE's at batch 4 x 2048,
    # Minitron's at 1 x 512
    *[(1, 32, 8, S, 128, True, 0, torch.bfloat16) for S in (16, 37, 64, 2048)],
    (1, 16, 16, 50, 128, True, 0, torch.bfloat16),
    (4, 32, 8, 2048, 128, True, 0, torch.bfloat16),
    (4, 16, 16, 2048, 128, True, 0, torch.bfloat16),
    (1, 32, 8, 512, 128, True, 0, torch.bfloat16),
    # slice 12: Zamba2's shared block (32/32 heads, hd 80: the WMMA instance; window
    # 4096) at the engine's short prompts and the launcher's 4 x 2048, and a window of
    # 1024 inside S = 2048; MusicGen's 32/32 at hd 64; LLaVA's 32/8 at 4 x 4096 and a
    # ragged S (2,880 vision + 37 text positions, not a multiple of a tile)
    *[(1, 32, 32, S, 80, True, 4096, torch.bfloat16) for S in (16, 37, 64)],
    (4, 32, 32, 2048, 80, True, 4096, torch.bfloat16),
    (1, 32, 32, 2048, 80, True, 1024, torch.bfloat16),
    (4, 32, 32, 2048, 64, True, 0, torch.bfloat16),
    (4, 32, 8, 4096, 128, True, 0, torch.bfloat16),
    (1, 32, 8, 2917, 128, True, 0, torch.bfloat16),
]
FLASH_PATH = (4, 16, 8, 4096, 128)  # InternLM2-1.8B at batch 4 x 4096
FLASH_SERVE_PATH = (4, 32, 8, 2048, 128)  # Granite-8B's prefill at batch 4 x 2048
# (T, d, V): tests/test_kernels.py:93-98, then the bf16 design's edges
XENT_CASES = [(64, 128, 1000), (100, 64, 512), (128, 32, 2048), (32, 16, 77),
              (129, 64, 255), (129, 128, 257), (64, 40, 1001)]
XENT_PATH = (16384, 2048, 92544)  # (B*S, d_model, vocab)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 4096

# the paper's headline loop: seed-batched Anakin training at PPOConfig's
# defaults with interleaved greedy evaluation (2 updates and 2 evaluations
# of 32 episodes a lane), on the registry's env defaults
MARL_SEEDS, MARL_ENVS, MARL_ITERATIONS, MARL_EVAL_EVERY, MARL_EPISODES = 8, 256, 256, 128, 32
MARL_RUNS = [("ippo", "spread", {}), ("mappo", "lbf", {}),
             ("rec_mappo", "spread", {"recurrent_core": "linear"})]
# 3 runs each until the distributed phase came (PR 19): 2 keep the whole run near ~430 s
MARL_REPEATS = REPLAY_REPEATS = 2
# rec-MAPPO's unrolls with the seed lanes folded into the kernel's D axis:
# (T, lanes x 64 envs, H) a minibatch and (T, lanes x 256 envs, H) the bootstrap
MARL_PATH_SHAPES = [(128, MARL_SEEDS * MARL_ENVS // 4, 64), (128, MARL_SEEDS * MARL_ENVS, 64)]
SEED_IPPO_FIRST15, SEED_IPPO_LAST15 = 2.281, 4.994  # tests/test_onpolicy.py:18-19
# the replay family at the registry's defaults (OffPolicyConfig, MaddpgConfig), 8 seed
# lanes x 256 envs x 256 iterations like the MARL phase; maddpg runs once beside them
REPLAY_RUNS = [("vdn", "spread"), ("qmix", "lbf"), ("madqn-fp", "matrix_game"),
               ("mad4pg", "spread")]
REPLAY_PARITY = [("vdn", "spread"), ("qmix", "lbf"), ("mad4pg", "spread")]
# tests/test_system.py:13-20, FAST_CFG
REPLAY_MILESTONE_CFG = dict(buffer_capacity=5_000, min_replay=100, batch_size=32,
                            eps_decay_steps=2_000, target_update_period=50, learning_rate=1e-3)
# the rest of the support matrix (rec-MADQN, DIAL, RIAL; switch_game, speaker_listener,
# smax_lite, robot_warehouse) at the registry's defaults, 8 seed lanes x 256 envs x 256
# iterations like the MARL phase: (label, system, env, config overrides, runs)
MATRIX_RUNS = [
    ("rec_madqn linear", "rec_madqn", "spread", {"recurrent_core": "linear"}, 2),
    ("rec_madqn gru", "rec_madqn", "speaker_listener", {}, 1),
    ("dial", "dial", "switch_game", {}, 2),
    ("rial", "rial", "switch_game", {}, 1),
    ("dial fused", "dial", "switch_game", {"use_comm": False, "recurrent_core": "linear"}, 1),
    ("vdn", "vdn", "smax_lite", {}, 1),
    ("ippo", "ippo", "robot_warehouse", {}, 1),
]
# recurrent_scan on those paths, H = 64: rec-MADQN's burn-in (T=4) and suffix (T=8) over
# 32 windows x 8 lanes (x 3 agents, who share one stack: 768), DIAL's fused re-run (T=6)
# over 256 envs x 8 lanes (x 3 agents: 6144)
MATRIX_SCAN_SHAPES = [(T, B, 64) for T in (4, 8, 6) for B in (32 * MARL_SEEDS,
                                                               MARL_ENVS * MARL_SEEDS)]
MATRIX_SCAN_SHAPES += [(4, 3 * 32 * MARL_SEEDS, 64), (8, 3 * 32 * MARL_SEEDS, 64),
                       (6, 3 * MARL_ENVS * MARL_SEEDS, 64)]
REC_MADQN_SUFFIX = (8, 3 * 32 * MARL_SEEDS, 64)  # the shape its kernel time is read at
# tests/test_seq_replay.py:279-296, the rec-MADQN milestone's config (climbing game)
REC_MADQN_MILESTONE_CFG = dict(hidden_sizes=(32,), learning_rate=1e-3, seq_len=5, burn_in=2,
                               buffer_capacity=1024, batch_size=32, min_windows=64,
                               eps_decay_steps=3000, target_update_period=100)
# the distributed runners: the async actor/learner runner on ippo/spread at PPOConfig's
# defaults (a chunk is one 128-step rollout) at 1 / 2 / 4 actors, each actor stepping 256
# envs for 256 iterations (3 runs at 4 actors), beside anakin on the same config; the
# sharded runner at one rank on NCCL
ASYNC_ENVS, ASYNC_ITERATIONS, ASYNC_ACTORS, ASYNC_REPEATS = 256, 256, (1, 2, 4), 3
VTRACE_CLIPS = dict(use_vtrace=True, vtrace_clip_rho=0.9, vtrace_clip_c=0.8)
# the staleness-0 pins' small configs (tests/test_torch_async.py)
PIN_PPO = dict(hidden_sizes=(32, 32), rollout_len=8, epochs=1, num_minibatches=2)
PIN_VDN = dict(hidden_sizes=(32, 32), batch_size=32, buffer_capacity=5_000, min_replay=64)
PIN_TOL = 1e-5
SHARDED_RUNS = [("ippo", "spread"), ("madqn", "matrix_game")]
# slice 10, at serve_marl's defaults: train-then-serve checkpoints of 512 iterations x 8
# envs at the smoke operating point on matrix_game, served at 2 and 8 slots to 8 streams
# x 4 episodes at 0.2 requests a tick a stream, greedy; ippo on spread at 256 slots (the
# runners' env count) to 256 streams; the first 64 ticks held card vs CPU; the taps
# on/off runs at 8 lanes x 256 envs x 64 iterations; the sweep at 2 seeds x 8 iterations
SERVE_ROOT = "results/port/chip_smoke"  # git-ignored
SERVE_TRAIN_ITERATIONS, SERVE_TRAIN_ENVS, SERVE_LOG_EVERY = 512, 8, 64
SERVE_SLOTS, SERVE_STREAMS, SERVE_EPISODES, SERVE_RATE = (2, 8), 8, 4, 0.2
WIDE_SLOTS, PARITY_TICKS, NEAR_TIE = 256, 64, 1e-5
TAP_SEEDS, TAP_ENVS, TAP_ITERATIONS, TAP_EVERY = 8, 256, 64, 16
SWEEP_SYSTEMS, SWEEP_ENVS = ("ippo", "vdn", "rec_ippo", "maddpg"), ("matrix_game", "spread")
# slice 11, attention serving at the published configs, random weights from a seed:
# (arch, batch, prompt, tokens) through the launcher; the engine at Granite-8B with 4
# slots and 8 requests of 16-64 prompt tokens x 16; card vs CPU at Granite's full width
# cut to 2 layers in float32
ATTN_SERVE = [("granite-8b", 4, 2048, 32), ("olmoe-1b-7b", 4, 2048, 32), ("minitron-8b", 1, 512, 8)]
ATTN_ENGINE_ARCH = "granite-8b"
# slice 12, the hybrid, vlm and audio families at their published configs, random weights
# from a seed: (arch, batch, prompt positions, tokens) through the launcher (LLaVA's 4096
# are its 2,880 vision embeddings + 1,216 text tokens; MusicGen's 2048 frames of 4
# codebooks); the engine at Zamba2-2.7B; card vs CPU at full width, cut as below, float32
FAMILY_SERVE = [("zamba2-2.7b", 4, 2048, 32), ("llava-next-mistral-7b", 4, 4096, 32),
                ("musicgen-large", 4, 2048, 32)]
FAMILY_ENGINE_ARCH = "zamba2-2.7b"
# (config changes, prompt length): Zamba2's 300 runs 3 SSD chunks of 128 (the last
# padded); LLaVA's 40 text tokens follow 64 vision embeddings
FAMILY_PARITY = {"zamba2-2.7b": (dict(num_layers=4, attn_every=2), 300),
                 "llava-next-mistral-7b": (dict(num_layers=2, vision_tokens=64), 104),
                 "musicgen-large": (dict(num_layers=2), 40)}
# the three prefills as flash runs them: (B, Hq, Hkv, S, hd, window)
FLASH_FAMILY_PATHS = [(4, 32, 32, 2048, 80, 4096), (4, 32, 8, 4096, 128, 0),
                      (4, 32, 32, 2048, 64, 0)]
# slice 13, the throughput benchmark at 256 envs and bench_marl's smoke operating point,
# cut in run length to fit its ~150 s: iterations (bench_marl's 256; a multiple of the
# smoke rollout of 32, the async unroll), seeds (8) and loop episodes (3)
BENCH_SYSTEMS, BENCH_ENV, BENCH_ENVS = ("ippo", "rec_ippo"), "matrix_game", 256
BENCH_ITERATIONS, BENCH_SEEDS, BENCH_LOOP_EPISODES = 64, 2, 1
BENCH_OUT = "results/port/chip_smoke/BENCH_speed.json"  # git-ignored
# slice 14, training of the moe, mamba1, hybrid, vlm and audio families.  The selective
# scan's backward kernel against autograd of its plain version: (b, S, di, N) at N = 4,
# 8, 16; S not a multiple of its 16-step chunk (250, 37) with di not a multiple of its
# 32-lane block; and Falcon-Mamba's full di against `selective_scan_chunked`'s autograd,
# where a step-by-step graph of the plain version would not pay; every case with a
# nonzero h_final cotangent
SCAN_BWD_SHAPES = [(2, 256, 1024, 4), (2, 256, 1024, 8), (2, 256, 1024, 16),
                   (2, 250, 1024, 16), (3, 37, 200, 8)]
SCAN_BWD_CHUNKED = (1, 512, 8192, 16)
SCAN_BWD_PATH = (4, 2048, 8192, 16)  # Falcon-Mamba's training shape, timed in bf16
SCAN_BWD_BF16_TOL = 2e-2  # bf16 x/B/C/dy: dx, dB and dC are rounded to bf16
# (arch, config changes, text tokens a sequence) at the published widths, bf16, batch 4
# x 3 steps through `launch.train.train`; depth cut where 80 GB forces it, at ~10
# bytes a parameter of training state (bf16 params, grads and first moments, float32
# second moments) plus activations: OLMoE 8 of 16 layers, Falcon-Mamba 32 of 64,
# LLaVA-NeXT 16 of 32 (2,880 vision + 1,216 text = 4,096 positions); Zamba2 and
# MusicGen (4 codebooks) whole
FAMILY_TRAIN = [("olmoe-1b-7b", dict(num_layers=8), 2048),
                ("falcon-mamba-7b", dict(num_layers=32), 2048),
                ("zamba2-2.7b", {}, 2048),
                ("llava-next-mistral-7b", dict(num_layers=16), 1216),
                ("musicgen-large", {}, 2048)]
FAMILY_TRAIN_STEPS, FAMILY_TRAIN_BATCH = 3, 4
# card vs CPU, float32, batch 1 x 256 text tokens, one train step: full width cut to 2
# layers (Zamba2: one shared-block invocation; LLaVA: 64 vision embeddings)
FAMILY_TRAIN_PARITY = {"olmoe-1b-7b": dict(num_layers=2),
                       "falcon-mamba-7b": dict(num_layers=2),
                       "zamba2-2.7b": dict(num_layers=2, attn_every=2),
                       "llava-next-mistral-7b": dict(num_layers=2, vision_tokens=64),
                       "musicgen-large": dict(num_layers=2)}
LM_CKPT_ROOT = "results/port/chip_smoke/lm_ckpt"  # git-ignored


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a kernel from its mangled name, for the build report."""
    import re

    # walk the nested name's <length><identifier> parts: _ZN <parts> ...
    pos = 3 if mangled.startswith("_ZN") else 2
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + m.end()
        pos = start + int(m.group())
        name = mangled[start:pos]
        if not name.endswith("_kernel"):
            continue
        if not mangled.startswith("I", pos):
            return name
        # template arguments: int and bool literals, float, named types
        args, pos = [], pos + 1
        while not mangled.startswith("E", pos):
            if m := re.match(r"L([ib])(\d+)E", mangled[pos:]):
                kind, value = m.groups()
                args.append(value if kind == "i" else ("false", "true")[int(value)])
                pos += m.end()
            elif m := re.match(r"\d+", mangled[pos:]):
                pos += m.end() + int(m.group())
                args.append(mangled[pos - int(m.group()):pos])
            elif mangled.startswith("f", pos):
                args.append("float")
                pos += 1
            else:
                return name
        return f"{name}<{', '.join(args)}>"
    return mangled


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _inputs(T, B, H, pattern, seed, chunk=16):
    g = torch.Generator().manual_seed(seed)
    a = torch.sigmoid(torch.randn(T, B, H, generator=g))
    b = torch.randn(T, B, H, generator=g) * 0.1
    h0 = torch.randn(B, H, generator=g)
    at = {"mid_window": T // 2, "chunk_first": 0, "chunk_last": chunk - 1}
    reset = {
        "none": None,
        "all": torch.ones(T, B, dtype=torch.bool),
        "random": torch.rand(T, B, generator=g) < 0.3,
    }.get(pattern)
    if pattern in at:  # one reset row, or one on that step of every chunk
        rows = (torch.arange(T) == at[pattern]) if pattern == "mid_window" else (
            torch.arange(T) % chunk == at[pattern])
        reset = rows[:, None].expand(T, B).contiguous()
    dev = torch.device("cuda")
    return a.to(dev), b.to(dev), h0.to(dev), None if reset is None else reset.to(dev)


def _err(x, y):
    return float((x - y).abs().max()) if x.numel() else 0.0


def _within(x, y, tol):
    return bool(((x - y).abs() <= tol + tol * y.abs()).all())


def kernel_parity(ops, ref, shapes=None):
    """Forward, adjoint and gradients of the op against the plain versions."""
    worst = {"forward": 0.0, "reverse": 0.0, "chunked": 0.0, "grad": 0.0}
    if shapes is None:
        shapes = PATH_SHAPES + MARL_PATH_SHAPES + [RAGGED] + SCAN_EDGE_SHAPES
    for T, B, H in shapes:
        for i, pattern in enumerate(PATTERNS):
            a, b, h0, reset = _inputs(T, B, H, pattern, seed=i, chunk=ops.KERNEL_CHUNK)
            out = ops.linear_recurrent_scan(a, b, h0, reset)
            want = ref.linear_recurrence_ref(a, b, h0, reset)
            rev = ops._scan(a, b, reset, None, reverse=True)
            flat = (a.reshape(T, -1), b.reshape(T, -1),
                    None if reset is None else reset.reshape(T, B))
            rev_want = ref.scan_ref(*flat, None, reverse=True).reshape(T, B, H)
            chunked = [ref.chunked_scan_ref(*flat, h, ops.KERNEL_CHUNK, reverse=r).reshape(T, B, H)
                       for h, r in ((h0.reshape(-1), False), (None, True))]
            g = torch.randn(T, B, H, generator=torch.Generator().manual_seed(9)).cuda()
            leaves = [x.clone().requires_grad_(True) for x in (a, b, h0)]
            grads = torch.autograd.grad(
                (ops.linear_recurrent_scan(*leaves, reset) * g).sum(), leaves
            )
            leaves_ref = [x.clone().requires_grad_(True) for x in (a, b, h0)]
            grads_ref = torch.autograd.grad(
                (ref.linear_recurrence_ref(*leaves_ref, reset) * g).sum(), leaves_ref
            )
            torch.cuda.synchronize()
            case = f"T={T} B={B} H={H} reset={pattern}"
            _require(_within(out, want, FWD_TOL), f"forward differs: {case}")
            _require(_within(rev, rev_want, FWD_TOL), f"reverse scan differs: {case}")
            for x, y, direction in zip((out, rev), chunked, ("forward", "reverse")):
                _require(_within(x, y, FWD_TOL), f"{direction} differs from chunked_scan_ref: {case}")
                worst["chunked"] = max(worst["chunked"], _err(x, y))
            for name, x, y in zip(("da", "db", "dh0"), grads, grads_ref):
                _require(_within(x, y, GRAD_TOL), f"{name} differs: {case}")
                worst["grad"] = max(worst["grad"], _err(x, y))
            worst["forward"] = max(worst["forward"], _err(out, want))
            worst["reverse"] = max(worst["reverse"], _err(rev, rev_want))
    return worst


def _time_ms(fn, reps=25, inner=10):
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls a rep."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_ms(fn, inner=20, reps=10):
    """Median device time of one ``fn()`` over ``reps`` replays of a graph of ``inner`` calls.

    Unlike `_time_ms`, this leaves out the host's cost of a launch (ctypes
    and the op wrapper), which is more than a short kernel's whole work.
    """
    fn()  # first call: build, allocator, lazy loading; never captured
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_timing(ops, ref, shapes=None):
    """Kernel, plain-version and bound times at the path's shapes.

    ``ms`` times calls launched eagerly (`_time_ms`), which the host's cost
    of a launch bounds from below; ``device_ms`` the same calls replayed
    from a CUDA graph (`_device_ms`).  Each has its share of the bound.
    """
    rows = []
    for T, B, H in shapes or PATH_SHAPES + MARL_PATH_SHAPES:
        a, b, h0, reset = _inputs(T, B, H, "random", seed=0)
        D = B * H
        flat = (a.reshape(T, D), b.reshape(T, D), reset, h0.reshape(D))
        # each input read once, the output written once: a, b, out (T, D)
        # float32, h0 (D,) float32, the reset mask (T, B) bytes
        nbytes = 3 * T * D * 4 + D * 4 + T * B
        flops = 2 * T * D  # one multiply-add per element and step
        for direction in ("forward", "reverse"):
            rev = direction == "reverse"
            h = None if rev else flat[3]
            ms = _time_ms(lambda: ops._launch(*flat[:3], h, rev))
            dev_ms = _device_ms(lambda: ops._launch(*flat[:3], h, rev))
            plain_ms = _time_ms(lambda: ref.scan_ref(*flat[:3], h, reverse=rev), reps=20, inner=1)
            bytes_moved = nbytes - (D * 4 if rev else 0)
            bounds = {
                "bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
                "operations": flops / F32_FLOPS_PER_S * 1e3,
            }
            bound_by = max(bounds, key=bounds.get)
            rows.append({
                "T": T, "B": B, "H": H, "direction": direction, "ms": ms,
                "device_ms": dev_ms, "plain_ms": plain_ms, "bytes": bytes_moved, "flops": flops,
                "bound_ms": bounds[bound_by], "bound_by": bound_by,
                "bound_share": bounds[bound_by] / ms, "device_bound_share": bounds[bound_by] / dev_ms,
            })
    return rows


def train_and_evaluate(ops):
    """The port's main path: rec-IPPO (linear core) Anakin training + greedy eval."""
    from repro_torch.core import train_anakin
    from repro_torch.envs import MatrixGame
    from repro_torch.eval import evaluate
    from repro_torch.systems import PPOConfig, make_rec_ippo

    cfg = PPOConfig(recurrent_core="linear")
    system = make_rec_ippo(MatrixGame(), cfg)
    num_envs, num_iterations = 256, 256
    ops.linear_recurrent_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = train_anakin(system, 0, num_iterations, num_envs, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = evaluate(system, state.train, 0, num_episodes=32, num_envs=32, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = ops.linear_recurrent_scan.launches

    updates = num_iterations // cfg.rollout_len
    n_agents, n_mb = 2, cfg.num_minibatches
    # per update: one bootstrap critic unroll per agent, then per minibatch
    # an actor and a critic unroll per agent, forward and backward
    expected = updates * (n_agents + cfg.epochs * n_mb * n_agents * 2 * 2)
    _require(int(state.train.steps) == updates, f"train.steps = {int(state.train.steps)}")
    _require(metrics["loss"].shape == (updates,), f"losses {tuple(metrics['loss'].shape)}")
    for k, v in metrics.items():
        _require(bool(torch.isfinite(v).all()), f"non-finite training metric {k}")
    _require(launches == expected, f"recurrent_scan launched {launches}x, expected {expected}")
    _require(ev.episode_return.shape == (32,), "eval returns shape")
    _require(bool(torch.isfinite(ev.episode_return).all()), "non-finite eval return")
    _require(bool((ev.episode_length == MatrixGame().horizon).all()), "eval episode lengths")
    return system, state, {
        "train_s": train_s,
        "eval_s": eval_s,
        "env_steps_per_s": num_envs * num_iterations / train_s,
        "losses": [float(x) for x in metrics["loss"]],
        "eval_return_mean": float(ev.episode_return.mean()),
        "launches": launches,
        "launches_per_update": launches // updates,
    }


def slice_parity(system, state):
    """One PPO update from the trained state, on the card and on the CPU."""
    from repro_torch.convert import params_from_jax, params_to_jax
    from repro_torch.core.buffer import RolloutState
    from repro_torch.systems import onpolicy
    from repro_torch.tree import tree_leaves

    B = state.buffer.storage.discount.shape[1]
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(0))
    shuffle = onpolicy._env_permutation
    onpolicy._env_permutation = lambda n, g: perm.to(g.device)
    try:
        results = []
        for dev in ("cuda", "cpu"):
            train = params_from_jax(params_to_jax(state.train), dev)
            storage = params_from_jax(params_to_jax(state.buffer.storage), dev)
            gen = torch.Generator(dev)
            full = RolloutState(storage, storage.discount.shape[0])
            new, _, m = system.update(train, full, gen)
            results.append((new.params, float(m["loss"])))
    finally:
        onpolicy._env_permutation = shuffle
    (gpu, gpu_loss), (cpu, cpu_loss) = results
    diffs = [_err(g.cpu(), c) for g, c in zip(tree_leaves(gpu), tree_leaves(cpu))]
    worst = max(diffs)
    _require(worst <= SLICE_TOL, f"update on the card differs from the CPU by {worst}")
    _require(abs(gpu_loss - cpu_loss) <= SLICE_TOL * (1 + abs(cpu_loss)), "update loss differs")
    return worst, abs(gpu_loss - cpu_loss)


def _marl_run(system, num_seeds, seed=0):
    """One seed-batched (or single) Anakin run with interleaved eval, timed to the last op."""
    from repro_torch.core import train_anakin

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_anakin(system, seed, MARL_ITERATIONS, MARL_ENVS, eval_every=MARL_EVAL_EVERY,
                       eval_episodes=MARL_EPISODES, num_seeds=num_seeds, device="cuda")
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def marl_train(ops):
    """This slice's path: ippo, mappo and rec-MAPPO (linear core), 8 seeds as lanes of one batch.

    Each run: 256 envs x 8 seeds x 256 iterations (2 updates a lane) with
    a greedy evaluation of 32 episodes a lane every 128 iterations; env
    steps/s counts the training steps over the whole call's wall, the
    evaluations included.  The scan counter is set to 0 before each run
    and read after it.
    """
    from repro_torch.systems import PPOConfig
    from repro_torch.systems.registry import make_pair

    rows = {}
    for name, env, overrides in MARL_RUNS:
        _, system = make_pair(name, env, **overrides)
        cfg = PPOConfig(**overrides)
        walls, launches = [], []
        for _ in range(MARL_REPEATS):
            ops.linear_recurrent_scan.launches = 0
            (state, metrics, evals), wall = _marl_run(system, MARL_SEEDS)
            launches.append(ops.linear_recurrent_scan.launches)
            walls.append(wall)
        updates = MARL_ITERATIONS // cfg.rollout_len
        n_agents = len(system.spec.agent_ids)
        _require(metrics["loss"].shape == (MARL_SEEDS, updates),
                 f"{name} losses {tuple(metrics['loss'].shape)}")
        _require(evals.episode_return.shape == (MARL_SEEDS, MARL_ITERATIONS // MARL_EVAL_EVERY,
                                                MARL_EPISODES),
                 f"{name} eval returns {tuple(evals.episode_return.shape)}")
        for k, v in [*metrics.items(), ("eval", evals.episode_return)]:
            _require(bool(torch.isfinite(v).all()), f"{name}: non-finite {k}")
        _require(state.train.steps.tolist() == [updates] * MARL_SEEDS, f"{name} train.steps")
        expected = 0
        if name.startswith("rec_"):
            # per update: a bootstrap critic unroll per agent, then per
            # minibatch an actor and a critic unroll per agent, forward and
            # backward; the seed lanes fold into the kernel's D axis
            expected = updates * (n_agents + cfg.epochs * cfg.num_minibatches * n_agents * 4)
        _require(launches == [expected] * MARL_REPEATS,
                 f"{name}: recurrent_scan launched {launches}x a run, expected {expected}")
        steps = MARL_ITERATIONS * MARL_ENVS * MARL_SEEDS
        rates = sorted(steps / w for w in walls)
        rows[name] = {
            "env": env, "walls_s": walls, "env_steps_per_s": statistics.median(rates),
            "env_steps_per_s_min": rates[0], "env_steps_per_s_max": rates[-1],
            "losses": metrics["loss"].mean(0).tolist(),
            "eval_return": evals.episode_return.mean((0, 2)).tolist(),
            "launches": launches[-1], "system": system,
        }
    return rows


def marl_serial(system, batched_wall):
    """The same 8 seeds, one run after another: the counterpart of BENCH_speed's seed column."""
    walls = []
    for seed in range(MARL_SEEDS):
        (_, metrics, evals), wall = _marl_run(system, None, seed)
        _require(bool(torch.isfinite(metrics["loss"]).all()), f"serial seed {seed}: loss")
        walls.append(wall)
    steps = MARL_ITERATIONS * MARL_ENVS * MARL_SEEDS
    return {"walls_s": walls, "env_steps_per_s": steps / sum(walls),
            "batched_over_serial": sum(walls) / batched_wall}


def marl_milestone():
    """tests/test_onpolicy.py's IPPO milestone (matrix_game, 150 updates x 16 envs), on the card."""
    from repro_torch.core import train_anakin
    from repro_torch.envs import MatrixGame
    from repro_torch.systems import PPOConfig, make_ippo

    system = make_ippo(MatrixGame(horizon=10),
                       PPOConfig(rollout_len=32, epochs=4, num_minibatches=2,
                                 entropy_coef=0.02, learning_rate=1e-3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = train_anakin(system, 0, 150 * 32, 16, device="cuda")
    r = metrics["reward"].reshape(150, 32).mean(-1).cpu()
    wall = time.perf_counter() - t0
    first, late = float(r[:15].mean()), float(r[-15:].mean())
    _require(abs(late - SEED_IPPO_LAST15) < 0.1 * SEED_IPPO_LAST15,
             f"milestone: last 15 updates {late}, not within 10% of {SEED_IPPO_LAST15}")
    _require(late - first > 0.5 * (SEED_IPPO_LAST15 - SEED_IPPO_FIRST15),
             f"milestone: improvement {late - first}")
    return {"first15": first, "last15": late, "wall_s": wall}


def marl_update_parity(name, overrides, stale=False):
    """One seed-lane update of ``name`` on spread from the same state, on the card and the CPU.

    With ``stale`` the stored behaviour log-probs move off the acting
    policy's by seeded noise in [-0.6, 0.6), as a stale actor's would
    (what a ``use_vtrace`` update corrects).  Held at ``SLICE_TOL``: the
    first minibatch's per-lane loss and
    gradients, the params after the first optimizer step, and the update's
    mean loss.  Over an update's later steps Adam turns gradient
    components that rounding leaves near zero into steps of about the
    learning rate, so the params after all of them are a reading
    (returned, not held).
    """
    from repro_torch.core.buffer import RolloutState
    from repro_torch.core.system import _step_phase, _training_env, init_system_state
    from repro_torch.core.system import seed_generators
    from repro_torch.systems import PPOConfig, onpolicy
    from repro_torch.systems.registry import make_pair
    from repro_torch.tree import tree_leaves, tree_map

    _, system = make_pair(name, "spread", **overrides)
    cfg = PPOConfig(**overrides)
    lanes, envs = 2, MARL_ENVS
    tenv = _training_env(system.env)
    st = init_system_state(system, seed_generators(0, lanes, "cuda"), envs, tenv)
    with torch.no_grad():
        for _ in range(cfg.rollout_len):
            st, _ = _step_phase(system, tenv, st)
        if stale:
            noise = torch.Generator().manual_seed(1)
            for x in st.buffer.storage.extras["logp"].values():
                x.add_((torch.rand(x.shape, generator=noise) * 1.2 - 0.6).to(x.device))
    # feed-forward PPO shuffles the flattened (T * envs) rows, recurrent PPO the envs
    rows = st.buffer.storage.discount.shape[0] * envs
    g = torch.Generator().manual_seed(0)
    perm = {n: torch.stack([torch.randperm(n, generator=g) for _ in range(lanes)])
            for n in (rows, envs)}
    hooks = {k: getattr(onpolicy, k) for k in
             ("_row_permutation", "_env_permutation", "_value_and_grad", "_apply")}
    results = []
    try:
        for dev in ("cuda", "cpu"):
            first = {}

            def value_and_grad(*args):
                out = hooks["_value_and_grad"](*args)
                first.setdefault("loss_grads", out)
                return out

            def apply(*args):
                out = hooks["_apply"](*args)
                first.setdefault("params", out[0])
                return out

            onpolicy._row_permutation = onpolicy._env_permutation = (
                lambda n, gen, dev=dev: perm[n].to(dev))
            onpolicy._value_and_grad, onpolicy._apply = value_and_grad, apply
            move = lambda x: x.to(dev)
            buffer = RolloutState(tree_map(move, st.buffer.storage), st.buffer.t)
            new, _, m = system.update(tree_map(move, st.train), buffer,
                                      seed_generators(0, lanes, dev))
            loss, grads = first["loss_grads"]
            results.append({"loss": [loss], "grads": tree_leaves(grads),
                            "params": tree_leaves(first["params"]),
                            "update_params": tree_leaves(new.params),
                            "update_loss": [m["loss"]]})
    finally:
        for k, v in hooks.items():
            setattr(onpolicy, k, v)
    gpu, cpu = results
    err = {k: max(_err(x.cpu(), y) for x, y in zip(gpu[k], cpu[k])) for k in gpu}
    err["steps"] = cfg.epochs * cfg.num_minibatches
    for k in ("loss", "grads", "update_loss"):
        _require(all(_within(x.cpu(), y, SLICE_TOL) for x, y in zip(gpu[k], cpu[k])),
                 f"{name}: {k} on the card differs from the CPU by {err[k]}")
    _require(err["params"] <= SLICE_TOL,
             f"{name}: params after the first step differ from the CPU by {err['params']}")
    return err


def marl_launcher():
    """The MARL entry point a user calls, on the card (its default device)."""
    from repro_torch.launch import train_marl

    return train_marl.main(["--system", "ippo", "--env", "lbf", "--runner", "anakin",
                            "--num-seeds", str(MARL_SEEDS), "--num-envs", str(MARL_ENVS),
                            "--iterations", str(MARL_ITERATIONS), "--eval-every",
                            str(MARL_EVAL_EVERY)])


def _replay_config(name):
    """The registry's config of a replay system at its defaults."""
    from repro_torch.systems.registry import REGISTRY

    return REGISTRY[name].config_cls()


def replay_train():
    """This slice's path: the replay family, 8 seeds as lanes of one batch.

    vdn on spread, qmix on lbf, madqn-fp on matrix_game and mad4pg on
    continuous spread (2 runs each), and maddpg on continuous spread (one
    run), at the registry's defaults: 256 envs x 8 seeds x 256 iterations
    with a greedy evaluation of 32 episodes a lane every 128 iterations.
    Once the table holds ``min_replay`` rows every iteration updates, so
    each run's update count follows from the fill alone; env steps/s
    counts the training steps over the whole call's wall, evals included.
    """
    from repro_torch.systems.registry import make_pair

    rows = {}
    for name, env in REPLAY_RUNS + [("maddpg", "spread")]:
        _, system = make_pair(name, env)
        cfg = _replay_config(name)
        walls = []
        for _ in range(REPLAY_REPEATS if name != "maddpg" else 1):
            (state, metrics, evals), wall = _marl_run(system, MARL_SEEDS)
            walls.append(wall)
        # the iteration whose rows fill the table to min_replay updates, and every later one
        ready = -(-cfg.min_replay // MARL_ENVS)  # ceil
        updates = MARL_ITERATIONS - ready + 1
        loss = "critic_loss" if name in ("maddpg", "mad4pg") else "loss"
        _require(state.train.steps == updates, f"{name}: {state.train.steps} updates, "
                 f"expected {updates}")
        _require(metrics[loss].shape == (MARL_SEEDS, updates),
                 f"{name} losses {tuple(metrics[loss].shape)}")
        _require(evals.episode_return.shape == (MARL_SEEDS, MARL_ITERATIONS // MARL_EVAL_EVERY,
                                                MARL_EPISODES),
                 f"{name} eval returns {tuple(evals.episode_return.shape)}")
        for k, v in [*metrics.items(), ("eval", evals.episode_return)]:
            _require(bool(torch.isfinite(v).all()), f"{name}: non-finite {k}")
        filled = min(MARL_ITERATIONS * MARL_ENVS, cfg.buffer_capacity)
        _require(isinstance(state.buffer.size, int) and state.buffer.size == filled,
                 f"{name}: replay fill {state.buffer.size}, expected {filled}")
        steps = MARL_ITERATIONS * MARL_ENVS * MARL_SEEDS
        rates = sorted(steps / w for w in walls)
        rows[name] = {
            "env": env, "walls_s": walls, "env_steps_per_s": statistics.median(rates),
            "env_steps_per_s_min": rates[0], "env_steps_per_s_max": rates[-1],
            "updates": updates, "last_loss": metrics[loss][:, -1].mean().item(),
            "eval_return": evals.episode_return.mean((0, 2)).tolist(), "system": system,
        }
    return rows


def replay_milestone():
    """tests/test_system.py's value milestone for vdn (FAST_CFG, 3,000 iterations x 8 envs)."""
    from repro_torch.core import train_anakin
    from repro_torch.envs import MatrixGame
    from repro_torch.systems import OffPolicyConfig, make_vdn

    system = make_vdn(MatrixGame(horizon=10), OffPolicyConfig(**REPLAY_MILESTONE_CFG))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = train_anakin(system, 0, 3_000, 8, device="cuda")
    r = metrics["reward"].cpu()
    wall = time.perf_counter() - t0
    early, late = float(r[:200].mean()), float(r[-200:].mean())
    _require(late > early + 2.0 and late > 3.0,
             f"vdn milestone: first 200 iterations {early}, last 200 {late}")
    return {"early": early, "late": late, "wall_s": wall}


def replay_update_parity(name, env, steps=8):
    """The first replay update of 2 seed lanes x 256 envs on the card and on the CPU.

    The table is filled on the card to ``min_replay`` rows, then both
    devices run ``steps`` updates from the same state with the same
    sample indices.  Held at ``SLICE_TOL``: the first update's losses and
    gradients, and the params after its optimizer step(s).  The params
    after all ``steps`` updates are a reading (Adam turns gradient
    components that rounding leaves near zero into steps of about lr).
    """
    from repro_torch.core import buffer as table
    from repro_torch.core.system import _step_phase, _training_env, init_system_state
    from repro_torch.core.system import seed_generators
    from repro_torch.systems import maddpg, offpolicy
    from repro_torch.systems.registry import make_pair
    from repro_torch.tree import tree_leaves, tree_map

    _, system = make_pair(name, env)
    cfg = _replay_config(name)
    module = maddpg if name in ("maddpg", "mad4pg") else offpolicy
    per_update = 2 if module is maddpg else 1  # the critic's and the actor's step
    lanes = 2
    tenv = _training_env(system.env)
    st = init_system_state(system, seed_generators(0, lanes, "cuda"), MARL_ENVS, tenv)
    with torch.no_grad():
        while not system.can_sample(st.buffer):
            st, _ = _step_phase(system, tenv, st)
    g = torch.Generator().manual_seed(0)
    idx = [torch.randint(st.buffer.size, (lanes, cfg.batch_size), generator=g)
           for _ in range(steps)]
    hooks = {k: getattr(module, k) for k in ("_value_and_grad", "_apply")}
    sample_indices = table.sample_indices
    results = []
    try:
        for dev in ("cuda", "cpu"):
            seen = {"loss_grads": [], "params": []}

            def value_and_grad(*args):
                out = hooks["_value_and_grad"](*args)
                seen["loss_grads"].append(out)
                return out

            def apply(*args):
                out = hooks["_apply"](*args)
                seen["params"].append(out[0])
                return out

            draws = iter(idx)
            table.sample_indices = lambda s, gen, n, dev=dev: next(draws).to(dev)
            module._value_and_grad, module._apply = value_and_grad, apply
            move = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x
            train = tree_map(move, st.train)
            buffer = st.buffer._replace(storage=tree_map(move, st.buffer.storage))
            gens = seed_generators(0, lanes, dev)
            for _ in range(steps):
                train, buffer, _ = system.update(train, buffer, gens)
            first = seen["loss_grads"][:per_update]
            results.append({"loss": [lg[0] for lg in first],
                            "grads": [x for lg in first for x in tree_leaves(lg[1])],
                            "params": [x for p in seen["params"][:per_update]
                                       for x in tree_leaves(p)],
                            "update_params": tree_leaves(train.params)})
    finally:
        table.sample_indices = sample_indices
        for k, v in hooks.items():
            setattr(module, k, v)
    gpu, cpu = results
    err = {k: max(_err(x.cpu(), y) for x, y in zip(gpu[k], cpu[k])) for k in gpu}
    err["steps"] = steps
    for k in ("loss", "grads"):
        _require(all(_within(x.cpu(), y, SLICE_TOL) for x, y in zip(gpu[k], cpu[k])),
                 f"{name}: {k} on the card differs from the CPU by {err[k]}")
    _require(err["params"] <= SLICE_TOL,
             f"{name}: params after the first update differ from the CPU by {err['params']}")
    return err


def replay_phase(tag):
    """Phases 20-23: the replay family's runs, the serial rung, the milestone, the parity."""
    t0 = time.perf_counter()
    replay = replay_train()
    for name, r in replay.items():
        print(
            f"train (replay): {name} on {r['env']}, {MARL_SEEDS} seeds x {MARL_ENVS} envs x "
            f"{MARL_ITERATIONS} iterations, greedy eval of {MARL_EPISODES} episodes a lane every "
            f"{MARL_EVAL_EVERY}: {r['env_steps_per_s']:.0f} env steps/s median of "
            f"{len(r['walls_s'])} (min {r['env_steps_per_s_min']:.0f}, max "
            f"{r['env_steps_per_s_max']:.0f}), walls {[round(w, 3) for w in r['walls_s']]} s; "
            f"{r['updates']} updates a lane, last loss {r['last_loss']:.4f}; eval returns "
            f"{[round(x, 4) for x in r['eval_return']]} {tag}"
        )
    serial = marl_serial(replay["vdn"]["system"], statistics.median(replay["vdn"]["walls_s"]))
    print(
        f"train (replay, serial): vdn on spread, seeds 0-{MARL_SEEDS - 1} one run after "
        f"another: walls {[round(w, 3) for w in serial['walls_s']]} s = "
        f"{serial['env_steps_per_s']:.0f} env steps/s; batched over serial "
        f"{serial['batched_over_serial']:.2f}x {tag}"
    )
    del replay
    milestone = replay_milestone()
    print(
        f"milestone: vdn matrix_game (tests/test_system.py FAST_CFG), 3000 iterations x 8 envs: "
        f"mean reward first 200 iterations {milestone['early']:.3f}, last 200 "
        f"{milestone['late']:.3f} (> first + 2 and > 3) in {milestone['wall_s']:.1f} s {tag}"
    )
    for name, env in REPLAY_PARITY:
        e = replay_update_parity(name, env)
        print(f"slice parity: {name} on {env}, the first replay update of 2 seed lanes x "
              f"{MARL_ENVS} envs on the card vs the CPU: loss {e['loss']:.3e}, grads "
              f"{e['grads']:.3e}, params after it {e['params']:.3e} (tol {SLICE_TOL}); after "
              f"{e['steps']} updates params {e['update_params']:.3e} (a reading)")
    print(f"slice 7 (replay) in {time.perf_counter() - t0:.1f} s")


def _matrix_updates(system, name, cfg):
    """Updates a lane in one matrix run, from the dataset's fill alone."""
    from repro_torch.core.buffer import seq_expected_size

    if name == "rec_madqn":
        window, stride = cfg.burn_in + cfg.seq_len, cfg.stride or cfg.seq_len
        ready = next(t for t in range(1, MARL_ITERATIONS + 1) if seq_expected_size(
            t, cfg.buffer_capacity, window, MARL_ENVS, stride) >= cfg.min_windows)
        return MARL_ITERATIONS - ready + 1
    if name in ("dial", "rial", "ippo"):
        return MARL_ITERATIONS // (cfg.rollout_len or int(system.env.horizon))
    return MARL_ITERATIONS - -(-cfg.min_replay // MARL_ENVS) + 1  # the replay family


def matrix_train(ops):
    """This slice's path: the systems and envs new to the port, 8 seeds as lanes of one batch.

    Each run: 256 envs x 8 seeds x 256 iterations at the registry's
    defaults with a greedy evaluation of 32 episodes a lane every 128
    iterations.  The scan counter is set to 0 just before each run and read
    just after: rec-MADQN's linear core launches it 5 times an update (its
    3 agents share one stack: both burn-ins, the suffix forward and
    backward, the target suffix), the fused no-channel DIAL 3 times (every
    agent's re-run: forward and backward, the target's forward), the rest
    never.
    """
    from repro_torch.systems.registry import REGISTRY, make_pair

    rows = {}
    for label, name, env, overrides, runs in MATRIX_RUNS:
        _, system = make_pair(name, env, **overrides)
        cfg = REGISTRY[name].config_cls(**overrides)
        walls, launches = [], []
        for _ in range(runs):
            ops.linear_recurrent_scan.launches = 0
            (state, metrics, evals), wall = _marl_run(system, MARL_SEEDS)
            launches.append(ops.linear_recurrent_scan.launches)
            walls.append(wall)
        updates = _matrix_updates(system, name, cfg)
        steps = state.train.steps
        steps = steps if isinstance(steps, int) else steps.tolist()
        _require(steps in (updates, [updates] * MARL_SEEDS),
                 f"{label}: {steps} updates, expected {updates}")
        _require(metrics["loss"].shape == (MARL_SEEDS, updates),
                 f"{label} losses {tuple(metrics['loss'].shape)}")
        _require(evals.episode_return.shape == (MARL_SEEDS, MARL_ITERATIONS // MARL_EVAL_EVERY,
                                                MARL_EPISODES),
                 f"{label} eval returns {tuple(evals.episode_return.shape)}")
        for k, v in [*metrics.items(), ("eval", evals.episode_return)]:
            _require(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
        per_update = {"rec_madqn linear": 5, "dial fused": 3}.get(label, 0)
        _require(launches == [per_update * updates] * runs,
                 f"{label}: recurrent_scan launched {launches}x a run, expected "
                 f"{per_update * updates}")
        steps_total = MARL_ITERATIONS * MARL_ENVS * MARL_SEEDS
        rates = sorted(steps_total / w for w in walls)
        rows[label] = {
            "system": name, "env": env, "walls_s": walls,
            "env_steps_per_s": statistics.median(rates), "env_steps_per_s_min": rates[0],
            "env_steps_per_s_max": rates[-1], "updates": updates,
            "last_eval_return": evals.episode_return[:, -1].mean().item(),
            "last_loss": metrics["loss"][:, -1].mean().item(),
            "launches": launches[-1], "launches_per_update": per_update,
        }
    return rows


def matrix_update_parity(ops, name, env, overrides):
    """The first update of 2 seed lanes x 256 envs on the card and on the CPU.

    The dataset is filled on the card (rec-MADQN: the sequence table to
    ``min_windows`` windows; DIAL: one rollout), then both devices update
    from the same state with the same draws: rec-MADQN's window indices,
    DIAL's DRU noise (one CPU stream replayed on each device).  Held at
    ``SLICE_TOL``: the loss, the gradients and the params after the step.
    """
    from repro_torch.core import buffer as table
    from repro_torch.core.system import _step_phase, _training_env, init_system_state
    from repro_torch.core.system import seed_generators
    from repro_torch.systems import dial, rec_madqn
    from repro_torch.systems.registry import make_pair
    from repro_torch.tree import tree_leaves, tree_map

    _, system = make_pair(name, env, **overrides)
    module = rec_madqn if name == "rec_madqn" else dial
    lanes = 2
    tenv = _training_env(system.env)
    st = init_system_state(system, seed_generators(0, lanes, "cuda"), MARL_ENVS, tenv)
    with torch.no_grad():
        while not system.can_sample(st.buffer):
            st, _ = _step_phase(system, tenv, st)
    if name == "rec_madqn":
        idx = torch.randint(st.buffer.size, (lanes, _replay_config(name).batch_size),
                            generator=torch.Generator().manual_seed(0))
    hooks = {k: getattr(module, k) for k in ("_value_and_grad", "_apply")}
    sample_indices, dru_noise = table.sample_indices, dial._dru_noise
    results = []
    try:
        for dev in ("cuda", "cpu"):
            seen = {}

            def value_and_grad(*args):
                seen["loss_grads"] = hooks["_value_and_grad"](*args)
                return seen["loss_grads"]

            def apply(*args):
                out = hooks["_apply"](*args)
                seen["params"] = out[0]
                return out

            noise = torch.Generator().manual_seed(1)
            dial._dru_noise = lambda g, shape, n, c, d, noise=noise: [
                torch.randn(*shape, c, generator=noise).to(d) for _ in range(n)]
            table.sample_indices = lambda s, g, n, dev=dev: idx.to(dev)
            module._value_and_grad, module._apply = value_and_grad, apply
            move = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x
            before = ops.linear_recurrent_scan.launches
            system.update(tree_map(move, st.train), tree_map(move, st.buffer),
                          seed_generators(0, lanes, dev))
            loss, grads = seen["loss_grads"]
            results.append({"loss": [loss], "grads": tree_leaves(grads),
                            "params": tree_leaves(seen["params"]),
                            "launches": ops.linear_recurrent_scan.launches - before})
    finally:
        table.sample_indices, dial._dru_noise = sample_indices, dru_noise
        for k, v in hooks.items():
            setattr(module, k, v)
    gpu, cpu = results
    err = {k: max(_err(x.cpu(), y) for x, y in zip(gpu[k], cpu[k])) for k in
           ("loss", "grads", "params")}
    for k in ("loss", "grads"):
        _require(all(_within(x.cpu(), y, SLICE_TOL) for x, y in zip(gpu[k], cpu[k])),
                 f"{name}: {k} on the card differs from the CPU by {err[k]}")
    _require(err["params"] <= SLICE_TOL,
             f"{name}: params after the update differ from the CPU by {err['params']}")
    err["launches"] = gpu["launches"]
    return err


def matrix_milestones():
    """The reference's own milestones on the card, at their own configs.

    tests/test_seq_replay.py:279 (rec-MADQN, GRU, on the climbing game,
    5,000 iterations x 8 envs: the last 10 of 100 blocks of 50 iterations
    above the first 10 by 1), tests/test_marl_modules.py:98 and :105 (DIAL
    over 60 updates not diverging, RIAL over 120 improving, 16 envs on the
    3-prisoner switch riddle).
    """
    from repro_torch.core import train_anakin
    from repro_torch.envs import MatrixGame, SwitchGame
    from repro_torch.systems import DialConfig, RecMadqnConfig, make_dial, make_rec_madqn

    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system = make_rec_madqn(MatrixGame(horizon=10), RecMadqnConfig(**REC_MADQN_MILESTONE_CFG))
    _, metrics = train_anakin(system, 0, 5000, 8, device="cuda")
    r = metrics["reward"].reshape(100, 50).mean(-1).cpu()
    first, late = float(r[:10].mean()), float(r[-10:].mean())
    _require(late > first + 1.0, f"rec_madqn milestone: first 10 blocks {first}, last {late}")
    out["rec_madqn"] = {"first": first, "late": late, "wall_s": time.perf_counter() - t0}
    for protocol, updates, k, margin in (("dial", 60, 15, -0.05), ("rial", 120, 30, 0.0)):
        env = SwitchGame(num_agents=3)
        t0 = time.perf_counter()
        system = make_dial(env, DialConfig(protocol=protocol))
        _, metrics = train_anakin(system, 0, updates * env.horizon, 16, device="cuda")
        r = metrics["reward"].reshape(updates, env.horizon).mean(-1).cpu()
        first, late = float(r[:k].mean()), float(r[-k:].mean())
        _require(bool(torch.isfinite(r).all()) and late > first + margin,
                 f"{protocol} milestone: first {k} updates {first}, last {k} {late}")
        out[protocol] = {"first": first, "late": late, "wall_s": time.perf_counter() - t0}
    return out


def matrix_phase(tag, ops, ref):
    """Slice 8: the runs, the scan at the new shapes, card-vs-CPU updates, the milestones."""
    t0 = time.perf_counter()
    worst = kernel_parity(ops, ref, MATRIX_SCAN_SHAPES)
    print(f"kernel parity (matrix): recurrent_scan forward {worst['forward']:.3e}, reverse "
          f"{worst['reverse']:.3e}, chunked {worst['chunked']:.3e} (tol {FWD_TOL}), grads "
          f"{worst['grad']:.3e} (tol {GRAD_TOL}) over {MATRIX_SCAN_SHAPES} x resets {PATTERNS}")
    timing = kernel_timing(ops, ref, [REC_MADQN_SUFFIX])
    for r in timing:
        print(f"kernel timing (matrix): recurrent_scan {r['direction']} T={r['T']} B={r['B']} "
              f"H={r['H']} (rec-MADQN's suffix): {r['device_ms'] * 1e3:.2f} us on the device, "
              f"{r['ms'] * 1e3:.2f} us launched eagerly, plain {r['plain_ms'] * 1e3:.1f} us, "
              f"bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} "
              f"({r['device_bound_share']:.3f} of it on the device) {tag}")
    rows = matrix_train(ops)
    for label, r in rows.items():
        scan = (f"; recurrent_scan launches {r['launches']} a run, {r['launches_per_update']} "
                f"an update" if r["launches_per_update"] else "")
        print(
            f"train (matrix): {label} ({r['system']}) on {r['env']}, {MARL_SEEDS} seeds x "
            f"{MARL_ENVS} envs x {MARL_ITERATIONS} iterations, greedy eval of {MARL_EPISODES} "
            f"episodes a lane every {MARL_EVAL_EVERY}: {r['env_steps_per_s']:.0f} env steps/s "
            f"median of {len(r['walls_s'])} (min {r['env_steps_per_s_min']:.0f}, max "
            f"{r['env_steps_per_s_max']:.0f}), walls {[round(w, 3) for w in r['walls_s']]} s; "
            f"{r['updates']} updates a lane, last loss {r['last_loss']:.4f}, last greedy team "
            f"return {r['last_eval_return']:.4f}{scan} {tag}"
        )
    for name, env, overrides in (("rec_madqn", "spread", {"recurrent_core": "linear"}),
                                 ("dial", "switch_game", {})):
        e = matrix_update_parity(ops, name, env, overrides)
        _require((e["launches"] > 0) == (name == "rec_madqn"),
                 f"{name} parity update launched recurrent_scan {e['launches']}x")
        print(f"slice parity (matrix): {name} on {env}, the first update of 2 seed lanes x "
              f"{MARL_ENVS} envs on the card vs the CPU: loss {e['loss']:.3e}, grads "
              f"{e['grads']:.3e}, params after it {e['params']:.3e} (tol {SLICE_TOL}); "
              f"recurrent_scan launches {e['launches']}")
    ms = matrix_milestones()
    print(f"milestone: rec_madqn matrix_game (tests/test_seq_replay.py:279), 5000 iterations x 8 "
          f"envs: first 10 blocks {ms['rec_madqn']['first']:.3f}, last 10 "
          f"{ms['rec_madqn']['late']:.3f} (> first + 1) in {ms['rec_madqn']['wall_s']:.1f} s; "
          f"dial switch_game (tests/test_marl_modules.py:98), 60 updates: first 15 "
          f"{ms['dial']['first']:.3f}, last 15 {ms['dial']['late']:.3f} (> first - 0.05) in "
          f"{ms['dial']['wall_s']:.1f} s; rial (:105), 120 updates: first 30 "
          f"{ms['rial']['first']:.3f}, last 30 {ms['rial']['late']:.3f} (> first) in "
          f"{ms['rial']['wall_s']:.1f} s {tag}")
    print(f"slice 8 (matrix) in {time.perf_counter() - t0:.1f} s")
    suffix = next(r for r in timing if r["direction"] == "forward")
    return {
        "launches_rec_madqn": rows["rec_madqn linear"]["launches"],
        "launches_dial_fused": rows["dial fused"]["launches"],
        "max_abs_err_matrix": max(worst.values()),
        "device_ms_rec_madqn": suffix["device_ms"],
        "ms_rec_madqn": suffix["ms"],
        "plain_ms_rec_madqn": suffix["plain_ms"],
        "bound_ms_rec_madqn": suffix["bound_ms"],
        "bound_by_rec_madqn": suffix["bound_by"],
        "shape_rec_madqn": "T=8 B=768 H=64 forward (rec-MADQN's suffix: 3 agents x 32 "
                           "windows x 8 lanes)",
        "by_shape_matrix": timing,
    }


def _timed_cuda(fn):
    """``fn()`` and its wall, from a synchronised start to its last op."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _finite(tree):
    from repro_torch.tree import tree_leaves

    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


def _rates(steps, walls):
    rates = sorted(steps / w for w in walls)
    return {"walls_s": walls, "env_steps_per_s": statistics.median(rates),
            "env_steps_per_s_min": rates[0], "env_steps_per_s_max": rates[-1]}


def async_rates():
    """The async runner at 1 / 2 / 4 actors on ippo/spread, beside anakin (before and after)."""
    from repro_torch.core import make_anakin
    from repro_torch.distributed.impala import default_unroll_len, train_async
    from repro_torch.systems.registry import make_pair

    _, system = make_pair("ippo", "spread")
    steps = ASYNC_ITERATIONS * ASYNC_ENVS
    anakin = lambda: make_anakin(system, ASYNC_ITERATIONS, ASYNC_ENVS, device="cuda")(0)
    rows = {}
    _, wall = _timed_cuda(anakin)
    rows["anakin"] = _rates(steps, [wall])
    for actors in ASYNC_ACTORS:
        walls = []
        for _ in range(ASYNC_REPEATS if actors == 4 else 1):
            (st, m), wall = _timed_cuda(lambda: train_async(
                system, 0, ASYNC_ITERATIONS, ASYNC_ENVS, actors, device="cuda"))
            walls.append(wall)
        ticks = ASYNC_ITERATIONS // default_unroll_len(system)
        _require(st.updates == ticks * actors and int(st.train.steps) == st.updates,
                 f"async {actors} actors: {st.updates} updates")
        _require(st.dropped == 0 and _finite(st.train.params), f"async {actors} actors")
        rows[f"async {actors}"] = {
            **_rates(steps * actors, walls), "updates": st.updates,
            "queue_depth_mean": float(m["queue_depth"].mean()),
            "staleness_mean": float(m["staleness"].mean()),
            "dropped_chunks": float(m["dropped"][-1]),
        }
    _, wall = _timed_cuda(anakin)
    rows["anakin (after)"] = _rates(steps, [wall])
    return rows


def async_rec_launches(ops):
    """rec-IPPO (linear core, matrix_game) under the async runner: its scan launches an update.

    2 actors x 256 envs x 256 iterations at PPOConfig's defaults; without
    V-trace, and with it at ``param_sync_every=2`` (the actor re-run over
    the stored window adds an unroll an agent an update).  The counter is
    set to 0 just before each run and read just after it.
    """
    from repro_torch.distributed.impala import train_async
    from repro_torch.systems import PPOConfig
    from repro_torch.systems.registry import make_pair

    rows = {}
    for label, overrides, sync in (("rec_ippo linear", {"recurrent_core": "linear"}, 1),
                                   ("rec_ippo linear vtrace",
                                    {"recurrent_core": "linear", **VTRACE_CLIPS}, 2)):
        _, system = make_pair("rec_ippo", "matrix_game", **overrides)
        cfg, n = PPOConfig(**overrides), len(system.spec.agent_ids)
        ops.linear_recurrent_scan.launches = 0
        (st, m), wall = _timed_cuda(lambda: train_async(
            system, 0, ASYNC_ITERATIONS, ASYNC_ENVS, 2, param_sync_every=sync, device="cuda"))
        launches = ops.linear_recurrent_scan.launches
        # a bootstrap critic unroll an agent, (with V-trace an actor re-run an agent), then
        # an actor and a critic unroll an agent a minibatch, forward and backward
        per_update = n + (n if cfg.use_vtrace else 0) + cfg.epochs * cfg.num_minibatches * n * 4
        _require(launches == st.updates * per_update and st.updates > 0,
                 f"async {label}: recurrent_scan launched {launches}x for {st.updates} updates, "
                 f"expected {per_update} an update")
        _require(_finite(st.train.params) and st.dropped == 0, f"async {label}")
        rows[label] = {**_rates(ASYNC_ITERATIONS * ASYNC_ENVS * 2, [wall]), "launches": launches,
                       "launches_per_update": per_update, "updates": st.updates,
                       "staleness_mean": float(m["staleness"].mean())}
    return rows


def async_replay_and_vtrace():
    """vdn/spread under the async runner (2 actors, unroll 8), and V-trace ippo at sync 4."""
    from repro_torch.distributed.impala import train_async
    from repro_torch.systems.registry import make_pair

    rows = {}
    _, system = make_pair("vdn", "spread")
    (st, m), wall = _timed_cuda(lambda: train_async(system, 0, ASYNC_ITERATIONS, ASYNC_ENVS, 2,
                                                    device="cuda"))
    _require(st.updates > 0 and st.dropped == 0 and _finite(st.train.params), "async vdn")
    rows["vdn"] = {**_rates(ASYNC_ITERATIONS * ASYNC_ENVS * 2, [wall]), "updates": st.updates,
                   "queue_depth_mean": float(m["queue_depth"].mean()),
                   "staleness_mean": float(m["staleness"].mean()),
                   "dropped_chunks": float(m["dropped"][-1])}
    # a 32-step rollout a chunk: 8 ticks, so the snapshot ages 0, 1, 2, 3 twice
    _, system = make_pair("ippo", "spread", rollout_len=32, **VTRACE_CLIPS)
    (st, m), wall = _timed_cuda(lambda: train_async(system, 0, ASYNC_ITERATIONS, ASYNC_ENVS, 1,
                                                    param_sync_every=4, device="cuda"))
    trace = m["staleness"].tolist()
    _require(trace == [0.0, 1.0, 2.0, 3.0] * 2, f"V-trace ippo staleness trace {trace}")
    _require(_finite(st.train.params) and st.updates == 8, "V-trace ippo under staleness")
    rows["ippo vtrace"] = {**_rates(ASYNC_ITERATIONS * ASYNC_ENVS, [wall]), "trace": trace,
                           "updates": st.updates}
    return rows


def staleness_zero_pins():
    """At 1 actor, a sync every tick and anakin's cadence the async run is anakin's, on the card."""
    from repro_torch.core import make_anakin
    from repro_torch.distributed.impala import make_async
    from repro_torch.envs import make_env
    from repro_torch.systems import registry
    from repro_torch.tree import tree_leaves

    out = {}
    for name, overrides, iterations, unroll in (
            ("ippo", PIN_PPO, 32, None),
            ("rec_ippo", dict(PIN_PPO, recurrent_core="linear"), 16, None),
            ("vdn", PIN_VDN, 64, 1)):
        system = registry.make_system(name, make_env("matrix_game"), **overrides)
        st_a, _ = make_anakin(system, iterations, 4, device="cuda")(1)
        st_b, _ = make_async(system, iterations, 4, 1, unroll_len=unroll, device="cuda")(1)
        _require(int(st_a.train.steps) == int(st_b.train.steps) > 0, f"pin {name}: steps")
        err = max(_err(x.cpu(), y.cpu()) for x, y in zip(
            tree_leaves((st_a.train.params, st_a.train.opt_state)),
            tree_leaves((st_b.train.params, st_b.train.opt_state)), strict=True))
        _require(err <= PIN_TOL, f"pin {name}: async differs from anakin by {err}")
        out[name] = err
    return out


def _sharded_rank(rank, world_size, device):
    """The one rank of the NCCL world: each sharded run twice, its training loops' walls."""
    from repro_torch.core.system import run_executor
    from repro_torch.launch.train_marl import _build_system

    del world_size
    out = {}
    for name, env in SHARDED_RUNS:
        runs = [run_executor(_build_system(name, env, None), 0, rank, ASYNC_ITERATIONS,
                             ASYNC_ENVS, device=device) for _ in range(2)]
        out[name] = {"walls_s": [float(r["metrics"]["wall_s"][0]) for r in runs],
                     "reward": float(runs[-1]["metrics"]["reward"][0]),
                     "finite": _finite(runs[-1]["params"])}
    return out


def sharded_world_one():
    """The sharded runner at one rank on NCCL (ippo/spread, madqn/matrix_game), beside anakin.

    One spawned world runs each system twice through `run_executor` (the
    rank's program of `train_distributed`): the first run of a fresh
    process pays its first-use costs (cuBLAS handles, CUDA module loading,
    the allocator's growth), which this process's anakin has paid already,
    so the second run's loop is the rate; the call's wall also holds the
    rank's start and NCCL's set-up.
    """
    from repro_torch.core import make_anakin
    from repro_torch.distributed import collective
    from repro_torch.systems.registry import make_pair

    (res,), wall = _timed_cuda(lambda: collective.run_world(_sharded_rank, 1, "nccl", "cuda",
                                                            timeout_s=300))
    steps = ASYNC_ITERATIONS * ASYNC_ENVS
    rows = {}
    for name, env in SHARDED_RUNS:
        r = res[name]
        _require(r["finite"], f"sharded {name}: non-finite params")
        _, system = make_pair(name, env)
        _, anakin_wall = _timed_cuda(
            lambda: make_anakin(system, ASYNC_ITERATIONS, ASYNC_ENVS, device="cuda")(0))
        rows[name] = {"env": env, "walls_s": r["walls_s"],
                      "env_steps_per_s": steps / r["walls_s"][-1],
                      "cold_env_steps_per_s": steps / r["walls_s"][0], "call_wall_s": wall,
                      "anakin_env_steps_per_s": steps / anakin_wall, "reward": r["reward"]}
    return rows


def _moments_rank(rank, world_size, device):
    """One rank of the 2-rank gloo world on one card: its final train state."""
    from repro_torch.core.system import run_executor
    from repro_torch.launch.train_marl import _build_system

    del world_size
    out = run_executor(_build_system("ippo", "spread", None), 0, rank, 256, 64, device=device)
    return {"train": out["state"].train, "params": out["params"]}


def gloo_world_on_one_card():
    """Two ranks on ``cuda:0`` over gloo: equal Adam moments, each rank's own params."""
    from repro_torch.distributed import collective
    from repro_torch.tree import tree_leaves

    (r0, r1), wall = _timed_cuda(lambda: collective.run_world(
        _moments_rank, 2, "gloo", ["cuda:0", "cuda:0"], timeout_s=300))
    equal = all(torch.equal(x, y) for x, y in zip(tree_leaves(r0["train"].opt_state),
                                                 tree_leaves(r1["train"].opt_state), strict=True))
    _require(equal, "gloo on one card: the ranks' Adam moments differ")
    gap = max(_err(x.cpu(), y.cpu()) for x, y in zip(tree_leaves(r0["train"].params),
                                                     tree_leaves(r1["train"].params)))
    _require(gap > 0, "gloo on one card: the ranks' params should differ (own inits)")
    _require(all(torch.equal(x, y) for x, y in zip(tree_leaves(r1["params"]),
                                                   tree_leaves(r0["train"].params))),
             "gloo on one card: rank 1 did not return rank 0's params")
    return {"params_gap": gap, "updates": int(r0["train"].steps), "wall_s": wall}


def distributed_phase(tag, ops):
    """Slice 9: the async actor/learner runner and the sharded runner on the card."""
    from repro_torch.launch import train_marl

    t0 = time.perf_counter()
    rates = async_rates()
    base = rates["anakin"]["env_steps_per_s"]
    for label, r in rates.items():
        extra = ("" if label.startswith("anakin") else
                 f"; {r['updates']} updates, queue depth {r['queue_depth_mean']:.2f}, "
                 f"staleness {r['staleness_mean']:.3f}, dropped {r['dropped_chunks']:.0f}; "
                 f"{r['env_steps_per_s'] / base:.3f}x anakin")
        print(f"train (distributed): ippo on spread, {label}, {ASYNC_ENVS} envs x "
              f"{ASYNC_ITERATIONS} iterations{'' if label.startswith('anakin') else ' an actor'}"
              f": {r['env_steps_per_s']:.0f} env steps/s (min {r['env_steps_per_s_min']:.0f}, "
              f"max {r['env_steps_per_s_max']:.0f}), walls {[round(w, 3) for w in r['walls_s']]}"
              f" s{extra} {tag}")
    rec = async_rec_launches(ops)
    for label, r in rec.items():
        print(f"train (distributed): async {label} on matrix_game, 2 actors x {ASYNC_ENVS} envs "
              f"x {ASYNC_ITERATIONS} iterations: {r['env_steps_per_s']:.0f} env steps/s; "
              f"{r['updates']} updates, staleness {r['staleness_mean']:.3f}; recurrent_scan "
              f"launches {r['launches']} ({r['launches_per_update']} an update) {tag}")
    more = async_replay_and_vtrace()
    r = more["vdn"]
    print(f"train (distributed): async vdn on spread, 2 actors x {ASYNC_ENVS} envs x "
          f"{ASYNC_ITERATIONS} iterations, unroll 8: {r['env_steps_per_s']:.0f} env steps/s; "
          f"{r['updates']} updates, queue depth {r['queue_depth_mean']:.2f}, staleness "
          f"{r['staleness_mean']:.3f}, dropped {r['dropped_chunks']:.0f} {tag}")
    r = more["ippo vtrace"]
    print(f"train (distributed): async V-trace ippo on spread (rollout 32), 1 actor, "
          f"param_sync_every 4: staleness {r['trace']}, {r['updates']} updates, "
          f"{r['env_steps_per_s']:.0f} env steps/s {tag}")
    pins = staleness_zero_pins()
    print(f"pin (distributed): async at staleness 0 vs anakin on the card, max abs diff of "
          f"params and Adam state: {', '.join(f'{k} {v:.3e}' for k, v in pins.items())} "
          f"(tol {PIN_TOL})")
    e = marl_update_parity("ippo", VTRACE_CLIPS, stale=True)
    print(f"slice parity (distributed): V-trace ippo on spread, stale behaviour log-probs, one "
          f"update of 2 seed lanes x {MARL_ENVS} envs on the card vs the CPU: first minibatch "
          f"loss {e['loss']:.3e}, grads {e['grads']:.3e}, params after its step "
          f"{e['params']:.3e} (tol {SLICE_TOL}); after all {e['steps']} steps params "
          f"{e['update_params']:.3e} (a reading)")
    sharded = sharded_world_one()
    for name, r in sharded.items():
        print(f"train (distributed): sharded {name} on {r['env']}, 1 rank on NCCL, "
              f"{ASYNC_ENVS} envs x {ASYNC_ITERATIONS} iterations: {r['env_steps_per_s']:.0f} env "
              f"steps/s in the rank's second loop ({r['cold_env_steps_per_s']:.0f} in its first;"
              f" walls {[round(w, 3) for w in r['walls_s']]} s; the world's call "
              f"{r['call_wall_s']:.2f} s), anakin {r['anakin_env_steps_per_s']:.0f} "
              f"({r['env_steps_per_s'] / r['anakin_env_steps_per_s']:.3f}x) {tag}")
    gloo = gloo_world_on_one_card()
    print(f"train (distributed): 2 gloo ranks on cuda:0, ippo on spread, 64 envs x 256 "
          f"iterations a rank: Adam moments equal bitwise after {gloo['updates']} updates, "
          f"params {gloo['params_gap']:.3e} apart (own inits) in {gloo['wall_s']:.2f} s")
    launched = train_marl.main(["--system", "ippo", "--env", "spread", "--runner", "async",
                                "--num-actors", "2", "--param-sync-every", "2", "--num-envs",
                                str(ASYNC_ENVS), "--iterations", str(ASYNC_ITERATIONS)])
    _require(launched["dropped_chunks"] == 0.0, "launcher async: dropped chunks")
    print(f"launcher (distributed): ippo on spread, --runner async, 2 actors, sync every 2: "
          f"{launched['steps_per_sec']:.0f} env steps/s ({launched['per_actor_steps_per_sec']:.0f}"
          f" an actor), staleness {launched['staleness_mean']:.3f} {tag}")
    print(f"slice 9 (distributed) in {time.perf_counter() - t0:.1f} s")
    return {"launches_async_rec_ippo": rec["rec_ippo linear"]["launches"],
            "launches_async_rec_ippo_vtrace": rec["rec_ippo linear vtrace"]["launches"]}


def _serve_sets(name, extra=()):
    """The launcher's ``--set`` flags for ``name`` at the smoke operating point (and ``extra``)."""
    from repro_torch.systems.registry import smoke_overrides

    sets = [f"{k}={v!r}" for k, v in smoke_overrides(name).items()] + list(extra)
    return [flag for s in sets for flag in ("--set", s)]


def _scan_update_bytes(T, N, M, n, H):
    """recurrent_scan's registered bytes for one rec-IPPO update (op_cost's count).

    A forward scan reads a, b and writes the output (T, B, H) float32, reads
    h0 (B, H) and the reset mask (T, B) in bytes; its reverse adjoint the
    same but h0.  An update runs one bootstrap critic unroll an agent over
    all N envs, then in each of M minibatches of N / M envs an actor and a
    critic unroll an agent, forward and backward.
    """
    fwd = lambda B: 3 * T * B * H * 4 + B * H * 4 + T * B
    bwd = lambda B: 3 * T * B * H * 4 + T * B
    return n * fwd(N) + M * n * 2 * (fwd(N // M) + bwd(N // M))


def serve_train(ops, root, gpu):
    """Train ippo and rec-IPPO (linear core) through the launcher with every telemetry flag.

    At serve_marl's defaults (matrix_game, 512 iterations x 8 envs, the
    smoke operating point), with --log-every, --log-dir, --run-id,
    --profile and --save-checkpoint; ippo on spread the same way, for the
    256-slot serving cell.  rec-IPPO's recurrent_scan launches over its
    launcher call must be what the updates' structure predicts.
    """
    from repro_torch.launch import train_marl
    from repro_torch.systems import PPOConfig
    from repro_torch.systems.registry import smoke_overrides

    out = {}
    for label, name, env, extra in (("ippo", "ippo", "matrix_game", ()),
                                    ("rec_ippo", "rec_ippo", "matrix_game",
                                     ("recurrent_core='linear'",)),
                                    ("ippo_spread", "ippo", "spread", ())):
        ops.linear_recurrent_scan.launches = 0
        (res,), wall = _timed_cuda(lambda: [train_marl.main([
            "--system", name, "--env", env, "--iterations", str(SERVE_TRAIN_ITERATIONS),
            "--num-envs", str(SERVE_TRAIN_ENVS), *_serve_sets(name, extra),
            "--log-every", str(SERVE_LOG_EVERY), "--log-dir", f"{root}/runs", "--run-id", label,
            "--profile", "--save-checkpoint", f"{root}/ckpt/{label}"])])
        launches = ops.linear_recurrent_scan.launches
        with open(res["run_record"]) as f:
            record = json.load(f)
        for section in ("run_id", "provenance", "config", "timing", "metrics", "retrace",
                        "profile"):
            _require(section in record, f"{label}: run record lacks {section!r}")
        prov = record["provenance"]
        _require(prov["backend"] == "cuda" and prov["device_kind"] == torch.cuda.get_device_name(0)
                 and f"{prov['gpu']}, {prov['power_limit']}" == gpu,
                 f"{label}: run record provenance {prov} does not name the card ({gpu})")
        prof = record["profile"]
        _require("skipped" not in prof and os.path.getsize(prof["trace_file"]) > 0,
                 f"{label}: no profiler trace ({prof})")
        _require(res["telemetry_rows"] == SERVE_TRAIN_ITERATIONS // SERVE_LOG_EVERY,
                 f"{label}: {res['telemetry_rows']} telemetry rows")
        row = {"wall_s": wall, "record": res["run_record"], "roofline": prof["roofline"],
               "phases": record["timing"]["phases"], "eval_return": res["eval_return"],
               "launches": launches}
        if name == "rec_ippo":
            cfg = PPOConfig(**smoke_overrides(name), recurrent_core="linear")
            n, M = 2, cfg.num_minibatches
            per_update = n + cfg.epochs * M * n * 2 * 2
            # the run's updates, --profile's update cycle twice (traced, then
            # counted), and the run record's phase timing: a warm update and 3
            # timed ones
            updates = SERVE_TRAIN_ITERATIONS // cfg.rollout_len + 2 + 4
            _require(launches == updates * per_update,
                     f"rec_ippo: recurrent_scan launched {launches}x over the launcher call, "
                     f"expected {updates} updates x {per_update}")
            scan = prof["roofline"]["custom_ops"].get("recurrent_scan", {})
            want = _scan_update_bytes(cfg.rollout_len, SERVE_TRAIN_ENVS, M, n,
                                      cfg.hidden_sizes[-1])
            _require(scan.get("calls") == per_update and scan.get("bytes") == want,
                     f"rec_ippo: roofline_summary counted recurrent_scan {scan}, expected "
                     f"{per_update} calls and {want} bytes")
            row.update(launches_per_update=per_update, updates=updates, scan_bytes=want)
        out[label] = row
    return out


def _state_equal(a, b):
    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def taps_on_off():
    """ippo/spread and rec-IPPO (linear)/matrix_game, tap on and off: bitwise, and the tap's cost.

    8 seed lanes x 256 envs x 64 iterations at the smoke operating point (2
    updates a lane); after a warm-up run, runs in turns off, on, on, off.
    """
    from repro_torch.core import make_anakin
    from repro_torch.obs import MetricTap, SeedAggregator
    from repro_torch.systems.registry import make_pair, smoke_overrides

    class Rows:
        def __init__(self):
            self.rows = []

        def write(self, metrics, step=None):
            self.rows.append(step)

        def close(self):
            pass

    out = {}
    for label, name, env, extra in (("ippo", "ippo", "spread", {}),
                                    ("rec_ippo linear", "rec_ippo", "matrix_game",
                                     {"recurrent_core": "linear"})):
        _, system = make_pair(name, env, **smoke_overrides(name), **extra)
        runs, walls = {}, {"off": [], "on": []}
        _timed_cuda(lambda: make_anakin(system, TAP_ITERATIONS, TAP_ENVS, num_seeds=TAP_SEEDS,
                                        device="cuda")(1))
        for mode in ("off", "on", "on", "off"):
            sink = Rows()
            tap = (MetricTap(SeedAggregator(sink), TAP_EVERY, TAP_SEEDS * TAP_ENVS)
                   if mode == "on" else None)
            program = make_anakin(system, TAP_ITERATIONS, TAP_ENVS, num_seeds=TAP_SEEDS,
                                  device="cuda", log_every=TAP_EVERY if tap else 0,
                                  log_callback=tap)
            (st, metrics), wall = _timed_cuda(lambda: program(0))
            walls[mode].append(wall)
            if tap is not None:
                _require(sink.rows == list(range(TAP_EVERY, TAP_ITERATIONS + 1, TAP_EVERY)),
                         f"taps {label}: rows at {sink.rows}")
            runs.setdefault(mode, (st.train, metrics))
            _require(_state_equal(runs[mode], (st.train, metrics)),
                     f"taps {label}: two runs of one mode differ")
        _require(int(runs["on"][0].steps.min()) == 2, f"taps {label}: {runs['on'][0].steps}")
        _require(_state_equal(runs["off"], runs["on"]),
                 f"taps {label}: the tapped run's params, optimizer state or metrics differ")
        out[label] = {"walls_off": walls["off"], "walls_on": walls["on"],
                      "cost_s": statistics.median(walls["on"]) - statistics.median(walls["off"]),
                      "emissions": TAP_ITERATIONS // TAP_EVERY}
    return out


def _logit_recorder(name, system):
    """``system`` whose greedy step also records each agent's logits (for the near-tie check)."""
    from repro_torch.systems import PPOConfig
    from repro_torch.systems.onpolicy import make_ppo_networks, make_recurrent_ppo_networks
    from repro_torch.systems.registry import smoke_overrides

    cfg = PPOConfig(**smoke_overrides(name), **(
        {"recurrent_core": "linear"} if name == "rec_ippo" else {}))
    if name == "rec_ippo":
        actor = make_recurrent_ppo_networks(system.env, cfg, False)[3]
        logits = lambda p, a, obs, carry: actor.step(p, a, carry.hidden["actor"][a], obs[a])[1]
    else:
        logits_fn = make_ppo_networks(system.env, cfg, False)[3]
        logits = lambda p, a, obs, carry: logits_fn(p, a, obs[a])
    log = []

    def select_actions(train, obs, state, carry, generator, training=True):
        with torch.no_grad():
            log.append({a: logits(train.params, a, obs, carry) for a in system.spec.agent_ids})
        return system.select_actions(train, obs, state, carry, generator, training=training)

    return dataclasses.replace(system, select_actions=select_actions), log


def _drive(engine, requests, max_ticks):
    """``serve_workload``'s arrival loop for at most ``max_ticks`` ticks: the decisions a tick."""
    pending = sorted(requests, key=lambda r: (r.arrival_tick, r.uid))
    ticks, clock, i = [], 0, 0
    while len(ticks) < max_ticks:
        while i < len(pending) and pending[i].arrival_tick <= clock:
            engine.submit(pending[i])
            i += 1
        if engine.idle():
            if i >= len(pending):
                break
            clock = pending[i].arrival_tick
            continue
        ticks.append(engine.tick())
        clock += 1
    return ticks


def card_vs_cpu_actions(label, name, directory, slots, streams):
    """The first 64 ticks' served actions on the card against the CPU, near ties counted.

    Both engines serve the same requests with the same resets (made on the
    CPU from each request's seed); a decision that differs must be a near
    tie on the CPU (its top two logits within NEAR_TIE), and the rest of
    that episode is then not compared (the next observation may differ).
    """
    from repro_torch.serve import DecisionEngine, load_policy, poisson_requests
    from repro_torch.tree import tree_map

    def requests(device):
        reqs = poisson_requests(streams, SERVE_EPISODES, SERVE_RATE, seed=0)
        for r in reqs:
            env_reset = cpu_system.env.reset(1, torch.device("cpu"),
                                             torch.Generator().manual_seed(r.seed))
            r.reset = tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x,
                               env_reset)
        return reqs

    _, cpu_system, cpu_train = load_policy(directory, device="cpu")
    _, card_system, card_train = load_policy(directory, device="cuda")
    recorded, log = _logit_recorder(name, cpu_system)
    cpu_reqs, card_reqs = requests("cpu"), requests("cuda")
    cpu_ticks = _drive(DecisionEngine(recorded, cpu_train, max_slots=slots, warmup=False,
                                      device="cpu"), cpu_reqs, PARITY_TICKS)
    card_ticks = _drive(DecisionEngine(card_system, card_train, max_slots=slots, device="cuda"),
                        card_reqs, PARITY_TICKS)
    _require(len(cpu_ticks) == len(card_ticks) == PARITY_TICKS,
             f"{label}: {len(cpu_ticks)} / {len(card_ticks)} ticks")
    slot_of = {r.uid: r.slot for r in cpu_reqs}
    decisions, near_ties, skipped, diverged = 0, 0, 0, set()
    for t, (cpu, card) in enumerate(zip(cpu_ticks, card_ticks)):
        _require(set(cpu) == set(card), f"{label}: tick {t} served other requests")
        for uid, decision in cpu.items():
            if uid in diverged:
                skipped += 1
                continue
            for a, act in decision.items():
                decisions += 1
                if int(card[uid][a]) == int(act):
                    continue
                top2 = torch.topk(log[t][a][slot_of[uid]], 2).values
                gap = float(top2[0] - top2[1])
                _require(gap <= NEAR_TIE, f"{label}: tick {t} request {uid} {a}: card "
                         f"{int(card[uid][a])}, CPU {int(act)}, top-two logit gap {gap:.3e}")
                near_ties += 1
                diverged.add(uid)
    return {"decisions": decisions, "near_ties": near_ties, "skipped_after_tie": skipped}


def _serve_cell(directory, slots, streams):
    from repro_torch.serve import DecisionEngine, load_policy, poisson_requests, serve_workload

    _, system, train = load_policy(directory, device="cuda")
    engine = DecisionEngine(system, train, max_slots=slots, device="cuda")
    return serve_workload(engine, poisson_requests(streams, SERVE_EPISODES, SERVE_RATE, seed=0))


def served_equals_evaluator(directory, slots):
    """Greedy served returns = `evaluate`'s on the card, for the evaluator's own resets."""
    from repro_torch.eval import evaluate
    from repro_torch.serve import DecisionEngine, ServeRequest, load_policy
    from repro_torch.tree import tree_map

    _, system, train = load_policy(directory, device="cuda")
    B, seed = 8, 7
    ev = evaluate(system, train, seed, num_episodes=B, num_envs=B, device="cuda")
    state, ts = system.env.reset(B, torch.device("cuda"),
                                 torch.Generator("cuda").manual_seed(seed))
    row = lambda tree, i: tree_map(lambda x: x[i:i + 1] if isinstance(x, torch.Tensor) else x,
                                   tree)
    engine = DecisionEngine(system, train, max_slots=slots, device="cuda")
    for i in range(B):
        engine.submit(ServeRequest(uid=i, reset=(row(state, i), row(ts, i))))
    finished = sorted(engine.run_until_drained(), key=lambda r: r.uid)
    served = torch.tensor([r.episode_return for r in finished], device="cuda")
    return bool(torch.equal(served, ev.episode_return)), served.tolist()


def engine_idle_share(directory, slots):
    """The device's busy time and idle share over 32 ticks of a full pool of ``slots``.

    4 x ``slots`` requests queued, so the pool stays full; the 32 ticks
    after the first hold an episode boundary and its admission wave.
    """
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.breakdown import _device_summary
    from repro_torch.serve import DecisionEngine, ServeRequest, load_policy

    _, system, train = load_policy(directory, device="cuda")
    engine = DecisionEngine(system, train, max_slots=slots, device="cuda")
    for i in range(4 * slots):
        engine.submit(ServeRequest(uid=i, seed=i))
    engine.tick()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed_cuda(lambda: [engine.tick() for _ in range(32)])
    return _device_summary(prof, wall)


def serve_sweep(root):
    """eval_marl on ippo, vdn, rec_ippo, maddpg x matrix_game, spread; 2 seeds, 8 iterations."""
    from repro_torch.launch import eval_marl

    out = f"{root}/BENCH_eval.json"
    results, wall = _timed_cuda(lambda: eval_marl.main([
        "--systems", *SWEEP_SYSTEMS, "--envs", *SWEEP_ENVS, "--seeds", "0", "1",
        "--train-iterations", "8", "--out", out]))
    cells = {(s, e): c for s, v in results["systems"].items() for e, c in v["envs"].items()}
    _require(len(cells) == len(SWEEP_SYSTEMS) * len(SWEEP_ENVS), f"sweep: {len(cells)} cells")
    _require(cells[("maddpg", "matrix_game")] == {
        "compatible": False,
        "reason": "maddpg supports continuous action spaces; env has discrete actions"},
        f"sweep: maddpg x matrix_game {cells[('maddpg', 'matrix_game')]}")
    _require(sum(not c["compatible"] for c in cells.values()) == 1, "sweep: incompatible cells")
    _require(all(np.isfinite(c["aggregates"]["iqm"]) for c in cells.values() if c["compatible"]),
             "sweep: non-finite IQM")
    return {"wall_s": wall, "out": out, "cells": {
        f"{s} x {e}": (c["aggregates"]["iqm"] if c["compatible"] else None)
        for (s, e), c in cells.items()}}


def serve_phase(tag, ops, gpu):
    """Slice 10: telemetry, run records, train -> checkpoint -> serve / eval on the card."""
    import shutil

    t0 = time.perf_counter()
    root = SERVE_ROOT
    shutil.rmtree(root, ignore_errors=True)
    trained = serve_train(ops, root, gpu)
    for label, r in trained.items():
        roof = r["roofline"]
        print(f"train (serve): {label} through train_marl with --log-every {SERVE_LOG_EVERY} "
              f"--log-dir --run-id --profile --save-checkpoint, {SERVE_TRAIN_ENVS} envs x "
              f"{SERVE_TRAIN_ITERATIONS} iterations: call {r['wall_s']:.2f} s, greedy eval "
              f"return {r['eval_return']:.3f}; phases {json.dumps(r['phases'])}; op cost of one "
              f"update cycle ({roof['iterations']} iterations): {roof['hlo_flops']:.0f} flop, "
              f"{roof['hlo_bytes']:.0f} B, recurrent_scan "
              f"{json.dumps(roof['custom_ops'].get('recurrent_scan'))}; recurrent_scan launches "
              f"{r['launches']} {tag}")
    taps = taps_on_off()
    for label, r in taps.items():
        print(f"taps (serve): {label}, {TAP_SEEDS} seeds x {TAP_ENVS} envs x {TAP_ITERATIONS} "
              f"iterations, tap every {TAP_EVERY}: params, optimizer state and metrics equal "
              f"bitwise on and off; walls off {[round(w, 4) for w in r['walls_off']]} s, on "
              f"{[round(w, 4) for w in r['walls_on']]} s: the tap costs {r['cost_s'] * 1e3:.2f} "
              f"ms a run ({r['emissions']} emissions) {tag}")
    cells = {}
    for label in ("ippo", "rec_ippo"):
        directory = f"{root}/ckpt/{label}"
        for slots in SERVE_SLOTS:
            c = _serve_cell(directory, slots, SERVE_STREAMS)
            equal, served = served_equals_evaluator(directory, slots)
            _require(equal, f"serve {label} slots {slots}: served returns {served} differ from "
                            f"the evaluator's")
            cells[(label, slots)] = c
            idle = engine_idle_share(directory, slots)
            _require(idle["device_idle_share"] is not None, "serve: the profiler saw no device time")
            lat = c["latency"]
            print(f"serve (engine): {label} matrix_game, slots {slots}, {SERVE_STREAMS} streams x "
                  f"{SERVE_EPISODES} episodes at {SERVE_RATE}: p50 {lat['p50_ms']:.3f} ms, p99 "
                  f"{lat['p99_ms']:.3f} ms a decision, {c['decisions_per_sec']:.0f} decisions/s, "
                  f"{c['ticks']} ticks, mean return {c['episode_return_mean']:.3f}; greedy served "
                  f"returns = the evaluator's; a full pool's 32 ticks under torch.profiler: wall "
                  f"{idle['wall_s'] * 1e3:.2f} ms, device busy {idle['device_busy_s'] * 1e3:.2f} "
                  f"ms, idle share {idle['device_idle_share']:.4f}, {idle['kernel_launches']} "
                  f"kernel launches {tag}")
        parity = card_vs_cpu_actions(label, label, directory, 2, SERVE_STREAMS)
        print(f"serve parity: {label} slots 2, first {PARITY_TICKS} ticks, card vs CPU: "
              f"{parity['decisions']} decisions compared, {parity['near_ties']} differ at a near "
              f"tie (top-two CPU logits within {NEAR_TIE}), {parity['skipped_after_tie']} "
              f"decisions after one not compared")
    wide_dir = f"{root}/ckpt/ippo_spread"
    c = _serve_cell(wide_dir, WIDE_SLOTS, WIDE_SLOTS)
    cells[("ippo_spread", WIDE_SLOTS)] = c
    idle = engine_idle_share(wide_dir, WIDE_SLOTS)
    _require(idle["device_idle_share"] is not None, "serve: the profiler saw no device time")
    lat = c["latency"]
    print(f"serve (engine): ippo spread, slots {WIDE_SLOTS}, {WIDE_SLOTS} streams x "
          f"{SERVE_EPISODES} episodes at {SERVE_RATE}: p50 {lat['p50_ms']:.3f} ms, p99 "
          f"{lat['p99_ms']:.3f} ms a decision, {c['decisions_per_sec']:.0f} decisions/s, "
          f"{c['ticks']} ticks, mean live slots {c['mean_live_slots']:.1f}, mean return "
          f"{c['episode_return_mean']:.3f}; a full pool's 32 ticks under torch.profiler: wall "
          f"{idle['wall_s'] * 1e3:.2f} ms, device busy {idle['device_busy_s'] * 1e3:.2f} ms, idle "
          f"share {idle['device_idle_share']:.4f}, {idle['kernel_launches']} kernel launches "
          f"{tag}")
    parity = card_vs_cpu_actions("ippo spread", "ippo", wide_dir, WIDE_SLOTS, WIDE_SLOTS)
    print(f"serve parity: ippo spread slots {WIDE_SLOTS}, first {PARITY_TICKS} ticks, card vs "
          f"CPU: {parity['decisions']} decisions compared, {parity['near_ties']} differ at a near "
          f"tie (top-two CPU logits within {NEAR_TIE}), {parity['skipped_after_tie']} decisions "
          f"after one not compared")
    sweep = serve_sweep(root)
    print(f"sweep (eval_marl): {len(sweep['cells'])} cells into {sweep['out']} in "
          f"{sweep['wall_s']:.2f} s, IQMs {json.dumps(sweep['cells'])} {tag}")
    print(f"slice 10 (serve) in {time.perf_counter() - t0:.1f} s")
    return {"launches_serve_train": trained["rec_ippo"]["launches"]}


def _scan_inputs(b, S, di, N, dtype, seed):
    """Selective-scan operands on the card, drawn like prefill's (delta > 0, A < 0)."""
    g = torch.Generator("cuda").manual_seed(seed)
    dev = torch.device("cuda")
    t = {
        "x": torch.randn(b, S, di, generator=g, device=dev),
        "delta": torch.randn(b, S, di, generator=g, device=dev).abs() * 0.1,
        "A": -(torch.randn(di, N, generator=g, device=dev).abs() + 0.5),
        "B": torch.randn(b, S, N, generator=g, device=dev),
        "C": torch.randn(b, S, N, generator=g, device=dev),
        "D": torch.randn(di, generator=g, device=dev),
    }
    for k in ("x", "B", "C"):
        t[k] = t[k].to(dtype)
    return t


def scan_parity(sops, sref):
    """selective_scan against its plain version, float32 and bf16 inputs."""
    worst = {}
    for b, S, di, N in SCAN_PATH_SHAPES + [SCAN_RAGGED] + SCAN_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            t = _scan_inputs(b, S, di, N, dtype, seed=b + S)
            y, h = sops.selective_scan(**t)
            y_ref, h_ref = sref.selective_scan_ref(**t)
            torch.cuda.synchronize()
            case = f"b={b} S={S} di={di} N={N} {str(dtype)[6:]}"
            y_tol = SCAN_TOL if dtype == torch.float32 else SCAN_BF16_Y_TOL
            _require(y.dtype == dtype and h.dtype == torch.float32, f"dtypes: {case}")
            _require(_within(y.float(), y_ref.float(), y_tol), f"y differs: {case}")
            _require(_within(h, h_ref, SCAN_TOL), f"h_final differs: {case}")
            worst[case] = {"y": _err(y.float(), y_ref.float()), "h_final": _err(h, h_ref)}
    return worst


def scan_timing(sops, sref):
    """Kernel, plain-version and bound times at the path's shapes, bf16 x/B/C.

    ``ms`` and ``device_ms`` as in `kernel_timing`.
    """
    rows = []
    for b, S, di, N in SCAN_PATH_SHAPES:
        t = _scan_inputs(b, S, di, N, torch.bfloat16, seed=0)
        ms = _time_ms(lambda: sops._launch(**t))
        dev_ms = _device_ms(lambda: sops._launch(**t), inner=5)
        plain_ms = _time_ms(lambda: sref.selective_scan_ref(**t), reps=3, inner=1)
        # each input read once, each output written once: x, y (b,S,di) bf16,
        # delta (b,S,di) f32, B, C (b,S,N) bf16, A (di,N) f32, D (di,) f32,
        # h_final (b,di,N) f32
        nbytes = b * S * di * (2 + 4 + 2) + 2 * b * S * N * 2 + di * N * 4 + di * 4 + b * di * N * 4
        exps = b * S * di * N  # one exp(delta A) per (b, t, d, n)
        # per (b, t, d, n): delta*A, the h fma (2), dx*B, the y fma (2)
        flops = b * S * di * (6 * N + 3)
        bounds = {
            "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": max(exps / SFU_EXP_PER_S, flops / F32_FLOPS_PER_S) * 1e3,
        }
        bound_by = max(bounds, key=bounds.get)
        rows.append({
            "b": b, "S": S, "di": di, "N": N, "dtype": "bfloat16", "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bytes": nbytes, "exps": exps, "flops": flops,
            "bytes_ms": bounds["bytes"], "exp_ms": exps / SFU_EXP_PER_S * 1e3,
            "flop_ms": flops / F32_FLOPS_PER_S * 1e3,
            "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "bound_share": bounds[bound_by] / ms, "device_bound_share": bounds[bound_by] / dev_ms,
        })
    return rows


def serve_launcher(sops):
    """The launcher's path at the published config: batch 4, prompt 2048, 32 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = M.init_model(torch.Generator("cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompts = serve.make_inputs(cfg, 4, 2048, 0, "cuda")["tokens"]
    warm = serve.generate(model, prompts, 2)  # first calls: cuBLAS, allocator
    cold_prefill_s = warm.prefill_s
    del warm
    torch.cuda.reset_peak_memory_stats()
    sops.selective_scan.launches = 0
    run = serve.generate(model, prompts, 32)
    launches = sops.selective_scan.launches
    peak = torch.cuda.max_memory_allocated()
    _require(launches == cfg.num_layers, f"prefill launched selective_scan {launches}x")
    _require(run.tokens.shape == (4, 32), f"tokens {tuple(run.tokens.shape)}")
    _require(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()), "token out of range")
    for name, logits in (("prefill", run.prefill_logits), ("decode", run.logits)):
        _require(logits.shape == (4, 1, cfg.vocab), f"{name} logits {tuple(logits.shape)}")
        _require(bool(torch.isfinite(logits.float()).all()), f"non-finite {name} logits")
    steps = 31
    return model, {
        "init_s": init_s, "params": n_params, "param_bytes": param_bytes,
        "cold_prefill_ms": cold_prefill_s * 1e3, "prefill_ms": run.prefill_s * 1e3,
        "decode_ms_per_step": run.decode_s / steps * 1e3,
        "decode_tok_per_s": 4 * steps / run.decode_s,
        "peak_gb": peak / 1e9, "launches": launches,
        "sample": run.tokens[0, :16].tolist(),
    }


def serve_engine(sops, model):
    """The engine at the published config: 4 slots, 8 ragged requests, 16 tokens each."""
    from repro_torch.serving import Request, ServingEngine

    cfg = model.cfg
    rng = np.random.default_rng(1)
    lens = rng.integers(16, 65, size=8)
    engine = ServingEngine(model, max_slots=4, device="cuda")
    for i, n in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
        engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=16))
    torch.cuda.synchronize()
    sops.selective_scan.launches = 0
    t0 = time.perf_counter()
    finished = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sops.selective_scan.launches
    _require(sorted(r.uid for r in finished) == list(range(8)), "engine lost a request")
    _require(all(len(r.output) == 16 for r in finished), "a request ended short")
    _require(all(0 <= t < cfg.vocab for r in finished for t in r.output), "token out of range")
    _require(launches == cfg.num_layers * 8, f"engine launched selective_scan {launches}x")
    return {
        "wall_s": wall, "tok_per_s": 8 * 16 / wall, "launches": launches,
        "prompt_lens": [int(n) for n in lens],
    }


def lm_slice_parity(arch=ARCH, changes=None, prompt=40):
    """Full width cut by ``changes`` (default: to 2 layers), float32: the same weights on
    the card and the CPU.

    Prefill logits and every cache leaf for 2 prompts of ``prompt``
    positions, then 4 decode steps on equal tokens, then (a token-only
    model) the engine on the card against sequential generation.
    """
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(arch), dtype="float32", **(changes or {"num_layers": 2}))
    cpu = M.init_model(torch.Generator().manual_seed(1), cfg)
    gpu = M.LM(tree_map(lambda t: t.to("cuda"), cpu.tree()), cfg)
    inputs = serve.make_inputs(cfg, 2, prompt, 2, "cpu")
    tokens, vision = inputs["tokens"], inputs.get("vision_embeds")
    lc, cc = M.prefill(cpu, tokens, max_len=prompt + 4, vision_embeds=vision)
    lg, cg = M.prefill(gpu, tokens.cuda(), max_len=prompt + 4,
                       vision_embeds=None if vision is None else vision.cuda())
    out = {"prefill_logits": _err(lg.cpu(), lc)}
    _require(_within(lg.cpu(), lc, LM_TOL), f"prefill logits differ by {out['prefill_logits']}")
    _require(torch.equal(cg["pos"].cpu(), cc["pos"]), "pos differs")
    out["cache"] = 0.0
    for x, y in zip(tree_leaves(cg), tree_leaves(cc)):
        out["cache"] = max(out["cache"], _err(x.cpu(), y))
        _require(_within(x.cpu(), y, LM_TOL), f"a cache leaf differs by {_err(x.cpu(), y)}")

    # 4 greedy steps, both fed the CPU's tokens (audio: a token a codebook)
    tok = lc.argmax(-1)
    differing, worst = [], 0.0
    for step in range(4):
        lc, cc = M.decode_step(cpu, cc, tok)
        lg, cg = M.decode_step(gpu, cg, tok.cuda())
        worst = max(worst, _err(lg.cpu(), lc))
        want, got = lc.argmax(-1), lg.cpu().argmax(-1)
        rows = lc.reshape(-1, cfg.vocab)
        for i in torch.nonzero(want.reshape(-1) != got.reshape(-1))[:, 0].tolist():
            top2 = rows[i].topk(2).values
            gap = float(top2[0] - top2[1])
            print(f"slice parity: {arch} decode step {step} row {i}: card token "
                  f"{int(got.reshape(-1)[i])}, CPU token {int(want.reshape(-1)[i])}, CPU top-2 "
                  f"gap {gap:.3e}")
            _require(gap < LM_TOL, f"decode step {step} row {i}: tokens differ, gap {gap}")
            differing.append((step, i))
        tok = want
    out["decode_logits"] = worst
    out["decode_cache"] = max(_err(x.cpu(), y) for x, y in zip(tree_leaves(cg), tree_leaves(cc)))
    _require(out["decode_cache"] <= LM_TOL * (1 + max(float(y.abs().max())
                                                       for y in tree_leaves(cc))),
             f"the cache after decode differs by {out['decode_cache']}")
    out["differing_tokens"] = len(differing)
    if cfg.arch_type in ("vlm", "audio"):  # the engine covers token-only archs
        return out

    # the engine on the card = sequential generation (tests/test_serving.py)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in (12, 9, 15)]
    engine = ServingEngine(gpu, max_slots=2, device="cuda")
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    got = {r.uid: r.output for r in engine.run_until_drained()}
    for i, p in enumerate(prompts):
        one = torch.as_tensor(p[None], dtype=torch.long, device="cuda")
        ref = serve.generate(gpu, one, 6).tokens[0].tolist()
        _require(got[i] == ref, f"engine stream {i} {got[i]} != sequential {ref}")
    return out


def _attn_inputs(B, Hq, Hkv, S, hd, dtype, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(B, H, S, hd, generator=g, device="cuda").to(dtype)
            for H in (Hq, Hkv, Hkv)]


def flash_parity(fops, fref):
    """flash_attention against its plain version, forward (`ref.kernel_errors`)."""
    worst = {}
    for B, Hq, Hkv, S, hd, causal, window, dtype in FLASH_CASES:
        q, k, v = _attn_inputs(B, Hq, Hkv, S, hd, dtype, seed=S + hd)
        out = fops.flash_attention(q, k, v, causal=causal, window=window)
        elem, row, max_abs = fref.kernel_errors(out, q, k, v, causal=causal, window=window)
        case = (f"B={B} Hq={Hq} Hkv={Hkv} S={S} hd={hd} causal={causal} window={window} "
                f"{str(dtype)[6:]}")
        _require(out.dtype == dtype, f"flash output dtype: {case}")
        _require(elem <= 1 and row <= fref.ROW_TOL,
                 f"flash_attention differs: {case}: {elem:.3f} of the element allowance, "
                 f"row {row:.3e}")
        worst[case] = {"abs": max_abs, "elem": elem, "row": row}
        del q, k, v, out
    return worst


def xent_parity(xops, xref):
    """fused_xent against its plain version, float32 and bf16 (`ref.kernel_errors`)."""
    worst = {}
    cases = [(T, d, V, dt) for T, d, V in XENT_CASES for dt in (torch.float32, torch.bfloat16)]
    for T, d, V, dtype in cases + [(*XENT_PATH, torch.bfloat16)]:
        g = torch.Generator("cuda").manual_seed(T + V)
        x = torch.randn(T, d, generator=g, device="cuda").to(dtype)
        w = (torch.randn(d, V, generator=g, device="cuda") * d**-0.5).to(dtype)
        labels = torch.randint(0, V, (T,), generator=g, device="cuda")
        got = xops.fused_softmax_xent(x, w, labels)
        elem, total, max_abs = xref.kernel_errors(got, x, w, labels)
        case = f"T={T} d={d} V={V} {str(dtype)[6:]}"
        _require(elem <= 1 and total <= 1,
                 f"fused_xent differs: {case}: {elem:.3f} of the token allowance, "
                 f"{total:.3f} of the summed one")
        worst[case] = {"abs": max_abs, "elem": elem, "total": total}
        del x, w, labels, got
    return worst


def _bound(nbytes, flops, f32_flops=0):
    """Bytes at 3.35 TB/s against operations: bf16 at 989 TFLOP/s, float32 at 67."""
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": (flops / BF16_FLOPS_PER_S + f32_flops / F32_FLOPS_PER_S) * 1e3}
    bound_by = max(bounds, key=bounds.get)
    return bounds, bound_by


def flash_timing(fops, fref, shape=FLASH_PATH, window=0):
    """Kernel, plain, SDPA and bound times at ``shape`` (the training shape), bf16, causal.

    SDPA has no window: a ``window`` is timed only where it is at least S,
    where it keeps every causal pair.
    """
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import _live_pairs

    B, Hq, Hkv, S, hd = shape
    _require(not window or window >= S, f"SDPA has no window of {window} < S = {S}")
    q, k, v = _attn_inputs(B, Hq, Hkv, S, hd, torch.bfloat16, seed=0)
    ms = _time_ms(lambda: fops._launch(q, k, v, True, window), reps=10, inner=5)
    plain_ms = _time_ms(lambda: fref.attention_ref(q, k, v, window=window), reps=3, inner=1)
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        reps=10, inner=5)
    # each input read once, the output written once; two products over the
    # S (S + 1) / 2 live (query, key) pairs of each (b, h)
    nbytes = 2 * (2 * B * Hq * S * hd + 2 * B * Hkv * S * hd)
    flops = 4 * hd * _live_pairs(S, True, window) * B * Hq
    bounds, bound_by = _bound(nbytes, flops)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bytes": nbytes,
            "flops": flops, "bytes_ms": bounds["bytes"], "flop_ms": bounds["operations"],
            "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} hd={hd} causal"
                     f"{f' window={window}' if window else ''} bf16"}


def xent_timing(xops, xref):
    """Kernel, plain, cuBLAS-product and bound times at the training shape, bf16."""
    T, d, V = XENT_PATH
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(T, d, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(d, V, generator=g, device="cuda") * d**-0.5).to(torch.bfloat16)
    labels = torch.randint(0, V, (T,), generator=g, device="cuda", dtype=torch.int32)
    ms = _time_ms(lambda: xops._launch(x, w, labels), reps=10, inner=2)
    plain_ms = _time_ms(lambda: xref.softmax_xent_ref(x, w, labels), reps=5, inner=1)
    gemm_ms = _time_ms(lambda: x @ w, reps=10, inner=2)  # the GEMM part alone, as context
    # x, w, labels read once, the loss written once; 2 T d V for the product
    nbytes = T * d * 2 + d * V * 2 + T * 4 + T * 4
    flops = 2 * T * d * V
    bounds, bound_by = _bound(nbytes, flops)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "gemm_ms": gemm_ms,
            "bytes": nbytes,
            "flops": flops, "bytes_ms": bounds["bytes"], "flop_ms": bounds["operations"],
            "bound_ms": bounds[bound_by], "bound_by": bound_by,
            "shape": f"T={T} d={d} V={V} bf16"}


def train_lm(fops, xops):
    """The launcher at the published config, then one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.breakdown import _device_summary
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    fops.flash_attention.launches = 0
    xops.fused_softmax_xent.launches = xops.fused_softmax_xent.combine_launches = 0
    run = train.main(["--arch", DENSE_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
                      str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", "3e-4",
                      "--log-every", "1"])
    flash_launches = fops.flash_attention.launches
    xent_launches = xops.fused_softmax_xent.launches
    combine_launches = xops.fused_softmax_xent.combine_launches
    peak = torch.cuda.max_memory_allocated()
    cfg = run.model.cfg
    _require(len(run.losses) == TRAIN_STEPS and all(np.isfinite(run.losses)),
             f"losses {run.losses}")
    _require(flash_launches == 2 * cfg.num_layers * TRAIN_STEPS,
             f"flash_attention launched {flash_launches}x in {TRAIN_STEPS} steps")
    _require(xent_launches == TRAIN_STEPS,
             f"fused_xent launched {xent_launches}x in {TRAIN_STEPS} steps")
    _require(combine_launches == TRAIN_STEPS,
             f"fused_xent's combine launched {combine_launches}x in {TRAIN_STEPS} steps")
    step_s = statistics.median(run.step_s[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in run.model.parameters())
    # the reference's count leaves out the final norm's d_model scales
    _require(n_params == cfg.param_count() + cfg.d_model,
             f"{n_params} params, config says {cfg.param_count()}")

    # one more step under the profiler
    _, step = make_train_step(cfg, 3e-4)
    host = SyntheticTokenDataset(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=1).sample(
        np.random.default_rng(1))
    batch = {name: torch.as_tensor(host[name], device="cuda") for name in ("tokens", "labels")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, metrics = step(run.model, run.opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _require(bool(torch.isfinite(metrics["loss"])), "non-finite profiled loss")
    summary = _device_summary(prof, wall, "flash_attention_", "fused_xent_", "xent_combine")
    seen = tuple(summary[k]["profiler"] for k in ("flash_attention_", "fused_xent_",
                                                  "xent_combine"))
    _require(seen == (2 * cfg.num_layers, 1, 1),
             f"the profiler saw (flash, xent, combine) launches {seen}")
    return {
        "params": n_params, "losses": run.losses, "step_s": run.step_s,
        "step_s_median": step_s, "tokens_per_s": tokens / step_s,
        "six_n_share": M.model_flops_per_token(cfg) * tokens / step_s / BF16_FLOPS_PER_S,
        "peak_gb": peak / 1e9, "flash_launches": flash_launches, "xent_launches": xent_launches,
        "combine_launches": combine_launches, "profiled": summary,
    }


def dense_slice_parity():
    """Full width, 2 layers, float32, batch 1 x 256: card vs CPU, one train step."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(DENSE_ARCH), num_layers=2, dtype="float32")
    cpu = M.init_model(torch.Generator().manual_seed(1), cfg)
    gpu = M.LM(tree_map(lambda t: t.to("cuda", copy=True), cpu.tree()), cfg)
    host = SyntheticTokenDataset(cfg.vocab, 256, 1, seed=2).sample(np.random.default_rng(2))
    results = []
    for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
        batch = {name: torch.as_tensor(host[name], device=dev) for name in ("tokens", "labels")}
        loss, _ = M.forward_train(model, batch)
        loss.backward()
        grads = tree_leaves(model.tree(lambda p: p.grad))
        for p in model.parameters():
            p.grad = None
        opt, step = make_train_step(cfg, 3e-4)
        model, _, metrics = step(model, opt.init(model.tree()), batch)
        results.append((float(loss.detach()), [g.cpu() for g in grads],
                        [p.cpu() for p in tree_leaves(model.tree())], float(metrics["loss"])))
    (lg, gg, pg, mg), (lc, gc, pc, mc) = results
    out = {"loss": abs(lg - lc), "step_loss": abs(mg - mc),
           "grads": max(_err(x, y) for x, y in zip(gg, gc)),
           "params": max(_err(x, y) for x, y in zip(pg, pc))}
    _require(abs(lg - lc) <= LM_TOL * (1 + abs(lc)), f"loss {lg} on the card, {lc} on the CPU")
    _require(abs(mg - mc) <= LM_TOL * (1 + abs(mc)), "train step loss differs")
    for name, xs, ys in (("gradient", gg, gc), ("parameter", pg, pc)):
        for i, (x, y) in enumerate(zip(xs, ys)):
            _require(_within(x, y, LM_TOL), f"{name} leaf {i} differs by {_err(x, y)}")
    return out


class _RoutingRecorder:
    """Wraps `moe.top_k_routing` to count routed, kept and expert-used assignments.

    The counts stay on the card until `read`; a recorded run is not timed.
    """

    def __init__(self, moe_lib):
        self.moe_lib, self.inner, self.counts = moe_lib, moe_lib.top_k_routing, []

    def __enter__(self):
        def recorded(logits, top_k, capacity):
            out = self.inner(logits, top_k, capacity)
            dispatch = out[0]  # (G, g, E, C)
            self.counts.append((logits.shape[0] * logits.shape[1] * top_k, dispatch.sum(),
                                dispatch.any(dim=3).any(dim=1).sum(), logits.shape[0]))
            return out

        self.moe_lib.top_k_routing = recorded
        return self

    def __exit__(self, *exc):
        self.moe_lib.top_k_routing = self.inner

    def read(self):
        """(routed, kept, experts used a group on average, each call's dropped share).

        The counts are cleared.
        """
        routed = sum(c[0] for c in self.counts)
        kept = [int(c[1]) for c in self.counts]
        groups = sum(c[3] for c in self.counts)
        used = sum(int(c[2]) for c in self.counts) / max(groups, 1)
        dropped = [round(1 - k / c[0], 4) for k, c in zip(kept, self.counts)]
        self.counts = []
        return routed, sum(kept), used, dropped


def _attention_layers(cfg):
    """Layers that run attention, hence flash once a prefill: a hybrid's shared-block
    invocations, every layer elsewhere."""
    return cfg.num_attn_invocations if cfg.arch_type == "hybrid" else cfg.num_layers


def _uncounted_params(cfg):
    """Parameters `ModelConfig.param_count` leaves out, as the reference's formula does:
    the final norm's d_model scales and, a mamba2 layer, ``conv_b`` (d_inner + 2
    ssm_state), ``dt_bias`` (ssm_heads) and ``norm_scale`` (d_inner)."""
    if cfg.arch_type != "hybrid":
        return cfg.d_model
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return cfg.d_model + cfg.num_layers * ((di + 2 * n) + h + di)


def _ssd_flops(cfg, B, S):
    """Float32 operations of mamba2's SSD over a prompt of S, every layer (`ssd_chunked`):
    a chunk of l takes C.B over its l (l + 1) / 2 causal pairs and M.(x dt) for each
    head, its input to the state and the entering state's output (2 l n h p each)."""
    l = min(cfg.ssm_chunk, S)
    chunks = -(-S // l)
    n, h, p = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    pairs = l * (l + 1) // 2
    per_chunk = 2 * n * pairs + 2 * h * p * pairs + 2 * (2 * l * n * h * p)
    return per_chunk * chunks * B * cfg.num_layers


def _serve_bounds(cfg, B, S, gen, experts_used=None):
    """Least prefill and decode-step times (ms) on this card for the launcher's work.

    Prefill: the layers' products over B * S positions (an MoE layer's
    top_k experts a token and its router; a hybrid's mamba2 projections
    every layer and its shared block at each of its invocations) plus
    attention over the causal pairs, and the last position's unembedding,
    at 989 TFLOP/s in bf16, and a hybrid's SSD at 67 TFLOP/s in float32;
    or the weights read once (a shared block once), the embedding rows
    (an audio position's K, a vlm's vision positions its input rows), the
    KV cache and a hybrid's float32 conv and SSM states written once, at
    3.35 TB/s.  A decode step at the run's mean position: the weights it
    needs read once (an MoE layer's attention, router and
    ``experts_used`` of its experts, as this run's routing kept them; a
    shared block at every invocation), the KV cache read up to each
    stream's position, the conv and SSM states read and written, the K
    unembeddings of audio; or the same products for B tokens.
    """
    from repro_torch.kernels.flash_attention.ops import _live_pairs

    d, L, V, hd = cfg.d_model, cfg.num_layers, cfg.vocab, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    K = cfg.num_codebooks or 1
    attn = d * hd * (nq + 2 * nkv) + nq * hd * d
    block = attn + 3 * d * cfg.d_ff
    n_att = _attention_layers(cfg)
    state_bytes = pre_f32 = dec_f32 = 0
    if cfg.arch_type == "moe":
        expert = 3 * d * cfg.moe_d_ff
        active = L * (attn + cfg.top_k * expert + d * cfg.num_experts)
        stored = L * (attn + cfg.num_experts * expert + d * cfg.num_experts)
        read = L * (attn + (experts_used or cfg.num_experts) * expert + d * cfg.num_experts)
    elif cfg.arch_type == "hybrid":
        di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        mixer = d * (2 * di + 2 * n + h) + di * d  # in_proj, out_proj
        active = read = L * mixer + n_att * block
        stored = L * mixer + block
        state_bytes = 4 * L * B * (h * n * p + (cfg.ssm_conv - 1) * (di + 2 * n))
        pre_f32 = _ssd_flops(cfg, B, S)
        dec_f32 = 6 * L * B * h * n * p  # the state's decay, input and output
    else:
        active = stored = read = L * block
    e = 2  # bf16
    C = min(S + gen, cfg.attn_window) if cfg.attn_window else S + gen
    kv_row = 2 * n_att * nkv * hd * e  # K and V of one position, every attention layer
    pairs = _live_pairs(S, True, cfg.attn_window)
    pre_flops = 2 * active * B * S + 4 * hd * pairs * B * nq * n_att + 2 * d * V * K * B
    pre_bytes = (stored + d * V * K) * e + B * S * K * d * e + kv_row * B * C + state_bytes
    p = S + (gen - 1) / 2  # the decode steps' mean position
    ctx = min(p + 1, C)
    dec_flops = 2 * B * (active + d * V * K) + 4 * hd * ctx * nq * n_att * B
    dec_bytes = (read + d * V * K) * e + kv_row * B * ctx + 2 * state_bytes
    bounds = {}
    for name, flops, f32, nbytes in (("prefill", pre_flops, pre_f32, pre_bytes),
                                     ("decode", dec_flops, dec_f32, dec_bytes)):
        b, by = _bound(nbytes, flops, f32)
        bounds[name] = {"ms": b[by], "by": by, "flops": flops, "f32_flops": f32,
                        "bytes": nbytes}
    return bounds


def attn_serve_launcher(fops, arch, B, S, gen):
    """The launcher's path at ``arch``'s published config: batch B, prompt S, ``gen`` tokens.

    S counts every prompt position: a vlm prompt's are its vision
    embeddings and then text tokens, an audio prompt's are frames of K
    codebook tokens.  The prefill must launch flash_attention once an
    attention layer (a hybrid: once a shared-block invocation) and decode
    never.  An MoE model's routing runs once more, recorded and untimed:
    the share of its routed assignments dropped over capacity at prefill
    and decode.
    """
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = M.init_model(torch.Generator("cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    _require(n_params == cfg.param_count() + _uncounted_params(cfg),
             f"{n_params} params, config says {cfg.param_count()} + "
             f"{_uncounted_params(cfg)} uncounted")
    inputs = serve.make_inputs(cfg, B, S, 0, "cuda")
    prompts, vision = inputs["tokens"], inputs.get("vision_embeds")
    warm = serve.generate(model, prompts, 2, vision)  # first calls: cuBLAS, allocator
    cold_prefill_s = warm.prefill_s
    del warm
    torch.cuda.reset_peak_memory_stats()
    fops.flash_attention.launches = 0
    run = serve.generate(model, prompts, gen, vision)
    launches = fops.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    _require(launches == _attention_layers(cfg),
             f"{arch}: serving launched flash_attention {launches}x")
    codebooks = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    _require(run.tokens.shape == (B, gen, *codebooks), f"tokens {tuple(run.tokens.shape)}")
    _require(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()), "token out of range")
    for name, logits in (("prefill", run.prefill_logits), ("decode", run.logits)):
        _require(logits.shape == (B, 1, *codebooks, cfg.vocab),
                 f"{name} logits {tuple(logits.shape)}")
        _require(bool(torch.isfinite(logits.float()).all()), f"non-finite {name} logits")
    steps = gen - 1
    out = {
        "arch": arch, "layers": cfg.num_layers, "batch": B, "prompt": S, "gen": gen,
        "init_s": init_s, "params": n_params, "param_bytes": param_bytes,
        "cold_prefill_ms": cold_prefill_s * 1e3, "prefill_ms": run.prefill_s * 1e3,
        "decode_ms_per_step": run.decode_s / steps * 1e3,
        "decode_tok_per_s": B * steps / run.decode_s, "peak_gb": peak / 1e9,
        "launches": launches, "sample": run.tokens[0, :16].tolist(),
    }
    experts_used = None
    if cfg.arch_type == "moe":
        with _RoutingRecorder(moe_lib) as rec:
            logits, cache = M.prefill(model, prompts, max_len=S + gen)
            routed, kept, _, by_layer = rec.read()
            tok = torch.argmax(logits, dim=-1)
            for _ in range(steps):
                logits, cache = M.decode_step(model, cache, tok)
                tok = torch.argmax(logits, dim=-1)
            d_routed, d_kept, experts_used, _ = rec.read()
        out["dropped_prefill"] = 1 - kept / routed
        out["dropped_prefill_by_layer"] = by_layer
        out["dropped_decode"] = 1 - d_kept / d_routed
        out["experts_used_decode"] = experts_used
        out["experts"] = cfg.num_experts
        del cache
    out["bounds"] = _serve_bounds(cfg, B, S, gen, experts_used)
    return model, out


def attn_serve_engine(fops, model):
    """The engine at the published config: 4 slots, 8 ragged requests, 16 tokens each."""
    from repro_torch.serving import Request, ServingEngine

    cfg = model.cfg
    rng = np.random.default_rng(1)
    lens = rng.integers(16, 65, size=8)
    engine = ServingEngine(model, max_slots=4, prompt_capacity=64, max_new_tokens=16,
                           device="cuda")
    for i, n in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
        engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=16))
    torch.cuda.synchronize()
    fops.flash_attention.launches = 0
    t0 = time.perf_counter()
    finished = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fops.flash_attention.launches
    _require(sorted(r.uid for r in finished) == list(range(8)), "engine lost a request")
    _require(all(len(r.output) == 16 for r in finished), "a request ended short")
    _require(all(0 <= t < cfg.vocab for r in finished for t in r.output), "token out of range")
    _require(launches == _attention_layers(cfg) * 8,
             f"engine launched flash_attention {launches}x")
    return {"wall_s": wall, "tok_per_s": 8 * 16 / wall, "launches": launches,
            "prompt_lens": [int(n) for n in lens]}


def _print_launcher(r, tag):
    b, gen = r["bounds"], r["gen"]
    moe = (f"; routed assignments dropped over capacity: prefill {r['dropped_prefill']:.4f} "
           f"(by layer {r['dropped_prefill_by_layer']}), decode {r['dropped_decode']:.4f} "
           f"({r['experts_used_decode']:.1f} of {r['experts']} experts used a layer a decode "
           f"step)"
           if "dropped_prefill" in r else "")
    print(
        f"serve (launcher): {r['arch']} {r['layers']} layers bf16, {r['params']} params "
        f"({r['param_bytes'] / 1e9:.2f} GB), init {r['init_s']:.2f} s; batch {r['batch']} x "
        f"prompt {r['prompt']}: prefill {r['prefill_ms']:.1f} ms (cold "
        f"{r['cold_prefill_ms']:.1f} ms; bound {b['prefill']['ms']:.2f} ms by "
        f"{b['prefill']['by']}, {b['prefill']['ms'] / r['prefill_ms']:.3f} of it), decode "
        f"{r['decode_ms_per_step']:.2f} ms/step (bound {b['decode']['ms']:.3f} ms by "
        f"{b['decode']['by']}, {b['decode']['ms'] / r['decode_ms_per_step']:.3f} of it) = "
        f"{r['decode_tok_per_s']:.1f} tok/s (bound {r['batch'] * 1e3 / b['decode']['ms']:.0f}) "
        f"over {gen - 1} steps, peak {r['peak_gb']:.2f} GB; "
        f"flash_attention launches {r['launches']}{moe}; stream 0 {r['sample']} {tag}"
    )


def _print_engine(arch, engine, tag):
    print(
        f"serve (engine): {arch}, 4 slots, 8 requests (prompts {engine['prompt_lens']}) "
        f"x 16 tokens in {engine['wall_s']:.2f} s = {engine['tok_per_s']:.1f} tok/s; "
        f"flash_attention launches {engine['launches']} {tag}"
    )


def _print_flash_row(row, what, tag):
    print(
        f"kernel timing: flash_attention {row['shape']} ({what}): {row['ms']:.3f} ms "
        f"({row['flops'] / row['ms'] / 1e9:.0f} TFLOP/s, {row['bound_ms'] / row['ms']:.3f} of the "
        f"bound), plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.3f} ms by {row['bound_by']} {tag}"
    )


def attn_serve_phase(tag, fops, fref):
    """Slice 11: dense and MoE serving at Granite-8B, OLMoE-1B-7B and Minitron-8B."""
    t0 = time.perf_counter()
    launched, engine = {}, None
    for arch, B, S, gen in ATTN_SERVE:
        model, r = attn_serve_launcher(fops, arch, B, S, gen)
        launched[arch] = r
        _print_launcher(r, tag)
        if arch == ATTN_ENGINE_ARCH:
            engine = attn_serve_engine(fops, model)
            _print_engine(arch, engine, tag)
        del model
        torch.cuda.empty_cache()
    lm = lm_slice_parity(ATTN_ENGINE_ARCH)
    print(
        f"slice parity: {ATTN_ENGINE_ARCH} full width, 2 layers, float32, card vs CPU: prefill "
        f"logits {lm['prefill_logits']:.3e}, cache (K, V, pos) {lm['cache']:.3e} (tol {LM_TOL}); "
        f"4 decode steps: logits {lm['decode_logits']:.3e}, cache {lm['decode_cache']:.3e}, "
        f"{lm['differing_tokens']} differing tokens; engine = sequential on the card"
    )
    row = flash_timing(fops, fref, FLASH_SERVE_PATH)
    _print_flash_row(row, "Granite-8B's prefill", tag)
    print(f"slice 11 (attention serving) in {time.perf_counter() - t0:.1f} s")
    launches = {arch: r["launches"] for arch, r in launched.items()}
    launches["engine"] = engine["launches"]
    return {"launches_serving": launches, "serving_row": row}


def family_serve_phase(tag, fops, fref):
    """Slice 12: hybrid, vlm and audio serving at Zamba2-2.7B, LLaVA-NeXT-Mistral-7B and
    MusicGen-Large."""
    t0 = time.perf_counter()
    launched, engine = {}, None
    for arch, B, S, gen in FAMILY_SERVE:
        model, r = attn_serve_launcher(fops, arch, B, S, gen)
        launched[arch] = r
        _print_launcher(r, tag)
        if arch == FAMILY_ENGINE_ARCH:
            engine = attn_serve_engine(fops, model)
            _print_engine(arch, engine, tag)
        del model
        torch.cuda.empty_cache()
    for arch, (changes, prompt) in FAMILY_PARITY.items():
        lm = lm_slice_parity(arch, changes, prompt)
        cut = ", ".join(f"{k} {v}" for k, v in changes.items())
        engine_note = "; engine = sequential on the card" if arch == FAMILY_ENGINE_ARCH else ""
        print(
            f"slice parity: {arch} full width, {cut}, float32, 2 prompts of {prompt}, card vs "
            f"CPU: prefill logits {lm['prefill_logits']:.3e}, cache {lm['cache']:.3e} (tol "
            f"{LM_TOL}); 4 decode steps: logits {lm['decode_logits']:.3e}, cache "
            f"{lm['decode_cache']:.3e}, {lm['differing_tokens']} differing tokens{engine_note}"
        )
    rows = []
    for (arch, *_), (B, Hq, Hkv, S, hd, window) in zip(FAMILY_SERVE, FLASH_FAMILY_PATHS):
        rows.append(flash_timing(fops, fref, (B, Hq, Hkv, S, hd), window))
        _print_flash_row(rows[-1], f"{arch}'s prefill", tag)
    print(f"slice 12 (hybrid, vlm and audio serving) in {time.perf_counter() - t0:.1f} s")
    launches = {arch: r["launches"] for arch, r in launched.items()}
    launches[f"engine {FAMILY_ENGINE_ARCH}"] = engine["launches"]
    return {"launches_serving": launches, "serving_rows": rows}


def _scan_cotangents(b, S, di, N, dtype, seed):
    """dy (b,S,di) in ``dtype`` and a nonzero dh_final (b,di,N) float32, on the card."""
    g = torch.Generator("cuda").manual_seed(seed)
    return (torch.randn(b, S, di, generator=g, device="cuda").to(dtype),
            torch.randn(b, di, N, generator=g, device="cuda"))


def _chunked_vjp(t, dy, dh):
    """The vjp by autograd through `selective_scan_chunked` (the plain version for large
    shapes: each 128-step chunk under `torch.utils.checkpoint`)."""
    from repro_torch.models.ssm import selective_scan_chunked

    leaves = [x.detach().clone().requires_grad_() for x in t.values()]
    y, h = selective_scan_chunked(*leaves, 128)
    torch.autograd.backward((y, h), (dy, dh))
    return [x.grad for x in leaves]


def scan_bwd_parity(sops, sref):
    """selective_scan_bwd against autograd of its plain version, float32 and bf16."""
    names = ("dx", "ddelta", "dA", "dB", "dC", "dD")
    cases = [(shape, dt) for shape in SCAN_BWD_SHAPES for dt in (torch.float32, torch.bfloat16)]
    worst = {}
    for (b, S, di, N), dtype in cases + [(SCAN_BWD_CHUNKED, torch.float32)]:
        t = _scan_inputs(b, S, di, N, dtype, seed=S + N)
        dy, dh = _scan_cotangents(b, S, di, N, dtype, seed=di + N)
        got = sops.selective_scan_bwd(*t.values(), dy, dh)
        chunked = (b, S, di, N) == SCAN_BWD_CHUNKED
        want = (_chunked_vjp(t, dy, dh) if chunked
                else sref.selective_scan_ref_vjp(*t.values(), dy, dh))
        torch.cuda.synchronize()
        case = (f"b={b} S={S} di={di} N={N} {str(dtype)[6:]}"
                f"{' vs selective_scan_chunked' if chunked else ''}")
        tol = SCAN_TOL if dtype == torch.float32 else SCAN_BWD_BF16_TOL
        worst[case] = {}
        for name, x, y, inp in zip(names, got, want, t.values()):
            _require(x.dtype == y.dtype == inp.dtype, f"{name} dtype {x.dtype}: {case}")
            _require(_within(x.float(), y.float(), tol),
                     f"{name} differs by {_err(x.float(), y.float()):.3e}: {case}")
            worst[case][name] = _err(x.float(), y.float())
        del t, dy, dh, got, want
    return worst


def scan_bwd_timing(sops):
    """The backward kernel at Falcon-Mamba's training shape, bf16: both rulers, the
    plain version (`selective_scan_chunked`'s autograd) and the bound."""
    b, S, di, N = SCAN_BWD_PATH
    t = _scan_inputs(b, S, di, N, torch.bfloat16, seed=0)
    dy, dh = _scan_cotangents(b, S, di, N, torch.bfloat16, seed=1)
    args = (*t.values(), dy, dh)
    ms = _time_ms(lambda: sops._launch_bwd(*args), reps=5, inner=2)
    dev_ms = _device_ms(lambda: sops._launch_bwd(*args), inner=2, reps=5)
    plain_ms = _time_ms(lambda: _chunked_vjp(t, dy, dh), reps=1, inner=1)
    # each input read once, each output written once: x, dy, dx bf16 and delta,
    # ddelta float32 a (b, t, d); B, C, dB, dC bf16 a (b, t, n); A, dA, dh_final
    # float32 a (d, n) and (b, d, n); D, dD float32
    nbytes = (b * S * di * (3 * 2 + 8) + 4 * b * S * N * 2 + 2 * di * N * 4 + b * di * N * 4
              + 2 * di * 4)
    exps = 2 * b * S * di * N  # at least: the states rebuilt going forward, g carried back
    flops = b * S * di * (12 * N + 6)
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": max(exps / SFU_EXP_PER_S, flops / F32_FLOPS_PER_S) * 1e3}
    bound_by = max(bounds, key=bounds.get)
    return {"b": b, "S": S, "di": di, "N": N, "dtype": "bfloat16", "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bytes": nbytes, "exps": exps, "flops": flops,
            "bytes_ms": bounds["bytes"], "exp_ms": exps / SFU_EXP_PER_S * 1e3,
            "flop_ms": flops / F32_FLOPS_PER_S * 1e3, "bound_ms": bounds[bound_by],
            "bound_by": bound_by, "bound_share": bounds[bound_by] / ms,
            "device_bound_share": bounds[bound_by] / dev_ms}


def _path_launches(cfg):
    """Launches a training step should make: (selective_scan, selective_scan_bwd,
    flash_attention, fused_xent).  Remat runs every layer's forward twice."""
    fwd = 2 if cfg.remat else 1
    mamba1 = cfg.num_layers if cfg.arch_type == "ssm" else 0
    attention = (cfg.num_attn_invocations if cfg.arch_type == "hybrid"
                 else 0 if cfg.arch_type == "ssm" else cfg.num_layers)
    return fwd * mamba1, mamba1, fwd * attention, max(cfg.num_codebooks, 1)


def family_train(sops, fops, xops, arch, changes, seq):
    """``arch`` at its published width, cut by ``changes``: 3 steps of batch 4 through
    `launch.train.train`, then every parameter compared with its initial value."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(arch), **changes)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sops.selective_scan.launches = sops.selective_scan_bwd.launches = 0
    fops.flash_attention.launches = xops.fused_softmax_xent.launches = 0
    t0 = time.perf_counter()
    run = train.train(cfg, FAMILY_TRAIN_STEPS, FAMILY_TRAIN_BATCH, seq, lr=3e-4, seed=0,
                      log_every=FAMILY_TRAIN_STEPS, device="cuda")
    wall = time.perf_counter() - t0
    got = (sops.selective_scan.launches, sops.selective_scan_bwd.launches,
           fops.flash_attention.launches, xops.fused_softmax_xent.launches)
    peak = torch.cuda.max_memory_allocated()
    want = tuple(n * FAMILY_TRAIN_STEPS for n in _path_launches(cfg))
    _require(len(run.losses) == FAMILY_TRAIN_STEPS and all(np.isfinite(run.losses)),
             f"{arch}: losses {run.losses}")
    _require(got == want, f"{arch}: (selective_scan, its backward, flash_attention, "
                          f"fused_xent) launched {got} in {FAMILY_TRAIN_STEPS} steps, not {want}")
    init = M.init_model(torch.Generator("cuda").manual_seed(0), cfg)  # train's own init
    leaves = list(zip(tree_leaves(run.model.tree()), tree_leaves(init.tree())))
    unchanged = sum(bool(torch.equal(p, q)) for p, q in leaves)
    _require(unchanged == 0, f"{arch}: {unchanged} of {len(leaves)} parameters did not change")
    # a non-finite gradient would have spread through the clip's global norm to every leaf
    _require(all(bool(torch.isfinite(p).all()) for p, _ in leaves), f"{arch}: non-finite params")
    positions = seq + (cfg.vision_tokens if cfg.arch_type == "vlm" else 0)
    step_s = statistics.median(run.step_s[1:])
    tokens = FAMILY_TRAIN_BATCH * positions
    out = {"arch": arch, "layers": cfg.num_layers, "params": sum(p.numel() for p, _ in leaves),
           "positions": positions, "losses": run.losses, "step_s": run.step_s,
           "step_s_median": step_s, "tokens_per_s": tokens / step_s,
           "six_n_share": M.model_flops_per_token(cfg) * tokens / step_s / BF16_FLOPS_PER_S,
           "peak_gb": peak / 1e9, "wall_s": wall, "launches": dict(zip(
               ("selective_scan", "selective_scan_bwd", "flash_attention", "fused_xent"), got))}
    del run, init, leaves
    torch.cuda.empty_cache()
    return out


def family_train_parity(arch, changes, seq=256):
    """Full width cut by ``changes``, float32, batch 1 x ``seq`` text tokens: one train
    step on the card and on the CPU from the same weights and batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(arch), dtype="float32", **changes)
    gpu = M.init_model(torch.Generator("cuda").manual_seed(1), cfg)
    cpu = M.LM(tree_map(lambda x: x.to("cpu", copy=True), gpu.tree()), cfg)
    host = train.make_batch(cfg, SyntheticTokenDataset(cfg.vocab, seq, 1, seed=2),
                            np.random.default_rng(2), "cpu")
    results = []
    for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
        opt, step = make_train_step(cfg, 3e-4)
        model, _, metrics = step(model, opt.init(model.tree()),
                                 {k: v.to(dev) for k, v in host.items()})
        results.append(({k: float(v) for k, v in metrics.items()},
                        [p.cpu() for p in tree_leaves(model.tree())]))
    (mg, pg), (mc, pc) = results
    _require(sorted(mg) == sorted(mc), f"{arch}: metric keys {sorted(mg)} vs {sorted(mc)}")
    for k in mc:
        _require(abs(mg[k] - mc[k]) <= LM_TOL * (1 + abs(mc[k])),
                 f"{arch}: {k} {mg[k]} on the card, {mc[k]} on the CPU")
    for i, (x, y) in enumerate(zip(pg, pc)):
        _require(_within(x, y, LM_TOL), f"{arch}: parameter leaf {i} differs by {_err(x, y)}")
    return {"metrics": {k: abs(mg[k] - mc[k]) for k in mc},
            "params": max(_err(x, y) for x, y in zip(pg, pc))}


def lm_checkpoints():
    """Every arch's smoke config, 2 steps through the launcher with a checkpoint a step;
    the last restores to the model's parameters exactly."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    for arch in ARCH_IDS:
        root = os.path.join(LM_CKPT_ROOT, arch)
        run = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2", "--seq",
                          "64", "--ckpt-dir", root, "--ckpt-every", "1", "--log-every", "2"])
        _require(len(run.checkpoints) == 2, f"{arch}: checkpoints {run.checkpoints}")
        tree = train.jax_layout(run.model)
        back = restore_checkpoint(root, 2, tree)
        for x, y in zip(tree_leaves(back), tree_leaves(tree)):
            _require(x.dtype == y.dtype and torch.equal(x, y), f"{arch}: a restored leaf differs")
    return list(ARCH_IDS)


def lm_train_phase(tag, sops, sref, fops, xops):
    """Slice 14: the selective scan's backward kernel, and training of the moe, mamba1,
    hybrid, vlm and audio families at their published widths."""
    t0 = time.perf_counter()
    worst = scan_bwd_parity(sops, sref)
    for case, e in worst.items():
        tol = SCAN_TOL if "float32" in case else SCAN_BWD_BF16_TOL
        print(f"kernel parity: selective_scan_bwd {case}: max abs err "
              + ", ".join(f"{k} {v:.3e}" for k, v in e.items()) + f" (tol {tol})")
    row = scan_bwd_timing(sops)
    print(
        f"kernel timing: selective_scan_bwd b={row['b']} S={row['S']} di={row['di']} "
        f"N={row['N']} bf16: {row['ms'] * 1e3:.2f} us a call launched eagerly "
        f"({row['device_ms'] * 1e3:.2f} us on the device), plain (selective_scan_chunked's "
        f"autograd) {row['plain_ms']:.1f} ms, bound {row['bound_ms'] * 1e3:.2f} us by "
        f"{row['bound_by']} (bytes {row['bytes_ms'] * 1e3:.2f} us for {row['bytes']} B; exp "
        f"{row['exp_ms'] * 1e3:.2f} us for {row['exps']} exp; flop {row['flop_ms'] * 1e3:.2f} "
        f"us), {row['bound_share']:.3f} of the bound ({row['device_bound_share']:.3f} on the "
        f"device) {tag}"
    )
    print(f"slice 14 kernel: parity and timing in {time.perf_counter() - t0:.1f} s")
    trained = {}
    for arch, changes, seq in FAMILY_TRAIN:
        r = family_train(sops, fops, xops, arch, changes, seq)
        trained[arch] = r
        print(
            f"train: {arch} {r['layers']} layers bf16 remat, {r['params']} params, batch "
            f"{FAMILY_TRAIN_BATCH} x {r['positions']} positions: walls "
            f"{[round(x, 3) for x in r['step_s']]} s; median after the first "
            f"{r['step_s_median']:.3f} s = {r['tokens_per_s']:.0f} positions/s, 6N share "
            f"{r['six_n_share']:.4f} of 989 TFLOP/s; peak {r['peak_gb']:.2f} GB; losses "
            f"{[round(x, 4) for x in r['losses']]}; launches {json.dumps(r['launches'])}; "
            f"every parameter changed; {r['wall_s']:.1f} s with init {tag}"
        )
    t1 = time.perf_counter()
    parity = {}
    for arch, changes in FAMILY_TRAIN_PARITY.items():
        parity[arch] = e = family_train_parity(arch, changes)
        cut = ", ".join(f"{k} {v}" for k, v in changes.items())
        print(f"slice parity: {arch} full width, {cut}, float32, batch 1 x 256, one train step "
              f"on the card vs the CPU: params {e['params']:.3e}, metrics "
              + ", ".join(f"{k} {v:.3e}" for k, v in e["metrics"].items()) + f" (tol {LM_TOL})")
    print(f"slice 14 parity in {time.perf_counter() - t1:.1f} s")
    archs = lm_checkpoints()
    print(f"checkpoints: launch.train --smoke --ckpt-dir --ckpt-every 1, 2 steps, for {archs}: "
          f"the last restores to the parameters exactly")
    print(f"slice 14 (training of every family) in {time.perf_counter() - t0:.1f} s")
    return {"scan_bwd_worst": worst, "scan_bwd_row": row, "trained": trained, "parity": parity}


def _fused_rung_launches(iterations):
    """recurrent_scan launches the fused_recurrent rung predicts: a warm and 3 timed calls."""
    from repro_torch.bench.throughput import _REPEATS
    from repro_torch.systems import PPOConfig
    from repro_torch.systems.registry import make_pair, smoke_overrides

    overrides = smoke_overrides("rec_ippo")
    _, system = make_pair("rec_ippo", BENCH_ENV, recurrent_core="linear", **overrides)
    cfg, n = PPOConfig(**overrides), len(system.spec.agent_ids)
    # a bootstrap critic unroll an agent, then an actor and a critic unroll an agent a
    # minibatch, forward and backward
    per_update = n + cfg.epochs * cfg.num_minibatches * n * 4
    return (1 + _REPEATS) * (iterations // cfg.rollout_len) * per_update


def _bench_scan_shapes():
    """recurrent_scan's (T, B, H) on the fused rung: the bootstrap and the minibatch unrolls."""
    from repro_torch.systems import PPOConfig
    from repro_torch.systems.registry import smoke_overrides

    cfg = PPOConfig(**smoke_overrides("rec_ippo"))
    T, H = cfg.rollout_len, cfg.hidden_sizes[-1]
    return [(T, BENCH_ENVS, H), (T, BENCH_ENVS // cfg.num_minibatches, H)]


def _repeats(walls):
    return "[" + ", ".join(f"{w:.4f}" for w in walls) + "] s"


def bench_phase(tag, ops, ref):
    """Slice 13: the scan at the fused rung's shapes, the throughput benchmark, the speedup figure."""
    import contextlib
    import io

    from repro_torch.bench import schema
    from repro_torch.bench.throughput import run_bench
    from repro_torch.benchmarks import run as figures

    t0 = time.perf_counter()
    shapes = _bench_scan_shapes()
    worst = kernel_parity(ops, ref, shapes)
    print(f"kernel parity (bench): recurrent_scan forward {worst['forward']:.3e}, reverse "
          f"{worst['reverse']:.3e}, chunked {worst['chunked']:.3e} (tol {FWD_TOL}), grads "
          f"{worst['grad']:.3e} (tol {GRAD_TOL}) over {shapes} x resets {PATTERNS}")
    timing = kernel_timing(ops, ref, shapes)
    for r in timing:
        print(f"kernel timing (bench): recurrent_scan {r['direction']} T={r['T']} B={r['B']} "
              f"H={r['H']} (the fused rung's unroll): {r['device_ms'] * 1e3:.2f} us on the "
              f"device, {r['ms'] * 1e3:.2f} us launched eagerly, plain "
              f"{r['plain_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.2f} us by "
              f"{r['bound_by']} ({r['device_bound_share']:.3f} of it on the device) {tag}")
    t_bench = time.perf_counter()
    ops.linear_recurrent_scan.launches = 0
    doc = run_bench(BENCH_SYSTEMS, [BENCH_ENV], iterations=BENCH_ITERATIONS, num_envs=BENCH_ENVS,
                    num_seeds=BENCH_SEEDS, loop_episodes=BENCH_LOOP_EPISODES, out_path=BENCH_OUT,
                    device="cuda")
    fused_launches = ops.linear_recurrent_scan.launches
    bench_s = time.perf_counter() - t_bench
    problems = schema.check_speed_schema(doc) + schema.validate_path(BENCH_OUT)
    _require(not problems, f"bench: the document fails the schema: {problems}")
    cells = {c["system"]: c for c in doc["cells"]}
    _require("fused_recurrent" in cells["rec_ippo"] and "fused_recurrent" not in cells["ippo"],
             "bench: fused_recurrent must be on rec_ippo alone")
    _require(all(c["async_actors"]["actor_counts"] == [1, 2, 4] for c in cells.values()),
             "bench: async_actors must run at 1 / 2 / 4 actors")
    want = _fused_rung_launches(BENCH_ITERATIONS)
    _require(fused_launches == want, f"bench: recurrent_scan launched {fused_launches}x over "
                                     f"the bench, the fused rung predicts {want}")
    print(f"bench: run_bench {list(BENCH_SYSTEMS)} on {BENCH_ENV}, {BENCH_ENVS} envs x "
          f"{BENCH_ITERATIONS} iterations (bench_marl: 256), {BENCH_SEEDS} seeds (8), "
          f"{BENCH_LOOP_EPISODES} loop episode (3), smoke operating point, in {bench_s:.1f} s; "
          f"passes check_speed_schema; recurrent_scan launches {fused_launches} (the fused "
          f"rung's {want}) {tag}")
    for name, c in cells.items():
        r, sv, aa = c["runners"], c["seed_vectorization"], c["async_actors"]
        sm = r["shard_map"]
        print(f"bench: {name} {BENCH_ENV}: python loop {r['python_loop']['steps_per_sec']:.0f} "
              f"env steps/s ({r['python_loop']['env_steps']} steps); anakin "
              f"{r['anakin']['steps_per_sec']:.0f} (repeats {_repeats(r['anakin']['repeat_seconds'])}"
              f", {r['anakin']['speedup_vs_loop']:.1f}x the loop); shard_map "
              f"{sm['steps_per_sec']:.0f} ({sm['num_devices']} {sm['backend']} rank, warm loop "
              f"{sm['wall_seconds']:.4f} s, call {sm['call_wall_seconds']:.2f} s) {tag}")
        print(f"bench: {name} {BENCH_ENV}: {sv['num_seeds']} seeds serial "
              f"{sv['serial_steps_per_sec']:.0f} env steps/s (repeats "
              f"{_repeats(sv['serial_repeat_seconds'])}), as lanes "
              f"{sv['vmapped_steps_per_sec']:.0f} (repeats {_repeats(sv['lanes_repeat_seconds'])})"
              f", lanes over serial {sv['speedup']:.2f}x {tag}")
        for row in aa["cells"]:
            print(f"bench: {name} {BENCH_ENV}: async {row['num_actors']} actor(s), unroll "
                  f"{aa['unroll_len']}, V-trace {aa['use_vtrace']}: {row['steps_per_sec']:.0f} env "
                  f"steps/s (repeats {_repeats(row['repeat_seconds'])}) {tag}")
        if "fused_recurrent" in c:
            fr = c["fused_recurrent"]
            print(f"bench: {name} {BENCH_ENV}: fused core ({fr['core']}, recurrent_scan) "
                  f"{fr['fused_steps_per_sec']:.0f} env steps/s (repeats "
                  f"{_repeats(fr['repeat_seconds'])}) against the {fr['reference_core']} core's "
                  f"{fr['reference_steps_per_sec']:.0f}: {fr['speedup']:.2f}x {tag}")
    t1 = time.perf_counter()
    before = ops.linear_recurrent_scan.launches
    csv = io.StringIO()
    with contextlib.redirect_stdout(csv):
        figures.main(["--fast", "--only", "speedup", "--device", "cuda"])
    rows = [line.split(",", 2) for line in csv.getvalue().splitlines()[1:]]
    _require(len(rows) == 7 and all(float(us) > 0 for _, us, _ in rows),
             f"benchmarks.run speedup: rows {rows}")
    _require(ops.linear_recurrent_scan.launches == before, "speedup ran recurrent_scan")
    for name, us, derived in rows:
        print(f"benchmarks.run --fast --only speedup: {name}, {float(us):.1f} us a step, "
              f"{derived} {tag}")
    print(f"benchmarks.run --fast --only speedup in {time.perf_counter() - t1:.1f} s")
    print(f"slice 13 (bench) in {time.perf_counter() - t0:.1f} s")
    return {"launches_bench": ops.linear_recurrent_scan.launches,
            "launches_bench_fused_rung": fused_launches,
            "max_abs_err_bench": max(worst.values()), "by_shape_bench": timing}


def main():
    """Run every phase; any failure raises and exits non-zero."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import build, ptxas_report
    from repro_torch.kernels.recurrent_scan import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.fused_xent import ops as xops
    from repro_torch.kernels.fused_xent import ref as xref
    from repro_torch.kernels.selective_scan import ops as sops
    from repro_torch.kernels.selective_scan import ref as sref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _gpu_line()
    tag = f"[{gpu}]"
    print(f"gpu: {gpu}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    sources = ("recurrent_scan.cu", "selective_scan.cu", "selective_scan_bwd.cu",
               "flash_attention.cu", "fused_xent.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        libs = list(pool.map(build, sources))
    print(f"build: {', '.join(os.path.relpath(lib) for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for source, lib in zip(sources, libs):
        for k in ptxas_report(lib):
            print(f"build report: {source} {_kernel_name(k['name'])}: {k['registers']} registers, "
                  f"{k['static_smem']} B static shared memory, spills {k['spill_stores']} B "
                  f"stored / {k['spill_loads']} B loaded (nvcc -Xptxas -v)")

    # ---- slice 1: rec-IPPO (linear core)
    worst = kernel_parity(ops, ref)
    print(
        f"kernel parity: max abs err forward {worst['forward']:.3e} (tol {FWD_TOL}), "
        f"reverse {worst['reverse']:.3e} (tol {FWD_TOL}), against chunked_scan_ref "
        f"{worst['chunked']:.3e} (tol {FWD_TOL}), grads {worst['grad']:.3e} (tol {GRAD_TOL}) "
        f"over shapes {PATH_SHAPES + MARL_PATH_SHAPES + [RAGGED] + SCAN_EDGE_SHAPES} x resets "
        f"{PATTERNS}"
    )

    rows = kernel_timing(ops, ref)
    for r in rows:
        print(
            f"kernel timing: recurrent_scan {r['direction']} T={r['T']} B={r['B']} H={r['H']}: "
            f"{r['ms'] * 1e3:.2f} us a call launched eagerly ({r['device_ms'] * 1e3:.2f} us on "
            f"the device), plain {r['plain_ms'] * 1e3:.1f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} ({r['bytes']} B, "
            f"{r['flops']} flop), {r['bound_share']:.3f} of the bound ({r['device_bound_share']:.3f} "
            f"on the device) {tag}"
        )

    system, state, run = train_and_evaluate(ops)
    print(
        f"train: rec_ippo linear matrix_game, 256 envs x 256 iterations in "
        f"{run['train_s']:.2f} s = {run['env_steps_per_s']:.0f} env steps/s; "
        f"losses {run['losses']}; recurrent_scan launches {run['launches']} "
        f"({run['launches_per_update']} per update) {tag}"
    )
    print(f"eval: 32 greedy episodes in {run['eval_s']:.2f} s, mean return "
          f"{run['eval_return_mean']:.3f} {tag}")

    param_err, loss_err = slice_parity(system, state)
    print(f"slice parity: one update on the card vs the CPU, max abs param diff "
          f"{param_err:.3e}, loss diff {loss_err:.3e} (tol {SLICE_TOL})")
    del system, state

    # ---- slice 6: the paper's headline loop, feed-forward IPPO/MAPPO and rec-MAPPO
    t0 = time.perf_counter()
    marl = marl_train(ops)
    for name, r in marl.items():
        print(
            f"train (marl): {name} on {r['env']}, {MARL_SEEDS} seeds x {MARL_ENVS} envs x "
            f"{MARL_ITERATIONS} iterations, greedy eval of {MARL_EPISODES} episodes a lane every "
            f"{MARL_EVAL_EVERY}: {r['env_steps_per_s']:.0f} env steps/s median of "
            f"{MARL_REPEATS} (min {r['env_steps_per_s_min']:.0f}, max "
            f"{r['env_steps_per_s_max']:.0f}), walls {[round(w, 3) for w in r['walls_s']]} s; "
            f"mean losses {[round(x, 4) for x in r['losses']]}; eval returns "
            f"{[round(x, 4) for x in r['eval_return']]}; recurrent_scan launches "
            f"{r['launches']} a run {tag}"
        )
    batched = marl["ippo"]
    serial = marl_serial(batched["system"], statistics.median(batched["walls_s"]))
    print(
        f"train (marl, serial): ippo on spread, seeds 0-{MARL_SEEDS - 1} one run after another: "
        f"walls {[round(w, 3) for w in serial['walls_s']]} s = {serial['env_steps_per_s']:.0f} "
        f"env steps/s; batched over serial {serial['batched_over_serial']:.2f}x {tag}"
    )
    milestone = marl_milestone()
    print(
        f"milestone: ippo matrix_game (tests/test_onpolicy.py), 150 updates x 16 envs: mean "
        f"reward first 15 updates {milestone['first15']:.3f}, last 15 {milestone['last15']:.3f} "
        f"(within 10% of {SEED_IPPO_LAST15}, improvement over half of "
        f"{SEED_IPPO_LAST15 - SEED_IPPO_FIRST15:.3f}) in {milestone['wall_s']:.1f} s {tag}"
    )
    for name, _, overrides in MARL_RUNS:
        ops.linear_recurrent_scan.launches = 0
        e = marl_update_parity(name, overrides)
        launches = ops.linear_recurrent_scan.launches
        _require((launches > 0) == name.startswith("rec_"),
                 f"{name} parity update launched recurrent_scan {launches}x")
        print(f"slice parity: {name} on spread, one update of 2 seed lanes x {MARL_ENVS} envs "
              f"on the card vs the CPU: first minibatch loss {e['loss']:.3e}, grads "
              f"{e['grads']:.3e}, params after its step {e['params']:.3e} (tol {SLICE_TOL}); "
              f"update's mean loss {e['update_loss']:.3e} (tol {SLICE_TOL}); after all "
              f"{e['steps']} steps params {e['update_params']:.3e} (a reading); recurrent_scan "
              f"launches {launches}")
    launched = marl_launcher()
    print(f"launcher (marl): ippo on lbf, {MARL_SEEDS} seeds: {launched['env_steps_per_s']:.0f} "
          f"env steps/s, final eval return {launched['eval_return']:.4f} {tag}")
    rec_mappo_launches = marl["rec_mappo"]["launches"]
    del marl, batched
    print(f"slice 6 (marl) in {time.perf_counter() - t0:.1f} s")

    # ---- slice 7: the replay family (no kernel on this path)
    replay_phase(tag)

    # ---- slice 8: the rest of the support matrix (rec-MADQN, DIAL, RIAL, four envs)
    matrix = matrix_phase(tag, ops, ref)

    # ---- slice 9: the distributed runners (async actor/learner, sharded)
    distributed = distributed_phase(tag, ops)

    # ---- slice 10: telemetry, run records, train -> checkpoint -> serve / eval
    serving = serve_phase(tag, ops, gpu)

    # ---- slice 13: the throughput benchmark and the speedup figure
    benched = bench_phase(tag, ops, ref)

    # ---- slice 2: Falcon-Mamba-7B greedy serving
    scan_worst = scan_parity(sops, sref)
    for case, e in scan_worst.items():
        print(f"kernel parity: selective_scan {case}: max abs err y {e['y']:.3e}, "
              f"h_final {e['h_final']:.3e}")
    scan_rows = scan_timing(sops, sref)
    for r in scan_rows:
        print(
            f"kernel timing: selective_scan b={r['b']} S={r['S']} di={r['di']} N={r['N']} "
            f"bf16: {r['ms'] * 1e3:.2f} us a call launched eagerly ({r['device_ms'] * 1e3:.2f} us "
            f"on the device), plain {r['plain_ms'] * 1e3:.1f} us, bound "
            f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} (bytes {r['bytes_ms'] * 1e3:.2f} "
            f"us for {r['bytes']} B; exp {r['exp_ms'] * 1e3:.2f} us for {r['exps']} exp; "
            f"flop {r['flop_ms'] * 1e3:.2f} us), {r['bound_share']:.3f} of the bound "
            f"({r['device_bound_share']:.3f} on the device) {tag}"
        )

    model, launcher = serve_launcher(sops)
    print(
        f"serve (launcher): {ARCH} 64 layers bf16, {launcher['params']} params "
        f"({launcher['param_bytes'] / 1e9:.2f} GB), init {launcher['init_s']:.2f} s; "
        f"batch 4 x prompt 2048: prefill {launcher['prefill_ms']:.1f} ms (cold "
        f"{launcher['cold_prefill_ms']:.1f} ms), decode {launcher['decode_ms_per_step']:.2f} "
        f"ms/step = {launcher['decode_tok_per_s']:.1f} tok/s over 31 steps, peak "
        f"{launcher['peak_gb']:.2f} GB; selective_scan launches {launcher['launches']}; "
        f"stream 0 {launcher['sample']} {tag}"
    )
    engine = serve_engine(sops, model)
    print(
        f"serve (engine): 4 slots, 8 requests (prompts {engine['prompt_lens']}) x 16 "
        f"tokens in {engine['wall_s']:.2f} s = {engine['tok_per_s']:.1f} tok/s; "
        f"selective_scan launches {engine['launches']} {tag}"
    )
    del model
    torch.cuda.empty_cache()

    lm = lm_slice_parity()
    print(
        f"slice parity: {ARCH} full width, 2 layers, float32, card vs CPU: prefill logits "
        f"{lm['prefill_logits']:.3e}, cache (conv, ssm, pos) {lm['cache']:.3e} (tol "
        f"{LM_TOL}); 4 decode steps: logits {lm['decode_logits']:.3e}, cache "
        f"{lm['decode_cache']:.3e}, {lm['differing_tokens']} differing tokens; engine = "
        f"sequential on the card"
    )

    # ---- slice 3: InternLM2-1.8B dense LM training
    t0 = time.perf_counter()
    flash_worst = flash_parity(fops, fref)
    for case, e in flash_worst.items():
        print(f"kernel parity: flash_attention {case}: max abs err {e['abs']:.3e}, "
              f"{e['elem']:.3f} of the element allowance, max row err {e['row']:.3e} (tol "
              f"{fref.ROW_TOL})")
    xent_worst = xent_parity(xops, xref)
    for case, e in xent_worst.items():
        print(f"kernel parity: fused_xent {case}: max abs err {e['abs']:.3e}, "
              f"{e['elem']:.3f} of the token allowance, {e['total']:.3f} of the summed one")
    flash_row = flash_timing(fops, fref)
    xent_row = xent_timing(xops, xref)
    for name, r in (("flash_attention", flash_row), ("fused_xent", xent_row)):
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
        gemm = f", cuBLAS x @ w {r['gemm_ms']:.3f} ms" if "gemm_ms" in r else ""
        print(
            f"kernel timing: {name} {r['shape']}: {r['ms']:.3f} ms "
            f"({r['flops'] / r['ms'] / 1e9:.0f} TFLOP/s, {r['bound_ms'] / r['ms']:.3f} of the "
            f"bound), plain {r['plain_ms']:.3f} ms, library {lib}{gemm}, bound "
            f"{r['bound_ms']:.3f} ms by {r['bound_by']} (bytes {r['bytes_ms']:.3f} ms for "
            f"{r['bytes']} B; flop {r['flop_ms']:.3f} ms for {r['flops']} flop at 989 TFLOP/s) "
            f"{tag}"
        )
    print(f"slice 3 kernels: parity and timing in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lm_train = train_lm(fops, xops)
    prof = lm_train["profiled"]
    print(
        f"train: {DENSE_ARCH} 24 layers bf16 remat, {lm_train['params']} params, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: {TRAIN_STEPS} steps, walls "
        f"{[round(x, 3) for x in lm_train['step_s']]} s; median after the first "
        f"{lm_train['step_s_median']:.3f} s = {lm_train['tokens_per_s']:.0f} tokens/s, 6N "
        f"share {lm_train['six_n_share']:.4f} of 989 TFLOP/s; peak {lm_train['peak_gb']:.2f} "
        f"GB; losses {[round(x, 4) for x in lm_train['losses']]}; flash_attention launches "
        f"{lm_train['flash_launches']} ({lm_train['flash_launches'] // TRAIN_STEPS} a step), "
        f"fused_xent {lm_train['xent_launches']}, its combine {lm_train['combine_launches']} {tag}"
    )
    print(
        f"train (profiled step): wall {prof['wall_s']:.3f} s, device busy "
        f"{prof['device_busy_s']:.3f} s, idle share {prof['device_idle_share']:.4f}, "
        f"{prof['kernel_launches']} kernel launches; flash_attention "
        f"{prof['flash_attention_']}, fused_xent {prof['fused_xent_']}, its combine "
        f"{prof['xent_combine']} {tag}"
    )
    print("train (profiled step) top kernels: " + json.dumps(prof["top_kernels"]))
    lm_train_flash, lm_train_xent = lm_train["flash_launches"], lm_train["xent_launches"]
    lm_train_combine = lm_train["combine_launches"]
    del lm_train
    torch.cuda.empty_cache()
    print(f"slice 3 training in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    dense = dense_slice_parity()
    print(
        f"slice parity: {DENSE_ARCH} full width, 2 layers, float32, batch 1 x 256, card vs "
        f"CPU: loss {dense['loss']:.3e}, grads {dense['grads']:.3e}, params after one step "
        f"{dense['params']:.3e}, step loss {dense['step_loss']:.3e} (tol {LM_TOL}) in "
        f"{time.perf_counter() - t0:.1f} s"
    )

    # ---- slice 11: dense and MoE serving (Granite-8B, OLMoE-1B-7B, Minitron-8B)
    attn_serving = attn_serve_phase(tag, fops, fref)

    # ---- slice 12: hybrid, vlm and audio serving (Zamba2-2.7B, LLaVA-NeXT, MusicGen)
    family_serving = family_serve_phase(tag, fops, fref)

    # ---- slice 14: training of the moe, mamba1, hybrid, vlm and audio families
    lm = lm_train_phase(tag, sops, sref, fops, xops)
    trained = {arch: r["launches"] for arch, r in lm["trained"].items()}
    bwd_row = lm["scan_bwd_row"]

    main_row = next(r for r in rows if (r["B"], r["direction"]) == (64, "forward"))
    scan_row = scan_rows[0]
    print(json.dumps({"kernels": [{
        "name": "recurrent_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/recurrent_scan.cu",
        "replaces": "src/repro/kernels/recurrent_scan/kernel.py:72",
        "launches": run["launches"],
        "launches_rec_mappo": rec_mappo_launches,
        **{k: v for k, v in matrix.items() if k.startswith("launches")},
        **distributed,
        **serving,
        **benched,
        "max_abs_err": max(*worst.values(), matrix["max_abs_err_matrix"],
                           benched["max_abs_err_bench"]),
        "ms": main_row["ms"],
        "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "design": "chunked time-parallel scan: a block is 32 d x 8 chunks of 16 steps, "
                  "carries combined in shared memory",
        "shape": "T=128 B=64 H=64 forward (the minibatch unroll)",
        "by_shape": rows,
        **{k: v for k, v in matrix.items() if not k.startswith("launches")},
        "gpu": gpu,
    }, {
        "name": "selective_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan/kernel.py:72",
        "launches": launcher["launches"],
        "launches_engine": engine["launches"],
        "launches_training": trained["falcon-mamba-7b"]["selective_scan"],
        "max_abs_err": max(max(e.values()) for c, e in scan_worst.items() if "float32" in c),
        "max_abs_err_bf16": {"y": max(e["y"] for c, e in scan_worst.items() if "bfloat16" in c),
                             "h_final": max(e["h_final"] for c, e in scan_worst.items()
                                            if "bfloat16" in c)},
        "ms": scan_row["ms"],
        "device_ms": scan_row["device_ms"],
        "plain_ms": scan_row["plain_ms"],
        "bound_ms": scan_row["bound_ms"],
        "bound_by": scan_row["bound_by"],
        "library_ms": None,
        "design": "N / 8 threads a (b, d) lane, 8 states each, sub-major warps (B/C reads "
                  "broadcast); 16-step two-stage shared-memory ring filled a chunk ahead (4 lanes "
                  "a load where di % 4 == 0); partial y summed through shared memory",
        "shape": "b=4 S=2048 di=8192 N=16 bf16 (the launcher's prefill)",
        "by_shape": scan_rows,
        "gpu": gpu,
    }, {
        "name": "selective_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
        "replaces": "src/repro/kernels/selective_scan/ops.py:60",
        "launches": trained["falcon-mamba-7b"]["selective_scan_bwd"],
        "max_abs_err": max(max(e.values()) for c, e in lm["scan_bwd_worst"].items()
                           if "float32" in c),
        "max_abs_err_bf16": max(max(e.values()) for c, e in lm["scan_bwd_worst"].items()
                                if "bfloat16" in c),
        **{key: bwd_row[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "design": "a warp of 32 (b, d) lanes a block, N states a thread; the state entering "
                  "every 16th step stored by a forward sweep, each chunk rebuilt into shared "
                  "memory and walked back; dB/dC summed over the warp by a transposing "
                  "butterfly, over blocks and dA/dD over b by a second kernel in a fixed order",
        "shape": "b=4 S=2048 di=8192 N=16 bf16 (Falcon-Mamba's training shape)",
        "by_shape": [bwd_row],
        "gpu": gpu,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "launches": lm_train_flash,
        "launches_serving": {**attn_serving["launches_serving"],
                             **family_serving["launches_serving"]},
        "launches_training": {arch: n["flash_attention"] for arch, n in trained.items()},
        "max_abs_err": max(e["abs"] for c, e in flash_worst.items() if "float32" in c),
        "max_abs_err_bf16": max(e["abs"] for c, e in flash_worst.items() if "bfloat16" in c),
        "max_row_err_bf16": max(e["row"] for c, e in flash_worst.items() if "bfloat16" in c),
        **{key: flash_row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "shape")},
        "library": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
        "by_shape": [flash_row, attn_serving["serving_row"], *family_serving["serving_rows"]],
        "design": "bf16 head_dim 64/128: wgmma fed by a TMA/mbarrier ring, producer warpgroup; "
                  "bf16 head_dim 32/80: WMMA 16x16x16; float32: SIMT",
        "gpu": gpu,
    }, {
        "name": "fused_xent",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_xent.cu",
        "replaces": "src/repro/kernels/fused_xent/kernel.py:67",
        "launches": lm_train_xent,
        "combine_launches": lm_train_combine,
        "launches_training": {arch: n["fused_xent"] for arch, n in trained.items()},
        "design": "bf16: wgmma fed by a TMA/mbarrier ring over vocab splits, then a combine "
                  "kernel; float32: SIMT",
        "max_abs_err": max(e["abs"] for c, e in xent_worst.items() if "float32" in c),
        "max_abs_err_bf16": max(e["abs"] for c, e in xent_worst.items() if "bfloat16" in c),
        **{key: xent_row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "gemm_ms", "shape")},
        "gpu": gpu,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
