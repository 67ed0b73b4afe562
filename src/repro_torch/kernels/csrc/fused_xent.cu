// Fused softmax cross-entropy for Hopper: per-token lse(x W) - (x W)[label]
// without materialising the (T, V) logits.
//
// Replaces src/repro/kernels/fused_xent/kernel.py::fused_xent_kernel (the
// Pallas TPU kernel behind repro.kernels.fused_xent.ops.fused_softmax_xent,
// the TPU form of the training loss repro.models.layers.chunked_softmax_xent).
// It computes what that kernel computes, not its grid: the TPU walks (token
// block, vocab block) with the vocab blocks in order on one core and the
// online-logsumexp state in VMEM scratch.  Here a block owns one tile of
// tokens and loops over vocab tiles itself, keeping each row's running max,
// sum and gold logit in registers (kernel.py:36-64).  The kernel masks the
// token tail and the vocab tail, so it never shrinks the vocab tile to a
// divisor of V (the JAX wrapper does, ops.py:34-37: V = 92,544 = 2^7 * 3 *
// 241 would fall to 482-wide tiles).
//
// Layout (row-major, contiguous): x (T, d) and w (d, V) in T (float or bf16);
// labels (T,) int32; loss (T,) float32.  Each logit is a float32 sum of d
// products, rounded to T (round to nearest even) before the logsumexp and
// the gold pick: that is the training loss's numerics, whose product
// xc @ w_unembed runs in the operands' dtype (layers.py:125).  In float32
// the rounding is a no-op and this is softmax_xent_ref.  Then
// loss = m + log(max(l, 1e-30)) - gold, as kernel.py:62-64.
//
// Bound on this card: the product, 2 * T * d * V flop: 6.21e12 at the
// training shape (T = 16,384, d = 2048, V = 92,544), 6.28 ms at 989 TFLOP/s
// on bf16 tensor cores; the bytes (x, w, labels read once, loss written
// once: 446 MB) take 0.13 ms.  What the design does about the operations:
//   * bf16: a pipelined wgmma product with the online logsumexp as its
//     epilogue (hopper.cuh).  A block is two consumer warpgroups of 64
//     tokens and one producer warp; each warpgroup holds a 64 x 256 logit
//     tile as float32 accumulators in registers.  The producer streams
//     64-deep stages of x (128 tokens, K-major) and w (256 columns, read
//     MN-major, transposed by the wgmma) through a four-stage ring with TMA,
//     each stage behind a full and an empty mbarrier, so the copies run
//     under the products and each warpgroup keeps one stage's wgmmas in
//     flight while it releases the previous stage.  The fold reads the
//     accumulators in registers: round to bf16, max, exp2, sum and the gold
//     pick, each thread keeping (m, l, gold) for its two rows over its own
//     columns, combined across the quad once at the end.
//     The vocab is cut into splits of whole tiles (the wrapper picks how
//     many, ops.py `vocab_splits`): block (split, token tile) writes its
//     (m, l, gold) to a float32 scratch and `xent_combine_kernel` merges the
//     splits.  The splits of one token tile run side by side, so the x rows
//     the running blocks re-read for every vocab tile (a few MB) stay in L2;
//     with one block per token tile they would be all of x (64 MB at the
//     training shape), re-read from memory for each of the 362 vocab tiles.
//     TMA needs 16-byte strides: the wrapper pads d and the row length of w
//     to multiples of 8 where they are not (the training shape copies
//     nothing); columns >= V never enter the loss.
//   * float32 runs on the SIMT cores, which keeps the products exact in
//     float32 (the tensor cores' TF32 would not): 64 x 64 tiles, each thread
//     a 4 x 4 block of logits fed by two float4 shared-memory loads a step;
//     67 TFLOP/s peak.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

// Fold logits z (already rounded, masked by `live`) into a running
// (max, sum) pair: m' = max(m, max z), l' = l e^(m - m') + sum e^(z - m').
struct LseState {
  float m = kNegInf, l = 0.0f, gold = 0.0f;
};

// Combine the states of the `lanes` neighbouring lanes of a row (a power of
// two within a warp) and write the row's loss from its first lane.
__device__ __forceinline__ void finish_row(LseState s, int lanes, bool writer, float* out) {
  float m = s.m;
  for (int o = 1; o < lanes; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = s.l * expf(s.m - m), gold = s.gold;
  for (int o = 1; o < lanes; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
    gold += __shfl_xor_sync(0xffffffffu, gold, o);
  }
  if (writer) *out = m + logf(fmaxf(l, 1e-30f)) - gold;
}

// ------------------------------------------------------------ float32, SIMT

constexpr int kBT = 64;        // tokens per block
constexpr int kBV = 64;        // vocab columns per tile
constexpr int kKC = 32;        // depth of a staged slab
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes, 4 x 4 logits each
constexpr int kPad = 4;        // keeps float4 rows aligned

__global__ void __launch_bounds__(kThreads)
fused_xent_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int* __restrict__ labels, float* __restrict__ loss, int Tn,
                      int d, int V) {
  __shared__ __align__(16) float sX[kKC][kBT + kPad];  // x slab, transposed: [k][token]
  __shared__ __align__(16) float sW[kKC][kBV + kPad];  // w slab: [k][column]

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows 4 ty .. 4 ty + 3 of the tile
  const int tx = tid % 16;  // columns 4 tx .. 4 tx + 3 of each vocab tile
  const int t0 = blockIdx.x * kBT;

  int lab[4];
  LseState st[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = t0 + 4 * ty + r;
    lab[r] = row < Tn ? labels[row] : -1;
  }

  for (int v0 = 0; v0 < V; v0 += kBV) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kKC) {
      __syncthreads();  // every thread is done with the previous slab
      for (int i = tid; i < kBT * kKC; i += kThreads) {
        const int r = i / kKC, c = i % kKC;  // consecutive threads along d
        sX[c][r] = t0 + r < Tn && k0 + c < d ? x[static_cast<size_t>(t0 + r) * d + k0 + c] : 0.0f;
      }
      for (int i = tid; i < kKC * kBV; i += kThreads) {
        const int r = i / kBV, c = i % kBV;  // consecutive threads along V
        sW[r][c] = k0 + r < d && v0 + c < V ? w[static_cast<size_t>(k0 + r) * V + v0 + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&sX[kk][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&sW[kk][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = kNegInf;
      bool any = false;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = v0 + 4 * tx + c;
        if (col < V) {
          mx = fmaxf(mx, acc[r][c]);
          any = true;
          if (col == lab[r]) st[r].gold += acc[r][c];
        }
      }
      if (any) {
        const float m_new = fmaxf(st[r].m, mx);
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (v0 + 4 * tx + c < V) sum += expf(acc[r][c] - m_new);
        st[r].l = st[r].l * expf(st[r].m - m_new) + sum;
        st[r].m = m_new;
      }
    }
  }

  // the 16 column lanes of a row are lanes 16g .. 16g + 15 of one warp
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = t0 + 4 * ty + r;
    finish_row(st[r], 16, tx == 0 && row < Tn, loss + row);
  }
}

// ------------------------------------------- bf16, wgmma fed by a TMA ring

constexpr int kWgGroups = 2;                     // consumer warpgroups, 64 tokens each
constexpr int kWgBT = 64 * kWgGroups;            // tokens per block
constexpr int kWgBV = 256;                       // vocab columns per tile
constexpr int kWgBK = 64;                        // depth of a stage (one 128-byte row)
constexpr int kWgStages = 4;
constexpr int kWgThreads = 128 * kWgGroups + 32;  // + the producer warp
constexpr int kWgChunkW = kWgBK * 64 * 2;         // one 64-column chunk of a w stage
constexpr int kWgTileX = kWgBT * kWgBK * 2;
constexpr int kWgStage = kWgTileX + (kWgBV / 64) * kWgChunkW;
constexpr int kWgBytes = kWgStages * kWgStage + 1024;  // + the alignment slack
constexpr float kLog2e = 1.4426950408889634f;

// One block: tokens [t0, t0 + kWgBT) against the vocab tiles
// [split * tiles_per_split, ...) of its split.  Writes the split's
// (max, sum, gold) of each token to part[0 | 1 | 2][split][token].
__global__ void __launch_bounds__(kWgThreads, 1)
fused_xent_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const int* __restrict__ labels, float* __restrict__ part, int Tn, int d,
                       int V, int tiles_per_split) {
  extern __shared__ unsigned char wg_smem_raw[];
  __shared__ uint64_t full[kWgStages], empty[kWgStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int split = blockIdx.x, splits = gridDim.x;
  const int t0 = blockIdx.y * kWgBT;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, (V + kWgBV - 1) / kWgBV);
  const int nk = (d + kWgBK - 1) / kWgBK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kWgGroups);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kWgGroups) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
      int it = 0;
      for (int vt = vt_begin; vt < vt_end; ++vt) {
        const int v0 = vt * kWgBV;
        const int chunks = min(kWgBV / 64, (V - v0 + 63) / 64);  // chunks with a live column
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kWgStages;
          unsigned char* sx = smem + s * kWgStage;
          hopper::mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], kWgTileX + chunks * kWgChunkW);
          hopper::tma_load_2d(sx, &x_map, &full[s], kt * kWgBK, t0);
          for (int c = 0; c < chunks; ++c)
            hopper::tma_load_2d(sx + kWgTileX + c * kWgChunkW, &w_map, &full[s], v0 + 64 * c,
                                kt * kWgBK);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: tokens t0 + 64 wg .. + 63
  const int wg = warp / 4;
  const int row0 = t0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  const int kc = 2 * (lane % 4);  // this thread's first column in each 8-column chunk
  const int lab0 = row0 < Tn ? labels[row0] : -1;
  const int lab1 = row0 + 8 < Tn ? labels[row0 + 8] : -1;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, g0 = 0.0f, g1 = 0.0f;

  int it = 0;
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * kWgBV;
    float z[kWgBV / 2];  // the 64 x kWgBV logit tile of the warpgroup
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kWgStages;
      const uint32_t x_base = hopper::smem_addr(smem + s * kWgStage) + 64 * wg * 128;
      const uint32_t w_base = hopper::smem_addr(smem + s * kWgStage + kWgTileX);
      hopper::mbar_wait(&full[s], (it / kWgStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)  // x K-major; w MN-major, read transposed
        hopper::wgmma_ss<1>(z, hopper::desc(x_base + kk * 32, 16, 1024),
                            hopper::desc(w_base + kk * 16 * 128, kWgChunkW, 1024),
                            kt > 0 || kk > 0, hopper::Shape<kWgBV>{});
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
      prev = s;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(z);
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // round each logit to bf16 (the loss's numerics); columns >= V are -inf
    float mx0 = kNegInf, mx1 = kNegInf;
    const bool tail = v0 + kWgBV > V;
#pragma unroll
    for (int j = 0; j < kWgBV / 2; j += 2) {
      float2 r = hopper::unpack_bf16(hopper::pack_bf16(z[j], z[j + 1]));
      if (tail) {
        const int col = v0 + 8 * (j / 4) + kc;
        if (col >= V) r.x = -INFINITY;
        if (col + 1 >= V) r.y = -INFINITY;
      }
      z[j] = r.x;
      z[j + 1] = r.y;
      if (j & 2) mx1 = fmaxf(mx1, fmaxf(r.x, r.y));
      else mx0 = fmaxf(mx0, fmaxf(r.x, r.y));
    }
    // the gold logit, in the one tile (and thread) that holds it
    if (lab0 >= v0 && lab0 < v0 + kWgBV) {
#pragma unroll
      for (int j = 0; j < kWgBV / 2; ++j)
        if (!(j & 2) && v0 + 8 * (j / 4) + kc + (j & 1) == lab0) g0 = z[j];
    }
    if (lab1 >= v0 && lab1 < v0 + kWgBV) {
#pragma unroll
      for (int j = 0; j < kWgBV / 2; ++j)
        if ((j & 2) && v0 + 8 * (j / 4) + kc + (j & 1) == lab1) g1 = z[j];
    }
    // fold into this thread's running (max, sum) of each row
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float o0 = mn0 * kLog2e, o1 = mn1 * kLog2e;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kWgBV / 2; ++j) {
      if (j & 2) s1 += exp2f(fmaf(z[j], kLog2e, -o1));
      else s0 += exp2f(fmaf(z[j], kLog2e, -o0));
    }
    l0 = l0 * exp2f((m0 - mn0) * kLog2e) + s0;
    l1 = l1 * exp2f((m1 - mn1) * kLog2e) + s1;
    m0 = mn0;
    m1 = mn1;
  }

  // combine the quad's states of each row; lane 0 of the quad writes them
  const float ms[2] = {m0, m1}, ls[2] = {l0, l1}, gs[2] = {g0, g1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = ms[r];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float l = ls[r] * expf(ms[r] - m), g = gs[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    g += __shfl_xor_sync(0xffffffffu, g, 1);
    g += __shfl_xor_sync(0xffffffffu, g, 2);
    const int row = row0 + 8 * r;
    if (lane % 4 == 0 && row < Tn) {
      part[static_cast<size_t>(split) * Tn + row] = m;
      part[static_cast<size_t>(splits + split) * Tn + row] = l;
      part[static_cast<size_t>(2 * splits + split) * Tn + row] = g;
    }
  }
}

// loss = m + log(max(l, 1e-30)) - gold over the splits' (m, l, gold)
__global__ void xent_combine_kernel(const float* __restrict__ part, float* __restrict__ loss,
                                    int Tn, int splits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  float m = kNegInf;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[static_cast<size_t>(s) * Tn + t]);
  float l = 0.0f, gold = 0.0f;
  for (int s = 0; s < splits; ++s) {
    l += part[static_cast<size_t>(splits + s) * Tn + t] *
         expf(part[static_cast<size_t>(s) * Tn + t] - m);
    gold += part[static_cast<size_t>(2 * splits + s) * Tn + t];
  }
  loss[t] = m + logf(fmaxf(l, 1e-30f)) - gold;
}

}  // namespace

extern "C" int fused_xent_f32(const float* x, const float* w, const int* labels, float* loss,
                              int Tn, int d, int V, void* stream) {
  if (Tn == 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fused_xent_f32_kernel<<<(Tn + kBT - 1) / kBT, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, labels, loss, Tn, d, V);
  return static_cast<int>(cudaGetLastError());
}

// x (Tn, d) and w (d, ldw) with d and ldw multiples of 8 and both on 16
// bytes (TMA's strides); columns >= V of w are never read into the loss.
// part: float32 (3, splits, Tn) scratch; each split covers tiles_per_split
// vocab tiles of kWgBV columns.
extern "C" int fused_xent_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                               const int* labels, float* part, int Tn, int d, int V, int ldw,
                               int splits, int tiles_per_split, void* stream) {
  if (Tn == 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || V <= 0 || ldw < V || d % 8 || ldw % 8 || splits <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(d), static_cast<uint64_t>(Tn)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(d) * 2};
  const uint32_t x_box[2] = {kWgBK, kWgBT};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(ldw), static_cast<uint64_t>(d)};
  const uint64_t w_strides[1] = {static_cast<uint64_t>(ldw) * 2};
  const uint32_t w_box[2] = {64, kWgBK};
  if (!hopper::make_map(&x_map, x, 2, x_dims, x_strides, x_box) ||
      !hopper::make_map(&w_map, w, 2, w_dims, w_strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_xent_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWgBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, (Tn + kWgBT - 1) / kWgBT);  // the splits of a token tile together
  fused_xent_bf16_kernel<<<grid, kWgThreads, kWgBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, labels, part, Tn, d, V, tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_xent_combine(const float* part, float* loss, int Tn, int splits,
                                  void* stream) {
  if (Tn == 0) return static_cast<int>(cudaGetLastError());
  xent_combine_kernel<<<(Tn + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, loss, Tn, splits);
  return static_cast<int>(cudaGetLastError());
}
