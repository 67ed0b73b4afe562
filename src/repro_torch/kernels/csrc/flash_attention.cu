// Flash attention forward for Hopper: online-softmax attention over kv tiles,
// causal and sliding-window masks, GQA.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (the Pallas TPU kernel behind repro.kernels.flash_attention.ops.
// flash_attention, reached from repro.models.attention.attention_full).  It
// computes what that kernel computes, not its grid: the TPU walks (b, h, q
// block, kv block) with the kv blocks in order on one core and the
// accumulators in VMEM scratch.  Hopper's blocks run in no order, so here one
// block owns one (b, h, query tile) and loops over the kv tiles itself, with
// the row max m and the row sum l in registers.  The loop starts at the
// window's first live tile and stops at the causal diagonal, so fully masked
// tiles are never visited (kernel.py:58-62).  Query head h reads kv head
// h / (Hq / Hkv); no expanded copy of k or v exists.  The kernel masks keys
// past the causal limit, outside the window and at positions >= S, so it
// needs no padding and a non-causal call on a ragged S is right (the JAX
// wrapper pads S and relies on the causal mask, ops.py:35-37).
//
// Layout (row-major, contiguous): q, out (B, Hq, S, HD); k, v (B, Hkv, S, HD);
// all float or all bf16.  The softmax state and the output accumulator are
// float32; the output is divided by max(l, 1e-30) and rounded to the input
// type once, at the store.
//
// Bound on this card: the two tile products, 4 * S_live * HD flop per query
// row.  At the training shape (B = 4, Hq = 16, Hkv = 8, S = 4096, HD = 128,
// causal) that is 2.75e11 flop, 0.28 ms at 989 TFLOP/s on bf16 tensor cores;
// the bytes (q, k, v read once, out written once: 201 MB in bf16) take
// 0.06 ms.  What the design does about the operations:
//   * bf16, every head_dim (32, 64, 80, 112, 128): the products run as wgmma
//     with float32 accumulators in registers (hopper.cuh).  A block
//     is two consumer warpgroups of 64 query rows and one producer
//     warpgroup, which gives its registers to the consumers (setmaxnreg).
//     The producer loads the block's Q tile once and streams 128-key tiles
//     of K and V through two-stage rings in shared memory with TMA, each
//     stage behind a full and an empty mbarrier; K and V have rings of their
//     own, since K_i is free once S_i is done and V_i once P_i V_i is.
//     S = Q K^T reads both operands from shared memory (K is K-major as
//     stored); the scale, the masks, the row max and sum run on S in
//     registers (a row lives in the 4 lanes of a quad); P is rounded to bf16
//     in registers and is the register A operand of O += P V (V read
//     MN-major, transposed by the wgmma); O is rescaled by
//     alpha = exp(m_old - m_new) in registers.  Two overlaps keep the tensor
//     cores fed while the softmax runs: a warpgroup issues S_i = Q K_i and
//     O += P_{i-1} V_{i-1} together and computes the exponentials of S_i
//     while the second product runs; and the two warpgroups take turns to
//     issue (named barriers), so one's softmax runs under the other's
//     products.  The tensor maps are 3-d (HD, S, B * H), so a box past S
//     reads zeros, never the next head.  Blocks start with the last query
//     tiles, which have the most kv tiles under a causal mask, so the grid's
//     tail is short tiles.
//     Both products run at the head's own width: S = Q K^T takes HD / 16
//     k-steps and O += P V is one m64nHDk16 wgmma a 16-key step, so no
//     tensor-core work multiplies padding.  Shared memory holds each tile in
//     64-column chunks (HD / 64 rounded up); the tensor maps declare the row
//     as HD columns (2 HD bytes, a multiple of 16), so TMA fills the columns
//     past HD of a chunk with zeros (at HD = 32, 80 and 112), which costs
//     shared memory and none of the bytes from device memory.  At HD = 80 the
//     fifth k-step of S reads the first 32 bytes of the second chunk's rows,
//     as a k-step inside a chunk does.  P V reads V MN-major through the
//     128-byte-swizzled chunks as one n80 (n112) wgmma a 16-key step, not
//     an n64 product plus an n16 (n48) tail in a layout of its own: it takes
//     all of chunk 0 and the first 16 (48) columns of chunk 1, the chunk
//     stride as the leading byte offset.  The swizzle is a function of the
//     shared-memory address, so a product narrower than its last chunk
//     reads the bytes a full one would and never the columns past it; the
//     n32 product reads half of chunk 0.  Held against the plain version on
//     an H100 at every case of chip_smoke and the card test, this form is
//     right at every width, so no split and no second layout are needed.
//   * bf16: S is scaled by 1/sqrt(HD) in float32 (the same value as scaling q
//     first, kernel.py:66, with one rounding fewer), the softmax runs in
//     float32, and P is rounded to bf16 for P V; l sums the rounded weights
//     that P V uses.
//   * float32 runs on the SIMT cores, which keeps the reference's float32
//     products exactly (the tensor cores' TF32 would not): q scaled in
//     float32 first, a 64-row query tile and 32-key tiles in shared memory
//     (padded rows, no bank conflicts), each thread a 4 x 4 block of scores
//     and a 4 x HD/8 block of the output in registers.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 32;       // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kRows = kBQ / 16;   // query rows per thread
constexpr int kCols = kBKV / 8;   // score columns per thread
constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ float32, SIMT

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBKV * (HD + 1) + kBKV * HD + kBQ * (kBKV + 1);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int Hq,
                           int Hkv, int S, int causal, int window, float scale) {
  static_assert(HD % 8 == 0, "HD must be a multiple of 8");
  extern __shared__ float smem[];
  float* sQ = smem;                   // kBQ x (HD + 1), scaled
  float* sK = sQ + kBQ * (HD + 1);    // kBKV x (HD + 1)
  float* sV = sK + kBKV * (HD + 1);   // kBKV x HD
  float* sP = sV + kBKV * HD;         // kBQ x (kBKV + 1)

  const int tid = threadIdx.x;
  const int ty = tid / 8;  // rows ty * kRows .. + kRows - 1 of the tile
  const int tx = tid % 8;  // columns tx + 8 j
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const float* qh = q + (static_cast<size_t>(b) * Hq + h) * S * HD;
  const float* kh = k + (static_cast<size_t>(b) * Hkv + hk) * S * HD;
  const float* vh = v + (static_cast<size_t>(b) * Hkv + hk) * S * HD;
  float* oh = out + (static_cast<size_t>(b) * Hq + h) * S * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    sQ[r * (HD + 1) + c] = q0 + r < S ? qh[static_cast<size_t>(q0 + r) * HD + c] * scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][HD / 8];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) acc[r][c] = 0.0f;
  }

  // the live key range of this tile's rows: [kv_begin, kv_end)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window ? max(0, q0 - window + 1) : 0;

  for (int k0 = (kv_begin / kBKV) * kBKV; k0 < kv_end; k0 += kBKV) {
    __syncthreads();  // the previous tile's readers are done (and sQ is staged)
    for (int i = tid; i < kBKV * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const bool in = k0 + r < S;
      const size_t at = static_cast<size_t>(k0 + r) * HD + c;
      sK[r * (HD + 1) + c] = in ? kh[at] : 0.0f;
      sV[r * HD + c] = in ? vh[at] : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[r][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = sQ[(ty * kRows + r) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + 8 * j) * (HD + 1) + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + ty * kRows + r;
      bool live[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 8 * j;
        live[j] = kp < S && (!causal || kp <= qp) && (!window || kp > qp - window);
        if (live[j]) mx = fmaxf(mx, s[r][j]);
      }
      // the 8 lanes of a row group are lanes 8g .. 8g + 7 of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = live[j] ? expf(s[r][j] - m_new) : 0.0f;
        sP[(ty * kRows + r) * (kBKV + 1) + tx + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // every lane's p is in sP

#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = sP[(ty * kRows + r) * (kBKV + 1) + kk];
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const float vv = sV[kk * HD + tx + 8 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    if (row < S) {
      const float norm = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        oh[static_cast<size_t>(row) * HD + tx + 8 * c] = acc[r][c] / norm;
    }
  }
}

// ------------------------------------------- bf16, wgmma fed by a TMA ring

using bf16 = __nv_bfloat16;

constexpr int kWgGroups = 2;                     // consumer warpgroups, 64 query rows each
constexpr int kWgBQ = 64 * kWgGroups;            // query rows per block
constexpr int kWgBKV = 128;                      // keys per tile
constexpr int kWgStages = 2;                     // K and V tiles in flight, each
constexpr int kWgThreads = 128 * (kWgGroups + 1);  // + the producer warpgroup
// registers a thread: the producer gives up what the consumers take
// (setmaxnreg; 3 warps of each SM sub-partition: 24 + 2 x 240 <= 512)
constexpr int kWgProducerRegs = 24, kWgConsumerRegs = 240;

// Shared-memory plan (bytes from a 1,024-aligned base): Q, then the K and V
// stages; each tile is `chunks` chunks of (rows x 64) bf16, 128 bytes a row,
// the columns past HD zero.
template <int HD>
struct WgPlan {
  static constexpr int chunks = (HD + 63) / 64;
  static constexpr int tile = kWgBKV * chunks * 128;
  static constexpr int k = kWgBQ * chunks * 128;
  static constexpr int v = k + kWgStages * tile;
  static constexpr int bytes = v + kWgStages * tile + 1024;  // + the alignment slack
};

// Softmax of one S tile in registers, up to the exponentials: scale, mask
// (kMask), row max across the quad, the new running max m (log2 units) and
// alpha = exp(m_old - m), and S = exp(S - m) in place (float32).
template <bool kMask, int N>
__device__ __forceinline__ void softmax_exp(float (&sc)[N], float scale_log2, int k0, int kc,
                                            int row0, int S, int causal, int window, float& m0,
                                            float& m1, float& a0, float& a1) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float x = sc[j] * scale_log2;
    if (kMask) {
      const int kp = k0 + 8 * (j / 4) + kc + (j & 1);
      const int qp = row0 + ((j & 2) ? 8 : 0);
      const bool live = kp < S && (!causal || kp <= qp) && (!window || kp > qp - window);
      x = live ? x : -INFINITY;
    }
    sc[j] = x;
    if (j & 2) mx1 = fmaxf(mx1, x);
    else mx0 = fmaxf(mx0, x);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  a0 = exp2f(m0 - mn0);
  a1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int j = 0; j < N; ++j) sc[j] = exp2f(sc[j] - ((j & 2) ? mn1 : mn0));
}

// the masked instance only where the tile needs it (`edge`): the diagonal,
// the window's first tile, the tail past S
template <int N>
__device__ __forceinline__ void softmax_tile(bool edge, float (&sc)[N], float scale_log2, int k0,
                                             int kc, int row0, int S, int causal, int window,
                                             float& m0, float& m1, float& a0, float& a1) {
  if (edge)
    softmax_exp<true>(sc, scale_log2, k0, kc, row0, S, causal, window, m0, m1, a0, a1);
  else
    softmax_exp<false>(sc, scale_log2, k0, kc, row0, S, causal, window, m0, m1, a0, a1);
}

// P = the weights rounded to bf16, packed as the A fragments of P V; l is
// rescaled by alpha and gains the rounded weights that P V uses
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N], uint32_t (&p)[N / 2], float a0,
                                       float a1, float& l0, float& l1) {
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    p[j / 2] = hopper::pack_bf16(sc[j], sc[j + 1]);
    const float2 w = hopper::unpack_bf16(p[j / 2]);
    if (j & 2) rs1 += w.x + w.y;
    else rs0 += w.x + w.y;
  }
  l0 = l0 * a0 + rs0;
  l1 = l1 * a1 + rs1;
}

// S = Q K^T for one K tile: 16 columns of head_dim a step, both operands
// K-major in shared memory (the step's 32 bytes into the 128-byte rows of
// chunk kk / 4)
template <int HD>
__device__ __forceinline__ void issue_s(float (&sc)[kWgBKV / 2], uint64_t q_desc,
                                        uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int in_row = (kk % 4) * 32;
    hopper::wgmma_ss<0>(sc, hopper::desc_add(q_desc, (kk / 4) * kWgBQ * 128 + in_row),
                        hopper::desc_add(k_desc, (kk / 4) * kWgBKV * 128 + in_row), kk > 0,
                        hopper::Shape<kWgBKV>{});
  }
}

// O += P V over one V tile: 16 keys a step, P from registers, V MN-major
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p)[kWgBKV / 4],
                                         uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < kWgBKV / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    hopper::wgmma_rs<1>(o, a, hopper::desc_add(v_desc, kk * 16 * 128), 1, hopper::Shape<HD>{});
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                             int Hq, int Hkv, int S, int causal, int window, float scale_log2) {
  static_assert(HD % 16 == 0, "HD must be a multiple of 16 (8 columns a store, 16 a k-step)");
  using P = WgPlan<HD>;
  extern __shared__ unsigned char wg_smem_raw[];
  // K and V have rings of their own: K_i is free once S_i is done, V_i once P_i V_i is
  __shared__ uint64_t q_full, k_full[kWgStages], k_empty[kWgStages], v_full[kWgStages],
      v_empty[kWgStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWgBQ;  // the longest causal tiles first
  const int bh_q = b * Hq + h;
  const int bh_kv = b * Hkv + h / (Hq / Hkv);

  // the live key tiles of this block's rows: [t_begin, t_begin + n_tiles)
  const int q_last = min(q0 + kWgBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int t_begin = (window ? max(0, q0 - window + 1) : 0) / kWgBKV;
  const int n_tiles = (kv_end + kWgBKV - 1) / kWgBKV - t_begin;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * kWgGroups);  // one arrival per consumer warp
      hopper::mbar_init(&v_empty[s], 4 * kWgGroups);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWgGroups) {  // the producer warpgroup: one thread issues every copy
    hopper::regs_dealloc<kWgProducerRegs>();
    if (threadIdx.x == 128 * kWgGroups) {
      hopper::mbar_arrive_expect_tx(&q_full, P::k);  // a box's bytes, fill included
      for (int c = 0; c < P::chunks; ++c)
        hopper::tma_load_3d(smem + c * kWgBQ * 128, &q_map, &q_full, 64 * c, q0, bh_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kWgStages, parity = ((i / kWgStages) & 1) ^ 1;
        const int k0 = (t_begin + i) * kWgBKV;
        unsigned char* sk = smem + P::k + s * P::tile;
        unsigned char* sv = smem + P::v + s * P::tile;
        hopper::mbar_wait(&k_empty[s], parity);
        hopper::mbar_arrive_expect_tx(&k_full[s], P::tile);
        for (int c = 0; c < P::chunks; ++c)
          hopper::tma_load_3d(sk + c * kWgBKV * 128, &k_map, &k_full[s], 64 * c, k0, bh_kv);
        hopper::mbar_wait(&v_empty[s], parity);
        hopper::mbar_arrive_expect_tx(&v_full[s], P::tile);
        for (int c = 0; c < P::chunks; ++c)
          hopper::tma_load_3d(sv + c * kWgBKV * 128, &v_map, &v_full[s], 64 * c, k0, bh_kv);
      }
    }
    return;
  }

  // A consumer warpgroup: query rows q0 + 64 wg .. + 63.  Iteration i issues
  // S_i = Q K_i and then O += P_{i-1} V_{i-1}, waits for S_i only, and runs
  // the softmax of S_i while the tensor cores work on P_{i-1} V_{i-1}; O is
  // rescaled once that product is done.  The first tile is peeled off, so
  // every wgmma sits on a path all threads of the warpgroup take.
  hopper::regs_alloc<kWgConsumerRegs>();
  // the warpgroup index, known to the compiler to be the same across the warp,
  // so the descriptors below live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  const int kc = 2 * (lane % 4);  // this thread's first column in each 8-column chunk
  const uint64_t q_desc = hopper::desc(hopper::smem_addr(smem) + 64 * wg * 128, 16, 1024);
  const auto k_desc = [&](int s) {
    return hopper::desc(hopper::smem_addr(smem + P::k + s * P::tile), 16, 1024);
  };
  const auto v_desc = [&](int s) {  // MN-major: 64-column chunks kWgBKV rows apart
    return hopper::desc(hopper::smem_addr(smem + P::v + s * P::tile), kWgBKV * 128, 1024);
  };

  float o[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;  // m in log2 units
  uint32_t p[kWgBKV / 4];  // P_{i-1}: the A fragments of the product in flight
  hopper::mbar_wait(&q_full, 0);
  const auto edge = [&](int k0) {  // does tile k0 need masks?
    return (causal && k0 + kWgBKV - 1 > q0) || (window && k0 <= q_last - window) ||
           k0 + kWgBKV > S;
  };

  // The two warpgroups take turns to issue their wgmmas (named barriers 1
  // and 2, one per group), so one's softmax runs under the other's products.
  const auto my_turn = [&] { hopper::bar_sync(1 + wg, 256); };
  const auto your_turn = [&] { hopper::bar_arrive(2 - wg, 256); };
  if (wg == 1) your_turn();  // group 0 starts

  {  // tile 0: S_0 and its softmax; O and l are still zero
    const int k0 = t_begin * kWgBKV;
    hopper::mbar_wait(&k_full[0], 0);
    float sc[kWgBKV / 2];
    my_turn();
    hopper::wgmma_fence();
    issue_s<HD>(sc, q_desc, k_desc(0));
    hopper::wgmma_commit();
    your_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    if (lane == 0) hopper::mbar_arrive(&k_empty[0]);
    float a0, a1;
    softmax_tile(edge(k0), sc, scale_log2, k0, kc, row0, S, causal, window, m0, m1, a0, a1);
    pack_p(sc, p, a0, a1, l0, l1);
  }
  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % kWgStages;
    const int sp = (i - 1) % kWgStages;  // tile i - 1's stage
    const int k0 = (t_begin + i) * kWgBKV;
    hopper::mbar_wait(&k_full[s], (i / kWgStages) & 1);
    hopper::mbar_wait(&v_full[sp], ((i - 1) / kWgStages) & 1);
    float sc[kWgBKV / 2];
    my_turn();
    hopper::wgmma_fence();
    issue_s<HD>(sc, q_desc, k_desc(s));
    hopper::wgmma_commit();
    hopper::fence_regs(o);
    hopper::fence_regs(p);
    hopper::wgmma_fence();
    issue_pv<HD>(o, p, v_desc(sp));
    hopper::wgmma_commit();
    your_turn();
    hopper::wgmma_wait<1>();  // S_i is done; P_{i-1} V_{i-1} may still run
    hopper::fence_regs(sc);
    if (lane == 0) hopper::mbar_arrive(&k_empty[s]);  // this warp is done with K_i

    float a0, a1;
    softmax_tile(edge(k0), sc, scale_log2, k0, kc, row0, S, causal, window, m0, m1, a0, a1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(p);
    if (lane == 0) hopper::mbar_arrive(&v_empty[sp]);  // and with V_{i-1}
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] *= (j & 2) ? a1 : a0;
    pack_p(sc, p, a0, a1, l0, l1);
  }
  {  // the last tile's O += P V
    const int sp = (n_tiles - 1) % kWgStages;
    hopper::mbar_wait(&v_full[sp], ((n_tiles - 1) / kWgStages) & 1);
    hopper::fence_regs(o);
    hopper::fence_regs(p);
    my_turn();
    hopper::wgmma_fence();
    issue_pv<HD>(o, p, v_desc(sp));
    hopper::wgmma_commit();
    if (wg == 0) your_turn();  // group 1's last turn follows; nobody waits after it
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(p);
    if (lane == 0) hopper::mbar_arrive(&v_empty[sp]);
  }

  // the quad's partial sums, then out = O / max(l, 1e-30), rounded once
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float n0 = fmaxf(l0, 1e-30f), n1 = fmaxf(l1, 1e-30f);
  bf16* oh = out + static_cast<size_t>(bh_q) * S * HD;
#pragma unroll
  for (int j = 0; j < HD / 2; j += 2) {
    const int row = row0 + ((j & 2) ? 8 : 0);
    const int col = 8 * (j / 4) + kc;
    const float n = (j & 2) ? n1 : n0;
    if (row < S)
      *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(row) * HD + col) =
          hopper::pack_bf16(o[j] / n, o[j + 1] / n);
  }
}

// ------------------------------------------------------------------ launch

template <int HD>
int launch_f32(const float* q, const float* k, const float* v, float* out, int B, int Hq,
               int Hkv, int S, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_f32_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, Hq, Hkv, S, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Hq,
                 int Hkv, int S, int causal, int window, float scale, cudaStream_t stream) {
  // 3-d maps (HD, S, B * H), innermost first: a box never crosses into the next head,
  // and the columns of a 64-column box past HD read as zeros
  CUtensorMap q_map, k_map, v_map;
  const uint64_t q_dims[3] = {HD, static_cast<uint64_t>(S), static_cast<uint64_t>(B) * Hq};
  const uint64_t kv_dims[3] = {HD, static_cast<uint64_t>(S), static_cast<uint64_t>(B) * Hkv};
  const uint64_t strides[2] = {HD * 2, static_cast<uint64_t>(S) * HD * 2};
  const uint32_t q_box[3] = {64, kWgBQ, 1}, kv_box[3] = {64, kWgBKV, 1};
  if (!hopper::make_map(&q_map, q, 3, q_dims, strides, q_box) ||
      !hopper::make_map(&k_map, k, 3, kv_dims, strides, kv_box) ||
      !hopper::make_map(&v_map, v, 3, kv_dims, strides, kv_box))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = WgPlan<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, (S + kWgBQ - 1) / kWgBQ);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  flash_attention_wgmma_kernel<HD><<<grid, kWgThreads, bytes, stream>>>(
      q_map, k_map, v_map, out, Hq, Hkv, S, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, T* out, int B, int Hq, int Hkv, int S,
              int causal, int window, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  if constexpr (sizeof(T) == sizeof(float)) {
    return launch_f32<HD>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale, stream);
  } else {
    // TMA's global addresses: q, k and v start on 16 bytes
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
    if (any % 16) return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_wgmma<HD>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale, stream);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int B, int Hq, int Hkv, int S,
           int hd, int causal, int window, void* stream) {
  if (B == 0 || Hq == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || Hq % Hkv != 0 || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<T, 32>(q, k, v, out, B, Hq, Hkv, S, causal, window, s);
    case 64: return launch_hd<T, 64>(q, k, v, out, B, Hq, Hkv, S, causal, window, s);
    case 80: return launch_hd<T, 80>(q, k, v, out, B, Hq, Hkv, S, causal, window, s);
    case 112: return launch_hd<T, 112>(q, k, v, out, B, Hq, Hkv, S, causal, window, s);
    case 128: return launch_hd<T, 128>(q, k, v, out, B, Hq, Hkv, S, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k, const float* v,
                                   float* out, int B, int Hq, int Hkv, int S, int hd,
                                   int causal, int window, void* stream) {
  return launch<float>(q, k, v, out, B, Hq, Hkv, S, hd, causal, window, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* out, int B,
                                    int Hq, int Hkv, int S, int hd, int causal, int window,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, hd, causal, window, stream);
}
