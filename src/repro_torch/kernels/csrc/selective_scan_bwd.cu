// Backward of the Mamba1 selective scan for Hopper: the vjp of
//   h_t = exp(delta_t * A) * h_{t-1} + (delta_t * x_t) outer B_t,
//   y_t = h_t . C_t + D * x_t,                      h_{-1} = 0,
// for the cotangents dy (of y) and dh_final (of h_{S-1}).
//
// Replaces the backward of src/repro/kernels/selective_scan/ops.py::
// selective_scan, the vjp of its jnp oracle (ops.py:60-62): the TPU has no
// backward kernel of its own, and the JAX op recomputes the scan step by
// step under `jax.vjp`.  This computes the same gradients:
//   dx (b, S, di) in T, ddelta (b, S, di) float32, dA (di, N) float32 summed
//   over b and t, dB, dC (b, S, N) in T summed over di, dD (di,) float32.
//
// With g_t = dL/dh_t = G_t + dy_t C_t, where G_t is what the later steps
// (or dh_final, at t = S-1) hand back, and a_t = exp(delta_t A):
//   dC_t[n] = sum_d dy_t h_t[n]             dB_t[n] = sum_d g_t[n] u_t
//   du_t    = sum_n g_t[n] B_t[n]            (u_t = delta_t x_t)
//   ddelta_t = du_t x_t + sum_n g_t[n] a_t[n] h_{t-1}[n] A[n]
//   dx_t    = du_t delta_t + dy_t D          dD += dy_t x_t
//   dA[n]  += g_t[n] a_t[n] h_{t-1}[n] delta_t
//   G_{t-1} = g_t * a_t.
//
// What bounds it.  A backward that takes only the primals and the two
// cotangents needs at least two exp(delta A) a (b, t, d, n): one to rebuild
// the states going forward, one to carry g backward.  On an NVIDIA H100
// 80GB HBM3 at 700.00 W (132 SMs, 16 exponentials a clock each, ~4.18e12 a
// second; 3.35 TB/s), at Falcon-Mamba's training shape (b = 4, S = 2048,
// di = 8192, N = 16) that is 2.15e9 of them, 514 us; the operands read once
// and the gradients written once are ~944 MB, 282 us.  In this design shared
// memory comes next: each (b, t, d, n) hands two floats (its dB_t and dC_t
// shares) to a sum over d, and the register file, which must keep a chunk's
// a_t and a_t h_{t-1} to avoid a third exponential, leaves room for 12 warps
// an SM.
//
// The design, three kernels a call:
// - `selective_scan_bwd_sweep` (exp #1): the forward kernel's layout (8
//   states a thread, N / 8 threads a lane, 4 blocks an SM) carries each
//   lane's state through the sequence and stores it at every kChunk-th (16th)
//   step: b (ceil(S / 16) - 1) di N floats, 266 MB at the training shape, half
//   of what storing every 8th step took.
// - `selective_scan_bwd_kernel` (exp #2), the chunks last first.  Blocks of 4
//   warps over 128 / G lanes of one batch row, a lane's N states split over
//   G = N / 4 threads, 4 states each; a warp holds 32 lanes and one group of
//   states, so its reads of a step's delta, x and dy are 128 contiguous bytes
//   and its reads of B_t and C_t one broadcast.  The rebuild carries the
//   stored state through the chunk and keeps a_t and a_t h_{t-1} of its 16
//   steps and 4 states in registers (128 a thread); the walk back carries g
//   through them with no exponential.  Both read each step's operands a step
//   ahead of its dependent chain.  16 steps is as far as the kept values fit
//   at 3 blocks an SM (168 registers, the few that do not fit spilled).
// - dB/dC sums over d off the steps' critical path.  Each step a thread
//   stores its 4 dB_t and 4 dC_t shares into shared memory (two 16-byte
//   stores; the 16-byte groups swizzled by lane, so a quarter warp's stores
//   and reads hit distinct banks).  Every kRed (8) steps, between two
//   barriers, each group of a step is summed over the block's lanes as eight
//   interleaved sums (the swizzle's period) added in turn, and each lane's
//   du_t and ddelta term over its G threads, with dx, ddelta written by
//   consecutive threads on consecutive lanes.  One partial a block reaches
//   global memory (256 at the training shape, 268 MB), and
//   `selective_scan_bwd_finish` adds them in block order.  No float atomics:
//   every sum has a fixed order, so a call gives the same gradients from run
//   to run.  (Not a thread block cluster adding its blocks' sums through
//   distributed shared memory: fewer partials, but its barrier's release is
//   a GPU-wide fence at every barrier, and clusters of 4 do not tile the SMs.)
// - Operands staged a chunk ahead.  Each chunk's x, delta, dy rows (16 x
//   lanes), its B/C run and the stored state of its lanes go into shared
//   memory by `cp.async` (16 bytes a copy, zero-filled past S and di) while
//   the chunk before is computed; bf16 is converted to float once, by the
//   thread that copied it.  Rows that are not 16-byte aligned (di not a
//   multiple of 16 bytes of T, S N not of 16 bytes of T, or a misaligned
//   operand) take a path that loads element by element.  A ragged last
//   chunk's zero steps leave g and the state as they are (exp(0) = 1) and
//   add nothing; masked lanes (d >= di) add exact zeros to every sum.
// - dA and dD sum over t in registers, over b in the finish kernel.
//
// Workspace (`selective_scan_bwd_workspace_bytes`): the stored states, the
// blocks' dB/dC partials (b, S, 2N) each, and dA, dD a batch row: 537 MB at
// the training shape.
//
// Layout (all row-major, contiguous): x, dy, dx (b, S, di) in T (float or
// bf16); delta, ddelta (b, S, di) float32; A, dA (di, N) float32; B, C, dB,
// dC (b, S, N) in T; D, dD (di,) float32; dh_final (b, di, N) float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // threads a block: 4 warps
constexpr int kChunk = 16;     // steps between stored states; steps kept in registers
constexpr int kStates = 4;     // states a thread
constexpr int kRed = 8;        // steps whose dB/dC shares are summed at a time
constexpr int kMainBlocks = 3;  // blocks an SM the reverse walk is compiled for
constexpr int kFinishThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// lanes of d a block holds: the N states of a lane take N / kStates threads
__host__ __device__ constexpr int lanes_for(int N) { return kThreads * kStates / N; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, of which the first `bytes` are read
// and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// A tile of kRows x kCols elements (row r at src + r * stride) into
// contiguous shared memory, 16 bytes a copy: elements past `vrows` rows or
// `vcols` columns are zero.  Copy j of a thread is granule tid + j kThreads.
template <int kRows, int kCols, typename Src>
__device__ __forceinline__ void copy_async(Src* dst, const Src* base, const Src* src, int stride,
                                           int vrows, int vcols, int tid) {
  constexpr int W = 16 / sizeof(Src), kPerRow = kCols / W, kGranules = kRows * kPerRow;
#pragma unroll
  for (int j = 0; j < (kGranules + kThreads - 1) / kThreads; ++j) {
    const int g = tid + j * kThreads;
    if (kGranules % kThreads == 0 || g < kGranules) {
      const int r = g / kPerRow, c = g % kPerRow * W;
      const int n = r < vrows ? max(0, min(W, vcols - c)) : 0;
      cp_async16(dst + g * W, n > 0 ? src + r * stride + c : base,
                 n * static_cast<int>(sizeof(Src)));
    }
  }
}

// The same tile loaded element by element and converted to float (no
// alignment needed; the loads complete before the stores).
template <int kRows, int kCols, typename Src>
__device__ __forceinline__ void copy_sync(float* dst, const Src* src, int stride, int vrows,
                                          int vcols, int tid) {
#pragma unroll 4
  for (int e = tid; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols;
    dst[e] = r < vrows && c < vcols ? to_f32(src[r * stride + c]) : 0.0f;
  }
}

// bf16 granules that this thread copied with `copy_async` into float
template <int kN>
__device__ __forceinline__ void convert(float* dst, const __nv_bfloat16* src, int tid) {
#pragma unroll
  for (int j = 0; j < (kN / 8 + kThreads - 1) / kThreads; ++j) {
    const int g = tid + j * kThreads;
    if ((kN / 8) % kThreads == 0 || g < kN / 8) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[g];
      reinterpret_cast<float4*>(dst)[2 * g] =
          make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                      __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
      reinterpret_cast<float4*>(dst)[2 * g + 1] =
          make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
                      __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
    }
  }
}

template <typename T, int N>
struct Smem {
  static constexpr int G = N / kStates;   // threads a lane
  static constexpr int L = lanes_for(N);  // lanes a block
  static constexpr int Q = N / 2;         // 16-byte groups of a lane's dB_t and dC_t shares
  static constexpr int kOut = kRed * Q;   // 16-byte groups of kRed steps' dB/dC rows
  struct Stage {                          // a chunk's operands as float
    float dl[kChunk][L], x[kChunk][L], dy[kChunk][L];
    float B[kChunk][N], C[kChunk][N];
    float h0[L * N];                      // the state entering the chunk (reverse walk)
  };
  struct Raw {                            // bf16 operands as copied (T = bf16 only)
    T x[kChunk][L], dy[kChunk][L];
    T B[kChunk][N], C[kChunk][N];
  };
  alignas(16) Stage fs[2];
  alignas(16) Raw raw;
  alignas(16) float share[kRed][L][2 * N];  // dB_t shares in groups 0..Q/2-1, dC_t's after
  alignas(16) float2 lane_sums[kRed][G][L]; // (du_t, ddelta term) over a thread's states
};

struct Workspace {
  float* ckpt;     // (b, nc - 1, di, N): the state entering steps kChunk, 2 kChunk, ...
  float* part_bc;  // (nblk, b, S, 2N): each block's dB_t, dC_t over its lanes
  float* part_a;   // (b, di, N): dA summed over t, a batch row
  float* part_d;   // (b, di): dD summed over t, a batch row
};

__host__ __device__ inline size_t align_up(size_t n) { return (n + 63) / 64 * 64; }
__host__ __device__ inline int blocks_for(int di, int N) {
  return (di + lanes_for(N) - 1) / lanes_for(N);
}

// floats of each part of the workspace, each rounded up to 256 bytes
__host__ __device__ inline void workspace_floats(int b, int S, int di, int N, size_t (&n)[4]) {
  const size_t nc = (S + kChunk - 1) / kChunk;
  n[0] = align_up(static_cast<size_t>(b) * (nc > 0 ? nc - 1 : 0) * di * N);
  n[1] = align_up(static_cast<size_t>(blocks_for(di, N)) * b * S * 2 * N);
  n[2] = align_up(static_cast<size_t>(b) * di * N);
  n[3] = align_up(static_cast<size_t>(b) * di);
}

Workspace carve(void* base, int b, int S, int di, int N) {
  size_t n[4];
  workspace_floats(b, S, di, N, n);
  float* p = static_cast<float*>(base);
  return {p, p + n[0], p + n[0] + n[1], p + n[0] + n[1] + n[2]};
}

// The forward sweep (exp #1): each lane's state carried through chunks 0 ..
// nc-2 and stored at their ends, the state entering chunks 1 .. nc-1.  The
// forward kernel's layout (8 states a thread, N / 8 threads a lane), and no
// stash, so 4 blocks an SM hide the steps' latency.
template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_bwd_sweep(const T* __restrict__ x, const float* __restrict__ delta,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         float* __restrict__ ckpt, int S, int di) {
  constexpr int kS = N < 8 ? N : 8;     // states a thread
  constexpr int G = N / kS;             // threads a lane
  constexpr int L = kThreads / G;       // lanes a block
  constexpr int kWarpLanes = 32 / G;    // lanes a warp
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) float sdl[2][kChunk][L], sx[2][kChunk][L], sB[2][kChunk][N];
  __shared__ __align__(16) T rx[kChunk][L], rB[kChunk][N];  // bf16 as copied

  const int tid = threadIdx.x;
  const int lane = tid / 32 * kWarpLanes + tid % kWarpLanes, sub = tid % 32 / kWarpLanes;
  const int d0 = blockIdx.x * L, d = d0 + lane;
  const int bi = blockIdx.y;
  const bool live = d < di;
  const int vlanes = max(0, min(L, di - d0));
  const int nc = (S + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(bi) * S;
  float* out = ckpt + (static_cast<size_t>(bi) * (nc - 1) * di + (live ? d : 0)) * N + sub * kS;

  float a2[kS], h[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    a2[s] = live ? A[static_cast<size_t>(d) * N + sub * kS + s] * kLog2e : 0.0f;
    h[s] = 0.0f;
  }
  auto stage = [&](int c, int buf) {
    const size_t at = (row0 + c * kChunk) * di + d0, bc = (row0 + c * kChunk) * N;
    if constexpr (kVec) {
      copy_async<kChunk, L>(&sdl[buf][0][0], delta, delta + at, di, kChunk, vlanes, tid);
      copy_async<kChunk, L>(kBf16 ? &rx[0][0] : reinterpret_cast<T*>(&sx[buf][0][0]), x, x + at,
                            di, kChunk, vlanes, tid);
      copy_async<1, kChunk * N>(kBf16 ? &rB[0][0] : reinterpret_cast<T*>(&sB[buf][0][0]), Bm,
                                Bm + bc, 0, 1, kChunk * N, tid);
    } else {
      copy_sync<kChunk, L>(&sdl[buf][0][0], delta + at, di, kChunk, vlanes, tid);
      copy_sync<kChunk, L>(&sx[buf][0][0], x + at, di, kChunk, vlanes, tid);
      copy_sync<1, kChunk * N>(&sB[buf][0][0], Bm + bc, 0, 1, kChunk * N, tid);
    }
    cp_async_commit();
  };
  auto land = [&](int buf) {
    cp_async_wait_all();
    if constexpr (kVec && kBf16) {
      convert<kChunk * L>(&sx[buf][0][0], &rx[0][0], tid);
      convert<kChunk * N>(&sB[buf][0][0], &rB[0][0], tid);
    }
  };

  // chunks 0 .. nc-2 are whole: only the last can be ragged
  stage(0, 0);
  land(0);
  __syncthreads();
  for (int c = 0; c < nc - 1; ++c) {
    const int cur = c & 1;
    if (c + 1 < nc - 1) stage(c + 1, cur ^ 1);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float dl = sdl[cur][i][lane], u = dl * sx[cur][i][lane];
#pragma unroll
      for (int q = 0; q < kS; q += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&sB[cur][i][sub * kS + q]);
        h[q] = fmaf(ex2(dl * a2[q]), h[q], u * b4.x);
        h[q + 1] = fmaf(ex2(dl * a2[q + 1]), h[q + 1], u * b4.y);
        h[q + 2] = fmaf(ex2(dl * a2[q + 2]), h[q + 2], u * b4.z);
        h[q + 3] = fmaf(ex2(dl * a2[q + 3]), h[q + 3], u * b4.w);
      }
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < kS; q += 4) {
        *reinterpret_cast<float4*>(out + static_cast<size_t>(c) * di * N + q) =
            make_float4(h[q], h[q + 1], h[q + 2], h[q + 3]);
      }
    }
    if (c + 1 < nc - 1) land(cur ^ 1);
    __syncthreads();
  }
}

// The reverse walk over the chunks, last first (exp #2), and the sums over d.
template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kThreads, kMainBlocks)
selective_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm, const float* __restrict__ D,
                          const T* __restrict__ dy, const float* __restrict__ dh_final,
                          T* __restrict__ dx, float* __restrict__ ddelta, Workspace ws,
                          int S, int di) {
  using Sm = Smem<T, N>;
  constexpr int G = Sm::G, L = Sm::L, Q = Sm::Q, kOut = Sm::kOut;
  constexpr int R = 16 / N;           // lanes a 128-byte row of `share` (one a bank sweep)
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(kStates == 4, "a thread's states are read as one float4");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_bytes);

  // a warp holds 32 lanes and one `sub`: its reads of B_t and C_t are one
  // broadcast, its reads of a step's delta, x and dy 128 contiguous bytes
  const int tid = threadIdx.x, warp = tid / 32;
  const int lane = warp / G * 32 + tid % 32, sub = warp % G;
  const int d0 = blockIdx.x * L, d = d0 + lane;
  const int bi = blockIdx.y;
  const bool live = d < di;
  const int vlanes = max(0, min(L, di - d0));  // lanes of the block inside di
  const int nc = (S + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(bi) * S;  // first (b, t) row
  const size_t state0 = (static_cast<size_t>(bi) * di + (live ? d : 0)) * N + sub * kStates;
  // the stored states of chunk c (c >= 1) start at ckpt0 + (c - 1) di N
  const size_t ckpt0 = static_cast<size_t>(bi) * (nc - 1) * di * N;

  // A[d, n] log2(e) of this thread's states: exp(delta A) = ex2(delta a2)
  float a2[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    a2[s] = live ? A[static_cast<size_t>(d) * N + sub * kStates + s] * kLog2e : 0.0f;
  }

  // Chunk c's operands into stage `buf` (bf16 through `raw`), one commit
  // group: x, delta, dy, B, C and the stored state entering the chunk.
  auto stage = [&](int c, int buf) {
    typename Sm::Stage& f = sm.fs[buf];
    const int t0 = c * kChunk, vrows = min(kChunk, S - t0);
    const size_t at = (row0 + t0) * di + d0, bc = (row0 + t0) * N;
    if constexpr (kVec) {
      copy_async<kChunk, L>(&f.dl[0][0], delta, delta + at, di, vrows, vlanes, tid);
      copy_async<kChunk, L>(kBf16 ? &sm.raw.x[0][0] : reinterpret_cast<T*>(&f.x[0][0]), x,
                            x + at, di, vrows, vlanes, tid);
      copy_async<kChunk, L>(kBf16 ? &sm.raw.dy[0][0] : reinterpret_cast<T*>(&f.dy[0][0]), dy,
                            dy + at, di, vrows, vlanes, tid);
      copy_async<1, kChunk * N>(kBf16 ? &sm.raw.B[0][0] : reinterpret_cast<T*>(&f.B[0][0]), Bm,
                                Bm + bc, 0, 1, vrows * N, tid);
      copy_async<1, kChunk * N>(kBf16 ? &sm.raw.C[0][0] : reinterpret_cast<T*>(&f.C[0][0]), Cm,
                                Cm + bc, 0, 1, vrows * N, tid);
    } else {
      copy_sync<kChunk, L>(&f.dl[0][0], delta + at, di, vrows, vlanes, tid);
      copy_sync<kChunk, L>(&f.x[0][0], x + at, di, vrows, vlanes, tid);
      copy_sync<kChunk, L>(&f.dy[0][0], dy + at, di, vrows, vlanes, tid);
      copy_sync<1, kChunk * N>(&f.B[0][0], Bm + bc, 0, 1, vrows * N, tid);
      copy_sync<1, kChunk * N>(&f.C[0][0], Cm + bc, 0, 1, vrows * N, tid);
    }
    if (c > 0) {  // the workspace is always 16-byte aligned
      copy_async<1, L * N>(f.h0, ws.ckpt,
                           ws.ckpt + ckpt0 + (static_cast<size_t>(c - 1) * di + d0) * N, 0, 1,
                           vlanes * N, tid);
    }
    cp_async_commit();
  };
  // wait for this thread's copies, and convert its bf16 granules of stage `buf`
  auto land = [&](int buf) {
    cp_async_wait_all();
    if constexpr (kVec && kBf16) {
      typename Sm::Stage& f = sm.fs[buf];
      convert<kChunk * L>(&f.x[0][0], &sm.raw.x[0][0], tid);
      convert<kChunk * L>(&f.dy[0][0], &sm.raw.dy[0][0], tid);
      convert<kChunk * N>(&f.B[0][0], &sm.raw.B[0][0], tid);
      convert<kChunk * N>(&f.C[0][0], &sm.raw.C[0][0], tid);
    }
  };

  float G_[kStates], dA[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    G_[s] = live ? dh_final[state0 + s] : 0.0f;
    dA[s] = 0.0f;
  }
  float dD = 0.0f;
  const float Dl = d0 + tid % L < di ? D[d0 + tid % L] : 0.0f;  // D of the lane this thread writes
  float* part_bc = ws.part_bc + (static_cast<size_t>(blockIdx.x) * gridDim.y + bi) * S * 2 * N;
  // group q of a lane's shares sits at group q ^ swz(lane) of its row
  auto swz = [](int l) { return (l / R) % Q; };

  stage(nc - 1, 0);
  land(0);
  __syncthreads();
  for (int k = 0; k < nc; ++k) {
    const int c = nc - 1 - k, cur = k & 1, t0 = c * kChunk;
    if (c > 0) stage(c - 1, cur ^ 1);
    const typename Sm::Stage& f = sm.fs[cur];

    // rebuild (exp #2): the states entering each step, a_t and a_t h_{t-1}
    // kept.  Step i+1's operands and a_t are read and computed ahead of step
    // i's chain.
    float ea[kChunk][kStates], ah[kChunk][kStates];
    {
      float h[kStates] = {};
      if (c > 0) {
        const float4 v = *reinterpret_cast<const float4*>(&f.h0[lane * N + sub * kStates]);
        h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
      }
      float n_dl = f.dl[0][lane], n_x = f.x[0][lane];
      float4 n_b = *reinterpret_cast<const float4*>(&f.B[0][sub * kStates]);
#pragma unroll
      for (int s = 0; s < kStates; ++s) ea[0][s] = ex2(n_dl * a2[s]);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float u = n_dl * n_x;
        const float bs[4] = {n_b.x, n_b.y, n_b.z, n_b.w};
        if (i + 1 < kChunk) {
          n_dl = f.dl[i + 1][lane], n_x = f.x[i + 1][lane];
          n_b = *reinterpret_cast<const float4*>(&f.B[i + 1][sub * kStates]);
#pragma unroll
          for (int s = 0; s < kStates; ++s) ea[i + 1][s] = ex2(n_dl * a2[s]);
        }
#pragma unroll
        for (int s = 0; s < kStates; ++s) {
          ah[i][s] = ea[i][s] * h[s];
          h[s] = fmaf(u, bs[s], ah[i][s]);
        }
      }
    }
    // Steps i0 .. i0 + kRed - 1 of the chunk, their shares in `share` and
    // `lane_sums`: dB_t, dC_t summed over the block's lanes (each thread one
    // 16-byte group of a step, eight interleaved sums over the lanes, l % 8
    // being the swizzle's period, added in turn), and du_t and the ddelta
    // term over each lane's threads for dx_t, ddelta_t.
    auto reduce = [&](int i0) {
      for (int o = tid; o < kOut; o += kThreads) {
        const int i = o / Q, q = o % Q;
        float4 acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j] = *reinterpret_cast<const float4*>(&sm.share[i][j][(q ^ swz(j)) * 4]);
        }
#pragma unroll
        for (int l = 8; l < L; l += 8) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[j] = add4(acc[j], *reinterpret_cast<const float4*>(
                                      &sm.share[i][l + j][(q ^ swz(j)) * 4]));
          }
        }
        float4 sum = acc[0];
#pragma unroll
        for (int j = 1; j < 8; ++j) sum = add4(sum, acc[j]);
        const int t = t0 + i0 + i;
        if (t < S) *reinterpret_cast<float4*>(part_bc + static_cast<size_t>(t) * 2 * N + q * 4) = sum;
      }
#pragma unroll
      for (int o = tid; o < kRed * L; o += kThreads) {
        const int i = o / L, ln = o % L;  // ln = tid % L
        float du = 0.0f, dda = 0.0f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float2 v = sm.lane_sums[i][g][ln];
          du += v.x;
          dda += v.y;
        }
        if (t0 + i0 + i < S && d0 + ln < di) {
          const size_t at = (row0 + t0 + i0 + i) * di + d0 + ln;
          dx[at] = from_f32<T>(fmaf(du, f.dl[i0 + i][ln], f.dy[i0 + i][ln] * Dl));
          ddelta[at] = fmaf(du, f.x[i0 + i][ln], dda * kLn2);
        }
      }
    };

    // carry g back through the chunk, each step's operands read a step ahead;
    // the shares of each kRed steps summed once they are all in
    float n_dl = f.dl[kChunk - 1][lane], n_x = f.x[kChunk - 1][lane], n_g0 = f.dy[kChunk - 1][lane];
    float4 n_b = *reinterpret_cast<const float4*>(&f.B[kChunk - 1][sub * kStates]);
    float4 n_c = *reinterpret_cast<const float4*>(&f.C[kChunk - 1][sub * kStates]);
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
      const float dl = n_dl, xv = n_x, g0 = n_g0;
      const float bs[4] = {n_b.x, n_b.y, n_b.z, n_b.w}, cs[4] = {n_c.x, n_c.y, n_c.z, n_c.w};
      if (i > 0) {
        n_dl = f.dl[i - 1][lane], n_x = f.x[i - 1][lane], n_g0 = f.dy[i - 1][lane];
        n_b = *reinterpret_cast<const float4*>(&f.B[i - 1][sub * kStates]);
        n_c = *reinterpret_cast<const float4*>(&f.C[i - 1][sub * kStates]);
      }
      const float u = dl * xv;
      float vb[kStates], vc[kStates], du = 0.0f, dda = 0.0f;
#pragma unroll
      for (int s = 0; s < kStates; ++s) {
        const float g = fmaf(g0, cs[s], G_[s]);  // dL/dh_t
        vb[s] = g * u;                           // this lane's share of dB_t[n]
        vc[s] = g0 * fmaf(u, bs[s], ah[i][s]);   // and of dC_t[n]: dy_t h_t
        du = fmaf(g, bs[s], du);
        const float w = g * ah[i][s];
        dda = fmaf(w, a2[s], dda);  // times ln 2 below: sum_n w A[n]
        dA[s] = fmaf(w, dl, dA[s]);
        G_[s] = g * ea[i][s];
      }
      const int r = i % kRed;
      *reinterpret_cast<float4*>(&sm.share[r][lane][(sub ^ swz(lane)) * 4]) =
          make_float4(vb[0], vb[1], vb[2], vb[3]);
      *reinterpret_cast<float4*>(&sm.share[r][lane][((Q / 2 + sub) ^ swz(lane)) * 4]) =
          make_float4(vc[0], vc[1], vc[2], vc[3]);
      sm.lane_sums[r][sub][lane] = make_float2(du, dda);
      dD = fmaf(g0, xv, dD);
      if (r == 0) {
        if (i == 0 && c > 0) land(cur ^ 1);
        __syncthreads();
        reduce(i);
        __syncthreads();
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kStates; ++s) ws.part_a[state0 + s] = dA[s];
    if (sub == 0) ws.part_d[static_cast<size_t>(bi) * di + d] = dD;
  }
}

// dB, dC: the blocks' partial sums added over d in block order; dA, dD:
// the batch rows' added in row order.  One thread an output element.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
selective_scan_bwd_finish(Workspace ws, T* __restrict__ dB, T* __restrict__ dC,
                          float* __restrict__ dA, float* __restrict__ dD, int b, int S,
                          int di, int N) {
  const int nparts = blocks_for(di, N), V = 2 * N;
  const size_t nbc = static_cast<size_t>(b) * S * V, na = static_cast<size_t>(di) * N;
  const size_t total = nbc + na + di;
  for (size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < total;
       j += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (j < nbc) {
      float s = 0.0f;
      for (int k = 0; k < nparts; ++k) s += ws.part_bc[k * nbc + j];
      const size_t row = j / V;
      const int m = static_cast<int>(j % V);
      if (m < N) {
        dB[row * N + m] = from_f32<T>(s);
      } else {
        dC[row * N + m - N] = from_f32<T>(s);
      }
    } else if (j < nbc + na) {
      const size_t k = j - nbc;
      float s = 0.0f;
      for (int r = 0; r < b; ++r) s += ws.part_a[r * na + k];
      dA[k] = s;
    } else {
      const size_t k = j - nbc - na;
      float s = 0.0f;
      for (int r = 0; r < b; ++r) s += ws.part_d[static_cast<size_t>(r) * di + k];
      dD[k] = s;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int N>
cudaError_t launch_n(const T* x, const float* delta, const float* A, const T* Bm, const T* Cm,
                     const float* D, const T* dy, const float* dh_final, T* dx, float* ddelta,
                     const Workspace& ws, int b, int S, int di, cudaStream_t s) {
  constexpr size_t kSmem = sizeof(Smem<T, N>);
  // 16-byte copies where every staged row and B/C run starts on 16 bytes
  const bool vec = di % (16 / sizeof(T)) == 0 && di % 4 == 0 &&
                   static_cast<size_t>(S) * N * sizeof(T) % 16 == 0 && aligned16(x) &&
                   aligned16(delta) && aligned16(dy) && aligned16(Bm) && aligned16(Cm);
  if (S > kChunk) {
    constexpr int kSweepLanes = kThreads / (N < 8 ? 1 : N / 8);
    const dim3 grid((di + kSweepLanes - 1) / kSweepLanes, b);
    auto sweep = vec ? selective_scan_bwd_sweep<T, N, true> : selective_scan_bwd_sweep<T, N, false>;
    sweep<<<grid, kThreads, 0, s>>>(x, delta, A, Bm, ws.ckpt, S, di);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = vec ? selective_scan_bwd_kernel<T, N, true> : selective_scan_bwd_kernel<T, N, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks_for(di, N), b), kThreads, kSmem, s>>>(x, delta, A, Bm, Cm, D, dy,
                                                              dh_final, dx, ddelta, ws, S, di);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, const float* delta, const float* A, const T* Bm, const T* Cm,
           const float* D, const T* dy, const float* dh_final, T* dx, float* ddelta,
           float* dA, T* dB, T* dC, float* dD, void* workspace, int b, int S, int di, int N,
           void* stream) {
  if (b == 0 || S == 0 || di == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace ws = carve(workspace, b, S, di, N);
  cudaError_t err;
  switch (N) {
    case 4:
      err = launch_n<T, 4>(x, delta, A, Bm, Cm, D, dy, dh_final, dx, ddelta, ws, b, S, di, s);
      break;
    case 8:
      err = launch_n<T, 8>(x, delta, A, Bm, Cm, D, dy, dh_final, dx, ddelta, ws, b, S, di, s);
      break;
    case 16:
      err = launch_n<T, 16>(x, delta, A, Bm, Cm, D, dy, dh_final, dx, ddelta, ws, b, S, di, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(b) * S * 2 * N + static_cast<size_t>(di) * N + di;
  const size_t blocks = (total + kFinishThreads - 1) / kFinishThreads;
  const int grid_finish = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  selective_scan_bwd_finish<T><<<grid_finish, kFinishThreads, 0, s>>>(ws, dB, dC, dA, dD, b, S,
                                                                       di, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t selective_scan_bwd_workspace_bytes(int b, int S, int di, int N) {
  size_t n[4];
  workspace_floats(b, S, di, N, n);
  return (n[0] + n[1] + n[2] + n[3]) * sizeof(float);
}

extern "C" int selective_scan_bwd_f32(const float* x, const float* delta, const float* A,
                                      const float* Bm, const float* Cm, const float* D,
                                      const float* dy, const float* dh_final, float* dx,
                                      float* ddelta, float* dA, float* dB, float* dC, float* dD,
                                      void* workspace, int b, int S, int di, int N,
                                      void* stream) {
  return launch<float>(x, delta, A, Bm, Cm, D, dy, dh_final, dx, ddelta, dA, dB, dC, dD,
                       workspace, b, S, di, N, stream);
}

extern "C" int selective_scan_bwd_bf16(const __nv_bfloat16* x, const float* delta,
                                       const float* A, const __nv_bfloat16* Bm,
                                       const __nv_bfloat16* Cm, const float* D,
                                       const __nv_bfloat16* dy, const float* dh_final,
                                       __nv_bfloat16* dx, float* ddelta, float* dA,
                                       __nv_bfloat16* dB, __nv_bfloat16* dC, float* dD,
                                       void* workspace, int b, int S, int di, int N,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, delta, A, Bm, Cm, D, dy, dh_final, dx, ddelta, dA, dB, dC, dD,
                               workspace, b, S, di, N, stream);
}
