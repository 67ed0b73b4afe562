// Mamba1 selective scan for Hopper:
//   h_t = exp(delta_t * A) * h_{t-1} + (delta_t * x_t) outer B_t,
//   y_t = h_t . C_t + D * x_t,                      h_{-1} = 0.
//
// Replaces src/repro/kernels/selective_scan/kernel.py::selective_scan_kernel
// (the Pallas TPU kernel behind repro.kernels.selective_scan.ops.
// selective_scan, reached from repro.models.ssm.mamba1_forward).  It computes
// what that kernel computes, not its grid: the TPU walks (batch, d_inner
// block, seq chunk) with the seq chunks in order on one core and the
// (block_d, N) state in VMEM scratch.  Hopper's blocks run in no order, so
// here every (b, d) lane walks t = 0..S-1 inside one block, with its N states
// in registers.  There is no padding: lanes d >= di are masked and any S runs
// (the JAX wrapper pads S with delta = 0, ops.py:45-55, and the Pallas kernel
// asserts di % block_d == 0, kernel.py:89).
//
// Layout (all row-major, contiguous): x, y (b, S, di) in T (float or bf16);
// delta (b, S, di) float32; A (di, N) float32; B, C (b, S, N) in T; D (di,)
// float32; h_final (b, di, N) float32.  Arithmetic is float32 throughout; y
// is rounded to T once, at the store (round to nearest even, as PyTorch's
// cast does).
//
// Bound on this card: the exponentials.  Every (b, t, d, n) needs one
// exp(delta * A), b * S * di * N of them: 1.07e9 at the prefill shape
// (b = 4, S = 2048, di = 8192, N = 16).  The SFUs issue 16 per clock per SM,
// 132 SMs at ~1.98 GHz, ~4.2e12 per second: ~256 us.  The bytes come second:
// x and y in bf16 and delta in float32 are ~545 MB at that shape, ~163 us at
// 3.35 TB/s; B, C, A, D and h_final add little.  Two more limits sit close
// to the SFU's.  A warp's ex2 holds its scheduler's SFU for 8 cycles, and
// each exponential brings ~6 other instructions (delta * A, delta x * B_n,
// the h and y FMAs, its share of the reads), so the issue slots are nearly
// as scarce: an exponential moved to the FMA pipe as a polynomial (~8
// slots) would cost more issue than it frees SFU.  And shared memory serves
// one 128-byte wavefront a clock per SM, 16 exponentials' worth: a 16-byte
// read costs a warp 4 wavefronts unless a quarter warp reads one address,
// so B_t and C_t must be read as broadcasts and shared by several states.
//
// The design (one block = 128 threads on 128 / G lanes of d of one batch row):
// - Each lane's N states are split across G = N / 8 threads (G = 1 for
//   N <= 8), 8 states each in registers: twice the warps of one thread a
//   lane at N = 16, with no extra exponentials.  A warp holds 32 / G lanes
//   and the G threads of each, sub-major: the threads of a quarter warp
//   share their states, so each 16-byte read of B_t or C_t is a broadcast.
//   A lane's group is in one warp, wholly live or wholly masked.
// - Time goes in chunks of kChunk steps through a two-stage shared-memory
//   ring: (delta, x) as float2 a lane and step, B_t and C_t as float rows,
//   converted from T once, at staging.  The next chunk's global loads
//   (coalesced across d, 4 lanes a load where di % 4 == 0 and the rows are
//   16-byte aligned; B/C one contiguous run of kChunk * N elements) go into
//   registers and are stored to the other stage after the current chunk's
//   steps: no step waits on DRAM, and there is one barrier a chunk.  (The
//   compiler issues those loads after the steps, to spare registers; the
//   y sums below and the other blocks of the SM cover their latency.)  The
//   4-lane loads, against 1-lane ones everywhere, take ~4% off the prefill
//   shape and ~15% off the admission shape (one H100 80GB HBM3 at 700 W,
//   chip_smoke).  A ragged last chunk is staged with delta = x = B = 0,
//   which leaves the state unchanged (exp(0) = 1), so the step loop has no
//   branch.
// - A step per thread: one float2 read and four 16-byte reads of B_t and
//   C_t, issued a step ahead; delta * x once; 8 x (ex2.approx.ftz of
//   delta * A * log2(e), the h FMA, the y FMA); the partial y_t over its
//   states to shared memory.  At the end of the chunk (after a warp barrier:
//   a group is in one warp) each thread sums kChunk / G of its lane's steps
//   over the group, adds D * x_t and stores y_t rounded.  ftz is harmless: a
//   state that decays below the normal range is below what y can show.
// - h_final is written with consecutive threads on consecutive 32 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kChunk = 16;     // time steps a stage
constexpr float kLog2e = 1.4426950408889634f;

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

// kW consecutive elements of T as one load moves them (16 bytes of float,
// 8 of bf16 when kW = 4), and their values as float
template <typename T, int kW>
struct Raw {
  using type = T;
};
template <>
struct Raw<float, 4> {
  using type = float4;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};

__device__ __forceinline__ void to_floats(float v, float (&out)[1]) { out[0] = v; }
__device__ __forceinline__ void to_floats(__nv_bfloat16 v, float (&out)[1]) {
  out[0] = __bfloat162float(v);
}
__device__ __forceinline__ void to_floats(float4 v, float (&out)[4]) {
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
__device__ __forceinline__ void to_floats(uint2 v, float (&out)[4]) {  // 4 bf16
  out[0] = __uint_as_float(v.x << 16), out[1] = __uint_as_float(v.x & 0xffff0000u);
  out[2] = __uint_as_float(v.y << 16), out[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ D,
                      T* __restrict__ y, float* __restrict__ h_final,
                      int S, int di) {
  constexpr int kStates = N < 8 ? N : 8;  // states a thread
  constexpr int G = N / kStates;          // threads a lane
  constexpr int L = kThreads / G;         // lanes a block
  constexpr int kWarpLanes = 32 / G;      // lanes a warp
  constexpr int kBC = (kChunk * N + kThreads - 1) / kThreads;  // B and C a thread a chunk
  constexpr int kOut = kChunk / G;        // y a thread a chunk
  __shared__ float2 sXD[2][kChunk][L];
  __shared__ __align__(16) float sB[2][kChunk][N];
  __shared__ __align__(16) float sC[2][kChunk][N];
  __shared__ __align__(16) float sY[kChunk][kThreads];  // partial y_t: [step][lane * G + sub]

  // A warp holds kWarpLanes lanes and G subs, sub-major: the threads of a
  // quarter warp share `sub`, so their reads of B_t and C_t are broadcasts.
  const int tid = threadIdx.x;
  const int lane = tid / 32 * kWarpLanes + tid % kWarpLanes, sub = tid % 32 / kWarpLanes;
  const int d0 = blockIdx.x * L;
  const int d = d0 + lane;
  const bool live = d < di;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S;  // first (b, t) row

  float a2[kStates], h[kStates];  // A[d, n] * log2(e): exp(delta A) = ex2(delta a2)
#pragma unroll
  for (int n = 0; n < kStates; ++n) {
    a2[n] = live ? A[static_cast<size_t>(d) * N + sub * kStates + n] * kLog2e : 0.0f;
    h[n] = 0.0f;
  }
  const float Dd = live ? D[d] : 0.0f;

  // What this thread stages of a chunk: kW consecutive lanes from column c0
  // of (delta, x) rows r0 + j * kPass, and elements tid + j * kThreads of the
  // B and C runs.  The pointers walk forward a chunk at a time.
  constexpr int kW = kVec ? 4 : 1;              // lanes a staged load
  constexpr int kPass = kThreads * kW / L;      // rows a pass of the block
  constexpr int kXD = kChunk / kPass;           // passes a chunk
  const int r0 = tid / (L / kW), c0 = tid % (L / kW) * kW;
  const bool col_ok = d0 + c0 < di;             // all kW lanes or none: di % kW == 0
  const int row_step = kPass * di;              // elements between a thread's staged rows
  const size_t chunk_step = static_cast<size_t>(kChunk) * di;
  const float* dp = delta + (row0 + r0) * di + d0 + c0;
  const T* xp = x + (row0 + r0) * di + d0 + c0;
  const T* bp = Bm + row0 * N + tid;
  const T* cp = Cm + row0 * N + tid;
  T* yp = y + (row0 + sub * kOut) * di + d;  // this thread's first y_t of the chunk

  // the prefetch registers: one chunk's operands as read from global
  // memory, converted to float only when staged, so that nothing waits for a
  // load's value before the chunk's steps are done
  using RawD = typename Raw<float, kW>::type;
  using RawX = typename Raw<T, kW>::type;
  RawD pd[kXD];
  RawX px[kXD];
  T pb[kBC], pc[kBC];
  auto load = [&](int t0) {
    const int rows = S - t0 - r0;  // staged row j is in the sequence if j * kPass < rows
#pragma unroll
    for (int j = 0; j < kXD; ++j) {
      const bool ok = col_ok && j * kPass < rows;
      pd[j] = ok ? *reinterpret_cast<const RawD*>(dp + j * row_step) : RawD{};
      px[j] = ok ? *reinterpret_cast<const RawX*>(xp + j * row_step) : RawX{};
    }
    const int elems = min(kChunk, S - t0) * N - tid;  // element j is staged if j * kThreads < elems
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const bool ok = j * kThreads < elems;
      pb[j] = ok ? bp[j * kThreads] : T{};
      pc[j] = ok ? cp[j * kThreads] : T{};
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kXD; ++j) {
      float fd[kW], fx[kW];
      to_floats(pd[j], fd);
      to_floats(px[j], fx);
      float2* row = &sXD[buf][r0 + j * kPass][c0];
      if constexpr (kVec) {
        reinterpret_cast<float4*>(row)[0] = make_float4(fd[0], fx[0], fd[1], fx[1]);
        reinterpret_cast<float4*>(row)[1] = make_float4(fd[2], fx[2], fd[3], fx[3]);
      } else {
        row[0] = make_float2(fd[0], fx[0]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      if (tid + j * kThreads < kChunk * N) {
        (&sB[buf][0][0])[tid + j * kThreads] = to_f32(pb[j]);
        (&sC[buf][0][0])[tid + j * kThreads] = to_f32(pc[j]);
      }
    }
  };
  // one step's operands from the stage: (delta, x) and this thread's B_t, C_t
  auto read = [&](int buf, int i, float2& dx, float (&bs)[kStates], float (&cs)[kStates]) {
    dx = sXD[buf][i][lane];
#pragma unroll
    for (int q = 0; q < kStates; q += 4) {  // 16-byte reads
      const float4 b4 = *reinterpret_cast<const float4*>(&sB[buf][i][sub * kStates + q]);
      const float4 c4 = *reinterpret_cast<const float4*>(&sC[buf][i][sub * kStates + q]);
      bs[q] = b4.x, bs[q + 1] = b4.y, bs[q + 2] = b4.z, bs[q + 3] = b4.w;
      cs[q] = c4.x, cs[q + 1] = c4.y, cs[q + 2] = c4.z, cs[q + 3] = c4.w;
    }
  };

  load(0);
  stage(0);
  __syncthreads();
  for (int t0 = 0, buf = 0; t0 < S; t0 += kChunk, buf ^= 1) {
    const bool more = t0 + kChunk < S;
    if (more) {  // the next chunk's loads, in flight while this one is computed
      dp += chunk_step;
      xp += chunk_step;
      bp += kChunk * N;
      cp += kChunk * N;
      load(t0 + kChunk);
    }

    // the steps, each step's shared-memory reads issued a step ahead
    float2 dx;
    float bs[kStates], cs[kStates];
    read(buf, 0, dx, bs, cs);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      float2 dx_next = dx;
      float bs_next[kStates], cs_next[kStates];
      if (i + 1 < kChunk) read(buf, i + 1, dx_next, bs_next, cs_next);
      const float u = dx.x * dx.y;
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < kStates; ++n) {
        h[n] = fmaf(ex2(dx.x * a2[n]), h[n], u * bs[n]);
        acc = fmaf(h[n], cs[n], acc);
      }
      sY[i][lane * G + sub] = acc;
      if (i + 1 < kChunk) {
        dx = dx_next;
#pragma unroll
        for (int n = 0; n < kStates; ++n) bs[n] = bs_next[n], cs[n] = cs_next[n];
      }
    }
    // the group's partials lie in its own warp's columns of sY; every read
    // first, then the stores of the steps in the sequence
    __syncwarp();
    float ys[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int i = sub * kOut + j;
      float sum = sY[i][lane * G];
#pragma unroll
      for (int g = 1; g < G; ++g) sum += sY[i][lane * G + g];
      ys[j] = fmaf(Dd, sXD[buf][i][lane].y, sum);
    }
    const int len = min(kChunk, S - t0) - sub * kOut;  // this thread's steps in the sequence
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      if (live && j < len) yp[j * di] = from_f32<T>(ys[j]);
    }
    yp += chunk_step;
    if (more) stage(buf ^ 1);  // the other stage was last read before the previous barrier
    __syncthreads();
  }
  if (live) {
    float* out = h_final + (static_cast<size_t>(blockIdx.y) * di + d) * N + sub * kStates;
#pragma unroll
    for (int q = 0; q < kStates; q += 4) {
      *reinterpret_cast<float4*>(out + q) = make_float4(h[q], h[q + 1], h[q + 2], h[q + 3]);
    }
  }
}

template <typename T, int N>
void launch_n(const T* x, const float* delta, const float* A, const T* Bm,
              const T* Cm, const float* D, T* y, float* h_final, int b, int S,
              int di, cudaStream_t s) {
  constexpr int L = N > 8 ? kThreads * 8 / N : kThreads;  // lanes a block
  const dim3 grid((di + L - 1) / L, b);
  // 4 lanes a staged load where every row of 4 starts 16-byte aligned
  const bool vec = di % 4 == 0 && reinterpret_cast<uintptr_t>(delta) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  if (vec) {
    selective_scan_kernel<T, N, true><<<grid, kThreads, 0, s>>>(x, delta, A, Bm, Cm, D, y,
                                                                h_final, S, di);
  } else {
    selective_scan_kernel<T, N, false><<<grid, kThreads, 0, s>>>(x, delta, A, Bm, Cm, D, y,
                                                                 h_final, S, di);
  }
}

template <typename T>
int launch(const T* x, const float* delta, const float* A, const T* Bm,
           const T* Cm, const float* D, T* y, float* h_final, int b, int S,
           int di, int N, void* stream) {
  if (b == 0 || S == 0 || di == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4:
      launch_n<T, 4>(x, delta, A, Bm, Cm, D, y, h_final, b, S, di, s);
      break;
    case 8:
      launch_n<T, 8>(x, delta, A, Bm, Cm, D, y, h_final, b, S, di, s);
      break;
    case 16:
      launch_n<T, 16>(x, delta, A, Bm, Cm, D, y, h_final, b, S, di, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int selective_scan_f32(const float* x, const float* delta, const float* A,
                                  const float* Bm, const float* Cm, const float* D,
                                  float* y, float* h_final, int b, int S, int di, int N,
                                  void* stream) {
  return launch<float>(x, delta, A, Bm, Cm, D, y, h_final, b, S, di, N, stream);
}

extern "C" int selective_scan_bf16(const __nv_bfloat16* x, const float* delta,
                                   const float* A, const __nv_bfloat16* Bm,
                                   const __nv_bfloat16* Cm, const float* D,
                                   __nv_bfloat16* y, float* h_final, int b, int S,
                                   int di, int N, void* stream) {
  return launch<__nv_bfloat16>(x, delta, A, Bm, Cm, D, y, h_final, b, S, di, N, stream);
}
