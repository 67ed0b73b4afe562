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
// here each thread owns one (b, d) lane, keeps its N states in registers and
// walks t = 0..S-1 itself.  There is no padding: lanes d >= di are masked and
// any S runs (the JAX wrapper pads S with delta = 0, ops.py:45-55, and the
// Pallas kernel asserts di % block_d == 0, kernel.py:89).
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
// 3.35 TB/s; B, C, A, D and h_final add little.  What the design does about
// it: A is scaled by log2(e) once per lane, so each exponential is one
// exp2f; x and delta are read once, coalesced across d; a block stages a
// chunk of time steps of B_t and C_t for its batch row in shared memory,
// which every lane of the row then reads; y is written once.
//
// One lane per thread is latency-bound at small b * di: at the serving
// engine's admission shape (b = 1, di = 8192: 64 blocks of 128 threads) most
// of the 132 SMs sit idle and each thread's S dependent steps set the time.
// A chunked (time-parallel) or split-N design is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // lanes (values of d) per block
constexpr int kChunk = 16;     // time steps staged per round
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

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ D,
                      T* __restrict__ y, float* __restrict__ h_final,
                      int S, int di) {
  __shared__ float sB[kChunk][N];
  __shared__ float sC[kChunk][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;

  float a2[N];  // A[d, :] * log2(e): exp(delta * A) = exp2(delta * a2)
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? A[static_cast<size_t>(d) * N + n] * kLog2e : 0.0f;
    h[n] = 0.0f;
  }
  const float Dd = live ? D[d] : 0.0f;
  const size_t row0 = static_cast<size_t>(b) * S;  // first (b, t) row

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    __syncthreads();  // every lane is done with the previous chunk
    for (int i = threadIdx.x; i < len * N; i += kThreads) {
      const size_t src = (row0 + t0) * N + i;
      sB[i / N][i % N] = to_f32(Bm[src]);
      sC[i / N][i % N] = to_f32(Cm[src]);
    }
    __syncthreads();
    if (!live) continue;

    // issue the chunk's loads together, then walk its steps
    float xs[kChunk], ds[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < len) {
        const size_t at = (row0 + t0 + i) * di + d;
        xs[i] = to_f32(x[at]);
        ds[i] = delta[at];
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < len) {
        const float dx = ds[i] * xs[i];
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = fmaf(exp2f(ds[i] * a2[n]), h[n], dx * sB[i][n]);
          acc = fmaf(h[n], sC[i][n], acc);
        }
        y[(row0 + t0 + i) * di + d] = from_f32<T>(fmaf(Dd, xs[i], acc));
      }
    }
  }
  if (live) {
    float* out = h_final + (static_cast<size_t>(b) * di + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = h[n];
  }
}

template <typename T>
int launch(const T* x, const float* delta, const float* A, const T* Bm,
           const T* Cm, const float* D, T* y, float* h_final, int b, int S,
           int di, int N, void* stream) {
  if (b == 0 || S == 0 || di == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((di + kThreads - 1) / kThreads, b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4:
      selective_scan_kernel<T, 4><<<grid, kThreads, 0, s>>>(x, delta, A, Bm, Cm, D, y, h_final, S, di);
      break;
    case 8:
      selective_scan_kernel<T, 8><<<grid, kThreads, 0, s>>>(x, delta, A, Bm, Cm, D, y, h_final, S, di);
      break;
    case 16:
      selective_scan_kernel<T, 16><<<grid, kThreads, 0, s>>>(x, delta, A, Bm, Cm, D, y, h_final, S, di);
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
