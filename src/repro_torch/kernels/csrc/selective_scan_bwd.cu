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
// Bound on this card: the exponentials.  A backward needs at least two
// exp(delta A) a (b, t, d, n): one to rebuild the states going forward, one
// to carry g backward.  At Falcon-Mamba's training shape (b = 4, S = 2048,
// di = 8192, N = 16) that is 2.15e9 of them, 514 us at the SFUs' ~4.18e12 a
// second (16 a clock per SM, 132 SMs, ~1.98 GHz).  The bytes come second:
// x, dy and dx in bf16 and delta and ddelta in float32 are ~940 MB, ~281 us
// at 3.35 TB/s.
//
// The design is the simple one, written to be right first:
// - A block is one warp on the forward kernel's lane layout: a (b, d) lane's
//   N states are split over G = N / 8 threads (G = 1 for N <= 8), 8 states
//   each in registers, sub-major, so a warp holds 32 / G lanes and the
//   threads of a half warp share their states.  Sums over d inside the warp
//   go by shuffles (no shared-memory atomics), across blocks through a
//   float32 scratch that a second kernel adds up in a fixed order, so the
//   gradients are the same from run to run.  Sums over b and t (dA, dD) stay
//   in registers and are added over b by the second kernel.
// - Forward sweep: the lane walks t = 0..S-1 and stores its state entering
//   every kChunk-th (8th) step into a float32 scratch (b, ceil(S / 8), di,
//   N): 537 MB at the training shape, and as much again for the blocks'
//   partial sums of dB and dC.
// - Reverse walk over the chunks, last first: a chunk's x, delta, dy, B and C
//   are loaded into registers while the chunk before is computed, then
//   staged in shared memory (a ragged last chunk with zeros, which leave the
//   state as it is and contribute nothing); the state entering each step is
//   rebuilt from the stored one into shared memory (kChunk x 8 x 32 floats,
//   8 KB), then g is carried back step by step.  Chunks of 8 keep a
//   one-warp block at ~11 KB of shared memory, so an SM holds 16 of them
//   (the register file's limit) to cover the steps' long dependency chains.
//   Each step's dB_t and dC_t shares (2 x 8 a thread) are summed over the
//   lanes of the warp by a transposing butterfly: 15 shuffles leave each
//   thread holding the sum of one (state, B or C) pair, where a plain
//   butterfly a value would take 4 or 5 each.  A thread's 16 shares fit in
//   registers; 32 (all 16 states in one thread) did not, and went to local
//   memory.
// - So three exponentials a (b, t, d, n) (the sweep's, the rebuild's and the
//   reverse step's), against the two of the bound; any S runs, and lanes
//   d >= di are masked.
//
// Layout (all row-major, contiguous): x, dy, dx (b, S, di) in T (float or
// bf16); delta, ddelta (b, S, di) float32; A, dA (di, N) float32; B, C, dB,
// dC (b, S, N) in T; D, dD (di,) float32; dh_final (b, di, N) float32.  The
// caller passes one workspace of `selective_scan_bwd_workspace_bytes`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 32;  // threads a block: one warp
constexpr int kChunk = 8;     // steps between stored states
constexpr int kFinishThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// lanes of d a block holds: 32, or 16 where a lane's states take 2 threads
__host__ __device__ constexpr int lanes_for(int N) { return N > 8 ? kThreads * 8 / N : kThreads; }

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

// a where `first`, else b, as a bitwise select: `first ? a : b` on two
// elements of one array lets the compiler index the array by `first`, which
// moves the array to local memory
__device__ __forceinline__ float pick(bool first, float a, float b) {
  const int m = -static_cast<int>(first);
  return __int_as_float((__float_as_int(a) & m) | (__float_as_int(b) & ~m));
}

// The sum of v[tid % V] over the W threads that differ in the low log2(W)
// bits of `tid`, in each of them (V and W powers of two, V <= W <= 32).
// Each halving round, a thread keeps one half of its values, sends the other
// to its partner and adds the partner's copy of the half it keeps: slot 0
// ends as value tid % V summed over V threads, and a plain butterfly adds
// the other W / V groups.
template <int V, int W>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[V], int tid) {
#pragma unroll
  for (int o = V / 2; o >= 1; o /= 2) {
    const bool upper = tid & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = pick(upper, v[i], v[i + o]);
      const float keep = pick(upper, v[i + o], v[i]);
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  float s = v[0];
#pragma unroll
  for (int o = V; o < W; o *= 2) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

struct Workspace {
  float* ckpt;     // (b, nc, di, N): the state entering steps 0, kChunk, 2 kChunk, ...
  float* part_bc;  // (nblk, b, S, 2N): each block's dB_t, dC_t over its lanes
  float* part_a;   // (b, di, N): dA summed over t, a batch row
  float* part_d;   // (b, di): dD summed over t, a batch row
};

__host__ __device__ inline size_t align_up(size_t n) { return (n + 63) / 64 * 64; }

// floats of each part of the workspace, each rounded up to 256 bytes
__host__ __device__ inline void workspace_floats(int b, int S, int di, int N, size_t (&n)[4]) {
  const size_t nc = (S + kChunk - 1) / kChunk, nblk = (di + lanes_for(N) - 1) / lanes_for(N);
  n[0] = align_up(static_cast<size_t>(b) * nc * di * N);
  n[1] = align_up(nblk * b * static_cast<size_t>(S) * 2 * N);
  n[2] = align_up(static_cast<size_t>(b) * di * N);
  n[3] = align_up(static_cast<size_t>(b) * di);
}

Workspace carve(void* base, int b, int S, int di, int N) {
  size_t n[4];
  workspace_floats(b, S, di, N, n);
  float* p = static_cast<float*>(base);
  return {p, p + n[0], p + n[0] + n[1], p + n[0] + n[1] + n[2]};
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm, const float* __restrict__ D,
                          const T* __restrict__ dy, const float* __restrict__ dh_final,
                          T* __restrict__ dx, float* __restrict__ ddelta, Workspace ws,
                          int S, int di) {
  constexpr int kStates = N < 8 ? N : 8;  // states a thread
  constexpr int L = lanes_for(N);         // lanes a block
  constexpr int V = 2 * kStates;          // a thread's shares of dB_t and dC_t a step
  constexpr int kBC = (kChunk * N + kThreads - 1) / kThreads;  // B and C elements a thread a chunk
  __shared__ __align__(16) float sH[kChunk][kStates][kThreads];  // the state entering each step
  __shared__ float sX[kChunk][L], sDl[kChunk][L], sDy[kChunk][L];
  __shared__ __align__(16) float sB[kChunk][N], sC[kChunk][N];

  // sub-major: the threads of a half warp (a warp, where G = 1) share `sub`
  const int tid = threadIdx.x, lane = tid % L, sub = tid / L;
  const int d = blockIdx.x * L + lane;
  const int bi = blockIdx.y;
  const bool live = d < di;
  const int nc = (S + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(bi) * S;  // first (b, t) row
  const size_t state0 = (static_cast<size_t>(bi) * di + (live ? d : 0)) * N + sub * kStates;

  // A[d, n] and A[d, n] log2(e) of this thread's states: exp(delta A) = ex2(delta a2)
  float An[kStates], a2[kStates], h[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    An[s] = live ? A[static_cast<size_t>(d) * N + sub * kStates + s] : 0.0f;
    a2[s] = An[s] * kLog2e;
    h[s] = 0.0f;
  }
  const float Dd = live ? D[d] : 0.0f;
  // this thread's stored states of chunk c are at ck + c * di * N
  float* ck = ws.ckpt + (static_cast<size_t>(bi) * nc * di + (live ? d : 0)) * N + sub * kStates;

  // A chunk's operands: `load` reads them from global memory into registers
  // (zero past S and in dead lanes, so nothing waits on a load before the
  // last one is issued), `put` stores them to shared memory.  The next
  // chunk's loads are issued before the current chunk's steps.
  float rx[kChunk], rdl[kChunk], rdy[kChunk], rb[kBC], rc[kBC], rh[kStates];
  auto load = [&](int c, bool grads) {
    const int t0 = c * kChunk;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool ok = live && t0 + i < S;
      const size_t at = (row0 + t0 + i) * di + d;
      rx[i] = ok ? to_f32(x[at]) : 0.0f;
      rdl[i] = ok ? delta[at] : 0.0f;
      if (grads) rdy[i] = ok ? to_f32(dy[at]) : 0.0f;
    }
    const int elems = min(kChunk, S - t0) * N;  // B and C of the chunk: one contiguous run
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int e = tid + j * kThreads;
      const bool ok = e < elems;
      const size_t at = (row0 + t0) * N + e;
      rb[j] = ok ? to_f32(Bm[at]) : 0.0f;
      if (grads) rc[j] = ok ? to_f32(Cm[at]) : 0.0f;
    }
    if (grads && live) {  // the states stored for the chunk
      const float* src = ck + static_cast<size_t>(c) * di * N;
#pragma unroll
      for (int q = 0; q < kStates; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + q);
        rh[q] = v.x, rh[q + 1] = v.y, rh[q + 2] = v.z, rh[q + 3] = v.w;
      }
    }
  };
  auto put = [&](bool grads) {
    if (sub == 0) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        sX[i][lane] = rx[i];
        sDl[i][lane] = rdl[i];
        if (grads) sDy[i][lane] = rdy[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int e = tid + j * kThreads;
      if (e < kChunk * N) {
        (&sB[0][0])[e] = rb[j];
        if (grads) (&sC[0][0])[e] = rc[j];
      }
    }
  };

  // ---- forward sweep: the state entering each chunk
  load(0, false);
  for (int c = 0; c < nc; ++c) {
    if (live) {
      float* dst = ck + static_cast<size_t>(c) * di * N;
#pragma unroll
      for (int q = 0; q < kStates; q += 4) {
        *reinterpret_cast<float4*>(dst + q) = make_float4(h[q], h[q + 1], h[q + 2], h[q + 3]);
      }
    }
    if (c == nc - 1) break;  // the last chunk's steps are rebuilt below
    __syncwarp();
    put(false);
    __syncwarp();
    if (c + 1 < nc - 1) load(c + 1, false);
#pragma unroll 2
    for (int i = 0; i < kChunk; ++i) {
      const float dl = sDl[i][lane], u = dl * sX[i][lane];
#pragma unroll
      for (int s = 0; s < kStates; ++s) {
        h[s] = fmaf(ex2(dl * a2[s]), h[s], u * sB[i][sub * kStates + s]);
      }
    }
  }

  // ---- reverse walk
  float G[kStates], dA[kStates];
  float dD = 0.0f;
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    G[s] = live ? dh_final[state0 + s] : 0.0f;
    dA[s] = 0.0f;
    rh[s] = 0.0f;
  }
  float* part_bc = ws.part_bc + (static_cast<size_t>(blockIdx.x) * gridDim.y + bi) * S * 2 * N;
  // the (B or C, state) pair whose sum over the block's lanes this thread ends with
  const int q = tid % V;
  const int pair = (q < kStates ? 0 : N - kStates) + sub * kStates + q;
  load(nc - 1, true);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    __syncwarp();
    put(true);
#pragma unroll
    for (int s = 0; s < kStates; ++s) h[s] = rh[s];
    __syncwarp();
    if (c > 0) load(c - 1, true);
    // rebuild: the state entering each step of the chunk (each thread its own column)
#pragma unroll 2
    for (int i = 0; i < kChunk; ++i) {
      const float dl = sDl[i][lane], u = dl * sX[i][lane];
#pragma unroll
      for (int s = 0; s < kStates; ++s) {
        sH[i][s][tid] = h[s];
        h[s] = fmaf(ex2(dl * a2[s]), h[s], u * sB[i][sub * kStates + s]);
      }
    }
    // carry g back through the chunk
    for (int i = kChunk - 1; i >= 0; --i) {
      const int t = t0 + i;
      const float xv = sX[i][lane], dl = sDl[i][lane], g0 = sDy[i][lane];
      const float u = dl * xv;
      float v[V];
      float du = 0.0f, dda = 0.0f;
#pragma unroll
      for (int s = 0; s < kStates; ++s) {
        const int n = sub * kStates + s;
        const float a = ex2(dl * a2[s]);
        const float ah = a * sH[i][s][tid];        // a_t h_{t-1}
        const float bn = sB[i][n];
        const float g = fmaf(g0, sC[i][n], G[s]);  // dL/dh_t
        v[s] = g * u;                              // this lane's share of dB_t[n]
        v[kStates + s] = g0 * fmaf(u, bn, ah);     // of dC_t[n]: dy_t h_t[n]
        du = fmaf(g, bn, du);
        const float gah = g * ah;
        dda = fmaf(gah, An[s], dda);
        dA[s] = fmaf(gah, dl, dA[s]);
        G[s] = g * a;
      }
      if (kStates < N) {  // the lane's other thread's states
        du += __shfl_xor_sync(kFull, du, L);
        dda += __shfl_xor_sync(kFull, dda, L);
      }
      dD = fmaf(g0, xv, dD);
      const float sum = warp_transpose_sum<V, L>(v, tid);
      if (t < S) {
        if (live && sub == 0) {
          const size_t at = (row0 + t) * di + d;
          dx[at] = from_f32<T>(fmaf(du, dl, g0 * Dd));
          ddelta[at] = fmaf(du, xv, dda);
        }
        if (lane < V) part_bc[static_cast<size_t>(t) * 2 * N + pair] = sum;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kStates; ++s) ws.part_a[state0 + s] = dA[s];
    if (sub == 0) ws.part_d[static_cast<size_t>(bi) * di + d] = dD;
  }
}

// dB, dC: the blocks' partial sums added over d in block order; dA, dD: the
// batch rows' added in row order.  One thread an output element.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
selective_scan_bwd_finish(Workspace ws, T* __restrict__ dB, T* __restrict__ dC,
                          float* __restrict__ dA, float* __restrict__ dD, int b, int S,
                          int di, int N) {
  const int nblk = (di + lanes_for(N) - 1) / lanes_for(N), V = 2 * N;
  const size_t nbc = static_cast<size_t>(b) * S * V, na = static_cast<size_t>(di) * N;
  const size_t total = nbc + na + di;
  for (size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < total;
       j += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (j < nbc) {
      float s = 0.0f;
      for (int k = 0; k < nblk; ++k) s += ws.part_bc[k * nbc + j];
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

template <typename T>
int launch(const T* x, const float* delta, const float* A, const T* Bm, const T* Cm,
           const float* D, const T* dy, const float* dh_final, T* dx, float* ddelta,
           float* dA, T* dB, T* dC, float* dD, void* workspace, int b, int S, int di, int N,
           void* stream) {
  if (b == 0 || S == 0 || di == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace ws = carve(workspace, b, S, di, N);
  const dim3 grid((di + lanes_for(N) - 1) / lanes_for(N), b);
  switch (N) {
    case 4:
      selective_scan_bwd_kernel<T, 4><<<grid, kThreads, 0, s>>>(x, delta, A, Bm, Cm, D, dy,
                                                              dh_final, dx, ddelta, ws, S, di);
      break;
    case 8:
      selective_scan_bwd_kernel<T, 8><<<grid, kThreads, 0, s>>>(x, delta, A, Bm, Cm, D, dy,
                                                              dh_final, dx, ddelta, ws, S, di);
      break;
    case 16:
      selective_scan_bwd_kernel<T, 16><<<grid, kThreads, 0, s>>>(x, delta, A, Bm, Cm, D, dy,
                                                               dh_final, dx, ddelta, ws, S, di);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
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
