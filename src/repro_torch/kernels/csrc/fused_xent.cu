// Fused softmax cross-entropy for Hopper: per-token lse(x W) - (x W)[label]
// without materialising the (T, V) logits.
//
// Replaces src/repro/kernels/fused_xent/kernel.py::fused_xent_kernel (the
// Pallas TPU kernel behind repro.kernels.fused_xent.ops.fused_softmax_xent,
// the TPU form of the training loss repro.models.layers.chunked_softmax_xent).
// It computes what that kernel computes, not its grid: the TPU walks (token
// block, vocab block) with the vocab blocks in order on one core and the
// online-logsumexp state in VMEM scratch.  Here one block owns one tile of
// tokens and loops over the vocab tiles itself, keeping each row's running
// max, sum and gold logit in registers (kernel.py:36-64).  The kernel masks
// the token tail and the vocab tail, so it needs no padding and never shrinks
// the vocab tile to a divisor of V (the JAX wrapper does, ops.py:34-37:
// V = 92,544 = 2^7 * 3 * 241 would fall to 482-wide tiles).
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
//   * bf16 runs on the tensor cores (WMMA 16x16x16, float32 accumulators):
//     64 x 128 logit tiles, four warps of 32 x 64, the x and w slabs staged
//     32 deep in shared memory; the tile's logits go through shared memory
//     to the fold, two threads a row.
//   * float32 runs on the SIMT cores, which keeps the products exact in
//     float32 (the tensor cores' TF32 would not): 64 x 64 tiles, each thread
//     a 4 x 4 block of logits fed by two float4 shared-memory loads a step;
//     67 TFLOP/s peak.
// Neither pipelines its copies (cp.async or TMA) or uses wgmma: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

namespace wmma = nvcuda::wmma;

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

// --------------------------------------------------------- bf16, tensor cores

constexpr int kTcBT = 64;          // tokens per block
constexpr int kTcBV = 128;         // vocab columns per tile
constexpr int kTcKC = 32;          // depth of a staged slab
constexpr int kTcThreads = 128;    // 4 warps, each 32 tokens x 64 columns
constexpr int kLdX = kTcKC + 8;    // bf16 row strides: multiples of 8, rows
constexpr int kLdW = kTcBV + 8;    //   offset across banks
constexpr int kLdZ = kTcBV + 4;    // float row stride of the logit tile

__global__ void __launch_bounds__(kTcThreads)
fused_xent_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const int* __restrict__ labels, float* __restrict__ loss, int Tn,
                       int d, int V, int vec) {
  __shared__ __align__(32) __nv_bfloat16 sX[kTcBT * kLdX];  // x slab [token][k]
  __shared__ __align__(32) __nv_bfloat16 sW[kTcKC * kLdW];  // w slab [k][column]
  __shared__ __align__(32) float sZ[kTcBT * kLdZ];          // logit tile [token][column]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wy = warp / 2, wx = warp % 2;  // the warp's rows 32 wy.., columns 64 wx..
  const int t0 = blockIdx.x * kTcBT;
  const int row = tid / 2, half = tid % 2;  // the fold: one row, 64 columns a thread
  const int lab = t0 + row < Tn ? labels[t0 + row] : -1;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  LseState st;

  for (int v0 = 0; v0 < V; v0 += kTcBV) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < d; k0 += kTcKC) {
      __syncthreads();  // every warp is done with the previous slab
      if (vec) {  // d and V multiples of 8, 16-byte aligned rows: 8 values a load
        for (int i = tid; i < kTcBT * kTcKC / 8; i += kTcThreads) {
          const int r = i / (kTcKC / 8), c = 8 * (i % (kTcKC / 8));
          uint4 v = make_uint4(0, 0, 0, 0);
          if (t0 + r < Tn && k0 + c < d)
            v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(t0 + r) * d + k0 + c);
          *reinterpret_cast<uint4*>(sX + r * kLdX + c) = v;
        }
        for (int i = tid; i < kTcKC * kTcBV / 8; i += kTcThreads) {
          const int r = i / (kTcBV / 8), c = 8 * (i % (kTcBV / 8));
          uint4 v = make_uint4(0, 0, 0, 0);
          if (k0 + r < d && v0 + c < V)
            v = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k0 + r) * V + v0 + c);
          *reinterpret_cast<uint4*>(sW + r * kLdW + c) = v;
        }
      } else {
        for (int i = tid; i < kTcBT * kTcKC; i += kTcThreads) {
          const int r = i / kTcKC, c = i % kTcKC;
          sX[r * kLdX + c] =
              t0 + r < Tn && k0 + c < d ? x[static_cast<size_t>(t0 + r) * d + k0 + c] : zero;
        }
        for (int i = tid; i < kTcKC * kTcBV; i += kTcThreads) {
          const int r = i / kTcBV, c = i % kTcBV;
          sW[r * kLdW + c] =
              k0 + r < d && v0 + c < V ? w[static_cast<size_t>(k0 + r) * V + v0 + c] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTcKC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], sX + (32 * wy + 16 * i) * kLdX + kk, kLdX);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(b[j], sW + kk * kLdW + 64 * wx + 16 * j, kLdW);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(sZ + (32 * wy + 16 * i) * kLdZ + 64 * wx + 16 * j, acc[i][j],
                                kLdZ, wmma::mem_row_major);
    __syncthreads();

    // fold this thread's 64 logits, each rounded to bf16 as the loss rounds it
    const float* z = sZ + row * kLdZ + 64 * half;
    const int c0 = v0 + 64 * half;
    const int n = min(64, V - c0);
    if (n > 0) {
      float mx = kNegInf;
      for (int c = 0; c < n; ++c) {
        const float zc = __bfloat162float(__float2bfloat16(z[c]));
        mx = fmaxf(mx, zc);
        if (c0 + c == lab) st.gold += zc;
      }
      const float m_new = fmaxf(st.m, mx);
      float sum = 0.0f;
      for (int c = 0; c < n; ++c) sum += expf(__bfloat162float(__float2bfloat16(z[c])) - m_new);
      st.l = st.l * expf(st.m - m_new) + sum;
      st.m = m_new;
    }
  }
  finish_row(st, 2, half == 0 && t0 + row < Tn, loss + t0 + row);
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

extern "C" int fused_xent_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                               const int* labels, float* loss, int Tn, int d, int V,
                               void* stream) {
  if (Tn == 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 8 == 0 && V % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  fused_xent_bf16_kernel<<<(Tn + kTcBT - 1) / kTcBT, kTcThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, w, labels, loss, Tn, d, V,
                                                                vec);
  return static_cast<int>(cudaGetLastError());
}
