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
//   * bf16 runs both products on the tensor cores (WMMA 16x16x16, float32
//     accumulators): 64 query rows a block, one warp per 16 rows, 64-key
//     tiles of K and V in shared memory.  S = Q K^T is scaled by 1/sqrt(HD)
//     in float32 (the same value as scaling q first, kernel.py:66, with one
//     rounding fewer), the softmax runs in float32, and P is rounded to bf16
//     for P V.  A WMMA fragment's rows cannot be rescaled in registers, so
//     the output accumulator lives in shared memory, one slab per warp.
//   * float32 runs on the SIMT cores, which keeps the reference's float32
//     products exactly (the tensor cores' TF32 would not): q scaled in
//     float32 first, a 64-row query tile and 32-key tiles in shared memory
//     (padded rows, no bank conflicts), each thread a 4 x 4 block of scores
//     and a 4 x HD/8 block of the output in registers.
// Neither pipelines its copies (cp.async or TMA) or uses wgmma: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 32;       // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kRows = kBQ / 16;   // query rows per thread
constexpr int kCols = kBKV / 8;   // score columns per thread
constexpr float kNegInf = -1e30f;

namespace wmma = nvcuda::wmma;

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

// --------------------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;
constexpr int kTcBQ = 64;        // query rows per block
constexpr int kTcBKV = 64;       // keys per tile
constexpr int kTcThreads = 128;  // 4 warps, 16 query rows each

// Shared-memory plan of the tensor-core kernel: byte offsets of its slabs,
// each a multiple of 32 bytes as WMMA's loads and stores need.
template <int HD>
struct TcPlan {
  static constexpr int ldq = HD + 8;       // bf16 rows of Q, K, V
  static constexpr int lds = kTcBKV + 4;   // float rows of S
  static constexpr int ldp = kTcBKV + 8;   // bf16 rows of P
  static constexpr int ldo = HD + 4;       // float rows of the output accumulator
  static constexpr int k = kTcBQ * ldq * 2;
  static constexpr int v = k + kTcBKV * ldq * 2;
  static constexpr int s = v + kTcBKV * ldq * 2;
  static constexpr int p = s + kTcBQ * lds * 4;
  static constexpr int o = p + kTcBQ * ldp * 2;
  static constexpr int bytes = o + kTcBQ * ldo * 4;
};

// rows [r0, r0 + rows) of a (S, HD) bf16 matrix into shared memory (row
// stride ld), 8 values a load; rows at or past S are zero
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, int r0,
                                           int rows, int S) {
  for (int i = threadIdx.x; i < rows * HD / 8; i += kTcThreads) {
    const int r = i / (HD / 8), c = 8 * (i % (HD / 8));
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, int Hq,
                            int Hkv, int S, int causal, int window, float scale) {
  static_assert(HD % 16 == 0, "HD must be a multiple of 16");
  using P = TcPlan<HD>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sK = reinterpret_cast<bf16*>(tc_smem + P::k);
  bf16* sV = reinterpret_cast<bf16*>(tc_smem + P::v);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kTcBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bf16* qh = q + (static_cast<size_t>(b) * Hq + h) * S * HD;
  const bf16* kh = k + (static_cast<size_t>(b) * Hkv + hk) * S * HD;
  const bf16* vh = v + (static_cast<size_t>(b) * Hkv + hk) * S * HD;
  bf16* oh = out + (static_cast<size_t>(b) * Hq + h) * S * HD;

  // this warp's 16 rows of S, P and the output accumulator
  float* sS = reinterpret_cast<float*>(tc_smem + P::s) + 16 * warp * P::lds;
  bf16* sP = reinterpret_cast<bf16*>(tc_smem + P::p) + 16 * warp * P::ldp;
  float* sO = reinterpret_cast<float*>(tc_smem + P::o) + 16 * warp * P::ldo;

  stage_rows<HD>(sQ, P::ldq, qh, q0, kTcBQ, S);
  for (int i = lane; i < 16 * HD; i += 32) sO[(i / HD) * P::ldo + i % HD] = 0.0f;
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    wmma::load_matrix_sync(qf[ks], sQ + 16 * warp * P::ldq + 16 * ks, P::ldq);

  // the softmax: lane owns row lr of the warp's 16 and columns 32 lh .. 32 lh + 31
  const int lr = lane / 2, lh = lane % 2;
  const int qp = q0 + 16 * warp + lr;
  float m = kNegInf, l = 0.0f;

  const int q_last = min(q0 + kTcBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window ? max(0, q0 - window + 1) : 0;

  for (int k0 = (kv_begin / kTcBKV) * kTcBKV; k0 < kv_end; k0 += kTcBKV) {
    __syncthreads();  // every warp is done with the previous K and V tiles
    stage_rows<HD>(sK, P::ldq, kh, k0, kTcBKV, S);
    stage_rows<HD>(sV, P::ldq, vh, k0, kTcBKV, S);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kTcBKV / 16; ++j) {  // S = Q K^T, 16 keys at a time
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + 16 * j * P::ldq + 16 * ks, P::ldq);
        wmma::mma_sync(sf, qf[ks], kf, sf);
      }
      wmma::store_matrix_sync(sS + 16 * j, sf, P::lds, wmma::mem_row_major);
    }
    __syncwarp();

    float sc[32];
    unsigned live = 0;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kp = k0 + 32 * lh + c;
      sc[c] = sS[lr * P::lds + 32 * lh + c] * scale;
      if (kp < S && (!causal || kp <= qp) && (!window || kp > qp - window)) {
        live |= 1u << c;
        mx = fmaxf(mx, sc[c]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float rs = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bf16 p = __float2bfloat16((live >> c) & 1u ? expf(sc[c] - m_new) : 0.0f);
      sP[lr * P::ldp + 32 * lh + c] = p;
      rs += __bfloat162float(p);  // the weights P V uses
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_new;
    for (int c = 0; c < HD / 2; ++c) sO[lr * P::ldo + (HD / 2) * lh + c] *= alpha;
    __syncwarp();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf[kTcBKV / 16];
#pragma unroll
    for (int kk = 0; kk < kTcBKV / 16; ++kk) wmma::load_matrix_sync(pf[kk], sP + 16 * kk, P::ldp);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {  // O += P V, 16 output columns at a time
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, sO + 16 * n, P::ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTcBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sV + 16 * kk * P::ldq + 16 * n, P::ldq);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(sO + 16 * n, of, P::ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qp < S) {
    const float norm = fmaxf(l, 1e-30f);
    for (int c = 0; c < HD / 2; ++c) {
      const int col = (HD / 2) * lh + c;
      oh[static_cast<size_t>(qp) * HD + col] = __float2bfloat16(sO[lr * P::ldo + col] / norm);
    }
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
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Hq,
                int Hkv, int S, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = TcPlan<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTcBQ - 1) / kTcBQ, Hq, B);
  flash_attention_bf16_kernel<HD><<<grid, kTcThreads, bytes, stream>>>(
      q, k, v, out, Hq, Hkv, S, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, T* out, int B, int Hq, int Hkv, int S,
              int causal, int window, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  if constexpr (sizeof(T) == sizeof(float)) {
    return launch_f32<HD>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale, stream);
  } else {
    // 8 values a load: every row of q, k and v must start on 16 bytes
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
    if (any % 16) return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_bf16<HD>(q, k, v, out, B, Hq, Hkv, S, causal, window, scale, stream);
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
