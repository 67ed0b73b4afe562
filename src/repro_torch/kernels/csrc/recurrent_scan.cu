// Gated linear recurrence  h_t = a_t * (1 - r_t) * h_{t-1} + b_t  for Hopper.
//
// Replaces src/repro/kernels/recurrent_scan/kernel.py::linear_scan_kernel
// (the blocked associative-scan Pallas TPU kernel behind
// repro.kernels.recurrent_scan.ops.linear_recurrent_scan).  It computes what
// that kernel computes, not its blocking: the TPU walks time chunks in order
// on one core with the carry in VMEM, which has no counterpart across the
// H100's 132 SMs, so here the chunks of one window of time run side by side
// in one block and their carries are combined through shared memory.
//
// Layout: a, b, out are (T, D) float32, row-major, D = B * H (batch lanes
// times hidden units); reset is (T, B) bytes (torch.bool), or null for no
// resets; h0 is (D,) float32.  The reset of batch lane d / H is broadcast
// over its H features here, in the kernel, so the wrapper never
// materialises a (T, D) mask (the JAX wrapper does, ops.py:82).
//
// Two directions:
//   forward  (reverse = 0): h_t = a_eff_t * h_{t-1} + b_t, h_{-1} = h0;
//   adjoint  (reverse = 1): h_t = a_eff_{t+1} * h_{t+1} + b_t, h_{T-1} = b_{T-1};
// with a_eff_t = a_t * (1 - r_t).  The adjoint is the backward pass of the
// forward (ops.py:106-123 runs the same recurrence on time-flipped arrays
// with the decay shifted one step); walking time backwards here avoids
// flipped copies.  h0 must be null in adjoint mode.
//
// Bound: bytes.  Each call reads a and b and writes out once (3 * T * D * 4
// bytes), plus T * B reset bytes and D * 4 bytes of h0, against 2 flops per
// element: at T = 128, D = 16384 that is about 25 MB, or 7.5 us at
// 3.35 TB/s; at D = 4096 about 6.3 MB, 1.9 us, below the cost of a launch
// and one round trip to memory.  So what matters is that every SM has
// loads in flight at once, not a long dependent walk per thread.
//
// The design: a chunked time-parallel scan in one launch.  A block covers
// 32 consecutive d (a warp's width: every row access is coalesced) and a
// window of kWarps * kChunk steps (8 x 16 = 128); warp w owns chunk w of
// the window, so D = 4096 gives 128 blocks of 256 threads (at most 64
// registers a thread: four blocks an SM, so D = 16384's 512 blocks run in
// one wave).  Each thread
//   1. loads its chunk's a, b and reset as one batch of independent loads
//      and forms the decay (a_eff_t forward, a_eff_{t+1} in the adjoint,
//      whose last step reads the next chunk's first row; 0 at t = T - 1;
//      steps past T are identities, decay 1 and b 0);
//   2. scans the chunk from zero, keeping the local states and the running
//      products of the decay in registers;
//   3. publishes (product, last local state) in shared memory; after one
//      barrier it folds the chunks before its own, in order, from the
//      window's carry (h0 or 0 first), c <- P_j * c + H_j, into its
//      carry-in, and every thread folds all of them into the next window's
//      carry;
//   4. writes h_t = local_t + product_t * carry_in once.
// A reset makes its decay 0 and with it every product that spans it: no
// special case.  T > 128 walks further windows (in reverse from the last),
// each with the carry of the one before.  `ref.py::chunked_scan_ref` does
// the same algebra in PyTorch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // chunks a window, one warp each
constexpr int kChunk = 16;  // steps a chunk; ops.py's KERNEL_CHUNK, checked at load

__global__ void __launch_bounds__(32 * kWarps, 4)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const unsigned char* __restrict__ reset,
                   const float* __restrict__ h0, float* __restrict__ out,
                   int T, int D, int H, int reverse) {
  __shared__ float sP[kWarps][32];  // each chunk's product of decays
  __shared__ float sH[kWarps][32];  // and its local state at its last step
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int d = blockIdx.x * 32 + lane;
  const bool live = d < D;
  const int B = D / H;
  const int rl = live ? d / H : 0;

  constexpr int kWindow = kWarps * kChunk;
  const int windows = (T + kWindow - 1) / kWindow;
  float carry = (!reverse && h0 && live) ? h0[d] : 0.0f;
  for (int k = 0; k < windows; ++k) {
    const int lo = (reverse ? windows - 1 - k : k) * kWindow + w * kChunk;
    const int lo_a = lo + reverse;  // first row of the decays: a_eff_{t+1} in the adjoint
    // every load first, each under its own predicate and none behind a
    // branch, so that a thread's 3 * kChunk loads are in flight together
    float loc[kChunk], prod[kChunk];  // b, then local state; a, then product
    unsigned char r[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      loc[i] = 0.0f;
      prod[i] = 0.0f;
      r[i] = 0;
      if (live && lo + i < T) loc[i] = b[static_cast<size_t>(lo + i) * D + d];
      if (live && lo_a + i < T) prod[i] = a[static_cast<size_t>(lo_a + i) * D + d];
      if (reset && live && lo_a + i < T) r[i] = reset[static_cast<size_t>(lo_a + i) * B + rl];
    }
    // the decay: 0 at a reset and past the last row (h_{T-1} = b_{T-1} in
    // the adjoint); steps past T are identities
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      prod[i] = lo + i >= T ? 1.0f : (r[i] ? 0.0f : prod[i]);
    }
    if (!reverse) {
#pragma unroll
      for (int i = 1; i < kChunk; ++i) {
        loc[i] = fmaf(prod[i], loc[i - 1], loc[i]);
        prod[i] *= prod[i - 1];
      }
    } else {
#pragma unroll
      for (int i = kChunk - 2; i >= 0; --i) {
        loc[i] = fmaf(prod[i], loc[i + 1], loc[i]);
        prod[i] *= prod[i + 1];
      }
    }
    const int end = reverse ? 0 : kChunk - 1;
    sP[w][lane] = prod[end];
    sH[w][lane] = loc[end];
    __syncthreads();
    float c = carry, c_in = carry;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const int q = reverse ? kWarps - 1 - j : j;  // chunks in the scan's order
      if (q == w) c_in = c;
      c = fmaf(sP[q][lane], c, sH[q][lane]);
    }
    carry = c;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = lo + i;
      if (live && t < T) out[static_cast<size_t>(t) * D + d] = fmaf(prod[i], c_in, loc[i]);
    }
    if (k + 1 < windows) __syncthreads();  // the next window reuses sP and sH
  }
}

}  // namespace

// Steps a chunk, so that the wrapper can check its copy of kChunk.
extern "C" int linear_scan_chunk() { return kChunk; }

extern "C" int linear_scan_f32(const float* a, const float* b,
                               const unsigned char* reset, const float* h0,
                               float* out, int T, int D, int H, int reverse,
                               void* stream) {
  if (T > 0 && D > 0) {
    const int blocks = (D + 31) / 32;
    linear_scan_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, reset, h0, out, T, D, H, reverse);
  }
  return static_cast<int>(cudaGetLastError());
}
