// Gated linear recurrence  h_t = a_t * (1 - r_t) * h_{t-1} + b_t  for Hopper.
//
// Replaces src/repro/kernels/recurrent_scan/kernel.py::linear_scan_kernel
// (the blocked associative-scan Pallas TPU kernel behind
// repro.kernels.recurrent_scan.ops.linear_recurrent_scan).  It computes what
// that kernel computes, not its blocking: the TPU walks time chunks in order
// on one core with the carry in VMEM, which has no counterpart across the
// H100's 132 SMs, so here every feature lane walks its own time axis.
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
// 3.35 TB/s; at D = 4096 about 6.3 MB, 1.9 us, below the cost of a launch.
// What the design does about it: one pass over the data, with the reset
// folded into the decay in registers and the carry held in a register in
// float32.  Consecutive threads own consecutive d, so every load and store
// of a time row is coalesced.  A time-parallel (chunked) form, for small D
// where D / 128 blocks leave most SMs idle, is later work.

#include <cuda_runtime.h>

namespace {

__global__ void linear_scan_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   const unsigned char* __restrict__ reset,
                                   const float* __restrict__ h0,
                                   float* __restrict__ out,
                                   int T, int D, int H, int reverse) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int B = D / H;
  const int lane = d / H;
  if (!reverse) {
    float h = h0 ? h0[d] : 0.0f;
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      const size_t i = static_cast<size_t>(t) * D + d;
      float at = a[i];
      if (reset && reset[static_cast<size_t>(t) * B + lane]) at = 0.0f;
      h = fmaf(at, h, b[i]);
      out[i] = h;
    }
  } else {
    float h = 0.0f;
    float decay = 0.0f;  // a_eff_{t+1}; multiplies h = 0 at t = T - 1
#pragma unroll 8
    for (int t = T - 1; t >= 0; --t) {
      const size_t i = static_cast<size_t>(t) * D + d;
      h = fmaf(decay, h, b[i]);
      out[i] = h;
      decay = (reset && reset[static_cast<size_t>(t) * B + lane]) ? 0.0f : a[i];
    }
  }
}

}  // namespace

extern "C" int linear_scan_f32(const float* a, const float* b,
                               const unsigned char* reset, const float* h0,
                               float* out, int T, int D, int H, int reverse,
                               void* stream) {
  constexpr int kThreads = 128;
  if (T > 0 && D > 0) {
    const int blocks = (D + kThreads - 1) / kThreads;
    linear_scan_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        a, b, reset, h0, out, T, D, H, reverse);
  }
  return static_cast<int>(cudaGetLastError());
}
