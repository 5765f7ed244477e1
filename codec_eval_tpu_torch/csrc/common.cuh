// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (bound from Python with ctypes),
// launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of its launch.  Small constant tables (FIR taps, model
// constants) arrive as host pointers and are copied into structs passed by
// value, so a launch carries everything it needs.
#pragma once

#include <cuda_runtime.h>
#include <cstring>

namespace ce {

constexpr int kThreads = 256;

template <int N>
struct Floats {
  float v[N];
};

template <int N>
inline Floats<N> load_floats(const float* host) {
  Floats<N> f;
  std::memcpy(f.v, host, sizeof(f.v));
  return f;
}

// Sum of one value over the block; the result is valid in thread 0.
// `scratch` holds one float per warp.
__device__ inline float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) s += scratch[i];
  __syncthreads();
  return s;
}

// Row-streamed column strips (K1, K3): a block owns kStrip output columns
// of one plane and a segment of rows, and walks down the segment a group of
// rows at a time.  kStripThreads threads: one per column of the strip grown
// by the stencil's halo in the vertical passes.  The wrappers choose the
// segment length (kernels/cuda/_lib.py STRIP, segment_rows).
constexpr int kStrip = 128;
constexpr int kStripThreads = 160;

// Start a 4-byte asynchronous copy of *src into shared *dst, or zero-fill
// *dst where !in.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(to), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace ce
