// K4: Butteraugli Malta directional sweeps, batched.
//
// Replaces codec_eval_tpu/kernels/pallas/malta.py:malta_ac_batch_pallas:
// (B, 6, H, W) asymmetric band-diff planes -> (B, 2, H, W) accumulators.
// For each plane it takes the oriented line sums within radius 4 (9-sample
// "full" lines on the two UHF planes, 5-sample "lf" lines on the HF and MF
// planes), squares each sum, weights it, and adds it into the X (ac0) or Y
// (ac1) accumulator: planes 0, 2, 4 feed ac1 and planes 1, 3, 5 feed ac0.
// Samples outside the image read 0.
//
// What bounds it on an H100: latency and shared-memory bandwidth.  It
// reads six planes and writes two (32 bytes per pixel of device traffic),
// but does 512 shared-memory reads and adds per pixel: 2 x 96 samples on
// the 12 full lines of the UHF planes, 4 x 80 on the 16 lf lines of the
// others.
//
// The simple design: one 32x32 output tile per block, four pixels per
// thread; the six planes are staged one at a time, each with its 4-pixel
// halo, into shared memory, and every thread keeps its pixels' two
// accumulators in registers across the six planes, so each plane is read
// from device memory once per tile and the accumulators are written once.
// The line tables sit in __constant__ memory: every thread of a warp reads
// the same entry at the same time, which constant memory broadcasts, and a
// thread reads each sample's offset once for its four pixels.  Lines and
// samples are summed in the order of the plain version, so results match it
// bit for bit.
#include "common.cuh"

namespace {

constexpr int R = 4;
constexpr int TW = 32;
constexpr int TH = 32;
constexpr int SW = TW + 2 * R;
constexpr int SH = TH + 2 * R;
constexpr int kMaxLines = 16;
constexpr int kMaxSamples = 9;
constexpr int kGeom = 1 + 2 * kMaxSamples;  // sample count, dy[9], dx[9]
constexpr int kPerThread = TH * TW / ce::kThreads;

// [kind][line]: kind 0 = full lines, kind 1 = lf lines.
__constant__ float c_weight[2][kMaxLines];
__constant__ int c_geom[2][kMaxLines][kGeom];

__global__ void __launch_bounds__(ce::kThreads)
malta_kernel(const float* __restrict__ diffs, float* __restrict__ out, int h, int w,
             int nlines_full, int nlines_lf) {
  __shared__ float tile[SH * SW];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const float* src = diffs + (size_t)blockIdx.z * 6 * plane;

  // Pixel j of this thread is row tid/32 + 8j of the tile, so a warp reads
  // one tile row: consecutive shared-memory words, no bank conflicts.
  int center[kPerThread];
  float ac0[kPerThread], ac1[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * ce::kThreads;
    center[j] = (i / TW + R) * SW + i % TW + R;
    ac0[j] = ac1[j] = 0.f;
  }

  for (int ch = 0; ch < 6; ++ch) {
    for (int i = tid; i < SH * SW; i += ce::kThreads) {
      const int sy = i / SW, sx = i % SW;
      const int gy = y0 + sy - R, gx = x0 + sx - R;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      tile[i] = in ? src[ch * plane + (size_t)gy * w + gx] : 0.f;
    }
    __syncthreads();
    const int kind = ch < 2 ? 0 : 1;
    const int nlines = kind == 0 ? nlines_full : nlines_lf;
    float term[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) term[j] = 0.f;
    for (int l = 0; l < nlines; ++l) {
      // Each line's offsets are read once and applied to all this thread's
      // pixels; per pixel, samples and lines add in the plain version's order.
      const int* g = c_geom[kind][l];
      const int ns = g[0];
      float s[kPerThread];
      int off = g[1] * SW + g[1 + kMaxSamples];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) s[j] = tile[center[j] + off];
      for (int q = 1; q < ns; ++q) {
        off = g[1 + q] * SW + g[1 + kMaxSamples + q];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) s[j] = s[j] + tile[center[j] + off];
      }
      const float wl = c_weight[kind][l];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) term[j] = term[j] + wl * (s[j] * s[j]);
    }
    // Planes 0, 2, 4 feed ac1 (Y), planes 1, 3, 5 feed ac0 (X).
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (ch % 2 == 0) ac1[j] = ac1[j] + term[j];
      else ac0[j] = ac0[j] + term[j];
    }
    __syncthreads();
  }

  float* dst = out + (size_t)blockIdx.z * 2 * plane;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * ce::kThreads;
    const int gy = y0 + i / TW, gx = x0 + i % TW;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    dst[gi] = ac0[j];
    dst[plane + gi] = ac1[j];
  }
}

}  // namespace

// diffs: (b, 6, h, w); out: (b, 2, h, w).  weights: (2, 16) host floats and
// geometry: (2, 16, 19) host ints (per line: sample count, 9 dy, 9 dx),
// copied into constant memory on the launch stream ahead of the kernel.
extern "C" int ce_malta_ac(const float* diffs, float* out, int b, int h, int w,
                           const float* weights, const int* geometry, int nlines_full,
                           int nlines_lf, void* stream) {
  if (nlines_full > kMaxLines || nlines_lf > kMaxLines) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(c_weight, weights, sizeof(c_weight), 0,
                                            cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbolAsync(c_geom, geometry, sizeof(c_geom), 0,
                                cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  malta_kernel<<<grid, ce::kThreads, 0, s>>>(diffs, out, h, w, nlines_full, nlines_lf);
  return (int)cudaGetLastError();
}
