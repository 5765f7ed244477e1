// K9: the candidate-side SSIM moments of a batch of pairs.
//
// Replaces the Pallas kernel codec_eval_tpu/kernels/pallas/moments.py
// :candidate_moments_pallas.  For every (pair, channel) plane of x1 and x2
// it writes the zero-boundary sigma-1.5 blurs (15 taps) mu2 = blur(x2),
// s22 = blur(x2*x2) and s12 = blur(x1*x2).  Unlike K1, each pair brings its
// own x1: the masked scorer (kernels/masked.py) pads every pair of a bucket
// to one shape, and each has its own reference.  Given x1 as both inputs it
// gives the reference side, blur(x1) and blur(x1*x1).
//
// What bounds it on an H100: memory traffic.  Per pixel of a plane it reads
// two f32 inputs and writes three (20 bytes) and does 176 flops, about 9
// flops per byte, under the card's f32 balance of ~20.
//
// The simple design is K1's moment tile (moments.cuh): one 32x16 output tile
// per block, x1 and x2 staged once with a 7-pixel zero halo in shared
// memory, x2*x2 and x1*x2 formed in registers, the vertical pass into
// shared memory and the horizontal pass per output pixel; the three planes
// are written out instead of K1's SSIM maps and sums.  Taps add in
// kernels/blur.py:fir_separable's order under -fmad=false, so the three
// planes equal the plain version bit for bit.  The Pallas kernel's 128-lane
// width padding, 8-row slab rounding and VMEM tile shrinking are TPU layout
// with no counterpart: the tile and its halo fit shared memory at any width,
// and the grid masks the ragged edge.
#include "moments.cuh"

using namespace ce::moments;

namespace {

__global__ void __launch_bounds__(ce::kThreads)
candidate_moments_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                         float* __restrict__ out, int h, int w, size_t total,
                         ce::Floats<K> taps) {
  __shared__ Tile t;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t base = (size_t)blockIdx.z * h * w;  // this (pair, channel) plane
  stage_vertical(t, x1 + base, x2 + base, x0, y0, h, w, taps);

  for (int i = threadIdx.x; i < TH * TW; i += ce::kThreads) {
    const int ty = i / TW, tx = i % TW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    float mu2, s22, s12;
    horizontal(t, ty, tx, taps, mu2, s22, s12);
    const size_t gi = base + (size_t)gy * w + gx;
    out[gi] = mu2;
    out[total + gi] = s22;
    out[2 * total + gi] = s12;
  }
}

}  // namespace

// x1, x2: (planes, h, w) with planes = pairs * 3; out: (3, planes, h, w),
// mu2 then s22 then s12; taps: 15 host floats.
extern "C" int ce_candidate_moments(const float* x1, const float* x2, float* out, int planes,
                                    int h, int w, const float* taps, void* stream) {
  if (planes <= 0 || planes > 65535 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, planes);
  const size_t total = (size_t)planes * h * w;
  candidate_moments_kernel<<<grid, ce::kThreads, 0, (cudaStream_t)stream>>>(
      x1, x2, out, h, w, total, ce::load_floats<K>(taps));
  return (int)cudaGetLastError();
}
