// The SSIM moment tile that K1 (scale_features.cu) and K9 (moments.cu) share.
//
// Both kernels blur the candidate moments x2, x2*x2 and x1*x2 of one
// (pair, channel) plane with the normalized sigma-1.5 Gaussian (15 taps,
// zero padding): one 32x16 output tile per block, x1 and x2 staged once
// with a 7-pixel zero halo in shared memory, the two products formed in
// registers, the vertical pass kept in shared memory and the horizontal pass
// done per output pixel.  Taps add in order, t0*x0 first, as
// kernels/blur.py:fir_separable adds them; under -fmad=false the three
// blurs equal that plain version bit for bit.
#pragma once

#include "common.cuh"

namespace ce {
namespace moments {

constexpr int R = 7;
constexpr int K = 2 * R + 1;
constexpr int TW = 32;
constexpr int TH = 16;
constexpr int SW = TW + 2 * R;
constexpr int SH = TH + 2 * R;

struct Tile {
  float a[SH][SW];     // x1 tile + halo
  float b[SH][SW];     // x2 tile + halo
  float v[3][TH][SW];  // vertical blurs of x2, x2*x2, x1*x2
};

// Stage the (x0, y0) tile of planes p1 and p2 (zeros outside the image) and
// run the vertical pass of the three products into t.v.  Ends with the
// block synchronized.
__device__ __forceinline__ void stage_vertical(Tile& t, const float* __restrict__ p1,
                                               const float* __restrict__ p2, int x0, int y0,
                                               int h, int w, const Floats<K>& taps) {
  for (int i = threadIdx.x; i < SH * SW; i += kThreads) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 + sy - R, gx = x0 + sx - R;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t gi = (size_t)gy * w + gx;
    t.a[sy][sx] = in ? p1[gi] : 0.f;
    t.b[sy][sx] = in ? p2[gi] : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TH * SW; i += kThreads) {
    const int ty = i / SW, sx = i % SW;
    float xa = t.a[ty][sx], xb = t.b[ty][sx];
    float m = taps.v[0] * xb;
    float q22 = taps.v[0] * (xb * xb);
    float q12 = taps.v[0] * (xa * xb);
#pragma unroll
    for (int k = 1; k < K; ++k) {
      xa = t.a[ty + k][sx];
      xb = t.b[ty + k][sx];
      m = m + taps.v[k] * xb;
      q22 = q22 + taps.v[k] * (xb * xb);
      q12 = q12 + taps.v[k] * (xa * xb);
    }
    t.v[0][ty][sx] = m;
    t.v[1][ty][sx] = q22;
    t.v[2][ty][sx] = q12;
  }
  __syncthreads();
}

// The horizontal pass at output pixel (ty, tx) of the tile: mu2, s22, s12.
__device__ __forceinline__ void horizontal(const Tile& t, int ty, int tx, const Floats<K>& taps,
                                           float& mu2, float& s22, float& s12) {
  mu2 = taps.v[0] * t.v[0][ty][tx];
  s22 = taps.v[0] * t.v[1][ty][tx];
  s12 = taps.v[0] * t.v[2][ty][tx];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    mu2 = mu2 + taps.v[k] * t.v[0][ty][tx + k];
    s22 = s22 + taps.v[k] * t.v[1][ty][tx + k];
    s12 = s12 + taps.v[k] * t.v[2][ty][tx + k];
  }
}

}  // namespace moments
}  // namespace ce
