// K1: SSIMULACRA2 per-scale features for a batch of candidates.
//
// Replaces the Pallas kernel codec_eval_tpu/kernels/pallas/scale_features.py
// :scale_features_pallas_batch.  For one pyramid scale and every (candidate,
// channel) it blurs the candidate moments mu2, s22 = x2*x2 and s12 = x1*x2
// with the normalized sigma-1.5 Gaussian (15 taps, zero padding), forms the
// SSIM, ringing-artifact and detail-loss maps against the precomputed
// reference (x1, mu1, s11), and sums each map and its 4th power.
//
// What bounds it on an H100: memory traffic and latency.  Per output pixel
// it reads five f32 planes (x1, x2 with a 7-pixel halo, mu1, s11) and does
// ~100 flops, far below the card's flop/byte balance, and at the small
// pyramid scales (down to 16x16) a launch holds only a few blocks.
//
// The simple design: one 32x16 output tile per block, with the x1/x2 tile
// and its halo staged once in shared memory so each input is read from
// device memory once per tile (the halo costs 2.7x on the two staged
// planes).  The vertical pass blurs all three moment products into shared
// memory, the horizontal pass runs per output pixel in registers, and the
// maps never leave the SM; the staging and both passes are the moment tile
// that K9 (moments.cu) shares (moments.cuh).  Pixels outside the image are
// masked before the sums.  Each block writes its own six partial sums to
// (N, 3, nblocks, 6): no atomics, so results repeat run to run; the wrapper
// adds the partials.  The TPU kernel kept the reference slab resident across
// the candidate axis of a sequential grid; here blocks run in parallel and
// each loads its own reference tile (the reference planes stay hot in the
// 50 MB L2).
#include "moments.cuh"

using namespace ce::moments;

namespace {

constexpr float kC2 = 0.0009f;

__global__ void __launch_bounds__(ce::kThreads)
scale_features_kernel(const float* __restrict__ x1, const float* __restrict__ mu1,
                      const float* __restrict__ s11, const float* __restrict__ x2,
                      float* __restrict__ partial, int h, int w, ce::Floats<K> taps) {
  __shared__ Tile t;
  __shared__ float scratch[ce::kThreads / 32];

  const int tid = threadIdx.x;
  const int c = blockIdx.z % 3;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  // One reference for every candidate: its channel c.
  stage_vertical(t, x1 + c * plane, x2 + (size_t)blockIdx.z * plane, x0, y0, h, w, taps);

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < TH * TW; i += ce::kThreads) {
    const int ty = i / TW, tx = i % TW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;  // the ragged edge adds nothing
    float mu2, q22, q12;
    horizontal(t, ty, tx, taps, mu2, q22, q12);
    const size_t gi = c * plane + (size_t)gy * w + gx;
    const float m1 = mu1[gi], q11 = s11[gi];
    const float mu11 = m1 * m1, mu22 = mu2 * mu2, mu12 = m1 * mu2;
    const float md = m1 - mu2;
    const float num_m = 1.f - md * md;
    const float num_s = 2.f * (q12 - mu12) + kC2;
    const float den_s = (q11 - mu11) + (q22 - mu22) + kC2;
    const float d = fmaxf(1.f - (num_m * num_s) / den_s, 0.f);
    const float det1 = fabsf(t.a[ty + R][tx + R] - m1);
    const float det2 = fabsf(t.b[ty + R][tx + R] - mu2);
    const float ed = (1.f + det2) / (1.f + det1) - 1.f;
    const float art = fmaxf(ed, 0.f), lost = fmaxf(-ed, 0.f);
    const float d2 = d * d, a2 = art * art, l2 = lost * lost;
    acc[0] += d;
    acc[1] += d2 * d2;
    acc[2] += art;
    acc[3] += a2 * a2;
    acc[4] += lost;
    acc[5] += l2 * l2;
  }

  const int nblocks = gridDim.x * gridDim.y;
  float* out = partial + ((size_t)blockIdx.z * nblocks + blockIdx.y * gridDim.x + blockIdx.x) * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float s = ce::block_sum(acc[k], scratch);
    if (tid == 0) out[k] = s;
  }
}

}  // namespace

// x1, mu1, s11: (3, h, w); x2: (n, 3, h, w); partial: (n, 3, nblocks, 6)
// with nblocks = ceil(w/32) * ceil(h/16) (the wrapper's TILE); taps: 15
// host floats.
extern "C" int ce_scale_features(const float* x1, const float* mu1, const float* s11,
                                 const float* x2, float* partial, int n, int h, int w,
                                 const float* taps, void* stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n * 3);
  scale_features_kernel<<<grid, ce::kThreads, 0, (cudaStream_t)stream>>>(
      x1, mu1, s11, x2, partial, h, w, ce::load_floats<K>(taps));
  return (int)cudaGetLastError();
}
