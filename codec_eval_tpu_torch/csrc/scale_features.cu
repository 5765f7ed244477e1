// K1: SSIMULACRA2 per-scale features for a batch of candidates.
//
// Replaces the Pallas kernel codec_eval_tpu/kernels/pallas/scale_features.py
// :scale_features_pallas_batch.  For one pyramid scale and every (candidate,
// channel) it blurs the candidate moments mu2, s22 = x2*x2 and s12 = x1*x2
// with the normalized sigma-1.5 Gaussian (15 taps, zero padding), forms the
// SSIM, ringing-artifact and detail-loss maps against the precomputed
// reference (x1, mu1, s11), sums each map and its 4th power, and forms the
// features: the mean of each map and the 4th root of the mean of its 4th
// power.  K8 is this kernel at N = 1.
//
// A row window [row_lo, row_hi) limits the sums, and the pixel count that
// divides them, to those rows; the blurs still read every row of the plane.
// Spatial sharding (parallel/spatial.py) scores a row band of an image with
// a halo above and below and sums only the band's own rows.  The full
// window [0, h) adds the same values in the same order as no window.
//
// What bounds it on an H100: operations.  Per channel-pixel the three
// 15-tap blurs both ways and the maps take ~210 f32 operations against
// ~20 bytes of device traffic.  The sources build with -fmad=false and the
// blurs add t0*x0 first, then tk*xk, as the plain version does, so each tap
// costs a multiply and an add: the floor is twice the operations' time at
// peak, and the kernel is bound by instruction issue.
//
// The design (row-streamed column strips, as K3 and K9):
// - A block owns a strip of 128 output columns and a segment of rows of one
//   (candidate, channel) plane, and walks down the segment in groups of
//   8 rows.  A tiled design staged each tile's x1 and x2 with a 7-pixel
//   halo and ran both passes from shared memory (~100 shared accesses per
//   channel-pixel); here the vertical pass runs in registers.
// - The walk and stage A are moments.cuh's, shared with K9 (strip_walk,
//   form kFeatures): each thread owns one column of the strip grown by the
//   radius (142) and keeps the last 15 rows of x2, x2*x2 and x1*x2; cp.async
//   copies x1 and x2 a group of rows ahead; two block barriers per group.
// - Stage B, this kernel's own: each of 128 threads takes four adjacent
//   outputs in a quarter of the group's rows, runs the horizontal pass
//   (4.5 shared loads per output), then forms the maps, with the reference
//   at the outputs read from L2.
// - The candidate is the fastest grid index, so the candidates of one
//   (strip, segment, channel) run together and read the reference planes
//   from L2, not device memory.
// - Each thread keeps its six sums in double; each block writes its six
//   partials; the last block of a (candidate, channel) plane, found by an
//   atomic counter after a __threadfence, adds the plane's partials in
//   block order, writes the features and resets the counter to 0.  The
//   partials and that order depend on the plane's size only, never on N,
//   and no value is added atomically, so results repeat run to run and a
//   single pair equals its candidate in a batch.  The wrapper issues the
//   launch and nothing else.
#include "moments.cuh"

using namespace ce::moments;

namespace {

constexpr float kC2 = 0.0009f;
constexpr int WARPS1 = ce::kStripThreads / 32;

struct FeaturesSmem {
  StripSmem<kFeatures> strip;
  double red[WARPS1][6];
  bool last;
};

// Six sums over the block, in a fixed order; valid in thread 0.
__device__ __forceinline__ void block_sum6(double (&v)[6], double (*red)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 6; ++k) red[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      v[k] = red[0][k];
      for (int i = 1; i < WARPS1; ++i) v[k] += red[i][k];
    }
  __syncthreads();
}

// Block: one (segment, strip, channel, candidate), candidate fastest.
// Stage B (four output columns per thread, a quarter of a group's rows)
// forms each output row's moments and maps.
__global__ void __launch_bounds__(ce::kStripThreads, 4)
scale_features_kernel(const float* __restrict__ x1, const float* __restrict__ mu1,
                      const float* __restrict__ s11, const float* __restrict__ x2,
                      double* __restrict__ partial, int* __restrict__ counter,
                      float* __restrict__ out, int n, int h, int w, int seg, int row_lo,
                      int row_hi, ce::Floats<K> taps) {
  __shared__ FeaturesSmem sm;
  const int tid = threadIdx.x;
  const int cand = blockIdx.x % n;
  const int c = blockIdx.x / n % 3;
  const int blk = blockIdx.x / n / 3;  // segment-major block of the plane
  const int strips = (w + ce::kStrip - 1) / ce::kStrip;
  const int nblk = strips * ((h + seg - 1) / seg);
  const int x0 = blk % strips * ce::kStrip, y0 = blk / strips * seg;
  const int y_end = min(y0 + seg, h), x_end = min(x0 + ce::kStrip, w);
  const int pc = cand * 3 + c;  // this (candidate, channel) plane
  const size_t plane = (size_t)h * w;
  const float* ref = x1 + c * plane;
  const float* cnd = x2 + (size_t)pc * plane;
  const float* m1p = mu1 + c * plane;
  const float* s1p = s11 + c * plane;

  const int q = tid % QUADS;  // stage B: output quad
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  strip_walk<kFeatures>(sm.strip, ref, cnd, h, w, x0, y0, y_end, seg, taps,
                        [&](const Row (&v)[4], int y) {
    if (y < row_lo || y >= row_hi) return;  // outside the window: nothing to add
    float mom[3][QUAD];
#pragma unroll
    for (int m = 0; m < 3; ++m) horizontal_quad(v[m], q, taps.v, mom[m]);
    const float x2c[QUAD] = {col<R>(v[3], q), col<R + 1>(v[3], q), col<R + 2>(v[3], q),
                             col<R + 3>(v[3], q)};
#pragma unroll
    for (int p = 0; p < QUAD; ++p) {
      const int gx = x0 + QUAD * q + p;
      if (gx >= x_end) continue;  // the ragged edge adds nothing
      const size_t gi = (size_t)y * w + gx;
      const float mu2 = mom[0][p], q22 = mom[1][p], q12 = mom[2][p];
      const float m1 = m1p[gi], q11 = s1p[gi];
      const float mu11 = m1 * m1, mu22 = mu2 * mu2, mu12 = m1 * mu2;
      const float md = m1 - mu2;
      const float num_m = 1.f - md * md;
      const float num_s = 2.f * (q12 - mu12) + kC2;
      const float den_s = (q11 - mu11) + (q22 - mu22) + kC2;
      const float d = fmaxf(1.f - (num_m * num_s) / den_s, 0.f);
      const float det1 = fabsf(ref[gi] - m1);
      const float det2 = fabsf(x2c[p] - mu2);
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
  });

  block_sum6(acc, sm.red);
  if (tid == 0) {
    double* mine = partial + ((size_t)pc * nblk + blk) * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k) mine[k] = acc[k];
    __threadfence();
    sm.last = atomicAdd(&counter[pc], 1) == nblk - 1;
  }
  __syncthreads();
  if (!sm.last) return;

  // The plane's last block: its partials in block order.
  __threadfence();
  double tot[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const double* mine = partial + (size_t)pc * nblk * 6;
  for (int i = tid; i < nblk; i += ce::kStripThreads)
#pragma unroll
    for (int k = 0; k < 6; ++k) tot[k] += __ldcg(mine + (size_t)i * 6 + k);
  block_sum6(tot, sm.red);
  if (tid == 0) {
    const double pixels = (double)(row_hi - row_lo) * w;
    float* f = out + (size_t)pc * 6;  // (norm 1: ssim, artifact, detail; norm 4: the same)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      f[j] = (float)(tot[2 * j] / pixels);
      f[3 + j] = (float)sqrt(sqrt(tot[2 * j + 1] / pixels));
    }
    counter[pc] = 0;  // ready for the next launch
  }
}

}  // namespace

// x1, mu1, s11: (3, h, w); x2: (n, 3, h, w); partial: (n, 3, nblk, 6)
// doubles with nblk = ceil(w / 128) * ceil(h / seg); counter: n * 3 ints,
// all 0 (the kernel leaves them 0); out: (n, 3, 2, 3); seg: rows per
// segment; [row_lo, row_hi): the rows summed, 0 <= row_lo < row_hi <= h;
// taps: 15 host floats.
extern "C" int ce_scale_features(const float* x1, const float* mu1, const float* s11,
                                 const float* x2, double* partial, int* counter, float* out,
                                 int n, int h, int w, int seg, int row_lo, int row_hi,
                                 const float* taps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || seg <= 0) return (int)cudaErrorInvalidValue;
  if (row_lo < 0 || row_lo >= row_hi || row_hi > h) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)n * 3 * ((w + ce::kStrip - 1) / ce::kStrip) *
                           ((h + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scale_features_kernel<<<(unsigned)blocks, ce::kStripThreads, 0, (cudaStream_t)stream>>>(
      x1, mu1, s11, x2, partial, counter, out, n, h, w, seg, row_lo, row_hi,
      ce::load_floats<K>(taps));
  return (int)cudaGetLastError();
}
