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
// What bounds it on an H100: operations.  Per channel-pixel the three
// 15-tap blurs both ways and the maps take ~210 f32 operations against
// ~20 bytes of device traffic.  The sources build with -fmad=false and the
// blurs add t0*x0 first, then tk*xk, as the plain version does, so each tap
// costs a multiply and an add: the floor is twice the operations' time at
// peak, and the kernel is bound by instruction issue.
//
// The design (row-streamed column strips, as K3):
// - A block owns a strip of 128 output columns and a segment of rows of one
//   (candidate, channel) plane, and walks down the segment in groups of
//   RG1 = 8 rows.  A tiled design staged each tile's x1 and x2 with a
//   7-pixel halo and ran both passes from shared memory (~100 shared
//   accesses per channel-pixel); here the vertical pass runs in registers.
// - Stage A: each thread owns one column of the strip grown by the radius
//   (142) and keeps the last 15 rows of x2, x2*x2 and x1*x2, the products
//   formed once as a row arrives.  It writes the group's vertical sums to
//   shared memory, quarter-interleaved by column.
// - Stage B: each of 128 threads takes four adjacent outputs in a quarter
//   of the group's rows: it reads 18 values per moment and row (4.5 loads
//   per output), then forms the maps, with the reference at the outputs
//   read from L2.
// - cp.async copies x1 and x2 of each thread's column a group of rows
//   ahead into a ring of rows; one wait per group lets the compiler
//   interleave the group's rows.  Two block barriers per group.
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
// The radius and tap count are those of K9's moment tile (moments.cuh).
#include "moments.cuh"

using ce::moments::K;
using ce::moments::R;

namespace {

constexpr float kC2 = 0.0009f;
constexpr int G1 = ce::kStrip + 2 * R;  // grown column g is x0 - R + g
// Stage B: each thread makes QUAD adjacent outputs from one run of loads.
constexpr int QUAD = 4;
constexpr int QUADS = ce::kStrip / QUAD;
// A row of vertical sums in shared memory, column g at [g % QUAD][g / QUAD],
// so that thread j's loads of columns QUAD * j + m take one bank per lane.
// The quarters sit 40 floats apart (8 banks).
constexpr int kQuarter = 40;
// Rows per group: stage A runs a group's rows into shared memory, then
// stage B takes them, with two block barriers per group.  Stage B's
// threads split a group's rows in PARTS interleaved parts.
constexpr int RG1 = 8;
constexpr int PARTS = 4;
constexpr int B_THREADS = PARTS * QUADS;
// x1 and x2 of each input row, copied by each thread for its own grown
// column (no other thread reads them) into a ring of rows, a group at a
// time and a group ahead; one wait per group lets the compiler interleave
// the group's rows.  Stage B reads the reference at its outputs from device
// memory (L2) directly: staging those rows too cost more copies than it
// saved.
constexpr int NSLOT1 = 2 * RG1;
constexpr int DIST1 = NSLOT1 - RG1;  // rows copied ahead
constexpr int WARPS1 = ce::kStripThreads / 32;
static_assert(G1 <= ce::kStripThreads && G1 <= QUAD * kQuarter, "");
static_assert(B_THREADS <= ce::kStripThreads && RG1 % PARTS == 0, "");

struct FeaturesSmem {
  float slot[NSLOT1][2][G1];
  // Per row of the group: vertical sums of x2, x2*x2, x1*x2, and x2, at the
  // output row.
  float v[RG1][4][QUAD][kQuarter];
  double red[WARPS1][6];
  bool last;
};

// Column QUAD * j + M of a row of vertical sums.
template <int M>
__device__ __forceinline__ float col(const float (&row)[QUAD][kQuarter], int j) {
  return row[M % QUAD][j + M / QUAD];
}

// The blur's order: t0*x0 first, then + tk*xk.
__device__ __forceinline__ float fir(const float* t, const float* x) {
  float acc = t[0] * x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) acc = acc + t[k] * x[k];
  return acc;
}

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

// Block: one (segment, strip, channel, candidate), candidate fastest.  Step
// s reads input row r = y0 - R + s; stage A (a grown column per thread)
// completes the vertical sums of output row y = r - R, stage B (four output
// columns per thread, a quarter of a group's rows) that row's moments and
// maps.
__global__ void __launch_bounds__(ce::kStripThreads, 4)
scale_features_kernel(const float* __restrict__ x1, const float* __restrict__ mu1,
                      const float* __restrict__ s11, const float* __restrict__ x2,
                      double* __restrict__ partial, int* __restrict__ counter,
                      float* __restrict__ out, int n, int h, int w, int seg,
                      ce::Floats<K> taps) {
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

  const int gx_a = x0 - R + tid;
  const bool col_in = tid < G1 && gx_a >= 0 && gx_a < w;
  auto issue = [&](int s) {
    if (tid < G1) {
      const int r = y0 - R + s;
      const bool in = col_in && r >= 0 && r < h;
      const size_t gi = in ? (size_t)r * w + gx_a : 0;
      ce::cp_async4(&sm.slot[s % NSLOT1][0][tid], ref + gi, in);
      ce::cp_async4(&sm.slot[s % NSLOT1][1][tid], cnd + gi, in);
    }
    ce::cp_async_commit();
  };

  float rm[K], r22[K], r12[K];  // x2, x2*x2, x1*x2 of rows r - 14 .. r
#pragma unroll
  for (int i = 0; i < K; ++i) rm[i] = r22[i] = r12[i] = 0.f;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};

  const int q = tid % QUADS;  // stage B: output quad, and its part of the rows
  const int part = tid / QUADS;
  const int steps = seg + 2 * R;
  const int groups = (steps + RG1 - 1) / RG1;
#pragma unroll
  for (int s = 0; s < DIST1; ++s) issue(s);

#pragma unroll 1
  for (int grp = 0; grp < groups; ++grp) {
    const int s0 = grp * RG1;

    // Stage A: the vertical pass of one grown column, RG1 rows.
#pragma unroll
    for (int i = 0; i < RG1; ++i) issue(s0 + i + DIST1);
    ce::cp_async_wait<DIST1>();  // this group's rows are in
#pragma unroll
    for (int i = 0; i < RG1; ++i) {
      if (tid < G1) {
#pragma unroll
        for (int j = 0; j < K - 1; ++j) {
          rm[j] = rm[j + 1];
          r22[j] = r22[j + 1];
          r12[j] = r12[j + 1];
        }
        const float xa = sm.slot[(s0 + i) % NSLOT1][0][tid];
        const float xb = sm.slot[(s0 + i) % NSLOT1][1][tid];
        rm[K - 1] = xb;
        r22[K - 1] = xb * xb;
        r12[K - 1] = xa * xb;
        const int cq = tid % QUAD, cj = tid / QUAD;
        sm.v[i][0][cq][cj] = fir(taps.v, rm);
        sm.v[i][1][cq][cj] = fir(taps.v, r22);
        sm.v[i][2][cq][cj] = fir(taps.v, r12);
        sm.v[i][3][cq][cj] = rm[R];
      }
    }
    __syncthreads();

    // Stage B: QUAD adjacent outputs in each of a part of the group's rows.
    if (tid < B_THREADS) {
#pragma unroll 1
      for (int i = part; i < RG1; i += PARTS) {
        const int y = y0 - 2 * R + s0 + i;
        if (y < y0 || y >= y_end) continue;
        float mom[3][QUAD];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const float (&row)[QUAD][kQuarter] = sm.v[i][m];
          float x[K + QUAD - 1];
          x[0] = col<0>(row, q);
          x[1] = col<1>(row, q);
          x[2] = col<2>(row, q);
          x[3] = col<3>(row, q);
          x[4] = col<4>(row, q);
          x[5] = col<5>(row, q);
          x[6] = col<6>(row, q);
          x[7] = col<7>(row, q);
          x[8] = col<8>(row, q);
          x[9] = col<9>(row, q);
          x[10] = col<10>(row, q);
          x[11] = col<11>(row, q);
          x[12] = col<12>(row, q);
          x[13] = col<13>(row, q);
          x[14] = col<14>(row, q);
          x[15] = col<15>(row, q);
          x[16] = col<16>(row, q);
          x[17] = col<17>(row, q);
#pragma unroll
          for (int p = 0; p < QUAD; ++p) mom[m][p] = fir(taps.v, x + p);
        }
        const float x2c[QUAD] = {col<R>(sm.v[i][3], q), col<R + 1>(sm.v[i][3], q),
                                 col<R + 2>(sm.v[i][3], q), col<R + 3>(sm.v[i][3], q)};
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
      }
    }
    __syncthreads();
  }
  ce::cp_async_wait<0>();

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
    const double pixels = (double)h * w;
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
// segment; taps: 15 host floats.
extern "C" int ce_scale_features(const float* x1, const float* mu1, const float* s11,
                                 const float* x2, double* partial, int* counter, float* out,
                                 int n, int h, int w, int seg, const float* taps,
                                 void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || seg <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)n * 3 * ((w + ce::kStrip - 1) / ce::kStrip) *
                           ((h + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scale_features_kernel<<<(unsigned)blocks, ce::kStripThreads, 0, (cudaStream_t)stream>>>(
      x1, mu1, s11, x2, partial, counter, out, n, h, w, seg, ce::load_floats<K>(taps));
  return (int)cudaGetLastError();
}
