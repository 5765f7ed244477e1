// The row-streamed strip walk that K1 (scale_features.cu), K9 (moments.cu)
// and K6/K7 (blur.cu) share: a zero-boundary separable blur of the moments
// of one plane, walked down a column strip.  The walk is a template on the
// radius RAD: K1 and K9 take the normalized sigma-1.5 Gaussian (R = 7, 15
// taps), K6 and K7 Butteraugli's unnormalized taps (radius 1..16).
//
// - A block owns a strip of kStrip = 128 output columns and a segment of
//   rows of one plane, and walks down the segment in groups of RG = 8 rows
//   (the wrappers choose the segment length).
// - Stage A: each of kStripThreads = 160 threads owns one column of the
//   strip grown by the radius (128 + 2 RAD, 142 for K1 and K9) and keeps
//   the moments of its last 2 RAD + 1 rows in registers, the products
//   formed once as a row arrives.  It writes the group's vertical sums to
//   shared memory, quarter-interleaved by column.
// - Stage B (the caller's): each of 128 threads takes four adjacent
//   outputs in a quarter of the group's rows; `horizontal_quad` reads
//   2 RAD + 4 values per moment and row (4.5 loads per output at R = 7)
//   and runs the horizontal pass.
// - cp.async copies each thread's column of the inputs a group of rows
//   ahead into a ring of rows, zero-filled outside the image; one wait per
//   group lets the compiler interleave the group's rows.  Two block
//   barriers per group.
//
// Four forms:
// - kFeatures (K1): inputs x1, x2; moments x2, x2*x2, x1*x2, and the centre
//   x2 for the edge maps;
// - kCandidate (K9): inputs x1, x2; moments x2, x2*x2, x1*x2;
// - kReference (K9's reference side): input x1; moments x1, x1*x1;
// - kBlur (K6, K7): input x1; the one moment x1 itself.
//
// Taps add in kernels/blur.py:fir_separable's order, t0*x0 first, then
// + tk*xk, vertical pass first; under -fmad=false every blur equals that
// plain version bit for bit.  No tap folding: it would change the rounding.
#pragma once

#include "common.cuh"

namespace ce {
namespace moments {

// The SSIM blur's radius, K1's and K9's walk.
constexpr int R = 7;
constexpr int K = 2 * R + 1;
// Stage B: each thread makes QUAD adjacent outputs from one run of loads.
constexpr int QUAD = 4;
constexpr int QUADS = kStrip / QUAD;
// A row of vertical sums in shared memory, column g at [g % QUAD][g / QUAD],
// so that thread j's loads of columns QUAD * j + m take one bank per lane.
// The quarters sit 40 floats apart (8 banks).
constexpr int kQuarter = 40;
// Rows per group; stage B's threads split a group's rows in PARTS
// interleaved parts.
constexpr int RG = 8;
constexpr int PARTS = 4;
constexpr int B_THREADS = PARTS * QUADS;
// The ring of input rows: a group read, a group in flight.
constexpr int NSLOT = 2 * RG;
constexpr int DIST = NSLOT - RG;  // rows copied ahead
static_assert(DIST == RG, "the ring holds two groups");
static_assert(B_THREADS <= kStripThreads && RG % PARTS == 0, "");

// The walk's widths at radius RAD: grown column g is x0 - RAD + g.
template <int RAD>
struct Radius {
  static constexpr int K = 2 * RAD + 1;  // taps
  static constexpr int G = kStrip + 2 * RAD;  // grown columns, one thread each
  static_assert(RAD >= 1 && G <= kStripThreads && G <= QUAD * kQuarter, "");
};

enum Form { kFeatures, kCandidate, kReference, kBlur };

template <int FORM>
struct Shape {
  static constexpr int inputs = FORM == kReference || FORM == kBlur ? 1 : 2;
  static constexpr int moments = FORM == kBlur ? 1 : FORM == kReference ? 2 : 3;
  static constexpr int rows = moments + (FORM == kFeatures ? 1 : 0);  // + K1's centre x2
};

using Row = float[QUAD][kQuarter];

template <int FORM, int RAD = R>
struct StripSmem {
  float slot[NSLOT][Shape<FORM>::inputs][Radius<RAD>::G];
  Row v[RG][Shape<FORM>::rows];  // per row of the group: vertical sums (and centre)
};

// Column QUAD * j + M of a row of vertical sums.
template <int M>
__device__ __forceinline__ float col(const Row& row, int j) {
  return row[M % QUAD][j + M / QUAD];
}

// The blur's order over N taps: t0*x0 first, then + tk*xk.
template <int N = K>
__device__ __forceinline__ float fir(const float* t, const float* x) {
  float acc = t[0] * x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) acc = acc + t[k] * x[k];
  return acc;
}

template <int N, int M = 0>
__device__ __forceinline__ void load_run(const Row& row, int j, float* x) {
  x[M] = col<M>(row, j);
  if constexpr (M + 1 < N) load_run<N, M + 1>(row, j, x);
}

// The horizontal pass of radius RAD at output columns QUAD * q ..
// QUAD * q + 3 of a row.
template <int RAD = R>
__device__ __forceinline__ void horizontal_quad(const Row& row, int q, const float* t,
                                                float (&out)[QUAD]) {
  constexpr int KR = Radius<RAD>::K;
  float x[KR + QUAD - 1];
  load_run<KR + QUAD - 1>(row, q, x);
#pragma unroll
  for (int p = 0; p < QUAD; ++p) out[p] = fir<KR>(t, x + p);
}

// Walk one block's segment: output rows [y0, y_end) of the strip at x0 of
// planes p1 (x1) and p2 (x2; unused by the one-input forms).  Step s reads
// input row r = y0 - RAD + s; stage A completes the vertical sums of row
// y = r - RAD.  Stage B calls emit(v, y) in threads tid < B_THREADS, where v
// holds row y's vertical sums (Shape<FORM>::rows of them); thread tid takes
// quad tid % QUADS of the rows tid / QUADS, tid / QUADS + PARTS, ...
template <int FORM, int RAD, class Emit>
__device__ __forceinline__ void strip_walk(StripSmem<FORM, RAD>& sm,
                                           const float* __restrict__ p1,
                                           const float* __restrict__ p2, int h, int w, int x0,
                                           int y0, int y_end, int seg,
                                           const Floats<Radius<RAD>::K>& taps, Emit&& emit) {
  constexpr int NM = Shape<FORM>::moments;
  constexpr int KR = Radius<RAD>::K, GR = Radius<RAD>::G;
  const int tid = threadIdx.x;
  const int gx = x0 - RAD + tid;
  const bool col_in = tid < GR && gx >= 0 && gx < w;
  // The copy of input row y0 - RAD + s (step s) into a slot.
  auto issue = [&](int s, float (*slot)[GR]) {
    if (tid < GR) {
      const int r = y0 - RAD + s;
      const bool in = col_in && r >= 0 && r < h;
      const size_t gi = in ? (size_t)r * w + gx : 0;
      cp_async4(&slot[0][tid], p1 + gi, in);
      if constexpr (Shape<FORM>::inputs == 2) cp_async4(&slot[1][tid], p2 + gi, in);
    }
    cp_async_commit();
  };

  float win[NM][KR];  // the moments of rows r - 2 RAD .. r
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int i = 0; i < KR; ++i) win[m][i] = 0.f;

  const int part = tid / QUADS;
  const int steps = seg + 2 * RAD;
  const int groups = (steps + RG - 1) / RG;
  // Step s's row goes to slot s % NSLOT: group grp reads the half
  // (grp & 1) of the ring and fills the other half.
#pragma unroll
  for (int s = 0; s < DIST; ++s) issue(s, sm.slot[s]);

#pragma unroll 1
  for (int grp = 0; grp < groups; ++grp) {
    const int s0 = grp * RG;
    const int read_half = (grp & 1) * RG, fill_half = RG - read_half;

    // Stage A: the vertical pass of one grown column, RG rows.
#pragma unroll
    for (int i = 0; i < RG; ++i) issue(s0 + i + DIST, sm.slot[fill_half + i]);
    cp_async_wait<DIST>();  // this group's rows are in
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      if (tid < GR) {
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int j = 0; j < KR - 1; ++j) win[m][j] = win[m][j + 1];
        const float xa = sm.slot[read_half + i][0][tid];
        if constexpr (FORM == kBlur) {
          win[0][KR - 1] = xa;
        } else if constexpr (FORM == kReference) {
          win[0][KR - 1] = xa;
          win[1][KR - 1] = xa * xa;
        } else {
          const float xb = sm.slot[read_half + i][1][tid];
          win[0][KR - 1] = xb;
          win[1][KR - 1] = xb * xb;
          win[2][KR - 1] = xa * xb;
        }
        const int cq = tid % QUAD, cj = tid / QUAD;
#pragma unroll
        for (int m = 0; m < NM; ++m) sm.v[i][m][cq][cj] = fir<KR>(taps.v, win[m]);
        if constexpr (FORM == kFeatures) sm.v[i][3][cq][cj] = win[0][RAD];
      }
    }
    __syncthreads();

    // Stage B: the caller's, at the group's output rows.
    if (tid < B_THREADS) {
#pragma unroll 1
      for (int i = part; i < RG; i += PARTS) {
        const int y = y0 - 2 * RAD + s0 + i;
        if (y < y0 || y >= y_end) continue;
        emit(sm.v[i], y);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

}  // namespace moments
}  // namespace ce
