// K9: the SSIM moments of a batch of pairs, candidate side and reference
// side.
//
// Replaces the Pallas kernel codec_eval_tpu/kernels/pallas/moments.py
// :candidate_moments_pallas.  For every (pair, channel) plane of x1 and x2
// the candidate form writes the zero-boundary sigma-1.5 blurs (15 taps)
// mu2 = blur(x2), s22 = blur(x2*x2) and s12 = blur(x1*x2).  Unlike K1, each
// pair brings its own x1: the masked scorer (kernels/masked.py) pads every
// pair of a bucket to one shape, and each has its own reference.  The
// reference form reads x1 alone and writes mu1 = blur(x1) and
// s11 = blur(x1*x1), the values the candidate form gives with x1 as both
// inputs, without reading x1 twice or writing an s12 that equals s11.
//
// What bounds it on an H100: instruction issue.  Per channel-pixel the
// candidate form reads 8 bytes and writes 12 (the reference form 4 and 8),
// and its three 15-tap blurs both ways take 176 operations (the reference
// form 117), each tap a multiply and an add under -fmad=false: with the
// halo columns and rows, ~200 issued instructions per channel-pixel, whose
// issue time at the card's rate is about its byte time.  The tiled design
// (one 32x16 tile per block, both passes from shared memory, ~100 shared
// accesses per channel-pixel) ran at 3x the byte bound; the strips run at
// ~2x, 20 warps per SM (92 registers).
//
// The design is K1's strip walk (moments.cuh, strip_walk): a block owns
// 128 output columns and a segment of rows of one (pair, channel) plane;
// stage A keeps the 15-row windows of the moments in registers, one grown
// column per thread; stage B is the horizontal pass, four adjacent outputs
// per thread, written with one 16-byte store per moment where the width
// allows.  cp.async copies the inputs a group of rows ahead.  The segment
// length comes from the launch (kernels/cuda/moments.py segment_rows): the
// longest of 128 to 16 rows whose grid still gives every SM 2.5 blocks.
// The outputs do not depend on it: no value crosses a block.  Blocks run
// strip fastest, so the column halos of neighbouring strips are read from
// L2.  Small launches (the pyramid's lower scales) take the tile walk
// below: there a block's latency sets the time, and a walk of 30 rows in
// row groups loses to one staging step.
// The Pallas kernel's 128-lane width padding, 8-row slab rounding and VMEM
// tile shrinking are TPU layout with no counterpart: the walk masks the
// ragged edge.
#include <cstdint>

#include "moments.cuh"

using namespace ce::moments;

namespace {

// Block: one (strip, plane, segment), strip fastest.  Stage B writes the
// NM blurred moments of its quad of columns at each of its output rows.
template <int FORM>
__global__ void __launch_bounds__(ce::kStripThreads, 4)
candidate_moments_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                         float* __restrict__ out, int planes, int h, int w, int seg,
                         ce::Floats<K> taps) {
  constexpr int NM = Shape<FORM>::moments;
  __shared__ StripSmem<FORM> sm;
  const int strips = (w + ce::kStrip - 1) / ce::kStrip;
  const int strip = blockIdx.x % strips;
  const int p = blockIdx.x / strips % planes;
  const int segment = blockIdx.x / strips / planes;
  const int x0 = strip * ce::kStrip, y0 = segment * seg;
  const int y_end = min(y0 + seg, h), x_end = min(x0 + ce::kStrip, w);
  const size_t plane = (size_t)h * w, base = (size_t)p * plane, total = (size_t)planes * plane;
  const int gx = x0 + QUAD * (threadIdx.x % QUADS);  // stage B: this thread's first column
  const bool vec = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                   gx + QUAD <= x_end;
  const float* p1 = x1 + base;
  const float* p2 = (FORM == kReference ? x1 : x2) + base;

  strip_walk<FORM>(sm, p1, p2, h, w, x0, y0, y_end, seg, taps,
                   [&](const Row (&v)[NM], int y) {
    float* row = out + base + (size_t)y * w + gx;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float o[QUAD];
      horizontal_quad(v[m], threadIdx.x % QUADS, taps.v, o);
      float* dst = row + m * total;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int i = 0; i < QUAD; ++i)
          if (gx + i < x_end) dst[i] = o[i];
      }
    }
  });
}

// The tile walk, for small launches: one 32x16 output tile per block, the
// inputs staged once with a 7-pixel zero halo in shared memory, the
// products formed in registers, the vertical pass kept in shared memory
// and the horizontal pass done per output pixel.  Each blur adds its taps
// in the same order as the strip walk, so both equal the plain version.
constexpr int TW = 32;
constexpr int TH = 16;
constexpr int SW = TW + 2 * R;
constexpr int SH = TH + 2 * R;

template <int FORM>
__global__ void __launch_bounds__(ce::kThreads)
moments_tile_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                    float* __restrict__ out, int h, int w, ce::Floats<K> taps) {
  constexpr int NM = Shape<FORM>::moments;
  constexpr bool two = Shape<FORM>::inputs == 2;
  __shared__ float a[SH][SW];              // x1 tile + halo
  __shared__ float b[two ? SH : 1][SW];    // x2 tile + halo
  __shared__ float v[NM][TH][SW];          // vertical blurs of the moments
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w, base = (size_t)blockIdx.z * plane;
  const size_t total = (size_t)gridDim.z * plane;
  for (int i = threadIdx.x; i < SH * SW; i += ce::kThreads) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 + sy - R, gx = x0 + sx - R;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t gi = base + (size_t)gy * w + gx;
    a[sy][sx] = in ? x1[gi] : 0.f;
    if constexpr (two) b[sy][sx] = in ? x2[gi] : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TH * SW; i += ce::kThreads) {
    const int ty = i / SW, sx = i % SW;
    float acc[NM];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float xa = a[ty + k][sx];
      float mom[NM];
      if constexpr (two) {
        const float xb = b[ty + k][sx];
        mom[0] = xb;
        mom[1] = xb * xb;
        mom[NM - 1] = xa * xb;
      } else {
        mom[0] = xa;
        mom[1] = xa * xa;
      }
#pragma unroll
      for (int m = 0; m < NM; ++m) acc[m] = k ? acc[m] + taps.v[k] * mom[m] : taps.v[0] * mom[m];
    }
#pragma unroll
    for (int m = 0; m < NM; ++m) v[m][ty][sx] = acc[m];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TH * TW; i += ce::kThreads) {
    const int ty = i / TW, tx = i % TW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    const size_t gi = base + (size_t)gy * w + gx;
#pragma unroll
    for (int m = 0; m < NM; ++m) out[m * total + gi] = fir(taps.v, &v[m][ty][tx]);
  }
}

// The walk argument of the entry points (kernels/cuda/moments.py
// STRIP_WALK, TILE_WALK): the wrapper picks it by the launch's size.
enum Walk : int { kStripWalk = 0, kTileWalk = 1 };

// The strip walk takes segments of seg rows; the tile walk ignores seg.
template <int FORM>
int launch(const float* x1, const float* x2, float* out, int planes, int h, int w, int walk,
           int seg, const float* taps, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const auto t = ce::load_floats<K>(taps);
  if (walk == kTileWalk) {
    if (planes > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, planes);
    moments_tile_kernel<FORM><<<grid, ce::kThreads, 0, (cudaStream_t)stream>>>(
        x1, x2, out, h, w, t);
    return (int)cudaGetLastError();
  }
  if (walk != kStripWalk || seg <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)planes * ((w + ce::kStrip - 1) / ce::kStrip) *
                           ((h + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  candidate_moments_kernel<FORM><<<(unsigned)blocks, ce::kStripThreads, 0,
                                   (cudaStream_t)stream>>>(x1, x2, out, planes, h, w, seg, t);
  return (int)cudaGetLastError();
}

}  // namespace

// x1, x2: (planes, h, w) with planes = pairs * 3; out: (3, planes, h, w),
// mu2 then s22 then s12; walk: a Walk; seg: rows per segment of the strip
// walk; taps: 15 host floats.
extern "C" int ce_candidate_moments(const float* x1, const float* x2, float* out, int planes,
                                    int h, int w, int walk, int seg, const float* taps,
                                    void* stream) {
  return launch<kCandidate>(x1, x2, out, planes, h, w, walk, seg, taps, stream);
}

// x1: (planes, h, w); out: (2, planes, h, w), mu1 then s11; walk, seg and
// taps as above.
extern "C" int ce_reference_moments(const float* x1, float* out, int planes, int h, int w,
                                    int walk, int seg, const float* taps, void* stream) {
  return launch<kReference>(x1, x1, out, planes, h, w, walk, seg, taps, stream);
}
