// K6: border-renormalized Gaussian blur of a batch of planes, and
// K7: the same blur with Butteraugli's candidate-side masking epilogue.
//
// K6 replaces codec_eval_tpu/kernels/pallas/blur.py:blur_batch_pallas:
// (B, C, H, W) f32 planes -> (B, C, H, W).  A zero-padded separable FIR with
// Butteraugli's unnormalized taps (any odd count up to 33, so radius up to
// 16: 13 taps at sigma 2.7, 33 at sigma 7.16), vertical pass first, times
// the (H, W) border-renormalization reciprocal plane.
//
// K7 replaces codec_eval_tpu/kernels/pallas/maskac.py:mask_diff_ac_batch_pallas:
// (B, H, W) d1 and the reference's (H, W) blur b0 -> (B, H, W)
// ac_mul * (b0 - b1) * (b0 - b1), b1 being K6's blur of d1.  b1 never
// reaches device memory.
//
// What bounds both on an H100: memory traffic.  Per output pixel K6 reads
// one input value, writes one, and reads the reciprocal plane that all
// planes share; it does 4k - 1 flops for k taps (51 at sigma 2.7), about 6
// flops per byte, under the card's f32 balance of ~20.  K7 adds three flops
// and, at B = 1, one more plane read.
//
// The design is K1's and K9's row-streamed strip walk (moments.cuh,
// strip_walk, form kBlur) at the blur's radius: a block owns 128 output
// columns and a segment of rows of one plane; stage A keeps each grown
// column's last 2R + 1 input rows in registers and writes the group's
// vertical sums to shared memory; stage B runs the horizontal pass at four
// adjacent outputs per thread (2R + 4 shared loads), multiplies by the
// reciprocal plane (and, for K7, forms the mask term against b0), and
// writes the four results with one 16-byte store where the row allows.
// cp.async copies the input a group of rows ahead, and each stage-B thread
// loads the reciprocal (and b0) of its next output row with one 16-byte
// load as it finishes a row, so that load is in flight across the next
// stage A instead of stalling stage B.  By a count of the code, ~85 issued
// instructions per pixel at sigma 2.7, 51 of them the taps (a multiply and
// an add each) and the product.
// Blocks run strip fastest, then plane, then segment, so the planes of one
// segment read the reciprocal plane (and b0) from L2.  The segment length
// comes from the launch (kernels/cuda/blur.py segment_rows); no value
// crosses a block, so the outputs do not depend on it.  The radius is a
// template argument (one instantiation per radius 1..16), so the tap loops
// unroll and the taps stay in the kernel's parameter space.  Taps add in
// order, t0*x0 first, and the library is built with -fmad=false, so both
// kernels equal the plain PyTorch versions bit for bit; K7 runs K6's walk
// and product, so its b1 is K6's to the bit.
// The Pallas kernels' VMEM tile models and slab restaging have no
// counterpart here: the walk masks the ragged edge.
#include <cstdint>

#include "moments.cuh"

using namespace ce::moments;

namespace {

constexpr int kMaxRadius = 16;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
static_assert(Radius<kMaxRadius>::G <= ce::kStripThreads, "the walk takes radius 16");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The four values of plane p at row offset `at`: one 16-byte load, or
// scalar loads of the columns left of x_end.
__device__ __forceinline__ void load_quad(const float* __restrict__ p, size_t at, bool vec,
                                          int n, float (&v)[QUAD]) {
  if (vec) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p + at));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < QUAD; ++i) v[i] = i < n ? __ldg(p + at + i) : 0.f;
  }
}

// One block of K6 (MASK false) or K7 (MASK true): the strip walk of one
// (strip, plane, segment), strip fastest.  Stage B writes, at its quad of
// columns, the blur times the reciprocal, or K7's mask term of it.  The
// walk hands this thread the output rows y, y + PARTS, y + 2 PARTS, ... in
// order, so each row's reciprocal (and b0) is loaded one row ahead, into
// registers, and arrives while the walk runs the next group's stage A.
template <int RAD, bool MASK>
__device__ __forceinline__ void blur_block(StripSmem<kBlur, RAD>& sm,
                                           const float* __restrict__ in,
                                           const float* __restrict__ b0,
                                           const float* __restrict__ recip,
                                           float* __restrict__ out, int planes, int h, int w,
                                           int seg, const ce::Floats<Radius<RAD>::K>& taps,
                                           float ac_mul) {
  const int strips = (w + ce::kStrip - 1) / ce::kStrip;
  const int strip = blockIdx.x % strips;
  const int p = blockIdx.x / strips % planes;
  const int segment = blockIdx.x / strips / planes;
  const int x0 = strip * ce::kStrip, y0 = segment * seg;
  const int y_end = min(y0 + seg, h), x_end = min(x0 + ce::kStrip, w);
  const size_t base = (size_t)p * h * w;
  const int q = threadIdx.x % QUADS;
  const int gx = x0 + QUAD * q;  // stage B: this thread's first column
  const int n = x_end - gx;      // of which columns gx .. x_end - 1 are in the image
  const bool vec = (w & 3) == 0 && n >= QUAD && aligned16(out) && aligned16(recip) &&
                   (!MASK || aligned16(b0));
  const float* src = in + base;

  // This thread's first output row: the walk's rows y0 - 2 RAD + PARTS k +
  // part, from y0 on.
  const int part = threadIdx.x / QUADS;
  float r[QUAD] = {}, c[QUAD] = {};
  auto fetch = [&](int y) {
    if (n > 0 && y < y_end) {
      const size_t at = (size_t)y * w + gx;
      load_quad(recip, at, vec, n, r);
      if constexpr (MASK) load_quad(b0, at, vec, n, c);
    }
  };
  fetch(y0 + ((part - 2 * RAD) % PARTS + PARTS) % PARTS);

  strip_walk<kBlur>(sm, src, src, h, w, x0, y0, y_end, seg, taps,
                    [&](const Row (&v)[1], int y) {
    if (n <= 0) return;
    float o[QUAD];
    horizontal_quad<RAD>(v[0], q, taps.v, o);
    const size_t at = (size_t)y * w + gx;
#pragma unroll
    for (int i = 0; i < QUAD; ++i) o[i] = o[i] * r[i];
    if constexpr (MASK) {
#pragma unroll
      for (int i = 0; i < QUAD; ++i) {
        const float d = c[i] - o[i];
        o[i] = (ac_mul * d) * d;
      }
    }
    fetch(y + PARTS);
    float* dst = out + base + at;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int i = 0; i < QUAD; ++i)
        if (i < n) dst[i] = o[i];
    }
  });
}

template <int RAD>
__global__ void __launch_bounds__(ce::kStripThreads, 4)
blur_kernel(const float* __restrict__ in, const float* __restrict__ recip,
            float* __restrict__ out, int planes, int h, int w, int seg,
            ce::Floats<Radius<RAD>::K> taps) {
  __shared__ StripSmem<kBlur, RAD> sm;
  blur_block<RAD, false>(sm, in, nullptr, recip, out, planes, h, w, seg, taps, 0.f);
}

template <int RAD>
__global__ void __launch_bounds__(ce::kStripThreads, 4)
mask_diff_ac_kernel(const float* __restrict__ d1, const float* __restrict__ b0,
                    const float* __restrict__ recip, float* __restrict__ out, int planes, int h,
                    int w, int seg, ce::Floats<Radius<RAD>::K> taps, float ac_mul) {
  __shared__ StripSmem<kBlur, RAD> sm;
  blur_block<RAD, true>(sm, d1, b0, recip, out, planes, h, w, seg, taps, ac_mul);
}

// The grid of a launch: strips x planes x segments, or 0 if it is empty or
// too large.
unsigned grid_blocks(int planes, int h, int w, int seg) {
  if (planes <= 0 || h <= 0 || w <= 0 || seg <= 0) return 0;
  const long long blocks = (long long)planes * ((w + ce::kStrip - 1) / ce::kStrip) *
                           ((h + seg - 1) / seg);
  return blocks > 0x7fffffffLL ? 0 : (unsigned)blocks;
}

bool valid_taps(int ntaps) { return ntaps >= 3 && ntaps <= kMaxTaps && ntaps % 2 == 1; }

template <int RAD>
cudaError_t launch_blur(const float* in, const float* recip, float* out, int planes, int h,
                        int w, int seg, const float* taps, unsigned blocks, cudaStream_t stream) {
  blur_kernel<RAD><<<blocks, ce::kStripThreads, 0, stream>>>(
      in, recip, out, planes, h, w, seg, ce::load_floats<Radius<RAD>::K>(taps));
  return cudaGetLastError();
}

template <int RAD>
cudaError_t launch_mask(const float* d1, const float* b0, const float* recip, float* out,
                        int planes, int h, int w, int seg, const float* taps, float ac_mul,
                        unsigned blocks, cudaStream_t stream) {
  mask_diff_ac_kernel<RAD><<<blocks, ce::kStripThreads, 0, stream>>>(
      d1, b0, recip, out, planes, h, w, seg, ce::load_floats<Radius<RAD>::K>(taps), ac_mul);
  return cudaGetLastError();
}

}  // namespace

#define CE_RADIUS_CASES(CALL)                                           \
  switch (ntaps / 2) {                                                  \
    case 1: return (int)CALL(1);   case 2: return (int)CALL(2);         \
    case 3: return (int)CALL(3);   case 4: return (int)CALL(4);         \
    case 5: return (int)CALL(5);   case 6: return (int)CALL(6);         \
    case 7: return (int)CALL(7);   case 8: return (int)CALL(8);         \
    case 9: return (int)CALL(9);   case 10: return (int)CALL(10);       \
    case 11: return (int)CALL(11); case 12: return (int)CALL(12);       \
    case 13: return (int)CALL(13); case 14: return (int)CALL(14);       \
    case 15: return (int)CALL(15); case 16: return (int)CALL(16);       \
  }                                                                     \
  return (int)cudaErrorInvalidValue;

// planes, out: (n, h, w) with n = B * C; recip: (h, w); seg: rows per
// segment; taps: ntaps host floats, ntaps odd and at most 33.
extern "C" int ce_blur(const float* planes, const float* recip, float* out, int n, int h,
                       int w, int seg, const float* taps, int ntaps, void* stream) {
  const unsigned blocks = grid_blocks(n, h, w, seg);
  if (!blocks || !valid_taps(ntaps)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define CE_BLUR(r) launch_blur<r>(planes, recip, out, n, h, w, seg, taps, blocks, s)
  CE_RADIUS_CASES(CE_BLUR)
#undef CE_BLUR
}

// d1, out: (b, h, w); b0, recip: (h, w); seg and taps as for ce_blur.
extern "C" int ce_mask_diff_ac(const float* d1, const float* b0, const float* recip, float* out,
                               int b, int h, int w, int seg, const float* taps, int ntaps,
                               float ac_mul, void* stream) {
  const unsigned blocks = grid_blocks(b, h, w, seg);
  if (!blocks || !valid_taps(ntaps)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define CE_MASK(r) launch_mask<r>(d1, b0, recip, out, b, h, w, seg, taps, ac_mul, blocks, s)
  CE_RADIUS_CASES(CE_MASK)
#undef CE_MASK
}
