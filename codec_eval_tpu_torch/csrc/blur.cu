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
// reaches device memory, and b0 and the reciprocal plane are read once per
// tile and kept in registers while the block walks the batch.
//
// What bounds both on an H100: memory traffic.  Per output pixel K6 reads
// one input value, writes one, and reads the reciprocal plane that all
// planes share; it does 4k - 1 flops for k taps (51 at sigma 2.7), about 6
// flops per byte, under the card's f32 balance of ~20.  K7 adds three flops
// and, at B = 1, one more plane read.
//
// The simple design, after K3's chained FIR (freqsep.cu): one 64x32 output
// tile per block, its input tile and halo staged once in shared memory with
// zeros outside the image, the vertical pass kept in shared memory and the
// horizontal pass done per output pixel.  The radius is a template argument
// (one instantiation per radius 1..16), so the tap loops unroll and the taps
// stay in registers.  Taps add in order, t0*x0 first, and the library is
// built with -fmad=false, so both results equal the plain PyTorch versions
// bit for bit; K7 shares K6's tile code, so its b1 is K6's to the bit.
// The Pallas kernels' VMEM tile models and slab restaging have no
// counterpart here: a tile with its halo fits shared memory at any width.
#include "common.cuh"

namespace {

constexpr int TW = 64;
constexpr int TH = 32;
constexpr int kMaxRadius = 16;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
// Output pixels of a tile that each thread owns.
constexpr int kPerThread = TW * TH / ce::kThreads;

template <int R>
struct Tile {
  float s[TH + 2 * R][TW + 2 * R];  // the input tile with its halo
  float v[TH][TW + 2 * R];          // its vertical pass
};

// Stage one plane's tile (zeros outside the image) and run the vertical
// pass into t.v.  Ends with the block synchronized.
template <int R>
__device__ __forceinline__ void blur_tile_vertical(Tile<R>& t, const float* __restrict__ src,
                                                   int x0, int y0, int h, int w,
                                                   const float (&k)[2 * R + 1]) {
  constexpr int K = 2 * R + 1;
  constexpr int SW = TW + 2 * R;
  constexpr int SH = TH + 2 * R;
  for (int i = threadIdx.x; i < SH * SW; i += ce::kThreads) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 + sy - R, gx = x0 + sx - R;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    t.s[sy][sx] = inside ? src[(size_t)gy * w + gx] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TH * SW; i += ce::kThreads) {
    const int ty = i / SW, sx = i % SW;
    float acc = k[0] * t.s[ty][sx];
#pragma unroll
    for (int j = 1; j < K; ++j) acc = acc + k[j] * t.s[ty + j][sx];
    t.v[ty][sx] = acc;
  }
  __syncthreads();
}

// The horizontal pass at one output pixel of the tile, unnormalized.
template <int R>
__device__ __forceinline__ float blur_tile_horizontal(const Tile<R>& t, int ty, int tx,
                                                      const float (&k)[2 * R + 1]) {
  float acc = k[0] * t.v[ty][tx];
#pragma unroll
  for (int j = 1; j < 2 * R + 1; ++j) acc = acc + k[j] * t.v[ty][tx + j];
  return acc;
}

template <int R>
__device__ __forceinline__ void load_taps(float (&k)[2 * R + 1],
                                          const ce::Floats<kMaxTaps>& taps) {
#pragma unroll
  for (int i = 0; i < 2 * R + 1; ++i) k[i] = taps.v[i];
}

template <int R>
__global__ void __launch_bounds__(ce::kThreads)
blur_kernel(const float* __restrict__ in, const float* __restrict__ recip,
            float* __restrict__ out, int h, int w, ce::Floats<kMaxTaps> taps) {
  __shared__ Tile<R> t;
  float k[2 * R + 1];
  load_taps<R>(k, taps);
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  blur_tile_vertical<R>(t, in + (size_t)blockIdx.z * plane, x0, y0, h, w, k);

  float* dst = out + (size_t)blockIdx.z * plane;
  for (int i = threadIdx.x; i < TH * TW; i += ce::kThreads) {
    const int ty = i / TW, tx = i % TW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    dst[gi] = blur_tile_horizontal<R>(t, ty, tx, k) * recip[gi];
  }
}

template <int R>
__global__ void __launch_bounds__(ce::kThreads)
mask_diff_ac_kernel(const float* __restrict__ d1, const float* __restrict__ b0,
                    const float* __restrict__ recip, float* __restrict__ out, int b, int h,
                    int w, ce::Floats<kMaxTaps> taps, float ac_mul) {
  __shared__ Tile<R> t;
  float k[2 * R + 1];
  load_taps<R>(k, taps);
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;

  // This thread's pixels: pixel j is tile index threadIdx.x + j * kThreads.
  float b0r[kPerThread], rr[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * ce::kThreads;
    const int gy = y0 + i / TW, gx = x0 + i % TW;
    const bool inside = gy < h && gx < w;
    const size_t gi = (size_t)gy * w + gx;
    b0r[j] = inside ? b0[gi] : 0.f;
    rr[j] = inside ? recip[gi] : 0.f;
  }
  for (int n = 0; n < b; ++n) {
    blur_tile_vertical<R>(t, d1 + (size_t)n * plane, x0, y0, h, w, k);
    float* dst = out + (size_t)n * plane;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = threadIdx.x + j * ce::kThreads;
      const int ty = i / TW, tx = i % TW;
      const int gy = y0 + ty, gx = x0 + tx;
      if (gy >= h || gx >= w) continue;
      const float d = b0r[j] - blur_tile_horizontal<R>(t, ty, tx, k) * rr[j];
      dst[(size_t)gy * w + gx] = (ac_mul * d) * d;
    }
    // No barrier here: the horizontal pass reads only t.v, and the next
    // plane's vertical pass writes t.v after the staging barrier, which
    // every thread reaches only when this plane's pixels are done.
  }
}

bool valid_taps(int ntaps) { return ntaps >= 3 && ntaps <= kMaxTaps && ntaps % 2 == 1; }

template <int R>
cudaError_t launch_blur(const float* in, const float* recip, float* out, int n, int h, int w,
                        const ce::Floats<kMaxTaps>& taps, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  blur_kernel<R><<<grid, ce::kThreads, 0, stream>>>(in, recip, out, h, w, taps);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_mask(const float* d1, const float* b0, const float* recip, float* out,
                        int b, int h, int w, const ce::Floats<kMaxTaps>& taps, float ac_mul,
                        cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  mask_diff_ac_kernel<R><<<grid, ce::kThreads, 0, stream>>>(d1, b0, recip, out, b, h, w, taps,
                                                            ac_mul);
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

// planes, out: (n, h, w) with n = B * C; recip: (h, w); taps: ntaps host
// floats, ntaps odd and at most 33.
extern "C" int ce_blur(const float* planes, const float* recip, float* out, int n, int h,
                       int w, const float* taps, int ntaps, void* stream) {
  if (!valid_taps(ntaps)) return (int)cudaErrorInvalidValue;
  ce::Floats<kMaxTaps> t{};
  std::memcpy(t.v, taps, sizeof(float) * ntaps);
  const cudaStream_t s = (cudaStream_t)stream;
#define CE_BLUR(r) launch_blur<r>(planes, recip, out, n, h, w, t, s)
  CE_RADIUS_CASES(CE_BLUR)
#undef CE_BLUR
}

// d1, out: (b, h, w); b0, recip: (h, w); taps as for ce_blur.
extern "C" int ce_mask_diff_ac(const float* d1, const float* b0, const float* recip, float* out,
                               int b, int h, int w, const float* taps, int ntaps, float ac_mul,
                               void* stream) {
  if (!valid_taps(ntaps)) return (int)cudaErrorInvalidValue;
  ce::Floats<kMaxTaps> t{};
  std::memcpy(t.v, taps, sizeof(float) * ntaps);
  const cudaStream_t s = (cudaStream_t)stream;
#define CE_MASK(r) launch_mask<r>(d1, b0, recip, out, b, h, w, t, ac_mul, s)
  CE_RADIUS_CASES(CE_MASK)
#undef CE_MASK
}
