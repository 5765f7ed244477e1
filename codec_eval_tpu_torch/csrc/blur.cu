// K6: border-renormalized Gaussian blur of a batch of planes.
//
// Replaces codec_eval_tpu/kernels/pallas/blur.py:blur_batch_pallas:
// (B, C, H, W) f32 planes -> (B, C, H, W).  A zero-padded separable FIR with
// Butteraugli's unnormalized taps (any odd count up to 33, so radius up to
// 16: 13 taps at sigma 2.7, 33 at sigma 7.16), vertical pass first, times
// the (H, W) border-renormalization reciprocal plane.
//
// What bounds it on an H100: memory traffic.  Per output pixel it reads one
// input value, writes one, and reads the reciprocal plane that all planes
// share; it does 4k - 1 flops for k taps (51 at sigma 2.7), about 6 flops
// per byte, under the card's f32 balance of ~20.
//
// The simple design, after K3's chained FIR (freqsep.cu): one 64x32 output
// tile per block, its input tile and halo staged once in shared memory with
// zeros outside the image, the vertical pass kept in shared memory and the
// horizontal pass done per output pixel.  The radius is a template argument
// (one instantiation per radius 1..16), so the tap loops unroll and the taps
// stay in registers.  Taps add in order, t0*x0 first, and the library is
// built with -fmad=false, so the result equals the plain PyTorch version bit
// for bit.
#include "common.cuh"

namespace {

constexpr int TW = 64;
constexpr int TH = 32;
constexpr int kMaxRadius = 16;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;

template <int R>
__global__ void __launch_bounds__(ce::kThreads)
blur_kernel(const float* __restrict__ in, const float* __restrict__ recip,
            float* __restrict__ out, int h, int w, ce::Floats<kMaxTaps> taps) {
  constexpr int K = 2 * R + 1;
  constexpr int SW = TW + 2 * R;
  constexpr int SH = TH + 2 * R;
  __shared__ float s[SH][SW];
  __shared__ float v[TH][SW];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const float* src = in + (size_t)blockIdx.z * plane;

  float t[K];
#pragma unroll
  for (int i = 0; i < K; ++i) t[i] = taps.v[i];

  for (int i = tid; i < SH * SW; i += ce::kThreads) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 + sy - R, gx = x0 + sx - R;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    s[sy][sx] = inside ? src[(size_t)gy * w + gx] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < TH * SW; i += ce::kThreads) {
    const int ty = i / SW, sx = i % SW;
    float acc = t[0] * s[ty][sx];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + t[k] * s[ty + k][sx];
    v[ty][sx] = acc;
  }
  __syncthreads();

  float* dst = out + (size_t)blockIdx.z * plane;
  for (int i = tid; i < TH * TW; i += ce::kThreads) {
    const int ty = i / TW, tx = i % TW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    float acc = t[0] * v[ty][tx];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + t[k] * v[ty][tx + k];
    const size_t gi = (size_t)gy * w + gx;
    dst[gi] = acc * recip[gi];
  }
}

template <int R>
cudaError_t launch(const float* in, const float* recip, float* out, int n, int h, int w,
                   const ce::Floats<kMaxTaps>& taps, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  blur_kernel<R><<<grid, ce::kThreads, 0, stream>>>(in, recip, out, h, w, taps);
  return cudaGetLastError();
}

}  // namespace

// planes, out: (n, h, w) with n = B * C; recip: (h, w); taps: ntaps host
// floats, ntaps odd and at most 33.
extern "C" int ce_blur(const float* planes, const float* recip, float* out, int n, int h,
                       int w, const float* taps, int ntaps, void* stream) {
  if (ntaps < 3 || ntaps > kMaxTaps || ntaps % 2 == 0) return (int)cudaErrorInvalidValue;
  ce::Floats<kMaxTaps> t{};
  std::memcpy(t.v, taps, sizeof(float) * ntaps);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ntaps / 2) {
#define CE_BLUR_CASE(r) \
  case r:               \
    return (int)launch<r>(planes, recip, out, n, h, w, t, s);
    CE_BLUR_CASE(1) CE_BLUR_CASE(2) CE_BLUR_CASE(3) CE_BLUR_CASE(4)
    CE_BLUR_CASE(5) CE_BLUR_CASE(6) CE_BLUR_CASE(7) CE_BLUR_CASE(8)
    CE_BLUR_CASE(9) CE_BLUR_CASE(10) CE_BLUR_CASE(11) CE_BLUR_CASE(12)
    CE_BLUR_CASE(13) CE_BLUR_CASE(14) CE_BLUR_CASE(15) CE_BLUR_CASE(16)
#undef CE_BLUR_CASE
  }
  return (int)cudaErrorInvalidValue;
}
