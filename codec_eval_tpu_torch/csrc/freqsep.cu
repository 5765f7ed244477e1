// K2 and K3: Butteraugli opsin dynamics and band separation, batched.
//
// K2 replaces codec_eval_tpu/kernels/pallas/freqsep.py:opsin_xyb_batch_pallas:
// intensity-scaled linear RGB (B, 3, H, W) -> opponent XYB (B, 3, H, W).
// A sigma-1.2 surround blur (5 unnormalized taps, zero padding) times the
// border-renormalization reciprocal, the 3x3 absorbance mix + bias, the
// FastLog2f gamma, the sensitivity and the opponent transform.
//
// K3 replaces codec_eval_tpu/kernels/pallas/freqsep.py:bands_batch_pallas:
// (XYB, LF) (B, 3, H, W) -> 7 band planes (B, 7, H, W) in the order uhf_x,
// uhf_y, hf_x, hf_y, mf_x, mf_y, mf_b.  A renormalized sigma-3.22 blur
// (15 taps) of mf = XYB - LF, then a renormalized sigma-1.56 blur (7 taps)
// of the red-green-suppressed residual, then the range reshaping.
//
// What bounds them on an H100: memory traffic and latency.  Both are
// stencils with a few dozen flops per tap and pixel, well under the card's
// flop/byte balance; K3 chains two blurs, so its input halo compounds to
// 7 + 3 = 10 pixels.
//
// The simple design: one 32x16 output tile per block, its input tile and
// halo staged once in shared memory, the vertical pass of each blur kept in
// shared memory and the horizontal pass done per output pixel.  K3's first
// blur is evaluated on the output tile grown by the second blur's radius,
// so the residual never goes to device memory; its 52 KB of shared memory
// is above the 48 KB static limit and is taken as dynamic shared memory.
// The renormalization reciprocals arrive as precomputed (H, W) planes, the
// same f32 values the Pallas kernels used.  The library is built with
// -fmad=false, and an explicit fmaf stands exactly where XLA contracts a
// multiply-add in the JAX package (tap chains, the absorbance mix, the
// gamma polynomial, the residuals, the maximum clamp), so the outputs match
// the plain PyTorch version, and the Pallas kernel as JAX runs it on the
// CPU, bit for bit.
#include "common.cuh"

namespace {

constexpr int TW = 32;
constexpr int TH = 16;

__device__ __forceinline__ float fast_log2(float x) {
  const int bits = __float_as_int(x);
  const int e = bits - 0x3F2AAAAB;
  const int ex = e >> 23;  // arithmetic shift, as in FastLog2f
  const float mant = __int_as_float(bits - (ex << 23));
  const float m = mant - 1.0f;
  const float p = fmaf(fmaf(0.74245876f, m, 1.4287161f), m, -1.8503833e-06f);
  const float q = fmaf(fmaf(0.17409343f, m, 1.0096718f), m, 0.99032813f);
  return p / q + (float)ex;
}

// ---------------------------------------------------------------- K2: opsin

constexpr int OR = 2;  // radius of the sigma-1.2 surround blur
constexpr int OK = 2 * OR + 1;
constexpr int OSW = TW + 2 * OR;
constexpr int OSH = TH + 2 * OR;

// consts: m00..m22, bias0..2, gamma mul, gamma offset, gamma sub.
__global__ void __launch_bounds__(ce::kThreads)
opsin_kernel(const float* __restrict__ lin, const float* __restrict__ recip,
             float* __restrict__ out, int h, int w, ce::Floats<15> k, ce::Floats<OK> taps) {
  __shared__ float s[3][OSH][OSW];
  __shared__ float v[3][TH][OSW];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const float* src = lin + (size_t)blockIdx.z * 3 * plane;
  float* dst = out + (size_t)blockIdx.z * 3 * plane;

  for (int i = tid; i < 3 * OSH * OSW; i += ce::kThreads) {
    const int c = i / (OSH * OSW), r = i % (OSH * OSW);
    const int sy = r / OSW, sx = r % OSW;
    const int gy = y0 + sy - OR, gx = x0 + sx - OR;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    s[c][sy][sx] = in ? src[c * plane + (size_t)gy * w + gx] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < 3 * TH * OSW; i += ce::kThreads) {
    const int c = i / (TH * OSW), r = i % (TH * OSW);
    const int ty = r / OSW, sx = r % OSW;
    float acc = fmaf(taps.v[0], s[c][ty][sx], taps.v[1] * s[c][ty + 1][sx]);
#pragma unroll
    for (int t = 2; t < OK; ++t) acc = fmaf(taps.v[t], s[c][ty + t][sx], acc);
    v[c][ty][sx] = acc;
  }
  __syncthreads();

  const float* m = k.v;
  for (int i = tid; i < TH * TW; i += ce::kThreads) {
    const int ty = i / TW, tx = i % TW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    const float rn = recip[gi];
    float bl[3], ct[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = fmaf(taps.v[0], v[c][ty][tx], taps.v[1] * v[c][ty][tx + 1]);
#pragma unroll
      for (int t = 2; t < OK; ++t) acc = fmaf(taps.v[t], v[c][ty][tx + t], acc);
      bl[c] = acc * rn;
      ct[c] = s[c][ty + OR][tx + OR];
    }
    float xyb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float bias = m[9 + c];
      const float pre = fmaf(m[3 * c + 2], bl[2], fmaf(m[3 * c], bl[0], m[3 * c + 1] * bl[1])) + bias;
      const float cur = fmaf(m[3 * c + 2], ct[2], fmaf(m[3 * c], ct[0], m[3 * c + 1] * ct[1])) + bias;
      const float p = fmaxf(fmaxf(pre, bias), 1e-4f);
      const float gamma = fmaf(m[12], fast_log2(fmaxf(p, 0.f) + m[13]), -m[14]);
      const float sens = fmaxf(gamma / p, 1e-4f);
      xyb[c] = fmaxf(cur * sens, bias);
    }
    dst[gi] = xyb[0] - xyb[1];
    dst[plane + gi] = xyb[0] + xyb[1];
    dst[2 * plane + gi] = xyb[2];
  }
}

// ---------------------------------------------------------------- K3: bands

constexpr int R1 = 7;  // sigma-3.22 blur radius
constexpr int R2 = 3;  // sigma-1.56 blur radius
constexpr int K1 = 2 * R1 + 1;
constexpr int K2 = 2 * R2 + 1;
constexpr int HALO = R1 + R2;
constexpr int IW = TW + 2 * HALO, IH = TH + 2 * HALO;  // input tile
constexpr int MW = TW + 2 * R2, MH = TH + 2 * R2;      // first blur's extent
// Shared-memory layout, in floats.
constexpr int S_IN = 3 * IH * IW;     // mf = xyb - lf, zero outside the image
constexpr int S_V1 = 3 * MH * IW;     // first blur, vertical pass (reused by the second)
constexpr int S_HF = 2 * MH * MW;     // suppressed residual, X and Y
constexpr int S_CTR = 5 * TH * TW;    // at the output pixels: MF blurs X/Y/B, residual X, suppression
constexpr size_t kBandsSmem = sizeof(float) * (S_IN + S_V1 + S_HF + S_CTR);

__device__ __forceinline__ float remove_range(float v, float w) {
  return v > w ? v - w : (v < -w ? v + w : 0.f);
}
__device__ __forceinline__ float amplify_range(float v, float w) {
  return v > w ? v + w : (v < -w ? v - w : 2.f * v);
}
__device__ __forceinline__ float maximum_clamp(float v, float m, float mul) {
  return v >= m ? fmaf(v - m, mul, m) : (v < -m ? fmaf(v + m, mul, -m) : v);
}

// consts: mf_x_remove, mf_y_amplify, uhf_x_remove, hf_x_remove, suppress_yw,
// suppress_s, maxclamp_hf, maxclamp_uhf, maxclamp_mul, uhf_y_mul, hf_y_mul,
// hf_y_amplify, (1 - suppress_s) * suppress_yw.
__global__ void __launch_bounds__(ce::kThreads)
bands_kernel(const float* __restrict__ xyb, const float* __restrict__ lf,
             const float* __restrict__ recip1, const float* __restrict__ recip2,
             float* __restrict__ out, int h, int w, ce::Floats<13> k,
             ce::Floats<K1> t1, ce::Floats<K2> t2) {
  extern __shared__ float smem[];
  float (*in)[IH][IW] = reinterpret_cast<float (*)[IH][IW]>(smem);
  float (*v1)[MH][IW] = reinterpret_cast<float (*)[MH][IW]>(smem + S_IN);
  float (*hf)[MH][MW] = reinterpret_cast<float (*)[MH][MW]>(smem + S_IN + S_V1);
  float (*ctr)[TH][TW] = reinterpret_cast<float (*)[TH][TW]>(smem + S_IN + S_V1 + S_HF);
  float (*v2)[TH][MW] = reinterpret_cast<float (*)[TH][MW]>(smem + S_IN);  // after v1 is done

  const float mf_x_remove = k.v[0], mf_y_amplify = k.v[1], uhf_x_remove = k.v[2];
  const float hf_x_remove = k.v[3], suppress_yw = k.v[4], suppress_s = k.v[5];
  const float maxclamp_hf = k.v[6], maxclamp_uhf = k.v[7], maxclamp_mul = k.v[8];
  const float uhf_y_mul = k.v[9], hf_y_mul = k.v[10], hf_y_amplify = k.v[11];
  const float suppress_num = k.v[12];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const size_t base = (size_t)blockIdx.z * 3 * plane;

  for (int i = tid; i < S_IN; i += ce::kThreads) {
    const int c = i / (IH * IW), r = i % (IH * IW);
    const int sy = r / IW, sx = r % IW;
    const int gy = y0 + sy - HALO, gx = x0 + sx - HALO;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t gi = base + c * plane + (size_t)gy * w + gx;
    in[c][sy][sx] = inside ? xyb[gi] - lf[gi] : 0.f;
  }
  __syncthreads();

  // First blur, vertical pass, on rows of the grown extent.
  for (int i = tid; i < S_V1; i += ce::kThreads) {
    const int c = i / (MH * IW), r = i % (MH * IW);
    const int my = r / IW, sx = r % IW;
    float acc = fmaf(t1.v[0], in[c][my][sx], t1.v[1] * in[c][my + 1][sx]);
#pragma unroll
    for (int t = 2; t < K1; ++t) acc = fmaf(t1.v[t], in[c][my + t][sx], acc);
    v1[c][my][sx] = acc;
  }
  __syncthreads();

  // First blur, horizontal pass: the suppressed residual on the grown
  // extent, and the MF bands at the output pixels.
  for (int i = tid; i < MH * MW; i += ce::kThreads) {
    const int my = i / MW, mx = i % MW;
    const int gy = y0 + my - R2, gx = x0 + mx - R2;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const float rn = inside ? recip1[(size_t)gy * w + gx] : 0.f;
    const bool center = my >= R2 && my < R2 + TH && mx >= R2 && mx < R2 + TW;
    float fir[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c == 2 && !center) break;
      float acc = fmaf(t1.v[0], v1[c][my][mx], t1.v[1] * v1[c][my][mx + 1]);
#pragma unroll
      for (int t = 2; t < K1; ++t) acc = fmaf(t1.v[t], v1[c][my][mx + t], acc);
      fir[c] = acc;
    }
    const float h0 = fmaf(-fir[0], rn, in[0][my + R1][mx + R1]);
    const float h1 = fmaf(-fir[1], rn, in[1][my + R1][mx + R1]);
    const float suppress = suppress_s + suppress_num / fmaf(h1, h1, suppress_yw);
    hf[0][my][mx] = h0 * suppress;
    hf[1][my][mx] = h1;
    if (center) {
#pragma unroll
      for (int c = 0; c < 3; ++c) ctr[c][my - R2][mx - R2] = fir[c] * rn;
      ctr[3][my - R2][mx - R2] = h0;
      ctr[4][my - R2][mx - R2] = suppress;
    }
  }
  __syncthreads();

  // Second blur, vertical pass (reuses the first blur's buffer).
  for (int i = tid; i < 2 * TH * MW; i += ce::kThreads) {
    const int c = i / (TH * MW), r = i % (TH * MW);
    const int ty = r / MW, mx = r % MW;
    float acc = fmaf(t2.v[0], hf[c][ty][mx], t2.v[1] * hf[c][ty + 1][mx]);
#pragma unroll
    for (int t = 2; t < K2; ++t) acc = fmaf(t2.v[t], hf[c][ty + t][mx], acc);
    v2[c][ty][mx] = acc;
  }
  __syncthreads();

  float* dst = out + (size_t)blockIdx.z * 7 * plane;
  for (int i = tid; i < TH * TW; i += ce::kThreads) {
    const int ty = i / TW, tx = i % TW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    const float rn = recip2[gi];
    float hb[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float acc = fmaf(t2.v[0], v2[c][ty][tx], t2.v[1] * v2[c][ty][tx + 1]);
#pragma unroll
      for (int t = 2; t < K2; ++t) acc = fmaf(t2.v[t], v2[c][ty][tx + t], acc);
      hb[c] = acc * rn;
    }
    const float hc1 = hf[1][ty + R2][tx + R2];
    const float hfc = maximum_clamp(hb[1], maxclamp_hf, maxclamp_mul);
    dst[gi] = remove_range(fmaf(ctr[3][ty][tx], ctr[4][ty][tx], -hb[0]), uhf_x_remove);
    dst[plane + gi] = maximum_clamp(hc1 - hfc, maxclamp_uhf, maxclamp_mul) * uhf_y_mul;
    dst[2 * plane + gi] = remove_range(hb[0], hf_x_remove);
    dst[3 * plane + gi] = amplify_range(hfc * hf_y_mul, hf_y_amplify);
    dst[4 * plane + gi] = remove_range(ctr[0][ty][tx], mf_x_remove);
    dst[5 * plane + gi] = amplify_range(ctr[1][ty][tx], mf_y_amplify);
    dst[6 * plane + gi] = ctr[2][ty][tx];
  }
}

}  // namespace

// lin, out: (b, 3, h, w); recip: (h, w); consts: 15 host floats; taps: 5.
extern "C" int ce_opsin_xyb(const float* lin, const float* recip, float* out, int b,
                            int h, int w, const float* consts, const float* taps,
                            void* stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  opsin_kernel<<<grid, ce::kThreads, 0, (cudaStream_t)stream>>>(
      lin, recip, out, h, w, ce::load_floats<15>(consts), ce::load_floats<OK>(taps));
  return (int)cudaGetLastError();
}

// xyb, lf: (b, 3, h, w); recip332, recip156: (h, w); out: (b, 7, h, w);
// consts: 13 host floats; taps332: 15; taps156: 7.
extern "C" int ce_bands(const float* xyb, const float* lf, const float* recip332,
                        const float* recip156, float* out, int b, int h, int w,
                        const float* consts, const float* taps332, const float* taps156,
                        void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bands_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBandsSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  bands_kernel<<<grid, ce::kThreads, kBandsSmem, (cudaStream_t)stream>>>(
      xyb, lf, recip332, recip156, out, h, w, ce::load_floats<13>(consts),
      ce::load_floats<K1>(taps332), ce::load_floats<K2>(taps156));
  return (int)cudaGetLastError();
}
