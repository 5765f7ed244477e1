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
// What bounds them on an H100: memory traffic.  Both are stencils with a
// few dozen flops per tap and pixel, under the card's flop/byte balance.
// K2 keeps the simple design: one 32x16 output tile per block, its input
// tile and 2-pixel halo staged once in shared memory, the vertical pass
// kept in shared memory and the horizontal pass done per output pixel.
//
// K3 chains two blurs, so its input halo compounds to 7 + 3 = 10 pixels.
// Tiled in 32x16 blocks, that staged 3.7x the output area and cost about
// 230 shared-memory accesses per output pixel.  The design (row-streamed
// column strips):
// - A block owns a strip of 128 output columns and a segment of rows of one
//   image, and walks down the segment in groups of RG3 = 4 rows.  Input is
//   read at 148/128 across and (segment + 20)/segment down.
// - Stage A: the sigma-3.22 vertical pass in registers.  Each thread owns
//   one column of the grown strip and keeps mf = XYB - LF of its last 15
//   rows for the three channels: 15 fmaf per row and channel, no shared
//   memory.  It writes the group's vertical sums and centre mf values to
//   shared memory.
// - Stage B: each thread owns one column of the extent the second blur
//   needs (134) and takes the group's rows in order: the sigma-3.22
//   horizontal pass, the residual, the suppression and the MF bands
//   (written at once), and the sigma-1.56 vertical pass of the two HF
//   planes in a 7-row register window.  The residual, suppression and Y
//   residual, which output row y1 - 3 needs, go to a ring of rows in
//   shared memory.
// - Stage D: each thread owns one output column: the sigma-1.56
//   horizontal pass and the other four bands.
// - Staging overlaps the work: each thread copies its column's XYB and LF
//   a group of rows ahead with cp.async into a ring of rows, zero-filled
//   outside the image, with one wait per group; the reciprocal planes'
//   values for the next group are loaded into registers during stage D.
//   Two block barriers per group.
// - Blocks run image-fastest, so the images of one (segment, strip) share
//   the reciprocal planes in L2.
// What binds it now is instruction issue and latency, not device memory:
// ~350 instructions per output pixel on 15 warps per SM (3 blocks of 160
// threads, limited by registers).
// The renormalization reciprocals arrive as precomputed (H, W) planes, the
// same f32 values the Pallas kernels used.  The library is built with
// -fmad=false, and an explicit fmaf stands exactly where XLA contracts a
// multiply-add in the JAX package (tap chains, the absorbance mix, the
// gamma polynomial, the residuals, the maximum clamp), and every tap chain
// keeps its order, so the outputs match the plain PyTorch version, and the
// Pallas kernel as JAX runs it on the CPU, bit for bit.
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
// Columns of a strip, relative to its first output column x0:
// - grown: g in [0, G3) is column x0 - HALO + g, the sigma-3.22 vertical
//   pass (thread g);
// - extent: e in [0, E3) is column x0 - R2 + e = grown column e + R1, the
//   sigma-3.22 horizontal pass and the sigma-1.56 vertical pass (thread e);
// - output o in [0, kStrip) is column x0 + o = extent column o + R2 (thread o).
constexpr int G3 = ce::kStrip + 2 * HALO;
constexpr int E3 = ce::kStrip + 2 * R2;
// Rows per group: stage A runs a group's rows into shared memory, then
// stages B and D take them, with two block barriers per group.
constexpr int RG3 = 4;
// XYB and LF of each input row, copied by each thread for its own grown
// column (no other thread reads them) into a ring of rows, a group at a
// time and a group ahead; one wait per group lets the compiler interleave
// the group's rows.
constexpr int NSLOT3 = 2 * RG3;
constexpr int DIST3 = NSLOT3 - RG3;  // rows copied ahead
// Stage B's residual, suppression and HF Y of each row y1, which stage D
// takes R2 rows later at y2 = y1 - R2: a ring of rows in shared memory.
// Stage B of one group starts after stage D of the previous one ends, so a
// ring of RG3 + R2 rows is enough.
constexpr int ND3 = RG3 + R2;
static_assert(G3 <= ce::kStripThreads, "one thread per grown column");

__device__ __forceinline__ float remove_range(float v, float w) {
  return v > w ? v - w : (v < -w ? v + w : 0.f);
}
__device__ __forceinline__ float amplify_range(float v, float w) {
  return v > w ? v + w : (v < -w ? v - w : 2.f * v);
}
__device__ __forceinline__ float maximum_clamp(float v, float m, float mul) {
  return v >= m ? fmaf(v - m, mul, m) : (v < -m ? fmaf(v + m, mul, -m) : v);
}

// The tap chain of the plain version: fma(t0, x0, t1*x1), then fma(ti, xi,
// acc) in tap order.
template <int N>
__device__ __forceinline__ float chain(const float* t, const float* x) {
  float acc = fmaf(t[0], x[0], t[1] * x[1]);
#pragma unroll
  for (int i = 2; i < N; ++i) acc = fmaf(t[i], x[i], acc);
  return acc;
}

struct BandsSmem {
  float slot[NSLOT3][6][G3];  // XYB, LF of the input rows; zeros outside the image
  float v1[RG3][5][G3];       // sigma-3.22 vertical sums X/Y/B, then mf X/Y, at row y1
  float v2[RG3][2][E3];       // sigma-1.56 vertical sums of the HF planes at row y2
  float d[ND3][3][E3];        // residual X, suppression, HF Y at row y1
};

// consts: mf_x_remove, mf_y_amplify, uhf_x_remove, hf_x_remove, suppress_yw,
// suppress_s, maxclamp_hf, maxclamp_uhf, maxclamp_mul, uhf_y_mul, hf_y_mul,
// hf_y_amplify, (1 - suppress_s) * suppress_yw.
//
// Block: one (segment, strip, image), image fastest, so that the images of
// a (segment, strip) run together and share the reciprocal planes in L2.
// Step s reads input row r = y0 - HALO + s; its sigma-3.22 row is
// y1 = r - R1 and its output row y2 = r - HALO.  Stage A (a grown column
// per thread) completes the sigma-3.22 vertical sums of row y1; stage B (an
// extent column per thread, rows in order) its residual, MF bands and HF
// planes, and the sigma-1.56 vertical sums of row y2; stage D (an output
// column per thread) the other bands of row y2.
__global__ void __launch_bounds__(ce::kStripThreads, 3)
bands_kernel(const float* __restrict__ xyb, const float* __restrict__ lf,
             const float* __restrict__ recip1, const float* __restrict__ recip2,
             float* __restrict__ out, int b, int h, int w, int seg, ce::Floats<13> k,
             ce::Floats<K1> t1, ce::Floats<K2> t2) {
  extern __shared__ __align__(16) float bands_smem[];
  BandsSmem& sm = *reinterpret_cast<BandsSmem*>(bands_smem);
  const float mf_x_remove = k.v[0], mf_y_amplify = k.v[1], uhf_x_remove = k.v[2];
  const float hf_x_remove = k.v[3], suppress_yw = k.v[4], suppress_s = k.v[5];
  const float maxclamp_hf = k.v[6], maxclamp_uhf = k.v[7], maxclamp_mul = k.v[8];
  const float uhf_y_mul = k.v[9], hf_y_mul = k.v[10], hf_y_amplify = k.v[11];
  const float suppress_num = k.v[12];

  const int tid = threadIdx.x;
  const int img = blockIdx.x % b;
  const int tile = blockIdx.x / b;
  const int strips = (w + ce::kStrip - 1) / ce::kStrip;
  const int x0 = tile % strips * ce::kStrip, y0 = tile / strips * seg;
  const int y_end = min(y0 + seg, h), x_end = min(x0 + ce::kStrip, w);
  const size_t plane = (size_t)h * w;
  const float* src_xyb = xyb + (size_t)img * 3 * plane;
  const float* src_lf = lf + (size_t)img * 3 * plane;
  float* dst = out + (size_t)img * 7 * plane;

  // Stage A's column, and its copies of input row s into its slot.
  const int gx_a = x0 - HALO + tid;
  const bool col_in = tid < G3 && gx_a >= 0 && gx_a < w;
  auto issue = [&](int s) {
    if (tid < G3) {
      const int r = y0 - HALO + s;
      const bool in = col_in && r >= 0 && r < h;
      const size_t gi = in ? (size_t)r * w + gx_a : 0;
      float (*sl)[G3] = sm.slot[s % NSLOT3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ce::cp_async4(&sl[c][tid], src_xyb + c * plane + gi, in);
        ce::cp_async4(&sl[3 + c][tid], src_lf + c * plane + gi, in);
      }
    }
    ce::cp_async_commit();
  };

  float ring[3][K1];  // stage A: mf = xyb - lf of rows r - 14 .. r
  float win[2][K2];   // stage B: HF X/Y of rows y1 - 6 .. y1
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < K1; ++i) ring[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < K2; ++i) win[0][i] = win[1][i] = 0.f;

  // The reciprocals that stages B and D of the group at step s0 take,
  // loaded a group ahead so that their latency hides under stage A: zero
  // outside the image, as the first blur's renormalization needs.
  const int gx_b = x0 - R2 + tid, gx_d = x0 + tid;
  float rn1[RG3], rn2[RG3];
  auto load_recips = [&](int s0) {
#pragma unroll
    for (int i = 0; i < RG3; ++i) {
      const int y1 = y0 - HALO + s0 + i - R1, y2 = y1 - R2;
      const bool in1 = tid < E3 && y1 >= 0 && y1 < h && gx_b >= 0 && gx_b < w;
      const bool in2 = tid < ce::kStrip && y2 >= y0 && y2 < y_end && gx_d < x_end;
      rn1[i] = in1 ? recip1[(size_t)y1 * w + gx_b] : 0.f;
      rn2[i] = in2 ? recip2[(size_t)y2 * w + gx_d] : 0.f;
    }
  };

  const int steps = seg + 2 * HALO;
  const int groups = (steps + RG3 - 1) / RG3;
#pragma unroll
  for (int s = 0; s < DIST3; ++s) issue(s);
  load_recips(0);

#pragma unroll 1
  for (int grp = 0; grp < groups; ++grp) {
    const int s0 = grp * RG3;

    // Stage A: the sigma-3.22 vertical pass of one grown column, RG3 rows.
#pragma unroll
    for (int i = 0; i < RG3; ++i) issue(s0 + i + DIST3);
    ce::cp_async_wait<DIST3>();  // this group's rows are in
#pragma unroll
    for (int i = 0; i < RG3; ++i) {
      if (tid < G3) {
        const float (*sl)[G3] = sm.slot[(s0 + i) % NSLOT3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int j = 0; j < K1 - 1; ++j) ring[c][j] = ring[c][j + 1];
          ring[c][K1 - 1] = sl[c][tid] - sl[3 + c][tid];
          sm.v1[i][c][tid] = chain<K1>(t1.v, ring[c]);
        }
        sm.v1[i][3][tid] = ring[0][R1];
        sm.v1[i][4][tid] = ring[1][R1];
      }
    }
    __syncthreads();

    // Stage B: one extent column, the group's rows in order.
    if (tid < E3) {
      const int e = tid;
      const int gx = gx_b;
#pragma unroll
      for (int i = 0; i < RG3; ++i) {
        const int y1 = y0 - HALO + s0 + i - R1;
        const bool inside = y1 >= 0 && y1 < h && gx >= 0 && gx < w;
        const float rn = rn1[i];
        float fir[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) fir[c] = chain<K1>(t1.v, &sm.v1[i][c][e]);
        const float h0 = fmaf(-fir[0], rn, sm.v1[i][3][e + R1]);
        const float h1 = fmaf(-fir[1], rn, sm.v1[i][4][e + R1]);
        const float suppress = suppress_s + suppress_num / fmaf(h1, h1, suppress_yw);
        // The MF bands at row y1 need nothing of the second blur.
        if (y1 >= y0 && y1 < y_end && gx >= x0 && gx < x_end) {
          const size_t gi = (size_t)y1 * w + gx;
          dst[4 * plane + gi] = remove_range(fir[0] * rn, mf_x_remove);
          dst[5 * plane + gi] = amplify_range(fir[1] * rn, mf_y_amplify);
          dst[6 * plane + gi] = fir[2] * rn;
        }
        float (*d)[E3] = sm.d[(s0 + i) % ND3];
        d[0][e] = h0;
        d[1][e] = suppress;
        d[2][e] = h1;
#pragma unroll
        for (int j = 0; j < K2 - 1; ++j) {
          win[0][j] = win[0][j + 1];
          win[1][j] = win[1][j + 1];
        }
        // The second blur pads the HF planes with zeros.
        win[0][K2 - 1] = inside ? h0 * suppress : 0.f;
        win[1][K2 - 1] = inside ? h1 : 0.f;
        sm.v2[i][0][e] = chain<K2>(t2.v, win[0]);
        sm.v2[i][1][e] = chain<K2>(t2.v, win[1]);
      }
    }
    __syncthreads();

    // Stage D: the sigma-1.56 horizontal pass and the other bands of one
    // output column, at the group's output rows.
    if (tid < ce::kStrip && gx_d < x_end) {
#pragma unroll
      for (int i = 0; i < RG3; ++i) {
        const int y2 = y0 - HALO + s0 + i - HALO;
        if (y2 < y0 || y2 >= y_end) continue;
        const size_t gi = (size_t)y2 * w + gx_d;
        const float rn = rn2[i];
        const float hb0 = chain<K2>(t2.v, &sm.v2[i][0][tid]) * rn;
        const float hb1 = chain<K2>(t2.v, &sm.v2[i][1][tid]) * rn;
        const float hfc = maximum_clamp(hb1, maxclamp_hf, maxclamp_mul);
        const int e = tid + R2;
        const float (*d)[E3] = sm.d[(s0 + i + ND3 - R2) % ND3];  // row y1 - R2 = y2
        dst[gi] = remove_range(fmaf(d[0][e], d[1][e], -hb0), uhf_x_remove);
        dst[plane + gi] = maximum_clamp(d[2][e] - hfc, maxclamp_uhf, maxclamp_mul) * uhf_y_mul;
        dst[2 * plane + gi] = remove_range(hb0, hf_x_remove);
        dst[3 * plane + gi] = amplify_range(hfc * hf_y_mul, hf_y_amplify);
      }
    }
    load_recips(s0 + RG3);
  }
  ce::cp_async_wait<0>();
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
// seg: rows per segment; consts: 13 host floats; taps332: 15; taps156: 7.
extern "C" int ce_bands(const float* xyb, const float* lf, const float* recip332,
                        const float* recip156, float* out, int b, int h, int w, int seg,
                        const float* consts, const float* taps332, const float* taps156,
                        void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || seg <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)b * ((w + ce::kStrip - 1) / ce::kStrip) *
                           ((h + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int smem = sizeof(BandsSmem);  // above the 48 KB of static shared memory
  cudaError_t err =
      cudaFuncSetAttribute(bands_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bands_kernel<<<(unsigned)blocks, ce::kStripThreads, smem, (cudaStream_t)stream>>>(
      xyb, lf, recip332, recip156, out, b, h, w, seg, ce::load_floats<13>(consts),
      ce::load_floats<K1>(taps332), ce::load_floats<K2>(taps156));
  return (int)cudaGetLastError();
}
