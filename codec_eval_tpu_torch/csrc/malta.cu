// K4 and K5: Butteraugli Malta directional sweeps, batched.
//
// K4 replaces codec_eval_tpu/kernels/pallas/malta.py:malta_ac_batch_pallas:
// (B, 6, H, W) asymmetric band-diff planes -> (B, 2, H, W) accumulators.
// For each plane it takes the oriented line sums within radius 4 (9-sample
// "full" lines on the two UHF planes, 5-sample "lf" lines on the HF and MF
// planes), squares each sum, weights it, and adds it into the X (ac0) or Y
// (ac1) accumulator: planes 0, 2, 4 feed ac1 and planes 1, 3, 5 feed ac0.
// Samples outside the image read 0.
//
// K5 replaces codec_eval_tpu/kernels/pallas/malta.py:
// malta_diffmap_batch_pallas, the whole-diffmap kernel: from the six Malta
// band planes of the candidates (B, 6, H, W) and of the reference (6, H, W)
// it forms each asymmetric diff plane (the Malta prologue), sweeps it as K4
// does, then adds the HF asymmetric L2, the MF and LF squared differences
// (from the mf_b and LF planes, B x 4 and 4), the candidate masking term
// dac (B, H, W), combines with the reference masks (MaskY, MaskDcY) and
// writes sqrt(max(total, 0)): the (B, H, W) diffmap.  The diff planes and
// the accumulators never reach device memory.
//
// What bounds them on an H100: the shared-memory sweep.  K4 reads six
// planes and writes two (32 bytes per pixel of device traffic); K5 reads
// the candidate's 11 planes and writes one (48 bytes per pixel, the
// reference planes being shared by the batch).  Both do 512 shared-memory
// reads and adds per pixel: 2 x 96 samples on the 12 full lines of the UHF
// planes, 4 x 80 on the 16 lf lines of the others, about 780 flops with the
// squares and weights, which is at or above the card's f32 flop/byte
// balance.
//
// The simple design: one 32x32 output tile per block, four pixels per
// thread; the six planes are staged one at a time, each with its 4-pixel
// halo, into shared memory (K5 computes the prologue from the reference and
// candidate values while it stages), and every thread keeps its pixels' two
// accumulators in registers across the six planes, so each plane is read
// from device memory once per tile.  K5's epilogue reads the remaining
// per-pixel inputs straight from device memory.  The line tables sit in
// __constant__ memory: every thread of a warp reads the same entry at the
// same time, which constant memory broadcasts, and a thread reads each
// sample's offset once for its four pixels.  Lines, samples and epilogue
// terms are added in the order of the plain versions, so results match them
// bit for bit.
#include "common.cuh"

namespace {

constexpr int R = 4;
constexpr int TW = 32;
constexpr int TH = 32;
constexpr int SW = TW + 2 * R;
constexpr int SH = TH + 2 * R;
constexpr int kMaxLines = 16;
constexpr int kMaxSamples = 9;
constexpr int kGeom = 1 + 2 * kMaxSamples;  // sample count, dy[9], dx[9]
constexpr int kPerThread = TH * TW / ce::kThreads;

// [kind][line]: kind 0 = full lines, kind 1 = lf lines.
__constant__ float c_weight[2][kMaxLines];
__constant__ int c_geom[2][kMaxLines][kGeom];

// Pixel j of this thread is row tid/32 + 8j of the tile, so a warp reads
// one tile row: consecutive shared-memory words, no bank conflicts.
__device__ __forceinline__ void tile_centers(int* center) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * ce::kThreads;
    center[j] = (i / TW + R) * SW + i % TW + R;
  }
}

// Sum over the lines of one pattern of weight * (line sum)^2 at this
// thread's pixels of a staged plane.  Each line's offsets are read once and
// applied to all the thread's pixels; per pixel, samples and lines add in
// the plain version's order.
__device__ __forceinline__ void sweep(const float* tile, const int* center, int kind,
                                      int nlines, float* term) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) term[j] = 0.f;
  for (int l = 0; l < nlines; ++l) {
    const int* g = c_geom[kind][l];
    const int ns = g[0];
    float s[kPerThread];
    int off = g[1] * SW + g[1 + kMaxSamples];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) s[j] = tile[center[j] + off];
    for (int q = 1; q < ns; ++q) {
      off = g[1 + q] * SW + g[1 + kMaxSamples + q];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) s[j] = s[j] + tile[center[j] + off];
    }
    const float wl = c_weight[kind][l];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) term[j] = term[j] + wl * (s[j] * s[j]);
  }
}

// Planes 0, 2, 4 feed ac1 (Y), planes 1, 3, 5 feed ac0 (X); planes 0 and 1
// take the full lines, the others the lf lines.
__device__ __forceinline__ void accumulate(const float* tile, const int* center, int ch,
                                           int nlines_full, int nlines_lf, float* ac0,
                                           float* ac1) {
  const int kind = ch < 2 ? 0 : 1;
  float term[kPerThread];
  sweep(tile, center, kind, kind == 0 ? nlines_full : nlines_lf, term);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (ch % 2 == 0) ac1[j] = ac1[j] + term[j];
    else ac0[j] = ac0[j] + term[j];
  }
}

__global__ void __launch_bounds__(ce::kThreads)
malta_kernel(const float* __restrict__ diffs, float* __restrict__ out, int h, int w,
             int nlines_full, int nlines_lf) {
  __shared__ float tile[SH * SW];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const float* src = diffs + (size_t)blockIdx.z * 6 * plane;

  int center[kPerThread];
  float ac0[kPerThread], ac1[kPerThread];
  tile_centers(center);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) ac0[j] = ac1[j] = 0.f;

  for (int ch = 0; ch < 6; ++ch) {
    for (int i = tid; i < SH * SW; i += ce::kThreads) {
      const int sy = i / SW, sx = i % SW;
      const int gy = y0 + sy - R, gx = x0 + sx - R;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      tile[i] = in ? src[ch * plane + (size_t)gy * w + gx] : 0.f;
    }
    __syncthreads();
    accumulate(tile, center, ch, nlines_full, nlines_lf, ac0, ac1);
    __syncthreads();
  }

  float* dst = out + (size_t)blockIdx.z * 2 * plane;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * ce::kThreads;
    const int gy = y0 + i / TW, gx = x0 + i % TW;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    dst[gi] = ac0[j];
    dst[plane + gi] = ac1[j];
  }
}

// --------------------------------------------------------------------- K5

// The Malta prologue: the asymmetric diff of reference value l0 and
// candidate value l1 (kernels/butteraugli.py _malta_prologue), with the
// per-channel constants n2g, n2l, n1 resolved on the host.  0 for 0, 0.
__device__ __forceinline__ float prologue(float l0, float l1, float n2g, float n2l,
                                          float n1) {
  const float diff = l0 - l1;
  const float denom = n1 + 0.5f * (fabsf(l0) + fabsf(l1));
  const float diffs = (n2g / denom) * diff;
  const float scaler2 = n2l / denom;
  const float fabs0 = fabsf(l0);
  const float too_small = 0.55f * fabs0;
  const float too_big = 1.05f * fabs0;
  float impact;
  if (l0 >= 0.f) {
    impact = l1 < too_small ? scaler2 * (too_small - l1)
                            : (l1 > too_big ? -scaler2 * (l1 - too_big) : 0.f);
  } else {
    impact = l1 > -too_small ? -scaler2 * (l1 + too_small)
                             : (l1 < -too_big ? scaler2 * (-l1 - too_big) : 0.f);
  }
  return diffs + impact;
}

// The asymmetric L2 of the HF bands; kg and kl already carry the 0.8.
__device__ __forceinline__ float l2_asymmetric(float v0, float v1, float kg, float kl) {
  const float d = v0 - v1;
  const float total = kg * d * d;
  const float fabs0 = fabsf(v0);
  const float too_small = 0.4f * fabs0;
  float v;
  if (v0 < 0.f) {
    v = v1 > -too_small ? v1 + too_small : (v1 < -fabs0 ? -v1 - fabs0 : 0.f);
  } else {
    v = v1 < too_small ? too_small - v1 : (v1 > fabs0 ? v1 - fabs0 : 0.f);
  }
  return total + kl * v * v;
}

// ch: per channel (n2g, n2l, n1).  epi: 0.8 * (L2 hf X >, X <, Y >, Y <),
// then WMUL mf X, Y, B, lf X, Y, B, and xmul.
__global__ void __launch_bounds__(ce::kThreads)
malta_diffmap_kernel(const float* __restrict__ cand6, const float* __restrict__ ref6,
                     const float* __restrict__ cand_rest, const float* __restrict__ ref_rest,
                     const float* __restrict__ dac, const float* __restrict__ masks,
                     float* __restrict__ out, int h, int w, int nlines_full, int nlines_lf,
                     ce::Floats<18> ch, ce::Floats<11> epi) {
  __shared__ float tile[SH * SW];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const size_t b = blockIdx.z;
  const float* cand = cand6 + b * 6 * plane;

  int center[kPerThread];
  float ac0[kPerThread], ac1[kPerThread];
  tile_centers(center);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) ac0[j] = ac1[j] = 0.f;

  for (int c = 0; c < 6; ++c) {
    const float n2g = ch.v[3 * c], n2l = ch.v[3 * c + 1], n1 = ch.v[3 * c + 2];
    for (int i = tid; i < SH * SW; i += ce::kThreads) {
      const int sy = i / SW, sx = i % SW;
      const int gy = y0 + sy - R, gx = x0 + sx - R;
      float d = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const size_t gi = c * plane + (size_t)gy * w + gx;
        d = prologue(ref6[gi], cand[gi], n2g, n2l, n1);
      }
      tile[i] = d;
    }
    __syncthreads();
    accumulate(tile, center, c, nlines_full, nlines_lf, ac0, ac1);
    __syncthreads();
  }

  const float xmul = epi.v[10];
  const float* crest = cand_rest + b * 4 * plane;
  float* dst = out + b * plane;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * ce::kThreads;
    const int gy = y0 + i / TW, gx = x0 + i % TW;
    if (gy >= h || gx >= w) continue;
    const size_t gi = (size_t)gy * w + gx;
    // Six-plane order: uhf_y, uhf_x, hf_y, hf_x, mf_y, mf_x.
    float a0 = ac0[j] + l2_asymmetric(ref6[3 * plane + gi], cand[3 * plane + gi], epi.v[0], epi.v[1]);
    float a1 = ac1[j] + l2_asymmetric(ref6[2 * plane + gi], cand[2 * plane + gi], epi.v[2], epi.v[3]);
    const float d_mfx = ref6[5 * plane + gi] - cand[5 * plane + gi];
    a0 = a0 + epi.v[4] * d_mfx * d_mfx;
    const float d_mfy = ref6[4 * plane + gi] - cand[4 * plane + gi];
    a1 = a1 + epi.v[5] * d_mfy * d_mfy;
    // Rest order: mf_b, lf_x, lf_y, lf_b.
    const float d_mfb = ref_rest[gi] - crest[gi];
    const float a2 = epi.v[6] * d_mfb * d_mfb;
    a1 = a1 + dac[b * plane + gi];
    const float d_lfx = ref_rest[plane + gi] - crest[plane + gi];
    const float d_lfy = ref_rest[2 * plane + gi] - crest[2 * plane + gi];
    const float d_lfb = ref_rest[3 * plane + gi] - crest[3 * plane + gi];
    const float dc = xmul * (epi.v[7] * d_lfx * d_lfx) + epi.v[8] * d_lfy * d_lfy +
                     epi.v[9] * d_lfb * d_lfb;
    const float total = masks[plane + gi] * dc + masks[gi] * (xmul * a0 + a1 + a2);
    dst[gi] = sqrtf(fmaxf(total, 0.f));
  }
}

// Copy the line tables into constant memory on the launch stream, ahead of
// the kernel that reads them.
cudaError_t load_tables(const float* weights, const int* geometry, int nlines_full,
                        int nlines_lf, cudaStream_t s) {
  if (nlines_full > kMaxLines || nlines_lf > kMaxLines) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyToSymbolAsync(c_weight, weights, sizeof(c_weight), 0,
                                            cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbolAsync(c_geom, geometry, sizeof(c_geom), 0,
                                 cudaMemcpyHostToDevice, s);
}

}  // namespace

// diffs: (b, 6, h, w); out: (b, 2, h, w).  weights: (2, 16) host floats and
// geometry: (2, 16, 19) host ints (per line: sample count, 9 dy, 9 dx).
extern "C" int ce_malta_ac(const float* diffs, float* out, int b, int h, int w,
                           const float* weights, const int* geometry, int nlines_full,
                           int nlines_lf, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = load_tables(weights, geometry, nlines_full, nlines_lf, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  malta_kernel<<<grid, ce::kThreads, 0, s>>>(diffs, out, h, w, nlines_full, nlines_lf);
  return (int)cudaGetLastError();
}

// cand6: (b, 6, h, w); ref6: (6, h, w); cand_rest: (b, 4, h, w); ref_rest:
// (4, h, w); dac: (b, h, w); masks: (2, h, w); out: (b, h, w).  Line tables
// as for ce_malta_ac; ch: 18 host floats; epi: 11 host floats.
extern "C" int ce_malta_diffmap(const float* cand6, const float* ref6, const float* cand_rest,
                                const float* ref_rest, const float* dac, const float* masks,
                                float* out, int b, int h, int w, const float* weights,
                                const int* geometry, int nlines_full, int nlines_lf,
                                const float* ch, const float* epi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = load_tables(weights, geometry, nlines_full, nlines_lf, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  malta_diffmap_kernel<<<grid, ce::kThreads, 0, s>>>(
      cand6, ref6, cand_rest, ref_rest, dac, masks, out, h, w, nlines_full, nlines_lf,
      ce::load_floats<18>(ch), ce::load_floats<11>(epi));
  return (int)cudaGetLastError();
}
