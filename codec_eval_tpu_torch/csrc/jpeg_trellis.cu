// K10: the trellis DP of tpujpeg's device encoder, one launch per plane.
//
// Replaces no Pallas kernel.  The JAX package runs this DP as a
// jax.lax.scan in jnp (codec_eval_tpu/kernels/jpeg_enc.py:904
// trellis_quantize_dev, the scan at :997), which XLA fuses into one loop on
// the TPU.  Run eagerly, the same scan is ~2,490 launches per plane over
// (n, 64) and (n, 128) temporaries (kernels/jpeg_enc.py
// trellis_quantize_plain, the plain version, which this kernel equals bit
// for bit).  Per block of 64 zigzag coefficients and one quality's steps:
// x = |F| / q, the two candidates (round to nearest, one step toward zero),
// their magnitude sizes, the sequential prefix sums P of x^2, the 63 steps
// over the previous-nonzero state j, the EOB termination, the backtrack and
// the signed f32 output; DC rounds to nearest, clamped at 2047.
//
// What bounds it on an H100: issued instructions.  Its bytes are one f32
// read and one f32 write per coefficient (the steps come from a 64-float
// row per quality, cached): ~21 us per 512 px ladder's luma at 3.35 TB/s.
// Its arithmetic is ~2k candidate costs of a few f32 operations per
// position: ~24k operations per block.  Both are far below what the
// dependent steps cost in issue slots and latency.
//
// The design: one warp per block, lane l owning the states j = l and
// j = l + 32 in registers (best cost, prefix sum, the step's pick).  The
// per-position terms (both distortions, x^2, both sizes) sit in shared
// memory, one float4 per position, read by the whole warp at each step.  A
// step prices the candidates after the lane's states, takes each lane's
// first minimum in the flattened (candidate, j) order of the plain
// version's argmin, and reduces across the warp with two redux.sync
// minima: one over an order-preserving integer key of the cost, one over
// the index among the lanes that hold it, so ties go to the first index as
// in torch.argmin.  The lane that owns position k keeps its result; the
// backtrack follows the picks with one shuffle per nonzero.  A position
// whose round-to-nearest candidate is 0 is skipped (all its costs are
// +inf: best inf, pick 0), a branch the whole warp takes together.  The
// rate table lam * RT[r][s] (63 x 11 floats) arrives by value with the
// launch and is copied once per CTA into shared memory; a CTA of 8 warps
// walks its blocks with a grid stride.  Every cost keeps the plain
// version's order, ((best[j] + (P[k-1] - P[j])) + lam * RT[k-1-j][s]) + d,
// and the build's -fmad=false keeps each operation separately rounded.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRuns = 63;
constexpr int kSizes = 11;
constexpr int kRates = kRuns * kSizes;
constexpr int kWarps = 8;
constexpr unsigned kAll = 0xffffffffu;

// An unsigned key that orders floats as < does (NaN aside), -0 equal to +0.
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// JPEG magnitude category of a candidate c in [0, 1023].
__device__ __forceinline__ int size_of(float c) {
  return c > 0.0f ? 32 - __clz(static_cast<int>(c)) : 0;
}

// dct: (n_blocks, 64) zigzag coefficients; q: n_q rows of 64 zigzag steps,
// q_stride floats apart; out: (n_q, n_blocks, 64).  rates: lam * RT[r][s]
// laid out [s][r]; eob: lam * the EOB code length.
__global__ void __launch_bounds__(kWarps * 32)
trellis_dp_kernel(const float* __restrict__ dct, const float* __restrict__ q,
                  float* __restrict__ out, int n_q, int n_blocks, int q_stride,
                  ce::Floats<kRates> rates, float eob) {
  __shared__ float rate[kRates];
  // Per position k: (d0, d1, x^2, size0 | size1 << 4).
  __shared__ float4 terms[kWarps][64];
  for (int i = threadIdx.x; i < kRates; i += blockDim.x) rate[i] = rates.v[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float4* my = terms[threadIdx.x >> 5];
  const int64_t total = static_cast<int64_t>(n_q) * n_blocks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); g < total;
       g += stride) {
    const int64_t qi = g / n_blocks;
    const float* f = dct + (g - qi * n_blocks) * 64;
    const float* qs = q + qi * q_stride;
    float x[2], c0[2], c1[2], sgn[2];
    __syncwarp();  // the previous block's reads of `my` are done
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      const float fv = f[p];
      sgn[h] = static_cast<float>((fv > 0.0f) - (fv < 0.0f));
      x[h] = __fdiv_rn(fabsf(fv), qs[p]);
      c0[h] = fminf(floorf(x[h] + 0.5f), 1023.0f);
      c1[h] = fmaxf(c0[h] - 1.0f, 0.0f);
      const float t0 = x[h] - c0[h], t1 = x[h] - c1[h];
      my[p] = make_float4(t0 * t0, t1 * t1, x[h] * x[h],
                          __int_as_float(size_of(c0[h]) | size_of(c1[h]) << 4));
    }
    __syncwarp();

    float best[2] = {lane == 0 ? 0.0f : INFINITY, INFINITY};
    float pre[2] = {0.0f, 0.0f};  // P[j], set once the walk has passed j
    int pick[2] = {0, 0};
    float run = 0.0f;  // P[k - 1]
    for (int k = 1; k < 64; ++k) {
      const float4 t = my[k];
      const int s0 = __float_as_int(t.w) & 15, s1 = __float_as_int(t.w) >> 4;
      float bk = INFINITY;
      int pk = 0;
      if (s0 != 0) {
        unsigned kb = 0xffffffffu;
        int ib = 0;
        float cost[2][2];  // [candidate][half]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = k - 1 - lane - 32 * h;
          cost[0][h] = cost[1][h] = INFINITY;
          if (r >= 0) {
            const float z = best[h] + (run - pre[h]);
            cost[0][h] = (z + rate[s0 * kRuns + r]) + t.x;
            if (s1 != 0) cost[1][h] = (z + rate[s1 * kRuns + r]) + t.y;
          }
        }
        // The lane's first minimum in flattened order: lane, lane + 32,
        // 64 + lane, 96 + lane.
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned kc = key_of(cost[c][h]);
            if (kc < kb) {
              kb = kc;
              ib = 64 * c + 32 * h + lane;
            }
          }
        const unsigned m = __reduce_min_sync(kAll, kb);
        pk = static_cast<int>(__reduce_min_sync(kAll, kb == m ? static_cast<unsigned>(ib) : kAll));
        bk = value_of(m);
      }
      run = run + t.z;
      if (lane == (k & 31)) {  // constant indices keep the arrays in registers
        if (k < 32) {
          best[0] = bk;
          pick[0] = pk;
          pre[0] = run;
        } else {
          best[1] = bk;
          pick[1] = pk;
          pre[1] = run;
        }
      }
    }

    // Termination: the zero tail after the last nonzero j, plus EOB unless
    // j = 63; the first minimum.
    unsigned kb = key_of((best[0] + (run - pre[0])) + eob);
    int jlast = lane;
    const unsigned khi = key_of((best[1] + (run - pre[1])) + (lane == 31 ? eob * 0.0f : eob));
    if (khi < kb) {
      kb = khi;
      jlast = lane + 32;
    }
    const unsigned m = __reduce_min_sync(kAll, kb);
    int cur = static_cast<int>(__reduce_min_sync(kAll, kb == m ? static_cast<unsigned>(jlast) : kAll));

    // Backtrack: mark the positions on the path.  The plain version's walk
    // down k = 63..1 follows a pick only to a lower position.
    uint64_t on = 0;
    while (cur != 0) {
      on |= 1ull << cur;
      const int next = __shfl_sync(kAll, cur < 32 ? pick[0] : pick[1], cur & 31) & 63;
      if (next >= cur) break;
      cur = next;
    }

    float* o = out + g * 64;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      float v = (on >> p) & 1 ? sgn[h] * (pick[h] < 64 ? c0[h] : c1[h]) : 0.0f;
      if (p == 0) v = sgn[0] * fminf(floorf(x[0] + 0.5f), 2047.0f);
      o[p] = v;
    }
  }
}

}  // namespace

// dct: (n_blocks, 64) f32; q: n_q rows of 64 f32 steps, q_stride floats
// apart; out: (n_q, n_blocks, 64) f32.  rates: 11 x 63 host floats
// (lam * RT[r][s] at [s][r]); grid: CTAs of 8 warps.
extern "C" int ce_trellis_dp(const float* dct, const float* q, float* out, int n_q,
                             int n_blocks, int q_stride, int grid, const float* rates, float eob,
                             void* stream) {
  if (n_q <= 0 || n_blocks <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  trellis_dp_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      dct, q, out, n_q, n_blocks, q_stride, ce::load_floats<kRates>(rates), eob);
  return static_cast<int>(cudaGetLastError());
}
