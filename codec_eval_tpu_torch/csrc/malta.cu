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
// What bounds them on an H100: operations.  Per output pixel the six sweeps
// add 2 x 96 samples on the 12 full lines and 4 x 80 on the 16 lf lines,
// then square the 88 line sums, weight the 8 whose weight is 2, and sum
// them into the two accumulators: 606 f32 additions and multiplications, as
// chip_smoke.py counts them, against 32 (K4) or about 53 (K5) bytes of
// device traffic.  At the card's peak of 67 TFLOP/s the bytes take a little
// longer (chip_smoke.py's bound), but the sources build with -fmad=false,
// so that results match the plain versions bit for bit; without FMA the
// card issues 128 f32 instructions per clock and SM, half the 256 flops
// that its peak counts.  So the floor these kernels can reach is twice the
// operations' time at peak, above the bytes' time: about 0.12 ms for K4 at
// 512 px, B=25, and 0.9 ms for K5 at 2048 px, B=10.
//
// The design:
// - The line tables are compile-time constants (kLinesFull, kLinesLf), and
//   every loop over rows, lines and samples is unrolled, so each sample's
//   offset is an immediate of its shared-memory load.  The wrappers refuse
//   other tables on the card.
// - Register-blocked line sums.  Each thread owns a run of P = 4 pixels down
//   one tile column.  It streams the P + 8 rows of the run's window top to
//   bottom, loads the samples of each row that its lines take into
//   registers once, and adds each into every line sum that takes it.  Every
//   line lists its samples in nondecreasing row order, so each sum still adds
//   its samples in the plain version's order; a pixel's weighted squares are
//   added in line order once its last row has passed.  That is 22 (full) or
//   24 (lf) shared-memory loads per pixel and plane, 140 per pixel in all,
//   down from 508, with at most 64 line sums live per thread: 80 registers,
//   three blocks of 256 threads on each SM.
// - Staging overlaps the sweep.  Each plane's window (the 32 x 32 output
//   tile and its 4-pixel halo, 40 x 40) is copied into shared memory with
//   cp.async, zero-filled outside the image, into a double buffer: the next
//   plane's copy runs under the current plane's sweep, with one barrier per
//   plane.  Where rows are a multiple of 4 floats and the planes 16-byte
//   aligned, each copy moves 4 floats (V = 4), else one (V = 1).
// - K5 keeps its fusion: each thread turns the candidate samples that it
//   staged into diff samples in place (the prologue, once per staged element,
//   its two divisions kept as divisions), then all sweep them as K4 does.
//   Its epilogue reads the remaining per-pixel inputs from device memory.
// Lines, samples, planes and epilogue terms add in the order of the plain
// versions, so the results match them bit for bit.
#include <utility>

#include "common.cuh"

namespace {

constexpr int R = 4;    // line radius
constexpr int P = 4;    // pixels per thread: a run down one column
constexpr int TW = 32;  // output tile: one warp across, one run per warp down
constexpr int TH = 32;
constexpr int kThreads = TW * TH / P;
constexpr int SW = TW + 2 * R;
constexpr int SH = TH + 2 * R;
constexpr int kWindow = SH * SW;

// ------------------------------------------------------------- line tables

struct Sample {
  int dy, dx;
};

// {weight, sample count, {{dy, dx}, ...}}, with the samples in order.
struct Line {
  int weight, count;
  Sample at[9];
};

constexpr int kFull = 0;
constexpr int kLf = 1;
constexpr int kNumFull = 12;
constexpr int kNumLf = 16;

// kernels/cuda/malta.py LINES_FULL, line for line and sample for sample.
constexpr Line kLinesFull[kNumFull] = {
    {1, 7, {{-3, -3}, {-2, -2}, {-1, -1}, {0, 0}, {1, 1}, {2, 2}, {3, 3}}},
    {1, 7, {{-3, 3}, {-2, 2}, {-1, 1}, {0, 0}, {1, -1}, {2, -2}, {3, -3}}},
    {2, 9, {{-4, -1}, {-3, -1}, {-2, -1}, {-1, 0}, {0, 0}, {1, 0}, {2, 1}, {3, 1}, {4, 1}}},
    {2, 9, {{-4, 1}, {-3, 1}, {-2, 1}, {-1, 0}, {0, 0}, {1, 0}, {2, -1}, {3, -1}, {4, -1}}},
    {2, 9, {{-1, -4}, {-1, -3}, {-1, -2}, {0, -1}, {0, 0}, {0, 1}, {1, 2}, {1, 3}, {1, 4}}},
    {2, 9, {{-1, 2}, {-1, 3}, {-1, 4}, {0, -1}, {0, 0}, {0, 1}, {1, -4}, {1, -3}, {1, -2}}},
    {1, 9, {{-4, 0}, {-3, 0}, {-2, 0}, {-1, 0}, {0, 0}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}},
    {1, 9, {{0, -4}, {0, -3}, {0, -2}, {0, -1}, {0, 0}, {0, 1}, {0, 2}, {0, 3}, {0, 4}}},
    {1, 7, {{-3, -2}, {-2, -1}, {-1, -1}, {0, 0}, {1, 1}, {2, 1}, {3, 2}}},
    {1, 7, {{-3, 2}, {-2, 1}, {-1, 1}, {0, 0}, {1, -1}, {2, -1}, {3, -2}}},
    {1, 7, {{-2, -3}, {-1, -2}, {-1, -1}, {0, 0}, {1, 1}, {1, 2}, {2, 3}}},
    {1, 7, {{-2, 3}, {-1, 1}, {-1, 2}, {0, 0}, {1, -2}, {1, -1}, {2, -3}}},
};

// kernels/cuda/malta.py LINES_LF, line for line and sample for sample.
constexpr Line kLinesLf[kNumLf] = {
    {1, 5, {{-4, -2}, {-2, -1}, {0, 0}, {2, 1}, {4, 2}}},
    {1, 5, {{-4, 2}, {-2, 1}, {0, 0}, {2, -1}, {4, -2}}},
    {1, 5, {{-2, -4}, {-1, -2}, {0, 0}, {1, 2}, {2, 4}}},
    {1, 5, {{-2, 4}, {-1, 2}, {0, 0}, {1, -2}, {2, -4}}},
    {1, 5, {{-3, -3}, {-2, -2}, {0, 0}, {2, 2}, {3, 3}}},
    {1, 5, {{-3, 3}, {-2, 2}, {0, 0}, {2, -2}, {3, -3}}},
    {1, 5, {{-4, -1}, {-2, -1}, {0, 0}, {2, 1}, {4, 1}}},
    {1, 5, {{-4, 1}, {-2, 1}, {0, 0}, {2, -1}, {4, -1}}},
    {1, 5, {{-1, -4}, {-1, -2}, {0, 0}, {1, 2}, {1, 4}}},
    {1, 5, {{-1, 2}, {-1, 4}, {0, 0}, {1, -4}, {1, -2}}},
    {1, 5, {{-4, 0}, {-2, 0}, {0, 0}, {2, 0}, {4, 0}}},
    {1, 5, {{0, -4}, {0, -2}, {0, 0}, {0, 2}, {0, 4}}},
    {1, 5, {{-3, -2}, {-2, -1}, {0, 0}, {2, 1}, {3, 2}}},
    {1, 5, {{-3, 2}, {-2, 1}, {0, 0}, {2, -1}, {3, -2}}},
    {1, 5, {{-2, -3}, {-1, -2}, {0, 0}, {1, 2}, {2, 3}}},
    {1, 5, {{-2, 3}, {-1, 2}, {0, 0}, {1, -2}, {2, -3}}},
};

// Every sample within the radius, and each line's rows nondecreasing: the
// sweep streams rows top to bottom and adds samples in the order it meets
// them.
constexpr bool streamable(const Line* lines, int n) {
  for (int l = 0; l < n; ++l) {
    if (lines[l].count < 1 || lines[l].count > 9) return false;
    for (int q = 0; q < lines[l].count; ++q) {
      const Sample s = lines[l].at[q];
      if (s.dy < -R || s.dy > R || s.dx < -R || s.dx > R) return false;
      if (q > 0 && s.dy < lines[l].at[q - 1].dy) return false;
    }
  }
  return true;
}
static_assert(streamable(kLinesFull, kNumFull) && streamable(kLinesLf, kNumLf),
              "a line's samples must lie within the radius, rows in order");

// The tables' entries, read only in constant expressions.
__host__ __device__ constexpr int num_lines(int kind) { return kind == kFull ? kNumFull : kNumLf; }
__host__ __device__ constexpr int line_weight(int kind, int l) {
  return kind == kFull ? kLinesFull[l].weight : kLinesLf[l].weight;
}
__host__ __device__ constexpr int line_count(int kind, int l) {
  return kind == kFull ? kLinesFull[l].count : kLinesLf[l].count;
}
__host__ __device__ constexpr int sample_dy(int kind, int l, int q) {
  return kind == kFull ? kLinesFull[l].at[q].dy : kLinesLf[l].at[q].dy;
}
__host__ __device__ constexpr int sample_dx(int kind, int l, int q) {
  return kind == kFull ? kLinesFull[l].at[q].dx : kLinesLf[l].at[q].dx;
}

// Whether row rr of a run's window (rr = p + R + dy for pixel p) holds a
// sample of the pattern at column offset dx.
__host__ __device__ constexpr bool row_needs(int kind, int rr, int dx) {
  for (int p = 0; p < P; ++p)
    for (int l = 0; l < num_lines(kind); ++l)
      for (int q = 0; q < line_count(kind, l); ++q)
        if (sample_dy(kind, l, q) == rr - R - p && sample_dx(kind, l, q) == dx) return true;
  return false;
}

// ------------------------------------------------------------------- sweep

template <class F, int... I>
__device__ __forceinline__ void unroll_impl(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// f(std::integral_constant<int, i>{}) for i = 0 .. N - 1, in order.
template <int N, class F>
__device__ __forceinline__ void unroll(F&& f) {
  unroll_impl(f, std::make_integer_sequence<int, N>{});
}

// term[p] = the sum over the pattern's lines, in order, of weight * (line
// sum)^2 at pixel p of this thread's run.  `run` points at the window
// element of the run's top-left sample: pixel p's sample (dy, dx) is
// run[(p + R + dy) * SW + R + dx].
template <int Kind>
__device__ __forceinline__ void sweep(const float* run, float (&term)[P]) {
  constexpr int L = num_lines(Kind);
  float sum[P][L];
  unroll<P + 2 * R>([&](auto row) {
    constexpr int rr = decltype(row)::value;
    float v[2 * R + 1];
    unroll<2 * R + 1>([&](auto col) {
      constexpr int c = decltype(col)::value;
      if constexpr (row_needs(Kind, rr, c - R)) v[c] = run[rr * SW + c];
    });
    unroll<P>([&](auto pix) {
      constexpr int p = decltype(pix)::value;
      constexpr int dy = rr - R - p;
      if constexpr (dy >= -R && dy <= R) {
        unroll<L>([&](auto line) {
          constexpr int l = decltype(line)::value;
          unroll<line_count(Kind, l)>([&](auto sample) {
            constexpr int q = decltype(sample)::value;
            if constexpr (sample_dy(Kind, l, q) == dy) {
              constexpr int c = sample_dx(Kind, l, q) + R;
              if constexpr (q == 0) sum[p][l] = v[c];
              else sum[p][l] = sum[p][l] + v[c];
            }
          });
        });
        if constexpr (dy == R) {  // the pixel's last row: every line is complete
          unroll<L>([&](auto line) {
            constexpr int l = decltype(line)::value;
            constexpr float weight = line_weight(Kind, l);
            const float sq = weight * (sum[p][l] * sum[p][l]);
            if constexpr (l == 0) term[p] = sq;
            else term[p] = term[p] + sq;
          });
        }
      }
    });
  });
}

// Planes 0 and 1 take the full lines, the others the lf lines; planes 0, 2,
// 4 feed ac1 (Y), planes 1, 3, 5 feed ac0 (X).
__device__ __forceinline__ void accumulate(const float* run, int c, float (&ac0)[P],
                                           float (&ac1)[P]) {
  float term[P];
  if (c < 2) sweep<kFull>(run, term);
  else sweep<kLf>(run, term);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (c % 2) ac0[p] = ac0[p] + term[p];
    else ac1[p] = ac1[p] + term[p];
  }
}

// ----------------------------------------------------------------- staging

// f(i, in, gi) for this thread's chunks of V consecutive elements of the
// window at output tile (y0, x0): i indexes the chunk's first element in
// the window, gi in the image plane (valid where in).  Consecutive threads
// take consecutive chunks, so no lane idles at the end of a 40-wide row.
// With V = 4 the image width is a multiple of 4, so a chunk lies wholly
// inside or wholly outside the image.
template <int V, class F>
__device__ __forceinline__ void for_window(int y0, int x0, int h, int w, F&& f) {
  constexpr int kRow = SW / V;
  for (int k = threadIdx.x; k < SH * kRow; k += kThreads) {
    const int sy = k / kRow, sx = k % kRow * V;
    const int gy = y0 - R + sy, gx = x0 - R + sx;
    f(sy * SW + sx, gy >= 0 && gy < h && gx >= 0 && gx < w, (size_t)gy * w + gx);
  }
}

// Start copying one plane's window into dst, zeros outside the image:
// 16-byte copies with V = 4, 4-byte copies with V = 1.
template <int V>
__device__ __forceinline__ void stage(float* dst, const float* plane, int y0, int x0, int h,
                                      int w) {
  for_window<V>(y0, x0, h, w, [&](int i, bool in, size_t gi) {
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    if constexpr (V == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(to), "l"(plane + (in ? gi : 0)), "r"(in ? 16 : 0));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(to), "l"(plane + (in ? gi : 0)), "r"(in ? 4 : 0));
  });
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's copies.
__device__ __forceinline__ void staged() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Window element of the top-left sample of this thread's run.
__device__ __forceinline__ int run_origin() {
  return (threadIdx.x / 32) * P * SW + threadIdx.x % 32;
}

// Image offset of pixel p of this thread's run, or -1 outside the image.
__device__ __forceinline__ long long pixel(int p, int y0, int x0, int h, int w) {
  const int y = y0 + (threadIdx.x / 32) * P + p, x = x0 + threadIdx.x % 32;
  return y < h && x < w ? (long long)y * w + x : -1;
}

template <int V>
__global__ void __launch_bounds__(kThreads, 3)
malta_kernel(const float* __restrict__ diffs, float* __restrict__ out, int h, int w) {
  __shared__ __align__(16) float window[2][kWindow];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const float* src = diffs + (size_t)blockIdx.z * 6 * plane;
  const int run = run_origin();

  float ac0[P], ac1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) ac0[p] = ac1[p] = 0.f;

  stage<V>(window[0], src, y0, x0, h, w);
#pragma unroll 1
  for (int c = 0; c < 6; ++c) {
    staged();
    // Plane c is in; every thread is done with plane c - 1's buffer.
    __syncthreads();
    if (c < 5) stage<V>(window[(c + 1) % 2], src + (c + 1) * plane, y0, x0, h, w);
    accumulate(window[c % 2] + run, c, ac0, ac1);
  }

  float* dst = out + (size_t)blockIdx.z * 2 * plane;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long gi = pixel(p, y0, x0, h, w);
    if (gi < 0) continue;
    dst[gi] = ac0[p];
    dst[plane + gi] = ac1[p];
  }
}

// --------------------------------------------------------------------- K5

// The Malta prologue: the asymmetric diff of reference value l0 and
// candidate value l1 (kernels/butteraugli.py _malta_prologue), with the
// per-channel constants n2g, n2l, n1 resolved on the host.
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
template <int V>
__global__ void __launch_bounds__(kThreads, 3)
malta_diffmap_kernel(const float* __restrict__ cand6, const float* __restrict__ ref6,
                     const float* __restrict__ cand_rest, const float* __restrict__ ref_rest,
                     const float* __restrict__ dac, const float* __restrict__ masks,
                     float* __restrict__ out, int h, int w, ce::Floats<18> ch,
                     ce::Floats<11> epi) {
  // The candidate's windows become diff windows in place.
  __shared__ __align__(16) float ref_window[2][kWindow];
  __shared__ __align__(16) float cand_window[2][kWindow];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const size_t b = blockIdx.z;
  const float* cand = cand6 + b * 6 * plane;
  const int run = run_origin();

  float ac0[P], ac1[P];
#pragma unroll
  for (int p = 0; p < P; ++p) ac0[p] = ac1[p] = 0.f;

  stage<V>(ref_window[0], ref6, y0, x0, h, w);
  stage<V>(cand_window[0], cand, y0, x0, h, w);
#pragma unroll 1
  for (int c = 0; c < 6; ++c) {
    staged();
    // Each thread turns the samples it staged into diff samples: no barrier
    // is needed between its copies and the prologue.
    const float n2g = ch.v[3 * c], n2l = ch.v[3 * c + 1], n1 = ch.v[3 * c + 2];
    float* t = cand_window[c % 2];
    const float* r = ref_window[c % 2];
    for_window<V>(y0, x0, h, w, [&](int i, bool in, size_t) {
#pragma unroll
      for (int e = i; e < i + V; ++e) t[e] = in ? prologue(r[e], t[e], n2g, n2l, n1) : 0.f;
    });
    // Plane c's diffs are in; every thread is done with plane c - 1's buffers.
    __syncthreads();
    if (c < 5) {
      stage<V>(ref_window[(c + 1) % 2], ref6 + (c + 1) * plane, y0, x0, h, w);
      stage<V>(cand_window[(c + 1) % 2], cand + (c + 1) * plane, y0, x0, h, w);
    }
    accumulate(t + run, c, ac0, ac1);
  }

  const float xmul = epi.v[10];
  const float* crest = cand_rest + b * 4 * plane;
  float* dst = out + b * plane;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long gl = pixel(p, y0, x0, h, w);
    if (gl < 0) continue;
    const size_t gi = gl;
    // Six-plane order: uhf_y, uhf_x, hf_y, hf_x, mf_y, mf_x.
    float a0 = ac0[p] + l2_asymmetric(ref6[3 * plane + gi], cand[3 * plane + gi], epi.v[0], epi.v[1]);
    float a1 = ac1[p] + l2_asymmetric(ref6[2 * plane + gi], cand[2 * plane + gi], epi.v[2], epi.v[3]);
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

// Whether 16-byte copies (V = 4) can read a plane that starts at p.
bool aligned(const float* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

// diffs: (b, 6, h, w); out: (b, 2, h, w).
extern "C" int ce_malta_ac(const float* diffs, float* out, int b, int h, int w, void* stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  auto kernel = w % 4 == 0 && aligned(diffs) ? malta_kernel<4> : malta_kernel<1>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(diffs, out, h, w);
  return (int)cudaGetLastError();
}

// cand6: (b, 6, h, w); ref6: (6, h, w); cand_rest: (b, 4, h, w); ref_rest:
// (4, h, w); dac: (b, h, w); masks: (2, h, w); out: (b, h, w).  ch: 18 host
// floats; epi: 11 host floats.
extern "C" int ce_malta_diffmap(const float* cand6, const float* ref6, const float* cand_rest,
                                const float* ref_rest, const float* dac, const float* masks,
                                float* out, int b, int h, int w, const float* ch,
                                const float* epi, void* stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  auto kernel = w % 4 == 0 && aligned(cand6) && aligned(ref6) ? malta_diffmap_kernel<4>
                                                               : malta_diffmap_kernel<1>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      cand6, ref6, cand_rest, ref_rest, dac, masks, out, h, w, ce::load_floats<18>(ch),
      ce::load_floats<11>(epi));
  return (int)cudaGetLastError();
}
