// EOT two-pass hat-filter warp: the two forward passes and their transposes.
//
// Replaces the Pallas TPU kernels of tools/experiments/pallas_warp.py
// (`_pass1_fwd_kernel`, `_pass2_fwd_kernel`, `_pass2_bwd_kernel`,
// `_pass1_bwd_kernel`, under `warp_window`) and of
// tools/experiments/pallas_warp2.py (the same four functions, channel-major).
// Each entry computes what the plain version of the same name in
// mladversarialobjectdetection_torch/ops/eot.py computes, in float32:
//
//   pass 1:   t[n,i,x,c]   = sum_j hat(g(i,x) - j) canvas[img(n),i,j,c] / N1(i,x)
//   pass 2:   out[n,y,x,c] = sum_i hat(u(y,x) - i) t[n,i,x,c]          / N2(y,x)
//   pass 2^T: dt[n,i,x,c]  = sum_y hat(u(y,x) - i) (g[n,y,x,c] / N2(y,x))
//   pass 1^T: dcanvas[b,i,j,c] = sum_{n: img(n)=b} sum_x
//                                hat(g(i,x) - j) (dt[n,i,x,c] / N1(i,x))
//
// with g = (g_i*i + g_x*x) + g_c, u = (a*y + b*x) + cu, hat(d) =
// max(0, 1 - |d|/r) and N = max(sum over the contraction index of hat, 1e-8).
// One launch takes every live (image, slot) window of a step: canvases
// [B, p0, p0, 3], and a window table [N, 8] of (g_i, g_x, g_c, a, b, cu, r,
// image) per window; t and dt are [N, p0, w, 3], out and g [N, w, w, 3].
//
// Common to the four kernels:
//   - every output is a gather over its contraction interval, summed in a
//     fixed order: no atomics, and a launch repeats bit for bit. The Pallas
//     transposes accumulate over revisited output blocks and rely on the TPU
//     running the grid in order; Hopper runs blocks in no order, so the
//     transposes gather instead of scatter;
//   - the hat is zero beyond r, so an output visits only the taps around
//     its centre c (about 2r + 1, not p0 or w): [floor(c - r), ceil(c + r)]
//     (`taps_near`; pass 2 walks the union of 4 pixels' intervals, the
//     ablation [floor(c - r) - 1, ceil(c + r) + 1]). For the transposes' outputs the
//     interval is solved from the slope of the affine index (a in y for
//     pass 2^T, g_x in x for pass 1^T) by its sign, and is the full range
//     when the slope is 0 (`taps_along`);
//   - each weight is evaluated with the plain version's expression
//     (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: never contracted into
//     FMAs), so every tap that is non-zero there is non-zero here; the
//     results differ only in the order of the sums and in the
//     normalisation, a product with 1 / N where the plain version divides.
//
// The forward passes. Bytes bound them on an H100 (pass 2 at the attack step
// writes 86 MB, pass 1 26 MB).
//   - pass 2: one CTA per (window n, tile of 64 columns x by 16 rows y), a
//     thread per 4 adjacent pixels of a row, a half-warp per row. A thread
//     per output pixel that read its window's 8 floats from device memory,
//     walked two taps that are zero for certain, divided in every hat and
//     wrote its 3 floats with scalar stores ran at 47-52% of its byte bound
//     (kept as `pass2_fwd_per_output_kernel`, the ablation: no path calls
//     it). Here the window is read once into shared memory; a window with
//     r = 1 runs the hat without its division (`hat<true>`); a thread walks
//     the union of its 4 pixels' `taps_near` intervals (an empty one adds
//     nothing to it; a thread whose union is empty evaluates no hat) and
//     reads each tap's 4 pixels of t (12 floats) with three 16-byte loads,
//     from L1; its 12 outputs go through shared memory so that each 16-byte
//     store of a half-warp writes 256 contiguous bytes, whole sectors (each
//     thread storing its own 48 bytes was slower). Where w is not a multiple
//     of 4 or a pointer is not 16-byte aligned the same kernel runs with
//     scalar loads and stores. Staging a tile's band of t in shared memory,
//     a prefetch of the next tap's row, a CTA that walks several row tiles,
//     tiles of 32 or 128 columns and a register cap that spills were each
//     slower on the card (PERF.md). The sums keep i ascending, one
//     accumulator a channel, and the normaliser stays a product with 1 / N2;
//     a tap that is zero for a pixel adds +0 to its sums, which leaves a
//     float sum unchanged, so the outputs equal the ablation's bit for bit;
//   - pass 1: one CTA per (window n, block of 4 canvas rows i). A thread per
//     output that read its window's 8 floats and its canvas row from device
//     memory, walked two taps that are zero for certain and divided in
//     every hat ran at 40% of its byte bound. Here the window is read once
//     into shared memory, the block's canvas rows are staged there with
//     16-byte loads (4.6 KB at p0 = 96), the interval is `taps_near`, and a
//     window with r = 1 runs the hat without its division (`hat<true>`).
//     The sums keep j ascending and the normaliser stays a product with
//     1 / N1, and a zero tap adds nothing to a float sum, so the outputs
//     equal those of the thread-per-output version bit for bit.
//
// The transposes. A transpose divides each input by the forward's
// normaliser at that position, which depends on the position alone, and
// then spreads it over the 2r + 1 outputs whose hat reaches it. A thread
// per output that recomputes the normaliser for each tap (about 2r + 3 hat
// divisions, once for every output that reads the position), and that
// scans the whole window table in pass 1^T, ran at 16% and 6% of their
// byte bound. So each transpose stages the inputs it needs in shared
// memory, divided by their normaliser, computed once per position:
//   - pass 2^T: one CTA per (window n, strip of 32 columns x, block of 96
//     canvas rows i), its 96 x 32 outputs summed in shared memory. It walks
//     the strip's live rows y (those at which u(y, x) reaches [0, p0)
//     within r for some x of the strip, a host table [N, strips, 2]) in
//     chunks of 32: each position's normaliser once, g / N2 into shared
//     memory; then for each column the warps share out the rows i that the
//     chunk's taps reach, and each adds the chunk's taps to its output, y
//     ascending. dt is written once, zeros included;
//   - pass 1^T: one CTA per (canvas row i, image b, block of up to 128
//     columns j), a thread per column j. It stages the live columns x (a
//     host table [N, p0, 2]) of row i of all the image's windows at once, as
//     dt / N1, walking them in table order (the host's stable sort of the
//     table's image column, with offsets); then each thread adds its
//     column's taps, windows in table order, x ascending, in registers.
//     dcanvas is written once; an image with no window gets zeros.
// A position at which every hat is zero (the ends of a live range) is
// neither read nor divided: no tap reads it. The host tables are the window
// table's appendix, copied with it in one transfer (ops/warp_cuda.py builds
// them, and the CPU tests check that they cover every non-zero tap of the
// plain weights). A range that is too wide costs time, never a tap: every
// hat is still evaluated exactly and zeros are skipped.
//
// Bound on an H100 (chip_smoke.py computes it from a step's inputs): the
// bytes are each input position that a non-zero tap reads, read once, and
// each output written once (pass 2^T at the attack step: 46 MB, 0.0137 ms at
// 3.35 TB/s; pass 1^T: 8.7 MB); the operations are about 12 per non-zero tap
// (hat: 5, three FMAs: 6, the normaliser's add: 1). Bytes bound both
// transposes, yet by what moved their time on the card (PERF.md) what holds
// them is the instructions they issue, the hat's IEEE division first: it is
// evaluated for each tap of each staged normaliser and again for each
// output's taps. At r = 1 (every window whose patch is at least the
// canvas's size) that division is exact, |d| / 1 = |d|, so the transposes
// run an instance without it (`hat<true>`), chosen per window; their
// intervals visit no tap that is zero for certain; and `taps_along` takes
// the slope's reciprocal once per window.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableCols = 8;
constexpr int kThreads = 256;
constexpr float kNormFloor = 1e-8f;
constexpr int64_t kMaxSmem = 232448;  // 227 KB, the most a block can use

struct Window {
  float g_i, g_x, g_c, a, b, cu, r;
  int image;
};

__device__ __forceinline__ Window load_window(const float* table, int64_t n) {
  const float* q = table + n * kTableCols;
  Window w;
  w.g_i = q[0];
  w.g_x = q[1];
  w.g_c = q[2];
  w.a = q[3];
  w.b = q[4];
  w.cu = q[5];
  w.r = q[6];
  w.image = static_cast<int>(q[7]);
  return w;
}

// (alpha * m + beta * n) + gamma, in the plain version's order of operations
__device__ __forceinline__ float affine(float alpha, float m, float beta,
                                        float n, float gamma) {
  return __fadd_rn(__fadd_rn(__fmul_rn(alpha, m), __fmul_rn(beta, n)), gamma);
}

// hat(c - k) = max(0, 1 - |c - k| / r), as ops/eot.py `_hat`. At r = 1 the
// division is exact, so the kUnit instance (every kernel but the ablation)
// leaves it out and gets the same float
template <bool kUnit = false>
__device__ __forceinline__ float hat(float c, int k, float r) {
  const float d = __fsub_rn(c, static_cast<float>(k));
  const float q = kUnit ? fabsf(d) : __fdiv_rn(fabsf(d), r);
  return fmaxf(0.0f, __fsub_rn(1.0f, q));
}

// [lo, hi] within [0, n): the taps k whose hat(c - k) can be non-zero,
// widened by one on each side (the pass 2 ablation's)
__device__ __forceinline__ void taps_around(float c, float r, int n, int& lo,
                                            int& hi) {
  const float l = floorf(__fsub_rn(c, r)) - 1.0f;
  const float h = ceilf(__fadd_rn(c, r)) + 1.0f;
  lo = static_cast<int>(fminf(fmaxf(l, 0.0f), static_cast<float>(n)));
  hi = static_cast<int>(fminf(fmaxf(h, -1.0f), static_cast<float>(n - 1)));
}

// The other kernels' intervals hold no margin beyond the real one: their
// floor and ceil already take in the rounding of the affine index (well
// under a thousandth of a step), and each end may hold a zero tap. The CPU
// tests hold their float32 twins in ops/warp_cuda.py to every non-zero tap
// of the plain weights.

// [lo, hi] within [0, n): the k with |c - k| < r (`taps_near` in ops/warp_cuda.py)
__device__ __forceinline__ void taps_near(float c, float r, int n, int& lo,
                                          int& hi) {
  const float l = floorf(__fsub_rn(c, r));
  const float h = ceilf(__fadd_rn(c, r));
  lo = static_cast<int>(fminf(fmaxf(l, 0.0f), static_cast<float>(n)));
  hi = static_cast<int>(fminf(fmaxf(h, -1.0f), static_cast<float>(n - 1)));
}

// [lo, hi] within [0, n): the k with |slope * k + base - target| < r, where
// base does not depend on k; the full range for slope 0. inv is 1 / slope
// (__fdiv_rn, once per window): a product with it is within a few ulp of
// the quotient (`taps_along` in ops/warp_cuda.py)
__device__ __forceinline__ void taps_along(float slope, float inv, float base,
                                           float target, float r, int n,
                                           int& lo, int& hi) {
  if (slope == 0.0f) {
    lo = 0;
    hi = n - 1;
    return;
  }
  const float q0 = __fmul_rn(__fsub_rn(__fsub_rn(target, r), base), inv);
  const float q1 = __fmul_rn(__fsub_rn(__fadd_rn(target, r), base), inv);
  const float l = floorf(fminf(q0, q1));
  const float h = ceilf(fmaxf(q0, q1));
  lo = static_cast<int>(fminf(fmaxf(l, 0.0f), static_cast<float>(n)));
  hi = static_cast<int>(fminf(fmaxf(h, -1.0f), static_cast<float>(n - 1)));
}

// sum_k hat(c - k) over k in [0, n): the forward's normaliser before its floor
template <bool kUnit>
__device__ __forceinline__ float hat_sum(float c, float r, int n) {
  int lo, hi;
  taps_near(c, r, n, lo, hi);
  float s = 0.0f;
  for (int k = lo; k <= hi; ++k) s += hat<kUnit>(c, k, r);
  return s;
}

// v / nrm, three channels, into dst: one division, three products (as the
// forward passes normalise)
__device__ __forceinline__ void normalise3(const float* v, float nrm,
                                           float* dst) {
  const float inv = __fdiv_rn(1.0f, nrm);
  dst[0] = v[0] * inv;
  dst[1] = v[1] * inv;
  dst[2] = v[2] * inv;
}

// pass 1: a CTA per (window n, block of kRows1 canvas rows i). The
// window's parameters are read once into shared memory, and the block's
// canvas rows (p0 x 3 floats each) are staged there with 16-byte loads;
// then each thread sums its outputs (i, x) over the taps of `taps_near`,
// j ascending, with the exact hat (hat<true> when the window's r is 1).
constexpr int kRows1 = 4;

template <bool kUnit>
__device__ __forceinline__ void pass1_fwd_rows(const float* rows, const Window& q,
                                               int n, int i0, int nr, int p0,
                                               int w, float* __restrict__ t) {
  for (int f = threadIdx.x; f < nr * w; f += blockDim.x) {
    const int r = f / w, x = f - r * w, i = i0 + r;
    const float g = affine(q.g_i, static_cast<float>(i), q.g_x,
                           static_cast<float>(x), q.g_c);
    const float* row = rows + r * p0 * 3;
    int lo, hi;
    taps_near(g, q.r, p0, lo, hi);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, s = 0.0f;
    for (int j = lo; j <= hi; ++j) {
      const float h = hat<kUnit>(g, j, q.r);
      a0 += h * row[3 * j];
      a1 += h * row[3 * j + 1];
      a2 += h * row[3 * j + 2];
      s += h;
    }
    const float inv = __fdiv_rn(1.0f, fmaxf(s, kNormFloor));
    float* o = t + ((static_cast<int64_t>(n) * p0 + i) * w + x) * 3;
    o[0] = a0 * inv;
    o[1] = a1 * inv;
    o[2] = a2 * inv;
  }
}

__global__ void __launch_bounds__(kThreads)
pass1_fwd_kernel(const float* __restrict__ canvas,
                 const float* __restrict__ table, int p0, int w,
                 float* __restrict__ t) {
  extern __shared__ float4 rows4[];  // [nr][p0][3] of image(n)'s canvas
  __shared__ Window q_s;
  float* rows = reinterpret_cast<float*>(rows4);
  const int n = blockIdx.x;
  const int i0 = blockIdx.y * kRows1;
  const int nr = min(kRows1, p0 - i0);
  if (threadIdx.x == 0) q_s = load_window(table, n);
  __syncthreads();
  const Window q = q_s;
  // rows i0 .. i0 + nr - 1 of the image are contiguous
  const float* src = canvas + (static_cast<int64_t>(q.image) * p0 + i0) * p0 * 3;
  const int count = nr * p0 * 3;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (count & 3) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int k = threadIdx.x; k < count / 4; k += blockDim.x) rows4[k] = __ldg(src4 + k);
  } else {
    for (int k = threadIdx.x; k < count; k += blockDim.x) rows[k] = __ldg(src + k);
  }
  __syncthreads();
  if (q.r == 1.0f) {
    pass1_fwd_rows<true>(rows, q, n, i0, nr, p0, w, t);
  } else {
    pass1_fwd_rows<false>(rows, q, n, i0, nr, p0, w, t);
  }
}

// pass 2: a CTA per (window n, tile of kTileX columns x by kTileY rows y), a
// thread per kQuad adjacent pixels (y, x0 .. x0 + 3) of a row, a half-warp
// per row of the tile. The union of the pixels' `taps_near` intervals, i
// ascending: each tap reads the quad's 12 floats of t row i and adds hat * t
// to each pixel's sums (+0 where the tap is outside that pixel's interval).
// kVec: w % 4 == 0 and t, out 16-byte aligned, so the 12 floats are three
// float4s, and a half-warp's row of outputs (768 bytes) goes through shared
// memory so that each store instruction writes whole sectors.
constexpr int kQuad = 4;
constexpr int kTileX = 64;
constexpr int kQuadsX = kTileX / kQuad;  // 16: a half-warp
constexpr int kTileY = kThreads / kQuadsX;

// the quad's outputs o[3 * k + c] of pixel (y, x0 + k), k < nx
template <bool kUnit, bool kVec>
__device__ __forceinline__ void pass2_fwd_quad(const float* __restrict__ t,
                                               const Window& q, int n, int y,
                                               int x0, int nx, int p0, int w,
                                               float (&o)[kQuad * 3]) {
  float u[kQuad];
  int lo = p0, hi = -1;
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    u[k] = affine(q.a, static_cast<float>(y), q.b, static_cast<float>(x0 + k),
                  q.cu);
    int l, h;
    taps_near(u[k], q.r, p0, l, h);
    if (k < nx && l <= h) {
      lo = min(lo, l);
      hi = max(hi, h);
    }
  }
  float acc[kQuad * 3], s[kQuad];
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    acc[3 * k] = acc[3 * k + 1] = acc[3 * k + 2] = s[k] = 0.0f;
  }
  const float* col = t + (static_cast<int64_t>(n) * p0 * w + x0) * 3;
  for (int i = lo; i <= hi; ++i) {
    const float* src = col + static_cast<int64_t>(i) * w * 3;
    float v[kQuad * 3];
    if (kVec) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float4 f = __ldg(src4 + m);
        v[4 * m] = f.x;
        v[4 * m + 1] = f.y;
        v[4 * m + 2] = f.z;
        v[4 * m + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int m = 0; m < kQuad * 3; ++m) {
        v[m] = 0.0f;
        if (m < 3 * nx) v[m] = __ldg(src + m);
      }
    }
#pragma unroll
    for (int k = 0; k < kQuad; ++k) {
      const float h = hat<kUnit>(u[k], i, q.r);
      acc[3 * k] += h * v[3 * k];
      acc[3 * k + 1] += h * v[3 * k + 1];
      acc[3 * k + 2] += h * v[3 * k + 2];
      s[k] += h;
    }
  }
  if (lo > hi) return;  // no tap: o stays 0, as 0 * (1 / N2) is +0
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    const float inv = __fdiv_rn(1.0f, fmaxf(s[k], kNormFloor));
    o[3 * k] = acc[3 * k] * inv;
    o[3 * k + 1] = acc[3 * k + 1] * inv;
    o[3 * k + 2] = acc[3 * k + 2] * inv;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pass2_fwd_kernel(const float* __restrict__ t, const float* __restrict__ table,
                 int p0, int w, float* __restrict__ out) {
  __shared__ Window q_s;
  __shared__ float4 stage[kThreads * 3];  // each thread's 12 outputs, 12 KB
  const int n = blockIdx.x;
  const int lane_x = threadIdx.x % kQuadsX;
  const int xt = blockIdx.y * kTileX;
  const int x0 = xt + lane_x * kQuad;
  const int y = blockIdx.z * kTileY + threadIdx.x / kQuadsX;
  const int nx = min(kQuad, w - x0);  // pixels of the quad inside w
  if (threadIdx.x == 0) q_s = load_window(table, n);
  __syncthreads();
  const Window q = q_s;
  float o[kQuad * 3];
#pragma unroll
  for (int m = 0; m < kQuad * 3; ++m) o[m] = 0.0f;
  if (y < w && nx > 0) {
    if (q.r == 1.0f) {
      pass2_fwd_quad<true, kVec>(t, q, n, y, x0, nx, p0, w, o);
    } else {
      pass2_fwd_quad<false, kVec>(t, q, n, y, x0, nx, p0, w, o);
    }
  }
  float* row = out + ((static_cast<int64_t>(n) * w + y) * w + xt) * 3;
  if (!kVec) {
    if (y >= w) return;
#pragma unroll
    for (int m = 0; m < kQuad * 3; ++m) {
      if (m < 3 * nx) row[3 * kQuad * lane_x + m] = o[m];
    }
    return;
  }
  // the half-warp's row of 16 quads, in order, then float4 m * 16 + lane_x
  // of it from each thread: 256 contiguous bytes a half-warp a store
  float4* mine = stage + 3 * threadIdx.x;
  mine[0] = make_float4(o[0], o[1], o[2], o[3]);
  mine[1] = make_float4(o[4], o[5], o[6], o[7]);
  mine[2] = make_float4(o[8], o[9], o[10], o[11]);
  __syncwarp();
  if (y >= w) return;
  const float4* half = stage + 3 * (threadIdx.x - lane_x);
  const int count = min(kTileX, w - xt) * 3 / 4;  // float4s of the row (w % 4 == 0)
  float4* dst = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int f = m * kQuadsX + lane_x;
    if (f < count) dst[f] = half[f];
  }
}

// pass 2's first kernel, a thread per output pixel: the ablation timed
// beside pass2_fwd_kernel, which no path calls
__global__ void __launch_bounds__(kThreads)
pass2_fwd_per_output_kernel(const float* __restrict__ t,
                            const float* __restrict__ table, int64_t total,
                            int p0, int w, float* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % w);
  const int y = static_cast<int>((idx / w) % w);
  const int64_t n = idx / (static_cast<int64_t>(w) * w);
  const Window q = load_window(table, n);
  const float u = affine(q.a, static_cast<float>(y), q.b,
                         static_cast<float>(x), q.cu);
  const float* col = t + (n * p0 * w + x) * 3;  // t[n, 0, x, :]
  int lo, hi;
  taps_around(u, q.r, p0, lo, hi);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, s = 0.0f;
  for (int i = lo; i <= hi; ++i) {
    const float h = hat(u, i, q.r);
    const float* v = col + static_cast<int64_t>(i) * w * 3;
    a0 += h * v[0];
    a1 += h * v[1];
    a2 += h * v[2];
    s += h;
  }
  const float inv = __fdiv_rn(1.0f, fmaxf(s, kNormFloor));
  float* o = out + idx * 3;
  o[0] = a0 * inv;
  o[1] = a1 * inv;
  o[2] = a2 * inv;
}

// pass 2^T: a CTA per (window, strip of kStrip columns x, block of
// kRowBlock canvas rows i); its outputs dt[n, i, x, :] are summed in shared
// memory
constexpr int kStrip = 32;
constexpr int kChunk = 32;  // rows y staged per step
constexpr int kWarps = 8;
constexpr int kRowBlock = 96;  // one block at the path's p0

// the chunks of the strip's live rows [ylo, yhi]: stage g / N2, then add
// each chunk's taps to the outputs in acc
template <bool kUnit>
__device__ __forceinline__ void pass2_bwd_rows(
    const float* __restrict__ g, const Window& q, int n, int x0, int i_base,
    int i_last, int ylo, int yhi, int p0, int w, float* gn, float* acc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = x0 + lane;
  // u(y, x) - i = a * y + (b * x + cu) - i
  const float base = __fadd_rn(__fmul_rn(q.b, static_cast<float>(x)), q.cu);
  const float inv_a = __fdiv_rn(1.0f, q.a);
  for (int y0 = ylo; y0 <= yhi; y0 += kChunk) {
    const int ny = min(kChunk, yhi - y0 + 1);
    for (int p = threadIdx.x; p < ny * kStrip; p += blockDim.x) {
      const int y = y0 + p / kStrip;
      const int xs = x0 + p % kStrip;
      float* dst = gn + 3 * p;
      dst[0] = dst[1] = dst[2] = 0.0f;
      if (xs < w) {
        const float u = affine(q.a, static_cast<float>(y), q.b,
                               static_cast<float>(xs), q.cu);
        const float s = hat_sum<kUnit>(u, q.r, p0);
        if (s > 0.0f) {  // else no tap reads the position
          normalise3(g + ((static_cast<int64_t>(n) * w + y) * w + xs) * 3,
                     fmaxf(s, kNormFloor), dst);
        }
      }
    }
    __syncthreads();  // (the first one also orders the zero fill of acc)
    if (x < w) {
      // the rows i that a tap of this chunk reaches at column x: u is
      // monotone in y, so they lie around u at the chunk's two ends
      const float ua = affine(q.a, static_cast<float>(y0), q.b,
                              static_cast<float>(x), q.cu);
      const float ub = affine(q.a, static_cast<float>(y0 + ny - 1), q.b,
                              static_cast<float>(x), q.cu);
      int ilo, ihi, unused;
      taps_near(fminf(ua, ub), q.r, p0, ilo, unused);
      taps_near(fmaxf(ua, ub), q.r, p0, unused, ihi);
      ihi = min(ihi, i_last);
      for (int i = max(ilo, i_base) + warp; i <= ihi; i += kWarps) {
        int lo, hi;
        taps_along(q.a, inv_a, base, static_cast<float>(i), q.r, w, lo, hi);
        lo = max(lo, y0);
        hi = min(hi, y0 + ny - 1);
        if (lo > hi) continue;
        float* o = acc + 3 * ((i - i_base) * kStrip + lane);
        float a0 = o[0], a1 = o[1], a2 = o[2];  // y ascending across chunks
        for (int y = lo; y <= hi; ++y) {
          const float u = affine(q.a, static_cast<float>(y), q.b,
                                 static_cast<float>(x), q.cu);
          const float h = hat<kUnit>(u, i, q.r);
          if (h == 0.0f) continue;
          const float* v = gn + 3 * ((y - y0) * kStrip + lane);
          a0 += h * v[0];
          a1 += h * v[1];
          a2 += h * v[2];
        }
        o[0] = a0;
        o[1] = a1;
        o[2] = a2;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kWarps * 32)
pass2_bwd_kernel(const float* __restrict__ g, const float* __restrict__ table,
                 const int* __restrict__ rows, int p0, int w,
                 float* __restrict__ dt) {
  __shared__ float gn[kChunk * kStrip * 3];      // g / N2 of a chunk
  __shared__ float acc[kRowBlock * kStrip * 3];  // the outputs, 36 KB
  const int n = blockIdx.x;
  const int x0 = blockIdx.y * kStrip;
  const int i_base = blockIdx.z * kRowBlock;
  const int i_last = min(p0, i_base + kRowBlock) - 1;
  for (int f = threadIdx.x; f < kRowBlock * kStrip * 3; f += blockDim.x) {
    acc[f] = 0.0f;
  }
  const Window q = load_window(table, n);
  const int* live = rows + 2 * (static_cast<int64_t>(n) * gridDim.y + blockIdx.y);
  if (q.r == 1.0f) {
    pass2_bwd_rows<true>(g, q, n, x0, i_base, i_last, live[0], live[1], p0,
                         w, gn, acc);
  } else {
    pass2_bwd_rows<false>(g, q, n, x0, i_base, i_last, live[0], live[1], p0,
                          w, gn, acc);
  }
  __syncthreads();  // a strip with no live row has passed no barrier yet
  // dt[n, i_base:i_last + 1, x0:x0 + cols, :], rows of 3 * cols floats
  const int cols3 = 3 * min(kStrip, w - x0);
  const int total = (i_last - i_base + 1) * cols3;
  for (int f = threadIdx.x; f < total; f += blockDim.x) {
    const int r = f / cols3, c = f - r * cols3;
    dt[((static_cast<int64_t>(n) * p0 + i_base + r) * w + x0) * 3 + c] =
        acc[r * kStrip * 3 + c];
  }
}

// pass 1^T: a CTA per (canvas row i, image b, block of up to kColBlock
// canvas columns j), a thread per column j. A round stages up to kStage
// positions: the live columns of row i of the image's windows, in table
// order; a window longer than what is left of a round goes on in the next.
constexpr int kColBlock = 128;
constexpr int kStage = 1024;

// A place in the walk over an image's windows: the window's position o in
// the image's run of `order`, and the columns of it already staged.
struct Cursor {
  int o, done;
};

// dn[p] = dt[n, i, first + p, :] / N1(i, first + p) for p in [from, to),
// each thread its own slots
template <bool kUnit>
__device__ __forceinline__ void pass1_bwd_stage(const float* __restrict__ row,
                                                const Window& q, int i,
                                                int first, int from, int to,
                                                int p0, float* dn) {
  for (int p = from + threadIdx.x; p < to; p += blockDim.x) {
    const int x = first + p;
    const float gc = affine(q.g_i, static_cast<float>(i), q.g_x,
                            static_cast<float>(x), q.g_c);
    const float s = hat_sum<kUnit>(gc, q.r, p0);
    float* dst = dn + 3 * p;
    dst[0] = dst[1] = dst[2] = 0.0f;
    if (s > 0.0f) normalise3(row + 3 * x, fmaxf(s, kNormFloor), dst);
  }
}

// the taps of column j over the staged columns [x_from, x_to] of a window
template <bool kUnit>
__device__ __forceinline__ void pass1_bwd_gather(const Window& q, int i, int j,
                                                 int first, int x_from,
                                                 int x_to, int w,
                                                 const float* dn, float& a0,
                                                 float& a1, float& a2) {
  // g(i, x) - j = g_x * x + (g_i * i + g_c) - j
  const float base = __fadd_rn(__fmul_rn(q.g_i, static_cast<float>(i)), q.g_c);
  int lo, hi;
  taps_along(q.g_x, __fdiv_rn(1.0f, q.g_x), base, static_cast<float>(j), q.r,
             w, lo, hi);
  lo = max(lo, x_from);
  hi = min(hi, x_to);
  for (int x = lo; x <= hi; ++x) {
    const float gc = affine(q.g_i, static_cast<float>(i), q.g_x,
                            static_cast<float>(x), q.g_c);
    const float h = hat<kUnit>(gc, j, q.r);
    if (h == 0.0f) continue;
    const float* v = dn + 3 * (x - first);
    a0 += h * v[0];
    a1 += h * v[1];
    a2 += h * v[2];
  }
}

__global__ void __launch_bounds__(kColBlock)
pass1_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ table,
                 const int* __restrict__ order, const int* __restrict__ offsets,
                 const int* __restrict__ cols, int p0, int w,
                 float* __restrict__ dcanvas) {
  __shared__ float dn[kStage * 3];  // dt / N1 of the staged columns, 12 KB
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int j = blockIdx.z * blockDim.x + threadIdx.x;
  const int o_end = offsets[b + 1];
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  Cursor at{offsets[b], 0};
  while (at.o < o_end) {
    // stage: every thread walks the same windows and takes its own slots
    Cursor c = at;
    int slot = 0;
    for (; c.o < o_end && slot < kStage; ++c.o, c.done = 0) {
      const int n = order[c.o];
      const int* live = cols + 2 * (static_cast<int64_t>(n) * p0 + i);
      const int len = live[1] - live[0] + 1 - c.done;
      if (len <= 0) continue;
      const int take = min(len, kStage - slot);
      const Window q = load_window(table, n);
      const float* row = dt + (static_cast<int64_t>(n) * p0 + i) * w * 3;
      const int first = live[0] + c.done - slot;  // the column at slot 0
      if (q.r == 1.0f) {
        pass1_bwd_stage<true>(row, q, i, first, slot, slot + take, p0, dn);
      } else {
        pass1_bwd_stage<false>(row, q, i, first, slot, slot + take, p0, dn);
      }
      slot += take;
      if (take < len) {  // the round ends inside this window
        c.done += take;
        break;
      }
    }
    __syncthreads();
    // gather: the same walk, windows in table order, x ascending
    slot = 0;
    for (Cursor d = at; slot < kStage && d.o < o_end; ++d.o, d.done = 0) {
      const int n = order[d.o];
      const int* live = cols + 2 * (static_cast<int64_t>(n) * p0 + i);
      const int len = live[1] - live[0] + 1 - d.done;
      if (len <= 0) continue;
      const int take = min(len, kStage - slot);
      const int first = live[0] + d.done - slot;
      if (j < p0) {
        const Window q = load_window(table, n);
        if (q.r == 1.0f) {
          pass1_bwd_gather<true>(q, i, j, first, first + slot,
                                 first + slot + take - 1, w, dn, a0, a1, a2);
        } else {
          pass1_bwd_gather<false>(q, i, j, first, first + slot,
                                  first + slot + take - 1, w, dn, a0, a1, a2);
        }
      }
      slot += take;
    }
    __syncthreads();
    at = c;
  }
  if (j >= p0) return;
  float* out = dcanvas + ((static_cast<int64_t>(b) * p0 + i) * p0 + j) * 3;
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
}

int blocks_for(int64_t total) {
  return static_cast<int>((total + kThreads - 1) / kThreads);
}

bool shapes_ok(int n_win, int p0, int w) {
  // a grid of at most 2^31 - 1 blocks
  const int64_t most = static_cast<int64_t>(n_win) * w * (w > p0 ? w : p0);
  return n_win >= 1 && p0 >= 1 && w >= 1 &&
         most <= static_cast<int64_t>(kThreads) * 0x7fffffff;
}

}  // namespace

// C entries for ctypes. All arrays are float32 and contiguous; `table` is
// [n_win, 8] with every image index in [0, n_img) (the wrapper checks it on
// the host). For the transposes the table carries an int32 appendix, copied
// with it in one transfer (ops/warp_cuda.py `pass2_bwd_ranges`,
// `pass1_bwd_ranges`):
//   pass 2^T: rows [n_win, ceil(w / 32), 2], the live rows y of each strip
//             of 32 columns, an inclusive range (empty when lo > hi);
//   pass 1^T: order [n_win], the windows sorted by image, stably;
//             offsets [n_img + 1] into it; cols [n_win, p0, 2], the live
//             columns x of each window's row i.
// Each returns cudaErrorInvalidValue without launching when a size is out
// of range, else launches on `stream` and returns the cudaError_t of the
// launch (0 on success).

// canvas [n_img, p0, p0, 3] -> t [n_win, p0, w, 3]
extern "C" int mlad_warp_pass1_fwd(const float* canvas, const float* table,
                                   int n_win, int n_img, int p0, int w,
                                   float* t, void* stream) {
  const int row_blocks = (p0 + kRows1 - 1) / kRows1;
  const int64_t smem = static_cast<int64_t>(p0 < kRows1 ? p0 : kRows1) * p0 * 3 *
                       static_cast<int64_t>(sizeof(float));
  if (n_img < 1 || !shapes_ok(n_win, p0, w) || row_blocks > 65535 ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pass1_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pass1_fwd_kernel<<<dim3(n_win, row_blocks), kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(canvas, table, p0, w, t);
  return static_cast<int>(cudaGetLastError());
}

// t [n_win, p0, w, 3] -> out [n_win, w, w, 3]
extern "C" int mlad_warp_pass2_fwd(const float* t, const float* table,
                                   int n_win, int p0, int w, float* out,
                                   void* stream) {
  const int tiles_x = (w + kTileX - 1) / kTileX;
  const int tiles_y = (w + kTileY - 1) / kTileY;
  if (!shapes_ok(n_win, p0, w) || tiles_x > 65535 || tiles_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_win, tiles_x, tiles_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = w % kQuad == 0 &&
                   ((reinterpret_cast<uintptr_t>(t) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    pass2_fwd_kernel<true><<<grid, kThreads, 0, s>>>(t, table, p0, w, out);
  } else {
    pass2_fwd_kernel<false><<<grid, kThreads, 0, s>>>(t, table, p0, w, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// the same, by the ablation (a thread per output pixel)
extern "C" int mlad_warp_pass2_fwd_ablation(const float* t, const float* table,
                                            int n_win, int p0, int w,
                                            float* out, void* stream) {
  if (!shapes_ok(n_win, p0, w)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n_win) * w * w;
  pass2_fwd_per_output_kernel<<<blocks_for(total), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      t, table, total, p0, w, out);
  return static_cast<int>(cudaGetLastError());
}

// g [n_win, w, w, 3] -> dt [n_win, p0, w, 3]
extern "C" int mlad_warp_pass2_bwd(const float* g, const float* table,
                                   int n_win, int p0, int w, float* dt,
                                   void* stream) {
  const int strips = (w + kStrip - 1) / kStrip;
  const int row_blocks = (p0 + kRowBlock - 1) / kRowBlock;
  if (n_win < 1 || p0 < 1 || w < 1 || strips > 65535 || row_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* rows = reinterpret_cast<const int*>(
      table + static_cast<int64_t>(n_win) * kTableCols);
  pass2_bwd_kernel<<<dim3(n_win, strips, row_blocks), kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(g, table, rows, p0,
                                                          w, dt);
  return static_cast<int>(cudaGetLastError());
}

// dt [n_win, p0, w, 3] -> dcanvas [n_img, p0, p0, 3] (every element written)
extern "C" int mlad_warp_pass1_bwd(const float* dt, const float* table,
                                   int n_win, int n_img, int p0, int w,
                                   float* dcanvas, void* stream) {
  const int threads = p0 < kColBlock ? (p0 + 31) / 32 * 32 : kColBlock;
  const int col_blocks = (p0 + threads - 1) / threads;
  if (n_win < 1 || n_img < 1 || n_img > 65535 || p0 < 1 || w < 1 ||
      col_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* order = reinterpret_cast<const int*>(
      table + static_cast<int64_t>(n_win) * kTableCols);
  const int* offsets = order + n_win;
  const int* cols = offsets + n_img + 1;
  pass1_bwd_kernel<<<dim3(p0, n_img, col_blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      dt, table, order, offsets, cols, p0, w, dcanvas);
  return static_cast<int>(cudaGetLastError());
}
