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
// Design:
//   - one thread per output element (all three channels), so each output is
//     a gather over its contraction interval, summed in a fixed order: no
//     atomics, and a launch repeats bit for bit. The Pallas transposes
//     accumulate over revisited output blocks and rely on the TPU running
//     the grid in order; Hopper runs blocks in no order, so the transposes
//     gather instead of scatter;
//   - the hat is zero beyond r, so a thread visits only the taps of
//     [floor(c - r) - 1, ceil(c + r) + 1] around its centre c (about 2r + 1,
//     not p0 or w). For the transposes the interval is solved from the
//     slope of the affine index (a in y for pass 2^T, g_x in x for pass 1^T)
//     by its sign, and is the full range when the slope is 0;
//   - each weight is evaluated with the plain version's expression
//     (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: never contracted into
//     FMAs), so every tap that is non-zero there is non-zero here; the sums
//     differ only in their order;
//   - the transposes divide by the forward's normaliser, recomputed for each
//     tap they visit (about 2r + 1 hat evaluations), so the backward needs
//     nothing saved from the forward but the window table;
//   - the window table is read once per thread; pass 1^T scans it for the
//     windows of its own image (N <= B * max_boxes).
//
// Bound on an H100 (chip_smoke.py computes it from a step's inputs): the
// bytes are each input read once and each output written once (pass 2 at
// b24 with 70 live windows of w = 320 writes 86 MB: about 0.026 ms at
// 3.35 TB/s); the operations are about 12 per non-zero tap (hat: 5, three
// FMAs: 6, the normaliser's add: 1), with 2r + 1 taps per output (about 0.005
// ms at 67 TFLOP/s). So bytes bound every pass. The design keeps each pass
// at one read and one write of its operands (the sums stay in registers;
// the re-read of canvas rows and t columns by neighbouring threads hits the
// L1 and L2 caches); fusing the two forward passes to keep t on chip is
// later work.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableCols = 8;
constexpr int kThreads = 256;
constexpr float kNormFloor = 1e-8f;

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

// hat(c - k) = max(0, 1 - |c - k| / r), as ops/eot.py `_hat`
__device__ __forceinline__ float hat(float c, int k, float r) {
  const float d = __fsub_rn(c, static_cast<float>(k));
  return fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(fabsf(d), r)));
}

// [lo, hi] within [0, n): the taps k whose hat(c - k) can be non-zero,
// widened by one on each side
__device__ __forceinline__ void taps_around(float c, float r, int n, int& lo,
                                            int& hi) {
  const float l = floorf(__fsub_rn(c, r)) - 1.0f;
  const float h = ceilf(__fadd_rn(c, r)) + 1.0f;
  lo = static_cast<int>(fminf(fmaxf(l, 0.0f), static_cast<float>(n)));
  hi = static_cast<int>(fminf(fmaxf(h, -1.0f), static_cast<float>(n - 1)));
}

// [lo, hi] within [0, n): the k with |slope * k + base - target| < r, where
// base does not depend on k, widened by one on each side; the full range for
// slope 0
__device__ __forceinline__ void taps_along(float slope, float base,
                                           float target, float r, int n,
                                           int& lo, int& hi) {
  if (slope == 0.0f) {
    lo = 0;
    hi = n - 1;
    return;
  }
  const float q0 = __fdiv_rn(__fsub_rn(__fsub_rn(target, r), base), slope);
  const float q1 = __fdiv_rn(__fsub_rn(__fadd_rn(target, r), base), slope);
  const float l = floorf(fminf(q0, q1)) - 1.0f;
  const float h = ceilf(fmaxf(q0, q1)) + 1.0f;
  lo = static_cast<int>(fminf(fmaxf(l, 0.0f), static_cast<float>(n)));
  hi = static_cast<int>(fminf(fmaxf(h, -1.0f), static_cast<float>(n - 1)));
}

// the forward's normaliser max(sum_k hat(c - k), 1e-8) over k in [0, n)
__device__ __forceinline__ float norm_at(float c, float r, int n) {
  int lo, hi;
  taps_around(c, r, n, lo, hi);
  float s = 0.0f;
  for (int k = lo; k <= hi; ++k) s += hat(c, k, r);
  return fmaxf(s, kNormFloor);
}

__global__ void __launch_bounds__(kThreads)
pass1_fwd_kernel(const float* __restrict__ canvas,
                 const float* __restrict__ table, int64_t total, int p0,
                 int w, float* __restrict__ t) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % w);
  const int i = static_cast<int>((idx / w) % p0);
  const int64_t n = idx / (static_cast<int64_t>(w) * p0);
  const Window q = load_window(table, n);
  const float g = affine(q.g_i, static_cast<float>(i), q.g_x,
                         static_cast<float>(x), q.g_c);
  const float* row = canvas + (static_cast<int64_t>(q.image) * p0 + i) * p0 * 3;
  int lo, hi;
  taps_around(g, q.r, p0, lo, hi);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, s = 0.0f;
  for (int j = lo; j <= hi; ++j) {
    const float h = hat(g, j, q.r);
    a0 += h * row[3 * j];
    a1 += h * row[3 * j + 1];
    a2 += h * row[3 * j + 2];
    s += h;
  }
  const float inv = __fdiv_rn(1.0f, fmaxf(s, kNormFloor));
  float* o = t + idx * 3;
  o[0] = a0 * inv;
  o[1] = a1 * inv;
  o[2] = a2 * inv;
}

__global__ void __launch_bounds__(kThreads)
pass2_fwd_kernel(const float* __restrict__ t, const float* __restrict__ table,
                 int64_t total, int p0, int w, float* __restrict__ out) {
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

__global__ void __launch_bounds__(kThreads)
pass2_bwd_kernel(const float* __restrict__ g, const float* __restrict__ table,
                 int64_t total, int p0, int w, float* __restrict__ dt) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % w);
  const int i = static_cast<int>((idx / w) % p0);
  const int64_t n = idx / (static_cast<int64_t>(w) * p0);
  const Window q = load_window(table, n);
  // u(y, x) - i = a * y + (b * x + cu) - i
  const float base = __fadd_rn(__fmul_rn(q.b, static_cast<float>(x)), q.cu);
  int lo, hi;
  taps_along(q.a, base, static_cast<float>(i), q.r, w, lo, hi);
  const float* col = g + (n * w * w + x) * 3;  // g[n, 0, x, :]
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int y = lo; y <= hi; ++y) {
    const float u = affine(q.a, static_cast<float>(y), q.b,
                           static_cast<float>(x), q.cu);
    const float h = hat(u, i, q.r);
    if (h == 0.0f) continue;
    const float nrm = norm_at(u, q.r, p0);
    const float* v = col + static_cast<int64_t>(y) * w * 3;
    a0 += h * __fdiv_rn(v[0], nrm);
    a1 += h * __fdiv_rn(v[1], nrm);
    a2 += h * __fdiv_rn(v[2], nrm);
  }
  float* o = dt + idx * 3;
  o[0] = a0;
  o[1] = a1;
  o[2] = a2;
}

__global__ void __launch_bounds__(kThreads)
pass1_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ table,
                 int n_win, int64_t total, int p0, int w,
                 float* __restrict__ dcanvas) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = static_cast<int>(idx % p0);
  const int i = static_cast<int>((idx / p0) % p0);
  const int b = static_cast<int>(idx / (static_cast<int64_t>(p0) * p0));
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int n = 0; n < n_win; ++n) {
    const Window q = load_window(table, n);
    if (q.image != b) continue;
    // g(i, x) - j = g_x * x + (g_i * i + g_c) - j
    const float base = __fadd_rn(__fmul_rn(q.g_i, static_cast<float>(i)), q.g_c);
    int lo, hi;
    taps_along(q.g_x, base, static_cast<float>(j), q.r, w, lo, hi);
    const float* row = dt + (static_cast<int64_t>(n) * p0 + i) * w * 3;
    for (int x = lo; x <= hi; ++x) {
      const float gc = affine(q.g_i, static_cast<float>(i), q.g_x,
                              static_cast<float>(x), q.g_c);
      const float h = hat(gc, j, q.r);
      if (h == 0.0f) continue;
      const float nrm = norm_at(gc, q.r, p0);
      const float* v = row + 3 * x;
      a0 += h * __fdiv_rn(v[0], nrm);
      a1 += h * __fdiv_rn(v[1], nrm);
      a2 += h * __fdiv_rn(v[2], nrm);
    }
  }
  float* o = dcanvas + idx * 3;
  o[0] = a0;
  o[1] = a1;
  o[2] = a2;
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
// the host). Each returns cudaErrorInvalidValue without launching when a
// size is out of range, else launches on `stream` and returns the
// cudaError_t of the launch (0 on success).

// canvas [n_img, p0, p0, 3] -> t [n_win, p0, w, 3]
extern "C" int mlad_warp_pass1_fwd(const float* canvas, const float* table,
                                   int n_win, int n_img, int p0, int w,
                                   float* t, void* stream) {
  if (n_img < 1 || !shapes_ok(n_win, p0, w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(n_win) * p0 * w;
  pass1_fwd_kernel<<<blocks_for(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(canvas, table, total,
                                                          p0, w, t);
  return static_cast<int>(cudaGetLastError());
}

// t [n_win, p0, w, 3] -> out [n_win, w, w, 3]
extern "C" int mlad_warp_pass2_fwd(const float* t, const float* table,
                                   int n_win, int p0, int w, float* out,
                                   void* stream) {
  if (!shapes_ok(n_win, p0, w)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n_win) * w * w;
  pass2_fwd_kernel<<<blocks_for(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(t, table, total, p0,
                                                          w, out);
  return static_cast<int>(cudaGetLastError());
}

// g [n_win, w, w, 3] -> dt [n_win, p0, w, 3]
extern "C" int mlad_warp_pass2_bwd(const float* g, const float* table,
                                   int n_win, int p0, int w, float* dt,
                                   void* stream) {
  if (!shapes_ok(n_win, p0, w)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(n_win) * p0 * w;
  pass2_bwd_kernel<<<blocks_for(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(g, table, total, p0,
                                                          w, dt);
  return static_cast<int>(cudaGetLastError());
}

// dt [n_win, p0, w, 3] -> dcanvas [n_img, p0, p0, 3] (every element written)
extern "C" int mlad_warp_pass1_bwd(const float* dt, const float* table,
                                   int n_win, int n_img, int p0, int w,
                                   float* dcanvas, void* stream) {
  if (n_img < 1 || !shapes_ok(n_win, p0, w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(n_img) * p0 * p0;
  pass1_bwd_kernel<<<blocks_for(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(dt, table, n_win,
                                                          total, p0, w,
                                                          dcanvas);
  return static_cast<int>(cudaGetLastError());
}
