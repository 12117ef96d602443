// Fused frozen (eval-mode) MBConv block: forward and input gradient.
//
// Replaces the Pallas TPU kernels of tools/experiments/fused_mbconv.py:
// `_fwd_kernel` (called through `_mbconv_fwd_pallas`) and the dx
// `_bwd_kernel` (through `_mbconv_bwd_pallas`). It computes what
// `mbconv_plain` and `mbconv_dx_plain` of
// mladversarialobjectdetection_torch/ops/mbconv.py compute, in float32, with
// the three BatchNorms folded into the convs (`fold_block`):
//
//   z0 = x . We + be            e  = act(z0), zero outside the image
//   z1 = dwconv_kxk(e) + bd     d  = act(z1)          ('SAME', stride 1)
//   y  = d . Wp + bp  [+ x]
//
// and for the input gradient, given g = dL/dy:
//
//   gd = (g . Wp^T) * act'(z1)   ge = dwconv^T(gd) * act'(z0)
//   dx = ge . We^T  [+ g]
//
// x [B, H, W, C] (NHWC, contiguous), We [C, E], be [E], wd [k, k, E],
// bd [E], Wp [E, Co], bp [Co]; k is 3 or 5; act is relu6, relu or swish.
//
// Design:
//   - a block of 256 threads owns an 8x8 tile of output pixels of one image
//     and reads its haloed input with bounds checks: no padded copy in
//     device memory (the TPU wrapper materializes overlapping row tiles with
//     their halo, `_halo_rows`, and needs a row tile that divides H), any H
//     and W;
//   - the expanded width E is walked in chunks of 32, one channel per lane:
//     (1) the haloed tile's expand for the chunk, the input staged through
//     shared memory 32 channels at a time, (2) act and the image mask into
//     shared memory, (3) the depthwise into a chunk of d, (4) the project
//     accumulated into a [64 pixels][Co] sum in shared memory. e and d never
//     leave the block; the TPU kernel keeps them in VMEM the same way;
//   - the depthwise SAME padding pads e, not x: e is zeroed outside the
//     image (fused_mbconv.py:223-229), since act(be) is not 0;
//   - z0 and z1 are summed in the order of `mbconv_dx_plain` (C ascending
//     from 0, then be; bd, then the taps row by row) with __fmul_rn /
//     __fadd_rn, never contracted into an FMA, so they equal its z0 and z1
//     bit for bit. The masks act'(z0) and act'(z1) of relu6 / relu
//     therefore agree exactly with the plain version's; a ulp of difference
//     at a kink would otherwise drop a whole term from dx. The forward
//     computes z0 the same way (one code path), though its output is
//     continuous in z0. The 1x1 products (project, g . Wp^T, ge . We^T) and
//     the depthwise transpose are continuous and use FMAs in their own order;
//   - the dx kernel recomputes e on the tile with a halo of 2h and z1, g .
//     Wp^T and gd with a halo of h (fused_mbconv.py:282-339), saving nothing
//     but x in the forward, and writes dx without atomics.
//
// Bound on an H100 (chip_smoke.py computes it from the path's shapes):
// operations 2 (C E + k^2 E + E Co) per output pixel in the forward and
// 2 (C E + 2 k^2 E + 2 E Co + E C) in dx, over 67 TFLOP/s float32; the bytes
// (x, g and the output once, weights once) are a few percent of that time at
// every lite4@640 shape, so operations bound both. The kernel repeats the
// expand on the halo (x 1.56 for k3, x 2.25 for k5 in the forward; x 2.25 /
// x 4 in dx), and the separate multiply and add of the ordered sums halve
// their issue rate. Tensor cores (3xTF32), TMA and larger tiles are later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;                // output tile side
constexpr int kPix = kTile * kTile;     // output pixels per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEC = 32;                 // expanded channels per chunk (a warp)
constexpr int kCC = 32;                 // contraction channels staged at once
constexpr int kGroup = 8;               // pixels per thread in the 1x1 products
constexpr int kMaxSmem = 232448;        // 227 KB, the most a block can use

enum Act { kRelu6 = 0, kRelu = 1, kSwish = 2 };

template <int ACT>
__device__ __forceinline__ float act_fn(float z) {
  if (ACT == kRelu6) return fminf(fmaxf(z, 0.0f), 6.0f);
  if (ACT == kRelu) return fmaxf(z, 0.0f);
  return z * (1.0f / (1.0f + expf(-z)));
}

template <int ACT>
__device__ __forceinline__ float dact_fn(float z) {
  if (ACT == kRelu6) return (z > 0.0f && z < 6.0f) ? 1.0f : 0.0f;
  if (ACT == kRelu) return z > 0.0f ? 1.0f : 0.0f;
  const float s = 1.0f / (1.0f + expf(-z));
  return s * (1.0f + z * (1.0f - s));
}

__device__ __forceinline__ bool in_image(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

// Stage a [SIDE * SIDE pixels][kCC channels] tile of the NHWC image `src`
// (row origin y0, column origin x0, channels c0..) into `dst`, zero outside
// the image and past `n_ch`; and the [kCC][kEC] weight slice
// w[(c0 + cc) * w_stride + e0 + j] (w_t: w[(e0 + j) * w_stride + c0 + cc]).
// The trip counts are compile-time constants, so each thread issues all its
// loads before the first one has to arrive.
template <int SIDE, bool W_T>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int y0, int x0, int c0, int H, int W,
                                      int n_ch, const float* __restrict__ w,
                                      int w_stride, int e0, int E,
                                      float* dst, float* dst_w) {
  constexpr int n = SIDE * SIDE * kCC;
#pragma unroll
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    if (n % kThreads == 0 || i < n) {
      const int p = i / kCC, c = c0 + i % kCC;
      const int y = y0 + p / SIDE, x = x0 + p % SIDE;
      dst[i] = (c < n_ch && in_image(y, x, H, W))
                   ? __ldg(src + (static_cast<int64_t>(y) * W + x) * n_ch + c)
                   : 0.0f;
    }
  }
#pragma unroll
  for (int i = threadIdx.x; i < kCC * kEC; i += kThreads) {
    const int c = c0 + i / kEC, e = e0 + i % kEC;
    float v = 0.0f;
    if (c < n_ch && e < E) {
      v = W_T ? __ldg(w + static_cast<int64_t>(e) * w_stride + c)
              : __ldg(w + static_cast<int64_t>(c) * w_stride + e);
    }
    dst_w[i] = v;
  }
}

// z[i] (pixel warp + kWarps * i of an N-pixel tile, channel e0 + lane) +=
// sum over the staged kCC channels of s_x[p][cc] * s_w[cc][lane], in channel
// order; ORDERED keeps the multiply and the add apart.
template <int N, bool ORDERED>
__device__ __forceinline__ void accumulate(const float* s_x, const float* s_w,
                                           int n_ch, float* z) {
  constexpr int kPerWarp = (N + kWarps - 1) / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n4 = (n_ch + 3) & ~3;  // the staged tail is zero
  for (int cc = 0; cc < n4; cc += 4) {
    const float w0 = s_w[(cc + 0) * kEC + lane], w1 = s_w[(cc + 1) * kEC + lane];
    const float w2 = s_w[(cc + 2) * kEC + lane], w3 = s_w[(cc + 3) * kEC + lane];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int p = warp + kWarps * i;
      if (p < N) {
        const float4 v = *reinterpret_cast<const float4*>(s_x + p * kCC + cc);
        if (ORDERED) {
          z[i] = __fadd_rn(z[i], __fmul_rn(v.x, w0));
          z[i] = __fadd_rn(z[i], __fmul_rn(v.y, w1));
          z[i] = __fadd_rn(z[i], __fmul_rn(v.z, w2));
          z[i] = __fadd_rn(z[i], __fmul_rn(v.w, w3));
        } else {
          z[i] = fmaf(v.x, w0, z[i]);
          z[i] = fmaf(v.y, w1, z[i]);
          z[i] = fmaf(v.z, w2, z[i]);
          z[i] = fmaf(v.w, w3, z[i]);
        }
      }
    }
  }
}

// s_acc[q][o] += sum_j s_in[q][j] * w[(e0 + j) * n_out + o] (w_t: w[o *
// w_stride + e0 + j]) over the chunk's n_e channels, for the kPix pixels.
// W_T (dx) unrolls the channel loop over a fixed trip count so that the
// weight loads are issued ahead (s_in is zero past n_e, and those weights
// are not read); in the forward kernel the unrolled loop cost registers and
// time on the H100, so it keeps the plain loop.
template <bool W_T>
__device__ __forceinline__ void project(const float* s_in,
                                        const float* __restrict__ w,
                                        int w_stride, int e0, int n_e,
                                        int n_out, float* s_acc) {
  const int n_items = n_out * (kPix / kGroup);
  for (int it = threadIdx.x; it < n_items; it += kThreads) {
    const int o = it % n_out, grp = it / n_out;
    float a[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) a[r] = 0.0f;
    if constexpr (W_T) {
#pragma unroll 8
      for (int j = 0; j < kEC; ++j) {
        const float wv = j < n_e ? __ldg(w + static_cast<int64_t>(o) * w_stride + e0 + j)
                                 : 0.0f;
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          a[r] = fmaf(s_in[(grp * kGroup + r) * kEC + j], wv, a[r]);
        }
      }
    } else {
      for (int j = 0; j < n_e; ++j) {
        const float wv = __ldg(w + static_cast<int64_t>(e0 + j) * w_stride + o);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          a[r] = fmaf(s_in[(grp * kGroup + r) * kEC + j], wv, a[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) s_acc[(grp * kGroup + r) * n_out + o] += a[r];
  }
}

template <int K>
constexpr int fwd_smem_floats_fixed() {
  return (kTile + K - 1) * (kTile + K - 1) * (kCC + kEC) + kCC * kEC + kPix * kEC;
}

template <int K>
constexpr int dx_smem_floats_fixed() {
  constexpr int n2 = (kTile + 2 * (K - 1)) * (kTile + 2 * (K - 1));
  constexpr int n1 = (kTile + K - 1) * (kTile + K - 1);
  constexpr int region_a = (n2 > n1 ? n2 : n1) * kCC + kCC * kEC;
  return region_a + n2 * kEC + kPix * kEC + n1 * kEC;
}

template <int K, int ACT>
__global__ void __launch_bounds__(kThreads)
mbconv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ we,
                  const float* __restrict__ be, const float* __restrict__ wd,
                  const float* __restrict__ bd, const float* __restrict__ wp,
                  const float* __restrict__ bp, int H, int W, int C, int E,
                  int Co, int residual, float* __restrict__ out) {
  constexpr int h = K / 2;
  constexpr int TI = kTile + 2 * h;  // haloed tile side
  constexpr int NH = TI * TI;
  constexpr int kPerWarp = (NH + kWarps - 1) / kWarps;
  extern __shared__ float4 smem4[];
  float* s_x = reinterpret_cast<float*>(smem4);  // [NH][kCC]
  float* s_w = s_x + NH * kCC;                   // [kCC][kEC]
  float* s_e = s_w + kCC * kEC;                  // [NH][kEC]
  float* s_d = s_e + NH * kEC;                   // [kPix][kEC]
  float* s_acc = s_d + kPix * kEC;               // [kPix][Co]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const float* xb = x + static_cast<int64_t>(blockIdx.y) * H * W * C;

  for (int i = threadIdx.x; i < kPix * Co; i += kThreads) s_acc[i] = 0.0f;

  for (int e0 = 0; e0 < E; e0 += kEC) {
    const int e = e0 + lane;
    const bool e_ok = e < E;
    // (1) expand the haloed tile, C in ascending order
    float z[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) z[i] = 0.0f;
    for (int c0 = 0; c0 < C; c0 += kCC) {
      __syncthreads();  // the previous readers of s_x, s_w, s_e, s_d are done
      stage<TI, false>(xb, ty0 - h, tx0 - h, c0, H, W, C, we, E, e0, E, s_x, s_w);
      __syncthreads();
      accumulate<NH, true>(s_x, s_w, min(kCC, C - c0), z);
    }
    // (2) e = act(z0 + be), zero outside the image
    const float bev = e_ok ? __ldg(be + e) : 0.0f;
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int p = warp + kWarps * i;
      if (p < NH) {
        const bool in = e_ok && in_image(ty0 - h + p / TI, tx0 - h + p % TI, H, W);
        s_e[p * kEC + lane] = in ? act_fn<ACT>(__fadd_rn(z[i], bev)) : 0.0f;
      }
    }
    __syncthreads();
    // (3) depthwise: bd, then the taps row by row
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) {
      wk[t] = e_ok ? __ldg(wd + static_cast<int64_t>(t) * E + e) : 0.0f;
    }
    const float bdv = e_ok ? __ldg(bd + e) : 0.0f;
#pragma unroll
    for (int i = 0; i < kPix / kWarps; ++i) {
      const int q = warp + kWarps * i, qy = q / kTile, qx = q % kTile;
      float acc = bdv;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          acc = __fadd_rn(acc, __fmul_rn(s_e[((qy + ky) * TI + qx + kx) * kEC + lane],
                                         wk[ky * K + kx]));
        }
      }
      s_d[q * kEC + lane] = e_ok ? act_fn<ACT>(acc) : 0.0f;
    }
    __syncthreads();
    // (4) project into the shared sum
    project<false>(s_d, wp, Co, e0, min(kEC, E - e0), Co, s_acc);
  }
  __syncthreads();
  float* ob = out + static_cast<int64_t>(blockIdx.y) * H * W * Co;
  for (int i = threadIdx.x; i < kPix * Co; i += kThreads) {
    const int q = i / Co, o = i % Co;
    const int y = ty0 + q / kTile, xx = tx0 + q % kTile;
    if (y < H && xx < W) {
      const int64_t pix = static_cast<int64_t>(y) * W + xx;
      float v = s_acc[i] + __ldg(bp + o);
      if (residual) v += __ldg(xb + pix * C + o);
      ob[pix * Co + o] = v;
    }
  }
}

template <int K, int ACT>
__global__ void __launch_bounds__(kThreads)
mbconv_dx_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ we, const float* __restrict__ be,
                 const float* __restrict__ wd, const float* __restrict__ bd,
                 const float* __restrict__ wp, int H, int W, int C, int E,
                 int Co, int residual, float* __restrict__ dx) {
  constexpr int h = K / 2;
  constexpr int T2 = kTile + 4 * h;  // x tile side (halo 2h)
  constexpr int N2 = T2 * T2;
  constexpr int T1 = kTile + 2 * h;  // g / z1 / gd tile side (halo h)
  constexpr int N1 = T1 * T1;
  constexpr int kPerWarp2 = (N2 + kWarps - 1) / kWarps;
  constexpr int kPerWarp1 = (N1 + kWarps - 1) / kWarps;
  constexpr int kRegionA = (N2 > N1 ? N2 : N1) * kCC + kCC * kEC;
  extern __shared__ float4 smem4[];
  float* s_a = reinterpret_cast<float*>(smem4);  // x / g staging
  float* s_e = s_a + kRegionA;                   // [N2][kEC], then ge [kPix][kEC]
  float* s_dz0 = s_e + N2 * kEC;                 // [kPix][kEC] act'(z0), centre
  float* s_gd = s_dz0 + kPix * kEC;              // [N1][kEC]
  float* s_acc = s_gd + N1 * kEC;                // [kPix][C]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int64_t img = static_cast<int64_t>(blockIdx.y) * H * W;
  const float* xb = x + img * C;
  const float* gb = g + img * Co;

  for (int i = threadIdx.x; i < kPix * C; i += kThreads) s_acc[i] = 0.0f;

  for (int e0 = 0; e0 < E; e0 += kEC) {
    const int e = e0 + lane;
    const bool e_ok = e < E;
    // (1) recompute z0 and e on the tile with a halo of 2h
    {
      float z[kPerWarp2];
#pragma unroll
      for (int i = 0; i < kPerWarp2; ++i) z[i] = 0.0f;
      for (int c0 = 0; c0 < C; c0 += kCC) {
        __syncthreads();
        stage<T2, false>(xb, ty0 - 2 * h, tx0 - 2 * h, c0, H, W, C, we, E, e0,
                         E, s_a, s_a + N2 * kCC);
        __syncthreads();
        accumulate<N2, true>(s_a, s_a + N2 * kCC, min(kCC, C - c0), z);
      }
      const float bev = e_ok ? __ldg(be + e) : 0.0f;
#pragma unroll
      for (int i = 0; i < kPerWarp2; ++i) {
        const int p = warp + kWarps * i;
        if (p < N2) {
          const int py = p / T2, px = p % T2;
          const bool in = e_ok && in_image(ty0 - 2 * h + py, tx0 - 2 * h + px, H, W);
          const float z0 = __fadd_rn(z[i], bev);
          s_e[p * kEC + lane] = in ? act_fn<ACT>(z0) : 0.0f;
          const int qy = py - 2 * h, qx = px - 2 * h;
          if (qy >= 0 && qy < kTile && qx >= 0 && qx < kTile) {
            s_dz0[(qy * kTile + qx) * kEC + lane] = e_ok ? dact_fn<ACT>(z0) : 0.0f;
          }
        }
      }
    }
    __syncthreads();
    // (2) z1 on the tile with a halo of h, in the forward's order
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) {
      wk[t] = e_ok ? __ldg(wd + static_cast<int64_t>(t) * E + e) : 0.0f;
    }
    const float bdv = e_ok ? __ldg(bd + e) : 0.0f;
    float dz1[kPerWarp1];
#pragma unroll
    for (int i = 0; i < kPerWarp1; ++i) {
      const int p = warp + kWarps * i;
      dz1[i] = 0.0f;
      if (p < N1) {
        const int py = p / T1, px = p % T1;
        float acc = bdv;
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            acc = __fadd_rn(acc, __fmul_rn(s_e[((py + ky) * T2 + px + kx) * kEC + lane],
                                           wk[ky * K + kx]));
          }
        }
        dz1[i] = dact_fn<ACT>(acc);
      }
    }
    // (3) gp = g . Wp^T on the same pixels (g is zero outside the image),
    // gd = gp * act'(z1)
    float gp[kPerWarp1];
#pragma unroll
    for (int i = 0; i < kPerWarp1; ++i) gp[i] = 0.0f;
    for (int o0 = 0; o0 < Co; o0 += kCC) {
      __syncthreads();  // s_a and s_e are free
      stage<T1, true>(gb, ty0 - h, tx0 - h, o0, H, W, Co, wp, Co, e0, E, s_a,
                      s_a + N1 * kCC);
      __syncthreads();
      accumulate<N1, false>(s_a, s_a + N1 * kCC, min(kCC, Co - o0), gp);
    }
#pragma unroll
    for (int i = 0; i < kPerWarp1; ++i) {
      const int p = warp + kWarps * i;
      if (p < N1) s_gd[p * kEC + lane] = gp[i] * dz1[i];
    }
    __syncthreads();
    // (4) ge = dwconv^T(gd) * act'(z0) on the tile, into s_e's space
    float* s_ge = s_e;
#pragma unroll
    for (int i = 0; i < kPix / kWarps; ++i) {
      const int q = warp + kWarps * i, qy = q / kTile, qx = q % kTile;
      float acc = 0.0f;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          acc = fmaf(s_gd[((qy + 2 * h - ky) * T1 + qx + 2 * h - kx) * kEC + lane],
                     wk[ky * K + kx], acc);
        }
      }
      s_ge[q * kEC + lane] = acc * s_dz0[q * kEC + lane];
    }
    __syncthreads();
    // (5) dx += ge . We^T
    project<true>(s_ge, we, E, e0, min(kEC, E - e0), C, s_acc);
  }
  __syncthreads();
  float* db = dx + img * C;
  for (int i = threadIdx.x; i < kPix * C; i += kThreads) {
    const int q = i / C, c = i % C;
    const int y = ty0 + q / kTile, xx = tx0 + q % kTile;
    if (y < H && xx < W) {
      const int64_t pix = static_cast<int64_t>(y) * W + xx;
      float v = s_acc[i];
      if (residual) v += __ldg(gb + pix * Co + c);
      db[pix * C + c] = v;
    }
  }
}

size_t fwd_smem_bytes(int k, int Co) {
  const int fixed = k == 3 ? fwd_smem_floats_fixed<3>() : fwd_smem_floats_fixed<5>();
  return sizeof(float) * (static_cast<size_t>(fixed) + static_cast<size_t>(kPix) * Co);
}

size_t dx_smem_bytes(int k, int C) {
  const int fixed = k == 3 ? dx_smem_floats_fixed<3>() : dx_smem_floats_fixed<5>();
  return sizeof(float) * (static_cast<size_t>(fixed) + static_cast<size_t>(kPix) * C);
}

bool bad_args(int B, int H, int W, int C, int E, int Co, int k, int act,
              int residual) {
  return B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || E < 1 || Co < 1 ||
         (k != 3 && k != 5) || act < kRelu6 || act > kSwish ||
         (residual && C != Co) ||
         static_cast<int64_t>((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile) >
             2147483647LL;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kern, int B, int H, int W, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile), B);
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int K, int ACT>
cudaError_t fwd(const float* x, const float* we, const float* be,
                const float* wd, const float* bd, const float* wp,
                const float* bp, int B, int H, int W, int C, int E, int Co,
                int residual, float* out, cudaStream_t s) {
  return launch(mbconv_fwd_kernel<K, ACT>, B, H, W, fwd_smem_bytes(K, Co), s,
                x, we, be, wd, bd, wp, bp, H, W, C, E, Co, residual, out);
}

template <int K, int ACT>
cudaError_t dxk(const float* x, const float* g, const float* we,
                const float* be, const float* wd, const float* bd,
                const float* wp, int B, int H, int W, int C, int E, int Co,
                int residual, float* dx, cudaStream_t s) {
  return launch(mbconv_dx_kernel<K, ACT>, B, H, W, dx_smem_bytes(K, C), s,
                x, g, we, be, wd, bd, wp, H, W, C, E, Co, residual, dx);
}

}  // namespace

// act: 0 relu6, 1 relu, 2 swish. Returns a cudaError_t; 1 (invalid value)
// for arguments the kernel does not take, without launching.
extern "C" int mlad_mbconv_fwd(const float* x, const float* we, const float* be,
                               const float* wd, const float* bd, const float* wp,
                               const float* bp, int B, int H, int W, int C,
                               int E, int Co, int k, int act, int residual,
                               float* out, void* stream) {
  if (bad_args(B, H, W, C, E, Co, k, act, residual) ||
      fwd_smem_bytes(k, Co) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define MLAD_FWD(K, A) fwd<K, A>(x, we, be, wd, bd, wp, bp, B, H, W, C, E, Co, residual, out, s)
  if (k == 3) {
    err = act == kRelu6 ? MLAD_FWD(3, kRelu6) : act == kRelu ? MLAD_FWD(3, kRelu)
                                                             : MLAD_FWD(3, kSwish);
  } else {
    err = act == kRelu6 ? MLAD_FWD(5, kRelu6) : act == kRelu ? MLAD_FWD(5, kRelu)
                                                             : MLAD_FWD(5, kSwish);
  }
#undef MLAD_FWD
  return static_cast<int>(err);
}

extern "C" int mlad_mbconv_dx(const float* x, const float* g, const float* we,
                              const float* be, const float* wd, const float* bd,
                              const float* wp, int B, int H, int W, int C,
                              int E, int Co, int k, int act, int residual,
                              float* dx, void* stream) {
  if (bad_args(B, H, W, C, E, Co, k, act, residual) ||
      dx_smem_bytes(k, C) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define MLAD_DX(K, A) dxk<K, A>(x, g, we, be, wd, bd, wp, B, H, W, C, E, Co, residual, dx, s)
  if (k == 3) {
    err = act == kRelu6 ? MLAD_DX(3, kRelu6) : act == kRelu ? MLAD_DX(3, kRelu)
                                                            : MLAD_DX(3, kSwish);
  } else {
    err = act == kRelu6 ? MLAD_DX(5, kRelu6) : act == kRelu ? MLAD_DX(5, kRelu)
                                                            : MLAD_DX(5, kSwish);
  }
#undef MLAD_DX
  return static_cast<int>(err);
}
