// Channel-major 3x3 SAME convolution for small channel counts: the SIMT
// instance, float32 and bf16 (the tensor-core instances are cmconv_tc.cu,
// float32, and cmconv_bf16_sm90.cu, bf16).
//
// Replaces the Pallas TPU kernel `_kernel` of tools/proto_cmconv.py (called
// through `cmconv`). It computes what `cmconv_plain` of
// mladversarialobjectdetection_torch/ops/cmconv.py computes, in float32:
//
//   out[b,co,y,x] = sum_{c, dy, dx} x[b, c, y+dy-1, x+dx-1] * w[dy, dx, c, co]
//                   (+ bias[co])
//
// with x [B, C, H, W] (NCHW, contiguous), w [3, 3, C, Co] (HWIO, contiguous),
// zero padding outside the image, and 1 <= C, Co <= 32. The U-Net of the
// defender runs it for its ConvBlocks of at most 16 filters (C = 3..32,
// Co = 8 or 16 at 640x640 and 320x320), forward and, with the weights
// flipped in both spatial axes and C / Co swapped, for the input gradient.
//
// What bounds it on an H100 (chip_smoke.cmconv_bound): x, w and out once
// over 3.35 TB/s, against 2 * 9 * C * Co operations per output pixel over
// 67 TFLOP/s (float32 FMAs). At batch 24, 3 -> 8 and 8 -> 8 at 640x640 are
// bound by bytes; the launches with C * Co / (C + Co) above 4.4 (8 -> 16,
// 16 -> 16, 32 -> 16 ...) by operations. The first version (one thread per
// output pixel, nine bounds-checked __ldg per input value, every weight
// re-read from shared memory per pixel, multiplies and adds kept apart for
// bit equality) reached 22-31% of that bound. This design:
//
//   1. Halo tile in shared memory. A block computes a TH x 64 output tile of
//      one image. Its input tile, rows y0-1 .. y0+TH and columns x0-4 ..
//      x0+67 (72 columns, so that 16-byte copies stay aligned), is staged by
//      cp.async in chunks of 4 channels, double buffered. Pixels outside the
//      image and channels past C are zero-filled by the copy's src-size
//      operand: that is the SAME padding, and the TPU wrapper's pre-pad and
//      overlapping halo rows (proto_cmconv.py:41-62) have no counterpart.
//      Each input value comes from device memory once per tile, not nine
//      times through L1. 16-byte copies where W % 4 == 0 and x is 16-byte
//      aligned, 4-byte copies otherwise.
//   2. Register blocking. A thread computes a strip of 8 output pixels along
//      x for a slice of 8 output channels: 64 accumulators. Per (c, dy) it
//      reads the 16 input values around its strip (four 16-byte shared
//      loads, conflict-free with a row stride of 76 floats) and slides the
//      three dx taps over them, reading each tap's 8 weights as two 16-byte
//      broadcasts (a warp shares its channel slice): 192 FMAs for 10 shared
//      loads. The weights, at most 36,864 bytes, sit in shared memory for
//      the whole block: a __grid_constant__ parameter is capped below that
//      size, and constant memory would be shared by concurrent launches.
//   3. Co is covered by NS = 1, 2 or 4 slices of 8 (Co = 1..8, 9..16,
//      17..32; padded channels have zero weights and are never stored); the
//      8 warps of a block are split between the slices, so the tile height
//      is TH = 32 / NS and every slice reuses the same staged input.
//   4. FMA: each output sums c, then dy, then dx with fmaf, the same fixed
//      order whatever the tile, then adds the bias. The result is no longer
//      bit-equal to the plain version's separate multiplies and adds, but
//      is within 1e-5 of the output's scale of it; two launches are
//      bit-equal (no atomics, no order that depends on the schedule).
//   5. Epilogue: coalesced stores along W, two float4 per channel where
//      W % 4 == 0.
//
// What bounds it now (chip_smoke.py phase 11, defender step at b24): 45-62%
// of the bound per launch, 52% over the step's 15 launches. In the launches
// bound by operations the inner loop is 192 FMAs to 10 shared loads per
// (c, dy), so the loss is in stalls and in the last wave of blocks (not
// measured apart); those bound by bytes read each input value once but
// overlap loads with work only across the two blocks of an SM (two chunks
// of C at C = 8).
//
//   6. The bf16 SIMT instance (cmconv_bf16.cu includes this file and builds
//      `mlad_cmconv3x3_bf16`) is the ablation of the bf16 main path, which
//      runs the Hopper instance cmconv_bf16_sm90.cu (the products on the bf16
//      tensor cores, each float32 weight as bf16 hi + lo terms, a
//      channels-last halo tile staged once, persistent blocks: the notes are
//      there); this SIMT instance's float32 FMAs alone take 2.6x the bf16
//      byte bound. It is the TPU kernel's own signature
//      (proto_cmconv.py:57): x and out bf16, w float32, sums in float32,
//      the sum rounded once to bf16 (to nearest even); a bias, bf16, is
//      then added in bf16 (rounded again), as Flax's bf16 `nn.Conv` adds
//      it. It is the same template over the element type T of x, bias and
//      out, with the same thread layout and weights; only the staging
//      differs. The halo tile is staged in bf16 and each value widened to
//      float32 as it is read into registers: half the shared memory and
//      half the bytes from device memory. cp.async moves 4, 8 or 16 bytes,
//      never 2, and a 16-byte copy of 8 bf16 stays aligned only where its
//      first column is a multiple of 8, so the staged columns are x0 - 8 ..
//      x0 + 71 (80) and a strip reads three 16-byte vectors (its 10 inputs
//      lie at staged columns col + 7 .. col + 16). The row stride is 96
//      bf16 (192 bytes): the two rows of a quarter warp then fall in
//      opposite halves of the 128 bytes of banks, so its 16-byte reads
//      are conflict-free. 16-byte copies where W % 8 == 0 and x is 16-byte
//      aligned, 4-byte copies where W is even and x 4-byte aligned, plain
//      loads otherwise; outputs stored as one 16-byte vector of 8 bf16 per
//      channel where W % 8 == 0.

#include <cuda_bf16.h>

#include <type_traits>

#include "cmconv_tile.cuh"

namespace {

using namespace cmconv;
using bf16 = __nv_bfloat16;

constexpr int kCC = 4;    // channels per staged chunk
constexpr int kP = 8;     // output pixels per thread along x
constexpr int kCot = 8;   // output channels per slice

// The staged tile per element type: staged column s holds x0 - kOff + s,
// kLd elements a row, and a strip reads kLoad values from its column col
// on (its inputs x0 + col - 1 .. x0 + col + 8 at s = col + kOff - 1 ..).
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kOff = 4, kLd = kLdx, kLoad = 16;
};
template <>
struct Tile<bf16> {
  static constexpr int kOff = 8, kLd = 96, kCols = 80, kLoad = 24;
};

__host__ __device__ constexpr int tile_h(int ns) { return 32 / ns; }
template <typename T>
__host__ __device__ constexpr int chan_stride(int ns) {
  return (tile_h(ns) + 2) * Tile<T>::kLd;
}

// Stage a chunk of channels: float32 by cmconv_tile.cuh (VEC 16 or 4
// bytes per copy); bf16 by 16- or 4-byte copies (VEC 16, 4) or plain
// loads (VEC 0), zero outside the image and past C.
template <int CC, int ROWS, int CHS, int VEC>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ xb, int c0,
                                      int C, int H, int W, int y0, int x0) {
  stage_chunk<CC, ROWS, CHS, VEC == 16>(buf, xb, c0, C, H, W, y0, x0);
}

template <int CC, int ROWS, int CHS, int VEC>
__device__ __forceinline__ void stage(bf16* buf, const bf16* __restrict__ xb, int c0,
                                      int C, int H, int W, int y0, int x0) {
  using TT = Tile<bf16>;
  const int64_t plane = static_cast<int64_t>(H) * W;
  if constexpr (VEC == 16) {
    constexpr int kPerRow = TT::kCols / 8;
    for (int i = threadIdx.x; i < CC * ROWS * kPerRow; i += kThreads) {
      const int q = i % kPerRow, rest = i / kPerRow;
      const int r = rest % ROWS, cl = rest / ROWS;
      const int c = c0 + cl, y = y0 - 1 + r, x = x0 - TT::kOff + 8 * q;
      const bool ok = c < C && y >= 0 && y < H && x >= 0 && x < W;
      const bf16* src = ok ? xb + c * plane + static_cast<int64_t>(y) * W + x : xb;
      cp_async16(reinterpret_cast<float*>(buf + cl * CHS + r * TT::kLd + 8 * q),
                 reinterpret_cast<const float*>(src), ok);
    }
  } else {
    // a warp per staged row
    for (int row = threadIdx.x >> 5; row < CC * ROWS; row += kThreads / 32) {
      const int cl = row / ROWS, r = row - cl * ROWS;
      const int c = c0 + cl, y = y0 - 1 + r;
      const bool row_ok = c < C && y >= 0 && y < H;
      const bf16* src = xb + (row_ok ? c * plane + static_cast<int64_t>(y) * W : 0);
      bf16* dst = buf + cl * CHS + r * TT::kLd;
      if constexpr (VEC == 4) {
        for (int q = threadIdx.x & 31; q < TT::kCols / 2; q += 32) {
          const int x = x0 - TT::kOff + 2 * q;
          const bool ok = row_ok && x >= 0 && x < W;
          cp_async4(reinterpret_cast<float*>(dst + 2 * q),
                    reinterpret_cast<const float*>(ok ? src + x : xb), ok);
        }
      } else {
        for (int q = threadIdx.x & 31; q < TT::kCols; q += 32) {
          const int x = x0 - TT::kOff + q;
          dst[q] = row_ok && x >= 0 && x < W ? src[x] : __ushort_as_bfloat16(0);
        }
      }
    }
  }
}

// A strip's staged values for one (c, dy), widened to float32: four
// 16-byte reads of float32, or three of 8 bf16.
__device__ __forceinline__ void load_strip(const float* src, float (&v)[16]) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 t = s[q];
    v[4 * q + 0] = t.x;
    v[4 * q + 1] = t.y;
    v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }
}

__device__ __forceinline__ void load_strip(const bf16* src, float (&v)[24]) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint4 t = s[q];
    const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the low half holds the lower column; a bf16 is the top 16 bits of
      // its float32
      v[8 * q + 2 * i] = __uint_as_float(u[i] << 16);
      v[8 * q + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// The kP outputs of a strip for one channel: float32 sums plus the bias;
// bf16 sums rounded, then the bias added in bf16 (rounded again).
__device__ __forceinline__ void store_strip(float* o, const float (&r)[kP], const float* bias,
                                            int co, bool vec, int n) {
  const float bj = bias != nullptr ? bias[co] : 0.0f;
  float s[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) s[p] = bias != nullptr ? r[p] + bj : r[p];
  if (vec) {
    reinterpret_cast<float4*>(o)[0] = make_float4(s[0], s[1], s[2], s[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(s[4], s[5], s[6], s[7]);
  } else {
#pragma unroll
    for (int p = 0; p < kP; ++p)
      if (p < n) o[p] = s[p];
  }
}

__device__ __forceinline__ void store_strip(bf16* o, const float (&r)[kP], const bf16* bias,
                                            int co, bool vec, int n) {
  const float bj = bias != nullptr ? __bfloat162float(bias[co]) : 0.0f;
  bf16 s[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    s[p] = __float2bfloat16_rn(r[p]);
    if (bias != nullptr) s[p] = __float2bfloat16_rn(__bfloat162float(s[p]) + bj);
  }
  if (vec) {
    uint4 t;
    t.x = __bfloat16_as_ushort(s[0]) | (static_cast<unsigned>(__bfloat16_as_ushort(s[1])) << 16);
    t.y = __bfloat16_as_ushort(s[2]) | (static_cast<unsigned>(__bfloat16_as_ushort(s[3])) << 16);
    t.z = __bfloat16_as_ushort(s[4]) | (static_cast<unsigned>(__bfloat16_as_ushort(s[5])) << 16);
    t.w = __bfloat16_as_ushort(s[6]) | (static_cast<unsigned>(__bfloat16_as_ushort(s[7])) << 16);
    *reinterpret_cast<uint4*>(o) = t;
  } else {
#pragma unroll
    for (int p = 0; p < kP; ++p)
      if (p < n) o[p] = s[p];
  }
}

template <typename T, int NS, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
cmconv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const T* __restrict__ bias, int C, int Co, int H, int W,
                 T* __restrict__ out) {
  using TT = Tile<T>;
  constexpr int TH = tile_h(NS);
  constexpr int COB = kCot * NS;
  constexpr int kChunk = kCC * chan_stride<T>(NS);
  extern __shared__ float4 smem4[];
  T* s_x = reinterpret_cast<T*>(smem4);                   // [2][kCC][TH + 2][kLd]
  float* s_w = reinterpret_cast<float*>(s_x + 2 * kChunk);  // [C][3][3][COB]

  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * TH;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const T* xb = x + static_cast<int64_t>(blockIdx.z) * C * plane;
  const int n_chunks = (C + kCC - 1) / kCC;

  stage<kCC, TH + 2, chan_stride<T>(NS), VEC>(s_x, xb, 0, C, H, W, y0, x0);
  cp_commit();
  // weights w[dy][dx][c][co] -> s_w[c][dy][dx][co], zero for co >= Co
  for (int i = threadIdx.x; i < C * 9 * COB; i += kThreads) {
    const int co = i % COB;
    const int tap = (i / COB) % 9;
    const int c = i / (9 * COB);
    s_w[i] = co < Co ? w[(tap * C + c) * Co + co] : 0.0f;
  }

  // thread layout: warps split between the NS slices; a warp covers 8 rows
  // x 32 columns, lane = 4 * row + strip
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarpsPerSlice = 8 / NS;
  const int slice = warp / kWarpsPerSlice;
  const int wi = warp % kWarpsPerSlice;
  const int row = (wi >> 1) * 8 + (lane >> 2);    // 0 .. TH - 1
  const int col = (wi & 1) * 32 + (lane & 3) * kP;  // 0 .. 56, strip start

  float acc[kP][kCot];
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < kCot; ++j) acc[p][j] = 0.0f;

  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage<kCC, TH + 2, chan_stride<T>(NS), VEC>(s_x + ((k + 1) & 1) * kChunk, xb,
                                                  (k + 1) * kCC, C, H, W, y0, x0);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* buf = s_x + (k & 1) * kChunk;
    const int n_c = min(kCC, C - k * kCC);
    for (int cl = 0; cl < n_c; ++cl) {
      const float* wc = s_w + ((k * kCC + cl) * 9) * COB + slice * kCot;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        // input columns x0 + col - 1 + p + dx of the strip: staged
        // s = col + kOff - 1 + p + dx
        float v[TT::kLoad];
        load_strip(buf + (cl * (TH + 2) + row + dy) * TT::kLd + col, v);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wt = reinterpret_cast<const float4*>(wc + (dy * 3 + dx) * COB);
          const float4 w0 = wt[0], w1 = wt[1];
          const float ww[kCot] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < kP; ++p)
#pragma unroll
            for (int j = 0; j < kCot; ++j)
              acc[p][j] = fmaf(v[p + dx + TT::kOff - 1], ww[j], acc[p][j]);
        }
      }
    }
    __syncthreads();  // buf is restaged two chunks on
  }

  const int yo = y0 + row, xo = x0 + col;
  if (yo >= H || xo >= W) return;
  T* ob = out + static_cast<int64_t>(blockIdx.z) * Co * plane +
          static_cast<int64_t>(yo) * W + xo;
  const bool vec = VEC == 16 && xo + kP <= W;
#pragma unroll
  for (int j = 0; j < kCot; ++j) {
    const int co = slice * kCot + j;
    if (co >= Co) break;
    float r[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) r[p] = acc[p][j];
    store_strip(ob + co * plane, r, bias, co, vec, W - xo);
  }
}

template <typename T, int NS, int VEC>
cudaError_t launch_ns(const T* x, const float* w, const T* bias, int B, int C, int Co,
                      int H, int W, T* out, cudaStream_t stream) {
  const dim3 grid((W + kTW - 1) / kTW, (H + tile_h(NS) - 1) / tile_h(NS), B);
  const size_t smem = 2 * static_cast<size_t>(kCC) * chan_stride<T>(NS) * sizeof(T) +
                      static_cast<size_t>(C) * 9 * kCot * NS * sizeof(float);
  return cmconv::launch(cmconv3x3_kernel<T, NS, VEC>, grid, smem, stream, x, w, bias, C,
                        Co, H, W, out);
}

// VEC: float32 16 or 4; bf16 16, 4 or 0 (plain loads)
template <typename T, int NS>
cudaError_t launch_ns(int vec, const T* x, const float* w, const T* bias, int B, int C,
                      int Co, int H, int W, T* out, cudaStream_t stream) {
  if (vec == 16) return launch_ns<T, NS, 16>(x, w, bias, B, C, Co, H, W, out, stream);
  if constexpr (std::is_same<T, bf16>::value) {
    if (vec == 0) return launch_ns<T, NS, 0>(x, w, bias, B, C, Co, H, W, out, stream);
  }
  return launch_ns<T, NS, 4>(x, w, bias, B, C, Co, H, W, out, stream);
}

template <typename T>
int run(int vec, const T* x, const float* w, const T* bias, int B, int C, int Co, int H,
        int W, T* out, void* stream) {
  const int ns = Co <= 8 ? 1 : (Co <= 16 ? 2 : 4);
  if (!valid_args(B, C, Co, H, W, tile_h(ns))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ns == 1) {
    err = launch_ns<T, 1>(vec, x, w, bias, B, C, Co, H, W, out, s);
  } else if (ns == 2) {
    err = launch_ns<T, 2>(vec, x, w, bias, B, C, Co, H, W, out, s);
  } else {
    err = launch_ns<T, 4>(vec, x, w, bias, B, C, Co, H, W, out, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// x [B, C, H, W], w [3, 3, C, Co] float32, bias [Co] or null -> out [B, Co,
// H, W]; out 16-byte aligned. Returns cudaErrorInvalidValue, launching
// nothing, unless 1 <= B <= 65535, 1 <= C, Co <= 32, H, W >= 1 and the grid
// fits; otherwise launches on `stream` and returns the launch's cudaError_t.
#ifndef MLAD_CMCONV_BF16
// x, bias and out float32
extern "C" int mlad_cmconv3x3(const float* x, const float* w,
                              const float* bias, int B, int C, int Co, int H,
                              int W, float* out, void* stream) {
  return run<float>(use_v16(x, W) ? 16 : 4, x, w, bias, B, C, Co, H, W, out, stream);
}
#else
// x, bias and out bf16 (as raw 16-bit values), w float32
extern "C" int mlad_cmconv3x3_bf16(const void* x, const float* w, const void* bias, int B,
                                   int C, int Co, int H, int W, void* out, void* stream) {
  const auto addr = reinterpret_cast<uintptr_t>(x);
  const int vec = W % 8 == 0 && addr % 16 == 0 ? 16 : (W % 2 == 0 && addr % 4 == 0 ? 4 : 0);
  return run<bf16>(vec, static_cast<const bf16*>(x), w, static_cast<const bf16*>(bias), B, C,
                   Co, H, W, static_cast<bf16*>(out), stream);
}
#endif
