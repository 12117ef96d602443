// Channel-major 3x3 SAME convolution for small channel counts: the SIMT
// instance (the tensor-core instance is cmconv_tc.cu).
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

#include "cmconv_tile.cuh"

namespace {

using namespace cmconv;

constexpr int kCC = 4;    // channels per staged chunk
constexpr int kP = 8;     // output pixels per thread along x
constexpr int kCot = 8;   // output channels per slice

__host__ __device__ constexpr int tile_h(int ns) { return 32 / ns; }
__host__ __device__ constexpr int chan_stride(int ns) { return (tile_h(ns) + 2) * kLdx; }

template <int NS, bool V16>
__global__ void __launch_bounds__(kThreads, 2)
cmconv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, int C, int Co, int H, int W,
                 float* __restrict__ out) {
  constexpr int TH = tile_h(NS);
  constexpr int COB = kCot * NS;
  constexpr int kChunk = kCC * chan_stride(NS);
  extern __shared__ float4 smem4[];
  float* s_x = reinterpret_cast<float*>(smem4);  // [2][kCC][TH + 2][kLdx]
  float* s_w = s_x + 2 * kChunk;                 // [C][3][3][COB]

  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * TH;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* xb = x + static_cast<int64_t>(blockIdx.z) * C * plane;
  const int n_chunks = (C + kCC - 1) / kCC;

  stage_chunk<kCC, TH + 2, chan_stride(NS), V16>(s_x, xb, 0, C, H, W, y0, x0);
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
      stage_chunk<kCC, TH + 2, chan_stride(NS), V16>(s_x + ((k + 1) & 1) * kChunk, xb,
                                                      (k + 1) * kCC, C, H, W, y0, x0);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* buf = s_x + (k & 1) * kChunk;
    const int n_c = min(kCC, C - k * kCC);
    for (int cl = 0; cl < n_c; ++cl) {
      const float* wc = s_w + ((k * kCC + cl) * 9) * COB + slice * kCot;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        // input columns col + 3 + p + dx of the strip: staged s = col .. col + 15
        const float4* src = reinterpret_cast<const float4*>(
            buf + (cl * (TH + 2) + row + dy) * kLdx + col);
        float v[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 t = src[q];
          v[4 * q + 0] = t.x;
          v[4 * q + 1] = t.y;
          v[4 * q + 2] = t.z;
          v[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wt = reinterpret_cast<const float4*>(wc + (dy * 3 + dx) * COB);
          const float4 w0 = wt[0], w1 = wt[1];
          const float ww[kCot] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < kP; ++p)
#pragma unroll
            for (int j = 0; j < kCot; ++j)
              acc[p][j] = fmaf(v[p + dx + 3], ww[j], acc[p][j]);
        }
      }
    }
    __syncthreads();  // buf is restaged two chunks on
  }

  const int yo = y0 + row, xo = x0 + col;
  if (yo >= H || xo >= W) return;
  float* ob = out + static_cast<int64_t>(blockIdx.z) * Co * plane +
              static_cast<int64_t>(yo) * W + xo;
  const bool vec = V16 && xo + kP <= W;
#pragma unroll
  for (int j = 0; j < kCot; ++j) {
    const int co = slice * kCot + j;
    if (co >= Co) break;
    const float bj = bias != nullptr ? bias[co] : 0.0f;
    float r[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) r[p] = bias != nullptr ? acc[p][j] + bj : acc[p][j];
    float* o = ob + co * plane;
    if (vec) {
      reinterpret_cast<float4*>(o)[0] = make_float4(r[0], r[1], r[2], r[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(r[4], r[5], r[6], r[7]);
    } else {
#pragma unroll
      for (int p = 0; p < kP; ++p)
        if (xo + p < W) o[p] = r[p];
    }
  }
}

template <int NS, bool V16>
cudaError_t launch_ns(const float* x, const float* w, const float* bias, int B, int C,
                      int Co, int H, int W, float* out, cudaStream_t stream) {
  const dim3 grid((W + kTW - 1) / kTW, (H + tile_h(NS) - 1) / tile_h(NS), B);
  const size_t smem =
      (2 * static_cast<size_t>(kCC) * chan_stride(NS) + static_cast<size_t>(C) * 9 * kCot * NS) *
      sizeof(float);
  return cmconv::launch(cmconv3x3_kernel<NS, V16>, grid, smem, stream, x, w, bias, C,
                        Co, H, W, out);
}

template <int NS>
cudaError_t launch_ns(bool v16, const float* x, const float* w, const float* bias,
                      int B, int C, int Co, int H, int W, float* out,
                      cudaStream_t stream) {
  return v16 ? launch_ns<NS, true>(x, w, bias, B, C, Co, H, W, out, stream)
             : launch_ns<NS, false>(x, w, bias, B, C, Co, H, W, out, stream);
}

}  // namespace

// x [B, C, H, W], w [3, 3, C, Co], bias [Co] or null -> out [B, Co, H, W];
// out 16-byte aligned. Returns cudaErrorInvalidValue, launching nothing,
// unless 1 <= B <= 65535, 1 <= C, Co <= 32, H, W >= 1 and the grid fits;
// otherwise launches on `stream` and returns the launch's cudaError_t.
extern "C" int mlad_cmconv3x3(const float* x, const float* w,
                              const float* bias, int B, int C, int Co, int H,
                              int W, float* out, void* stream) {
  const int ns = Co <= 8 ? 1 : (Co <= 16 ? 2 : 4);
  if (!valid_args(B, C, Co, H, W, tile_h(ns))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool v16 = use_v16(x, W);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ns == 1) {
    err = launch_ns<1>(v16, x, w, bias, B, C, Co, H, W, out, s);
  } else if (ns == 2) {
    err = launch_ns<2>(v16, x, w, bias, B, C, Co, H, W, out, s);
  } else {
    err = launch_ns<4>(v16, x, w, bias, B, C, Co, H, W, out, s);
  }
  return static_cast<int>(err);
}
