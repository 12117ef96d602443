// Channel-major 3x3 SAME convolution for small channel counts.
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
// Design:
//   - one thread per output pixel (b, y, x), holding all Co accumulators in
//     registers (the Pallas kernel holds one [th, W] accumulator per Co in
//     VMEM); Co is rounded up to a compiled width COB in {1, 2, 4, 8, 16,
//     32}, with the weights of the extra outputs zero and never stored;
//   - the weights, at most 32 * 9 * 32 floats (36,864 bytes), are copied once
//     per block into shared memory as [C][9][COB]; every thread of a warp
//     reads the same weight, a broadcast;
//   - SAME padding by bounds checks: an input outside the image reads as 0.
//     The TPU wrapper pre-pads the input and materializes overlapping row
//     tiles with their halo (proto_cmconv.py:41-62) because a Mosaic block
//     must tile the array exactly; a thread here reads its 3x3 neighbourhood
//     directly, and the re-reads by neighbouring threads hit L1;
//   - each accumulator sums in the plain version's order (c, then dy, then
//     dx) with __fmul_rn / __fadd_rn, never contracted into an FMA, so the
//     kernel equals the plain version bit for bit, and a launch repeats bit
//     for bit (no atomics).
//
// Bound on an H100 (chip_smoke.py computes it from the path's shapes): the
// bytes are x read once, w read once and out written once, over 3.35 TB/s;
// the operations are 2 * 9 * C * Co per output pixel, over 67 TFLOP/s
// (float32 outside the tensor cores). 8 -> 8 at 640x640, batch 24, moves
// 629 MB (0.188 ms) and does 11.3 GFLOP (0.169 ms): bytes bound it; 32 -> 16
// at 320x320 does 22.6 GFLOP (0.338 ms) on 472 MB (0.141 ms): operations
// bound it. Keeping the multiply and the add apart (for bit equality with
// the plain version) halves the float32 issue rate against the FMA that the
// peak counts as two operations. Faster designs (row tiles with a halo in
// shared memory, tensor cores for C = 16 / 32, the BatchNorm statistics in
// the epilogue) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kMaxChannels = 32;
constexpr int kTaps = 9;

template <int COB>
__global__ void __launch_bounds__(kTileX * kTileY)
cmconv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, int C, int Co, int H, int W,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [C][kTaps][COB]

  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int n_w = C * kTaps * COB;
  for (int i = tid; i < n_w; i += kTileX * kTileY) {
    const int co = i % COB;
    const int rest = i / COB;
    const int tap = rest % kTaps;
    const int c = rest / kTaps;
    s_w[i] = co < Co ? w[(static_cast<int64_t>(tap) * C + c) * Co + co] : 0.0f;
  }
  __syncthreads();

  const int xo = blockIdx.x * kTileX + threadIdx.x;
  const int yo = blockIdx.y * kTileY + threadIdx.y;
  if (xo >= W || yo >= H) return;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* xb = x + static_cast<int64_t>(blockIdx.z) * C * plane;

  float acc[COB];
#pragma unroll
  for (int co = 0; co < COB; ++co) acc[co] = 0.0f;

  for (int c = 0; c < C; ++c) {
    const float* xc = xb + c * plane;
    const float* wc = s_w + c * kTaps * COB;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = yo + dy - 1;
      const bool y_in = yy >= 0 && yy < H;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = xo + dx - 1;
        const float v = (y_in && xx >= 0 && xx < W)
                            ? __ldg(xc + static_cast<int64_t>(yy) * W + xx)
                            : 0.0f;
        const float* wt = wc + (dy * 3 + dx) * COB;
        if constexpr (COB % 4 == 0) {
          const float4* wt4 = reinterpret_cast<const float4*>(wt);
#pragma unroll
          for (int q = 0; q < COB / 4; ++q) {
            const float4 ww = wt4[q];
            acc[4 * q + 0] = __fadd_rn(acc[4 * q + 0], __fmul_rn(v, ww.x));
            acc[4 * q + 1] = __fadd_rn(acc[4 * q + 1], __fmul_rn(v, ww.y));
            acc[4 * q + 2] = __fadd_rn(acc[4 * q + 2], __fmul_rn(v, ww.z));
            acc[4 * q + 3] = __fadd_rn(acc[4 * q + 3], __fmul_rn(v, ww.w));
          }
        } else {
#pragma unroll
          for (int co = 0; co < COB; ++co) {
            acc[co] = __fadd_rn(acc[co], __fmul_rn(v, wt[co]));
          }
        }
      }
    }
  }

  float* ob = out + static_cast<int64_t>(blockIdx.z) * Co * plane +
              static_cast<int64_t>(yo) * W + xo;
#pragma unroll
  for (int co = 0; co < COB; ++co) {
    if (co < Co) {
      ob[co * plane] = bias != nullptr ? __fadd_rn(acc[co], bias[co]) : acc[co];
    }
  }
}

template <int COB>
cudaError_t launch(const float* x, const float* w, const float* bias, int B,
                   int C, int Co, int H, int W, float* out,
                   cudaStream_t stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B);
  const size_t smem = static_cast<size_t>(C) * kTaps * COB * sizeof(float);
  cmconv3x3_kernel<COB><<<grid, block, smem, stream>>>(x, w, bias, C, Co, H,
                                                        W, out);
  return cudaGetLastError();
}

}  // namespace

// x [B, C, H, W], w [3, 3, C, Co], bias [Co] or null -> out [B, Co, H, W]
extern "C" int mlad_cmconv3x3(const float* x, const float* w,
                              const float* bias, int B, int C, int Co, int H,
                              int W, float* out, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxChannels || Co < 1 ||
      Co > kMaxChannels || H < 1 || W < 1 ||
      (H + kTileY - 1) / kTileY > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Co <= 1) {
    err = launch<1>(x, w, bias, B, C, Co, H, W, out, s);
  } else if (Co <= 2) {
    err = launch<2>(x, w, bias, B, C, Co, H, W, out, s);
  } else if (Co <= 4) {
    err = launch<4>(x, w, bias, B, C, Co, H, W, out, s);
  } else if (Co <= 8) {
    err = launch<8>(x, w, bias, B, C, Co, H, W, out, s);
  } else if (Co <= 16) {
    err = launch<16>(x, w, bias, B, C, Co, H, W, out, s);
  } else {
    err = launch<32>(x, w, bias, B, C, Co, H, W, out, s);
  }
  return static_cast<int>(err);
}
