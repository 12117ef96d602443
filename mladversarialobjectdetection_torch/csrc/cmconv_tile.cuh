// The staged input tile shared by the two cmconv instances (cmconv.cu, SIMT;
// cmconv_tc.cu, 3xTF32 tensor cores); the notes on both are in cmconv.cu.
//
// A block computes a TH x kTW output tile of one image. Its input tile, rows
// y0 - 1 .. y0 + TH and columns x0 - 4 .. x0 + 67 (kCols, so that 16-byte
// copies stay aligned), is staged by cp.async a chunk of channels at a time:
// buf[cl * chs + r * kLdx + s] = x[c0 + cl][y0 - 1 + r][x0 - 4 + s], zero
// outside the image and past C (the copy's src-size operand), which is the
// SAME padding.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cmconv {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 32;
constexpr int kTW = 64;    // output tile width
constexpr int kCols = 72;  // staged columns: x0 - 4 .. x0 + 67
constexpr int kLdx = 76;   // staged row stride (floats)

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage channels c0 .. c0 + CC - 1 (ROWS rows each, channel stride CHS
// floats) of image xb into buf. V16: 16-byte copies, for W % 4 == 0 and xb
// 16-byte aligned (then x0 - 4 + s is a multiple of 4 at every vector, so a
// vector lies all inside the image or all outside); else 4-byte copies.
template <int CC, int ROWS, int CHS, bool V16>
__device__ __forceinline__ void stage_chunk(float* buf, const float* __restrict__ xb,
                                            int c0, int C, int H, int W, int y0,
                                            int x0) {
  const int64_t plane = static_cast<int64_t>(H) * W;
  if constexpr (V16) {
    // 16-byte copies over the flattened [CC][ROWS][kCols / 4] vectors
    constexpr int kPerRow = kCols / 4;
    for (int i = threadIdx.x; i < CC * ROWS * kPerRow; i += kThreads) {
      const int q = i % kPerRow, rest = i / kPerRow;
      const int r = rest % ROWS, cl = rest / ROWS;
      const int c = c0 + cl, y = y0 - 1 + r, x = x0 - 4 + 4 * q;
      const bool ok = c < C && y >= 0 && y < H && x >= 0 && x < W;
      cp_async16(buf + cl * CHS + r * kLdx + 4 * q,
                 ok ? xb + c * plane + static_cast<int64_t>(y) * W + x : xb, ok);
    }
  } else {
    // 4-byte copies, a warp per staged row (fewer live registers than the
    // flattened loop, which spilled beside the accumulators)
    for (int row = threadIdx.x >> 5; row < CC * ROWS; row += kThreads / 32) {
      const int cl = row / ROWS, r = row - cl * ROWS;
      const int c = c0 + cl, y = y0 - 1 + r;
      const bool row_ok = c < C && y >= 0 && y < H;
      const float* src = xb + (row_ok ? c * plane + static_cast<int64_t>(y) * W : 0);
      float* dst = buf + cl * CHS + r * kLdx;
      for (int q = threadIdx.x & 31; q < kCols; q += 32) {
        const int x = x0 - 4 + q;
        const bool ok = row_ok && x >= 0 && x < W;
        cp_async4(dst + q, ok ? src + x : xb, ok);
      }
    }
  }
}

// Whether the staging may use 16-byte copies.
inline bool use_v16(const float* x, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Raise the dynamic shared memory limit of `kernel` where `smem` needs it,
// then launch it on grid x kThreads.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The C entries' argument check: cudaErrorInvalidValue unless 1 <= B <=
// 65535, 1 <= C, Co <= kMaxChannels, H, W >= 1 and H / th tiles fit a grid.
inline bool valid_args(int B, int C, int Co, int H, int W, int th) {
  return B >= 1 && B <= 65535 && C >= 1 && C <= kMaxChannels && Co >= 1 &&
         Co <= kMaxChannels && H >= 1 && W >= 1 && (H + th - 1) / th <= 65535;
}

}  // namespace cmconv
