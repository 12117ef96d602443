// Channel-major 3x3 SAME convolution: the 3xTF32 tensor-core instance.
//
// Replaces, with cmconv.cu (the SIMT instance, whose notes cover both), the
// Pallas TPU kernel `_kernel` of tools/proto_cmconv.py, and computes the
// same function: x [B, C, H, W], w [3, 3, C, Co], optional bias [Co] ->
// out [B, Co, H, W], 1 <= C, Co <= 32, float32. ops/cmconv_cuda.plan would
// pick it for a shape where it is faster than the SIMT instance; on an H100
// it is slower on every launch of the defender (1.06-2.49x, chip_smoke.py
// phase 11), so it runs only as the ablation there.
//
// The conv as an implicit GEMM: M the pixels of a tile, N = Co padded to
// 8 * NT, K = 9 C. Where the launch is bound by operations (C Co / (C + Co)
// above 4.4), the float32 pipe's 67 TFLOP/s bounds the SIMT instance; the
// products here run on the tensor cores as 3xTF32 (a = hi + lo with
// hi = tf32(a), lo = tf32(a - hi); lo.hi + hi.lo + hi.hi by three
// mma.sync.m16n8k8 into float32 accumulators; the dropped lo.lo term is
// 2^-22 of a product), bounded by the TF32 pipe's 495 / 3 TFLOP/s.
//
//   - A block computes a TH x 64 output tile of one image for all of Co.
//     Its input tile with its halo is staged as in cmconv.cu
//     (cmconv_tile.cuh), 8 channels a chunk, double buffered; the weights
//     sit in shared memory as [tap][C padded to 8][Co padded to 8 NT], zero
//     past C and Co.
//   - A warp computes MT m-tiles of 16 pixels of one output row: four (TH =
//     8) for NT <= 2, two (TH = 4) for NT = 4, so that the accumulators and
//     B fragments fit the registers of two blocks per SM. A k-step is one
//     tap (dy, dx) over the chunk's 8 channels, so the A fragment of lane
//     (gid, tig) is staged[c = tig (+4)][r + dy][x + gid (+8) + dx + 3] at
//     offsets fixed per step, and the B fragment w[tap][c = tig (+4)][8 n +
//     gid]. The channel strides (760 and 456 floats) and the weight row
//     strides (8, 24, 40) keep both reads free of bank conflicts. B is split
//     once per k-step and reused by the warp's m-tiles.
//   - Each output sums chunk by chunk, tap by tap, in the MMA's fixed order:
//     not the SIMT instance's order, within 1e-5 of the output's scale of
//     the plain version, and the same in every launch.

#include "cmconv_tile.cuh"

namespace {

using namespace cmconv;

constexpr int kCC = 8;  // channels per chunk: one k-step per tap

// A warp computes MT m-tiles of 16 pixels along x: four (a 64-wide row) for
// NT <= 2, two for NT = 4, whose 64 accumulators and 16 B fragments would not
// otherwise fit the 128 registers of two blocks per SM. The 8 warps cover TH
// rows.
__host__ __device__ constexpr int m_tiles(int nt) { return nt == 4 ? 2 : 4; }
__host__ __device__ constexpr int tile_h(int nt) { return 8 * m_tiles(nt) / 4; }
// channel stride: 8 or 24 mod 32 keeps the A reads free of bank conflicts
// (760 for 10 staged rows, 456 for 6)
__host__ __device__ constexpr int chan_stride(int nt) { return (tile_h(nt) + 2) * kLdx; }
__host__ __device__ constexpr int ldw(int nt) { return nt == 1 ? 8 : 8 * nt + 8; }

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT, bool V16>
__global__ void __launch_bounds__(kThreads, 2)
cmconv3x3_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, int C, int Co, int H, int W,
                    float* __restrict__ out) {
  constexpr int LDW = ldw(NT);
  constexpr int kMT = m_tiles(NT), kTH = tile_h(NT), kRows = kTH + 2;
  constexpr int kChs = chan_stride(NT), kChunk = kCC * kChs;
  extern __shared__ float4 smem4[];
  float* s_x = reinterpret_cast<float*>(smem4);  // [2][kCC][kRows][kLdx]
  float* s_w = s_x + 2 * kChunk;                 // [9][cp][LDW]

  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* xb = x + static_cast<int64_t>(blockIdx.z) * C * plane;
  const int n_chunks = (C + kCC - 1) / kCC;
  const int cp = n_chunks * kCC;

  stage_chunk<kCC, kRows, kChs, V16>(s_x, xb, 0, C, H, W, y0, x0);
  cp_commit();
  for (int i = threadIdx.x; i < 9 * cp * LDW; i += kThreads) {
    const int co = i % LDW;
    const int c = (i / LDW) % cp;
    const int tap = i / (LDW * cp);
    s_w[i] = co < Co && c < C ? w[(tap * C + c) * Co + co] : 0.0f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  constexpr int kWarpsPerRow = 4 / kMT;
  const int row = warp / kWarpsPerRow;                    // of the tile
  const int xw = (warp % kWarpsPerRow) * 16 * kMT;        // first pixel

  float acc[kMT][NT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.0f;

  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage_chunk<kCC, kRows, kChs, V16>(s_x + ((k + 1) & 1) * kChunk, xb,
                                          (k + 1) * kCC, C, H, W, y0, x0);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* a_base = s_x + (k & 1) * kChunk + tig * kChs + row * kLdx + xw + gid + 3;
    const float* b_base = s_w + (k * kCC + tig) * LDW + gid;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* bp = b_base + tap * cp * LDW + n * 8;
        split_tf32(bp[0], bhi[n][0], blo[n][0]);
        split_tf32(bp[4 * LDW], bhi[n][1], blo[n][1]);
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float* ap = a_base + dy * kLdx + dx + 16 * m;
        uint32_t ahi[4], alo[4];
        split_tf32(ap[0], ahi[0], alo[0]);
        split_tf32(ap[8], ahi[1], alo[1]);
        split_tf32(ap[4 * kChs], ahi[2], alo[2]);
        split_tf32(ap[4 * kChs + 8], ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_tf32(acc[m][n], alo, bhi[n][0], bhi[n][1]);
          mma_tf32(acc[m][n], ahi, blo[n][0], blo[n][1]);
          mma_tf32(acc[m][n], ahi, bhi[n][0], bhi[n][1]);
        }
      }
    }
    __syncthreads();  // the buffer is restaged two chunks on
  }

  // acc[m][n]: pixels 16 m + gid (q 0, 1) and + 8 (q 2, 3), output channels
  // 8 n + 2 tig (q 0, 2) and + 1 (q 1, 3)
  const int yo = y0 + row;
  if (yo >= H) return;
  float* ob = out + static_cast<int64_t>(blockIdx.z) * Co * plane +
              static_cast<int64_t>(yo) * W + x0 + xw;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int co = 8 * n + 2 * tig + (q & 1);
      if (co >= Co) continue;
      const float bj = bias != nullptr ? bias[co] : 0.0f;
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int xl = 16 * m + gid + (q >> 1) * 8;
        if (x0 + xw + xl < W) {
          ob[co * plane + xl] = bias != nullptr ? acc[m][n][q] + bj : acc[m][n][q];
        }
      }
    }
  }
}

template <int NT, bool V16>
cudaError_t launch_nt(const float* x, const float* w, const float* bias, int B, int C,
                      int Co, int H, int W, float* out, cudaStream_t stream) {
  const dim3 grid((W + kTW - 1) / kTW, (H + tile_h(NT) - 1) / tile_h(NT), B);
  const int cp = (C + kCC - 1) / kCC * kCC;
  const size_t smem = (2 * static_cast<size_t>(kCC) * chan_stride(NT) +
                       static_cast<size_t>(9) * cp * ldw(NT)) *
                      sizeof(float);
  return cmconv::launch(cmconv3x3_tc_kernel<NT, V16>, grid, smem, stream, x, w, bias,
                        C, Co, H, W, out);
}

template <int NT>
cudaError_t launch_nt(bool v16, const float* x, const float* w, const float* bias,
                      int B, int C, int Co, int H, int W, float* out,
                      cudaStream_t stream) {
  return v16 ? launch_nt<NT, true>(x, w, bias, B, C, Co, H, W, out, stream)
             : launch_nt<NT, false>(x, w, bias, B, C, Co, H, W, out, stream);
}

}  // namespace

// The signature and the argument check of mlad_cmconv3x3 (cmconv.cu).
extern "C" int mlad_cmconv3x3_tc(const float* x, const float* w,
                                 const float* bias, int B, int C, int Co, int H,
                                 int W, float* out, void* stream) {
  const int nt = Co <= 8 ? 1 : (Co <= 16 ? 2 : 4);
  if (!valid_args(B, C, Co, H, W, tile_h(nt))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool v16 = use_v16(x, W);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nt == 1) {
    err = launch_nt<1>(v16, x, w, bias, B, C, Co, H, W, out, s);
  } else if (nt == 2) {
    err = launch_nt<2>(v16, x, w, bias, B, C, Co, H, W, out, s);
  } else {
    err = launch_nt<4>(v16, x, w, bias, B, C, Co, H, W, out, s);
  }
  return static_cast<int>(err);
}
