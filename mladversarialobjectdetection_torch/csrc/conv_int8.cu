// int8 x int8 -> int32 convolution with float dequantisation: the first
// design of the W8A8 serve's conv (mladversarialobjectdetection_torch/
// inference/quantize.py), now the ablation (instance "simt") of its Hopper
// redesign, conv_int8_sm90.cu, which every path launches.
//
// Replaces no Pallas kernel. The JAX package runs this conv as XLA's int8
// `lax.conv_general_dilated(..., preferred_element_type=int32)`
// (mladversarialobjectdetection_tpu/inference/quantize.py:160-178), and no
// PyTorch call sums an int8 convolution in int32 on the card (`F.conv2d` on
// int8 tensors sums in int8; `torch._int_mm` covers 2-D products only). It
// computes what `conv_int8_plain` of ops/conv_int8.py computes, for one conv:
//
//   xq  = clip(rint(x / a_s), -127, 127)                      (int8)
//   acc = sum_{c, i, j} xq[b, c, oh*sh - pt + i, ow*sw - pl + j] * w[co, c, i, j]
//   out = float(acc) * scale[co] (+ bias[co]), in the output dtype
//
// with x [B, C, H, W] float32 or bf16 (NCHW, contiguous), w [Co, C/g, kh, kw]
// int8 (OIHW), scale = a_s * w_scale [Co] and bias [Co] float32, zero padding
// outside the image (Flax "SAME" pads pt / pl before, "VALID" none), and
// groups g = 1 or g = C = Co (depthwise).
//
// Exactness. Integer sums are exact in any order, so the int32 sums equal
// the plain version's. The quantisation divides with __fdiv_rn (never a
// multiply by the reciprocal) and rounds with rintf (half to even, as
// jnp.round and torch.round); the epilogue converts with __int2float_rn and
// multiplies and adds with __fmul_rn and __fadd_rn, so no FMA contraction
// fuses them. The output is then bit-equal to the plain version's.
//
// What bounds it on an H100 (chip_smoke.py phase 22): the int8 products at
// 1,979 TOPS against x, w and the output once over 3.35 TB/s. The 1x1 and
// 3x3 dense convs of lite4 at 640 have enough products per byte to be bound
// by operations on the tensor cores; this kernel does not use them. The
// depthwise convs (9 or 25 products per output) are bound by bytes. This is
// the first, simple design: right first, fast later.
//
//   1. Two launches a conv: `quantize_kernel` writes xq once (int8), then
//      the conv kernel reads it, so each activation is divided once and
//      the conv reads a quarter of the float bytes. For the dense conv xq
//      is channels-last with the channels padded to a multiple of 4, each
//      pixel a row of 32-bit words of 4 channels (zero past C); for the
//      depthwise conv it stays NCHW.
//   2. Dense conv (g = 1): an implicit GEMM, M = B*OH*OW output pixels,
//      N = Co, K = kh*kw*ceil(C/4) words, in SIMT integer units. A block of
//      256 threads computes a 64 x 64 tile; per step of 8 words it stages
//      the tile's A (64 pixels, gathered with the padding as zeros) and B
//      (64 output channels, packed from OIHW bytes) in shared memory, and
//      each thread sums 4 pixels x 4 channels with __dp4a (4 products a
//      call). Stores go along the pixels, coalesced in NCHW.
//   3. Depthwise conv (g = C = Co): one thread per output, the taps summed
//      in int32, the reads along W coalesced.
//
// The redesign, conv_int8_sm90.cu, is one launch a call with the
// quantisation fused into the loads: an implicit GEMM on the tensor cores
// (mma.sync s8 m16n8k32) for the dense convs, a shared-memory halo tile for
// the depthwise ones.

#include <cuda_bf16.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 64;  // output pixels a block
constexpr int kBN = 64;  // output channels a block
constexpr int kBK = 8;   // 32-bit words (4 channels each) a step

enum OutKind { kF32 = 0, kBF16 = 1, kSums = 2 };

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ int quantize(float v, float a_s) {
  float r = rintf(__fdiv_rn(v, a_s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int>(r);
}

// xq for the dense conv: [B, H, W, Cw] words, channel 4*cw + q in byte q
template <typename T>
__global__ void quantize_words_kernel(const T* __restrict__ x, float a_s, int B, int C,
                                      int HW, int Cw, int* __restrict__ xq) {
  const int64_t n = static_cast<int64_t>(B) * Cw * HW;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(idx % HW);
    const int64_t rest = idx / HW;
    const int cw = static_cast<int>(rest % Cw);
    const int b = static_cast<int>(rest / Cw);
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * cw + q;
      if (c < C) {
        const int v = quantize(load_f(x, (static_cast<int64_t>(b) * C + c) * HW + p), a_s);
        word |= (static_cast<uint32_t>(v) & 0xffu) << (8 * q);
      }
    }
    xq[(static_cast<int64_t>(b) * HW + p) * Cw + cw] = static_cast<int>(word);
  }
}

// xq for the depthwise conv: NCHW int8
template <typename T>
__global__ void quantize_bytes_kernel(const T* __restrict__ x, float a_s, int64_t n,
                                      int8_t* __restrict__ xq) {
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    xq[idx] = static_cast<int8_t>(quantize(load_f(x, idx), a_s));
  }
}

__device__ __forceinline__ void store(void* out, int kind, int64_t idx, int acc, float s,
                                      const float* __restrict__ bias, int co) {
  if (kind == kSums) {
    static_cast<int*>(out)[idx] = acc;
    return;
  }
  float v = __fmul_rn(__int2float_rn(acc), s);
  if (bias != nullptr) v = __fadd_rn(v, bias[co]);
  if (kind == kBF16) {
    static_cast<bf16*>(out)[idx] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[idx] = v;
  }
}

struct Geometry {
  int B, C, H, W, Co, kh, kw, sh, sw, pt, pl, OH, OW;
};

__global__ void __launch_bounds__(kThreads)
conv_dense_kernel(const int* __restrict__ xq, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias, Geometry g,
                  int Cw, void* __restrict__ out, int kind) {
  __shared__ int As[kBK][kBM + 1];
  __shared__ int Bs[kBK][kBN + 1];
  const int t = threadIdx.x;
  const int ohw = g.OH * g.OW;
  const int64_t M = static_cast<int64_t>(g.B) * ohw;
  const int K = g.kh * g.kw * Cw;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // the words this thread stages: pixel / channel t / 4, words 2 (t % 4) + {0, 1}
  const int lrow = t >> 2, lk = (t & 3) * 2;
  const int64_t am = m0 + lrow;
  const bool a_ok = am < M;
  int ab = 0, ih0 = 0, iw0 = 0;
  if (a_ok) {
    ab = static_cast<int>(am / ohw);
    const int p = static_cast<int>(am % ohw);
    ih0 = (p / g.OW) * g.sh - g.pt;
    iw0 = (p % g.OW) * g.sw - g.pl;
  }
  const int bco = n0 + lrow;
  const bool b_ok = bco < g.Co;
  const int taps = g.kh * g.kw;

  const int tx = t & 15, ty = t >> 4;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kk = k0 + lk + e;
      int aw = 0, bw = 0;
      if (kk < K) {
        const int tap = kk / Cw, cw = kk - tap * Cw;
        const int i = tap / g.kw, j = tap - i * g.kw;
        if (a_ok) {
          const int ih = ih0 + i, iw = iw0 + j;
          if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
            aw = xq[((static_cast<int64_t>(ab) * g.H + ih) * g.W + iw) * Cw + cw];
          }
        }
        if (b_ok) {
          uint32_t word = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = 4 * cw + q;
            if (c < g.C) {
              const int8_t v = w[((static_cast<int64_t>(bco) * g.C + c) * taps) + i * g.kw + j];
              word |= (static_cast<uint32_t>(static_cast<uint8_t>(v))) << (8 * q);
            }
          }
          bw = static_cast<int>(word);
        }
      }
      As[lk + e][lrow] = aw;
      Bs[lk + e][lrow] = bw;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][ty + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + tx + 16 * i;
    if (m >= M) continue;
    const int b = static_cast<int>(m / ohw);
    const int p = static_cast<int>(m % ohw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + ty + 16 * j;
      if (co >= g.Co) continue;
      store(out, kind, (static_cast<int64_t>(b) * g.Co + co) * ohw + p, acc[i][j],
            kind == kSums ? 0.0f : scale[co], bias, co);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
conv_depthwise_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      Geometry g, void* __restrict__ out, int kind) {
  const int ohw = g.OH * g.OW;
  const int64_t n = static_cast<int64_t>(g.B) * g.C * ohw;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(idx % ohw);
    const int64_t bc = idx / ohw;
    const int c = static_cast<int>(bc % g.C);
    const int ih0 = (p / g.OW) * g.sh - g.pt, iw0 = (p % g.OW) * g.sw - g.pl;
    const int8_t* xp = xq + bc * g.H * g.W;
    const int8_t* wp = w + static_cast<int64_t>(c) * g.kh * g.kw;
    int acc = 0;
    for (int i = 0; i < g.kh; ++i) {
      const int ih = ih0 + i;
      if (ih < 0 || ih >= g.H) continue;
      for (int j = 0; j < g.kw; ++j) {
        const int iw = iw0 + j;
        if (iw < 0 || iw >= g.W) continue;
        acc += static_cast<int>(xp[ih * g.W + iw]) * static_cast<int>(wp[i * g.kw + j]);
      }
    }
    store(out, kind, idx, acc, kind == kSums ? 0.0f : scale[c], bias, c);
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < (1 << 20) ? blocks : (1 << 20));
}

template <typename T>
int run(const T* x, float a_s, const int8_t* w, const float* scale, const float* bias,
        Geometry g, int depthwise, void* scratch, void* out, int kind, cudaStream_t s) {
  const int hw = g.H * g.W;
  if (depthwise) {
    const int64_t n = static_cast<int64_t>(g.B) * g.C * hw;
    auto* xq = static_cast<int8_t*>(scratch);
    quantize_bytes_kernel<T><<<grid_for(n), kThreads, 0, s>>>(x, a_s, n, xq);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t m = n / hw * g.OH * g.OW;
    conv_depthwise_kernel<<<grid_for(m), kThreads, 0, s>>>(xq, w, scale, bias, g, out, kind);
    return cudaGetLastError();
  }
  const int cw = (g.C + 3) / 4;
  auto* xq = static_cast<int*>(scratch);
  quantize_words_kernel<T>
      <<<grid_for(static_cast<int64_t>(g.B) * cw * hw), kThreads, 0, s>>>(x, a_s, g.B, g.C, hw,
                                                                           cw, xq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t M = static_cast<int64_t>(g.B) * g.OH * g.OW;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((g.Co + kBN - 1) / kBN));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  conv_dense_kernel<<<grid, kThreads, 0, s>>>(xq, w, scale, bias, g, cw, out, kind);
  return cudaGetLastError();
}

}  // namespace

// x: float32 (x_bf16 = 0) or bf16 (1); scratch: B*H*W*ceil(C/4)*4 bytes
// (dense) or B*C*H*W (depthwise); out: [B, Co, OH, OW] of `kind` (0 float32,
// 1 bf16, 2 the int32 sums, no dequantisation); bias may be null.
extern "C" int mlad_conv_int8(const void* x, int x_bf16, float a_s, const int8_t* w,
                              const float* scale, const float* bias, int B, int C, int H,
                              int W, int Co, int kh, int kw, int sh, int sw, int pt, int pl,
                              int OH, int OW, int depthwise, void* scratch, void* out, int kind,
                              void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || Co < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      OH < 1 || OW < 1 || kind < 0 || kind > 2 || (depthwise && Co != C))
    return cudaErrorInvalidValue;
  const Geometry g{B, C, H, W, Co, kh, kw, sh, sw, pt, pl, OH, OW};
  const auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return run(static_cast<const bf16*>(x), a_s, w, scale, bias, g, depthwise, scratch, out,
               kind, s);
  }
  return run(static_cast<const float*>(x), a_s, w, scale, bias, g, depthwise, scratch, out, kind,
             s);
}
