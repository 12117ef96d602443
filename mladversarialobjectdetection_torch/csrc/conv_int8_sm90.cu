// int8 x int8 -> int32 convolution with float dequantisation, redesigned for
// Hopper: the conv of the W8A8 serve (mladversarialobjectdetection_torch/
// inference/quantize.py), one launch a call with the quantisation fused into
// the loads. `conv_int8.cu` (two launches: quantise, then __dp4a / int32
// sums) is its ablation.
//
// Replaces no Pallas kernel. The JAX package runs this conv as XLA's int8
// `lax.conv_general_dilated(..., preferred_element_type=int32)`
// (mladversarialobjectdetection_tpu/inference/quantize.py:160-178). It
// computes what `conv_int8_plain` of ops/conv_int8.py computes, for one conv:
//
//   xq  = clip(rint(x / a_s), -127, 127)                      (int8)
//   acc = sum_{c, i, j} xq[b, c, oh*sh - pt + i, ow*sw - pl + j] * w[co, c, i, j]
//   out = float(acc) * scale[co] (+ bias[co]), in the output dtype
//
// with x [B, C, H, W] float32 or bf16 (NCHW, contiguous), scale = a_s *
// w_scale [Co] and bias [Co] float32, zero padding outside the image, and
// groups 1 or C = Co (depthwise). Exactness: integer sums are exact in any
// order; the quantisation takes the quotient as __fdiv_rn rounds it
// (`quantize`: a reciprocal product, the division itself near a
// half-integer) and rounds with rintf; the epilogue converts with
// __int2float_rn and multiplies and adds with __fmul_rn and __fadd_rn, so no
// FMA contraction fuses them. The output is bit-equal to the plain
// version's.
//
// What bounds it on an H100: bytes. Over lite4@640's 288 conv calls at b8
// the int8 products take 0.150 ms at 1,979 TOPS, x, the weights and the
// output once over 3.35 TB/s 3.711 ms (chip_smoke.py phase 22a). So the
// design moves each byte of x and of the output once:
//
//   1. Dense conv (groups 1): an implicit GEMM on the tensor cores,
//      mma.sync m16n8k32 s8 x s8 -> s32. M = B*OH*OW output pixels, N = Co,
//      K = taps x Cp (Cp = C padded to 4, so that a word of 4 channels
//      never straddles two taps), padded to 64, 64 of K a step. A block of
//      8 warps (2 along M, 4 along N) computes 64 pixels x BN channels, BN
//      up to 256 (the plan's pick): every Co tile quantises its pixels' x
//      again, so the plan takes as few as fill the SMs. Each thread
//      quantises 4 channels x 4 pixels a step and packs each pixel's 4
//      channels into one word (__byte_perm); the words land in shared memory
//      as [word][pixel] rows, padded so that the fragments' loads meet no
//      bank conflict. Where a 1x1 stride-1 conv maps pixels to pixels (and
//      H*W is a multiple of 4), raw x comes through a 3-deep cp.async ring
//      (16 bytes of 4 pixels a copy, zeros past C or M), so that two steps
//      of loads are in flight while one is quantised from shared memory;
//      otherwise each thread gathers its 16 values a step ahead into
//      registers, with the zero padding as zeros. The weights come packed
//      once per conv (`pack_int8_weights`: [Co padded to 32][Kp], K-major in
//      the kernel's K order) through the same ring, their 16-byte quarters
//      swizzled against bank conflicts. The epilogue stores the sums
//      straight from the fragments, a quad group of lanes writing 8
//      consecutive pixels of a channel: whole 32-byte sectors.
//   2. Depthwise conv (g = C = Co): a halo tile in shared memory. A block
//      takes one (image, group of channels, band of output rows), reads the
//      band's input rows with their halo once (16-byte loads along W where
//      W is a multiple of 4, four loads in flight a thread), quantises them
//      into an int8 tile whose zero margins are the padding. Each thread
//      keeps one quad of 4 neighbouring outputs along W and steps over the
//      block's rows (no division an item); it reads a kernel row's window
//      as words, aligns it once with funnel shifts and sums taps 0-3 of
//      each output with one __dp4a against the kernel row packed in a word
//      (kernel size and stride compiled in for k3 / k5, stride 1 / 2; the
//      packed rows stay in registers while the channel does), then stores
//      the quad with one vector store.
//   3. The stem (C 3, 3x3, stride 2) runs the dense path's gather with Cp 4:
//      K 36 in one step of 64, which wastes products, not bytes.

#include <cuda_bf16.h>

#include <cstdint>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSMs = 132;       // an H100 SXM's; the dense plan reads it
constexpr int kBM = 64;         // output pixels a dense block
constexpr int kBK = 64;         // K a dense step (bytes of a weight row)
constexpr int kAW = kBK / 4;    // words a pixel a step, 4 channels each
constexpr int kAS = kBM + 8;    // words a row of the dense A words ([word][pixel])
constexpr int kStages = 3;      // the dense cp.async ring's depth (VEC)
constexpr int kMaxNT = 8;       // BN <= 256 channels
constexpr int kDwQuads = 1024;  // 4-output items a depthwise block aims at
constexpr int kDwSmem = 48 * 1024;

enum OutKind { kF32 = 0, kBF16 = 1, kSums = 2 };

struct Geometry {
  int B, C, H, W, Co, kh, kw, sh, sw, pt, pl, OH, OW;
};

// clip(rint(v / a_s), -127, 127), the quotient rounded as __fdiv_rn rounds
// it, with r = __frcp_rn(a_s). The product t = v * r (both roundings to
// nearest) lies within 3 * 2^-24 |v / a_s| of the rounded quotient q: under
// 2.3e-5 where |q| < 128.5, and beyond that both clip to the same bound. So
// t and q round to the same integer unless t lies within 1e-4 of a
// half-integer; there the division itself decides. (__fdiv_rn on every
// value was slower on the card, most of all on zero dividends, which ReLU6
// activations and the channel padding are full of.)
__device__ __forceinline__ int quantize(float v, float a_s, float r) {
  float t = __fmul_rn(v, r);
  if (fabsf(__fsub_rn(t, __fadd_rn(floorf(t), 0.5f))) < 1e-4f) t = __fdiv_rn(v, a_s);
  return static_cast<int>(fminf(fmaxf(rintf(t), -127.0f), 127.0f));
}

// the low bytes of a, b, c, d as one word, a in byte 0
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(__ldg(p))) << 16);
}

// 4 consecutive elements (16-byte aligned for float, 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = lo_f(u.x), v[1] = hi_f(u.x), v[2] = lo_f(u.y), v[3] = hi_f(u.y);
}

// the same from shared memory
__device__ __forceinline__ void load4_shared(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4_shared(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = lo_f(u.x), v[1] = hi_f(u.x), v[2] = lo_f(u.y), v[3] = hi_f(u.y);
}

__device__ __forceinline__ float dequant(int acc, float s, const float* __restrict__ bias,
                                         int co) {
  const float v = __fmul_rn(__int2float_rn(acc), s);
  return bias != nullptr ? __fadd_rn(v, __ldg(bias + co)) : v;
}

__device__ __forceinline__ void store1(void* out, int kind, int64_t idx, int acc, float s,
                                       const float* __restrict__ bias, int co) {
  if (kind == kSums) {
    static_cast<int*>(out)[idx] = acc;
  } else if (kind == kBF16) {
    static_cast<bf16*>(out)[idx] = __float2bfloat16_rn(dequant(acc, s, bias, co));
  } else {
    static_cast<float*>(out)[idx] = dequant(acc, s, bias, co);
  }
}

// 4 outputs at idx (a multiple of 4; out 16-byte aligned)
__device__ __forceinline__ void store4(void* out, int kind, int64_t idx, const int (&acc)[4],
                                       float s, const float* __restrict__ bias, int co) {
  if (kind == kSums) {
    *reinterpret_cast<int4*>(static_cast<int*>(out) + idx) =
        make_int4(acc[0], acc[1], acc[2], acc[3]);
    return;
  }
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = dequant(acc[e], s, bias, co);
  if (kind == kBF16) {
    *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + idx) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + idx) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- dense

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}

// one cp.async of 4 consecutive elements (zeros where !ok)
__device__ __forceinline__ void copy4(void* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void copy4(void* dst, const bf16* src, bool ok) {
  cp_async8(dst, src, ok);
}

template <typename T, int NT>
struct DenseSmem {
  static constexpr int kBN = 32 * NT;
  static constexpr int kRaw = kBK * kBM * static_cast<int>(sizeof(T));  // [channel][pixel]
  static constexpr int kB = kBN * kBK;                                   // [row][64 bytes]
  static constexpr int kA = kAW * kAS * 4;                               // [word][pixel]
  // VEC: the ring holds `slots` <= kStages slots
  static constexpr int bytes(bool vec, int slots) {
    return vec ? slots * (kRaw + kB) + 2 * kA : 2 * kB + 2 * kA;
  }
};

// The gather path's staging: the 16 x values a thread stages a step (4
// channels q x 4 pixels p, one step ahead in registers) and its pixels'
// addressing.
struct GatherStage {
  float v[4][4];
  int64_t base[4];  // the pixel's image offset in x
  int ih0[4], iw0[4];

  __device__ __forceinline__ void init(const Geometry& g, int64_t m, int64_t M) {
    const int ohw = g.OH * g.OW;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int64_t mp = m + p;
      if (mp < M) {
        const int64_t b = mp / ohw;
        const int r = static_cast<int>(mp - b * ohw);
        const int oh = r / g.OW;
        base[p] = b * g.C * g.H * g.W;
        ih0[p] = oh * g.sh - g.pt;
        iw0[p] = (r - oh * g.OW) * g.sw - g.pl;
      } else {  // no such pixel: every tap falls outside the image
        base[p] = 0;
        ih0[p] = -(1 << 29);
        iw0[p] = 0;
      }
    }
  }

  // channels c .. c + 3 (c >= C: zeros) at tap (i, j)
  template <typename T>
  __device__ __forceinline__ void load(const T* __restrict__ x, const Geometry& g, int c, int i,
                                       int j) {
    const int64_t hw = static_cast<int64_t>(g.H) * g.W;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int ih = ih0[p] + i, iw = iw0[p] + j;
        const bool in = c + q < g.C && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
        v[q][p] = in ? load1(x + base[p] + (c + q) * hw + static_cast<int64_t>(ih) * g.W + iw)
                     : 0.0f;
      }
  }
};

// 16 values (4 channels q x 4 pixels p) quantised, one word of 4 channels a
// pixel, the 4 pixels' words to dst [4]
__device__ __forceinline__ void store_words(uint32_t* dst, const float (&v)[4][4], float a_s,
                                            float r) {
  int qv[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) qv[q][p] = quantize(v[q][p], a_s, r);
  uint4 words;
  words.x = pack4(qv[0][0], qv[1][0], qv[2][0], qv[3][0]);
  words.y = pack4(qv[0][1], qv[1][1], qv[2][1], qv[3][1]);
  words.z = pack4(qv[0][2], qv[1][2], qv[2][2], qv[3][2]);
  words.w = pack4(qv[0][3], qv[1][3], qv[2][3], qv[3][3]);
  *reinterpret_cast<uint4*>(dst) = words;
}

// wp: [w_rows][Kp] int8, row co holding tap t's channel c at t*Cp + c (Cp = C
// padded to 4, Kp = taps*Cp padded to 64). A block: 64 output pixels x BN =
// 32 NT channels, 8 warps, 2 along M (32 pixels each) x 4 along N (8 NT
// channels each); a step: 64 of K (two m16n8k32 products a tile).
// VEC (1x1, stride 1, no padding, H*W a multiple of 4, x aligned): raw x
// comes through a kStages-deep cp.async ring beside the weights and is
// quantised from shared memory; otherwise each thread gathers its 16 values
// a step ahead into registers.
// blocks an SM should hold: more for the narrow tiles, whose accumulators
// leave registers to spare
constexpr int dense_min_blocks(int nt, bool vec) {
  return !vec ? 2 : nt <= 2 ? 4 : nt <= 5 ? 3 : 2;
}

template <typename T, int NT, bool VEC>
__global__ void __launch_bounds__(kThreads, dense_min_blocks(NT, VEC))
conv_dense_sm90_kernel(const T* __restrict__ x, float a_s, const int8_t* __restrict__ wp,
                       int w_rows, const float* __restrict__ scale,
                       const float* __restrict__ bias, Geometry g, int n_tiles,
                       void* __restrict__ out, int kind) {
  using Smem = DenseSmem<T, NT>;
  constexpr int BN = Smem::kBN;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int gq = lane >> 2, tq = lane & 3;  // the mma fragments' group and thread
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * kBM;
  const int ohw = g.OH * g.OW;
  const int64_t M = static_cast<int64_t>(g.B) * ohw;
  const int cp = (g.C + 3) / 4 * 4;
  const int taps = g.kh * g.kw;
  const int steps = (taps * cp + kBK - 1) / kBK;
  const int64_t Kp = static_cast<int64_t>(steps) * kBK;
  // staging: pixel group pg (pixels 4 pg .. 4 pg + 3), word cg of the step
  // (K 4 cg .. 4 cg + 3)
  const int pg = tid & 15, cg = tid >> 4;
  const float rcp = __frcp_rn(a_s);

  // the B rows of step s: BN rows of four 16-byte quarters, quarter h of
  // row n at h ^ bits 1-2 of n
  auto load_b = [&](int s, unsigned char* dst) {
    for (int e = tid; e < 4 * BN; e += kThreads) {
      const int n = e >> 2, h = e & 3;
      const bool ok = n0 + n < w_rows;
      const int8_t* src = ok ? wp + (n0 + n) * Kp + s * kBK + h * 16 : wp;
      cp_async16(dst + n * kBK + ((h ^ ((n >> 1) & 3)) << 4), src, ok);
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  auto mma_step = [&](const uint32_t* As, const unsigned char* Bs) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int mb = wm * 32 + mt * 16 + gq;
        af[mt][0] = As[(8 * ks + tq) * kAS + mb];
        af[mt][1] = As[(8 * ks + tq) * kAS + mb + 8];
        af[mt][2] = As[(8 * ks + 4 + tq) * kAS + mb];
        af[mt][3] = As[(8 * ks + 4 + tq) * kAS + mb + 8];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn * (BN / 4) + nt * 8 + gq;
        const uint32_t* row = reinterpret_cast<const uint32_t*>(Bs + n * kBK);
        const int sw = (n >> 1) & 3;
        const uint32_t b0 = row[((2 * ks) ^ sw) * 4 + tq];
        const uint32_t b1 = row[((2 * ks + 1) ^ sw) * 4 + tq];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
      }
    }
  };

  // the sums, straight from the fragments: the 8 lanes of a quad group hold
  // one channel's 8 consecutive pixels, so each store instruction writes
  // whole 32-byte sectors of NCHW rows
  auto epilogue = [&]() {
    int64_t off[2][2];  // the output offset of pixel (mt, half) at channel 0
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int64_t m = m0 + wm * 32 + mt * 16 + hf * 8 + gq;
        const int64_t b = m / ohw;
        off[mt][hf] = m < M ? b * g.Co * ohw + (m - b * ohw) : -1;
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int co = n0 + wn * (BN / 4) + nt * 8 + 2 * tq + e2;
        if (co >= g.Co) continue;
        const float sc = kind == kSums ? 0.0f : __ldg(scale + co);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            if (off[mt][hf] >= 0)
              store1(out, kind, off[mt][hf] + static_cast<int64_t>(co) * ohw,
                     acc[mt][nt][2 * hf + e2], sc, bias, co);
      }
  };

  if constexpr (VEC) {
    // step s in slot s % kStages: min(kStages, steps) slots are allocated
    const int slots = steps < kStages ? steps : kStages;
    auto raw = [&](int slot) { return smem + slot * Smem::kRaw; };
    auto bst = [&](int slot) { return smem + slots * Smem::kRaw + slot * Smem::kB; };
    auto aw = [&](int buf) {
      return reinterpret_cast<uint32_t*>(smem + slots * (Smem::kRaw + Smem::kB) +
                                         buf * Smem::kA);
    };
    // step s's copies: 4 pixels (pixel group pg) of channels cg + 16 u, u < 4
    const int64_t mq = m0 + 4 * pg;
    const bool pok = mq < M;  // all 4 pixels, M being a multiple of 4
    const int64_t bq = mq / ohw;
    const T* xq = x + (pok ? bq * g.C * ohw + (mq - bq * ohw) : 0);
    auto load_step = [&](int s, int slot) {
      unsigned char* dst = raw(slot);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ch = cg + 16 * u, c = s * kBK + ch;
        const bool ok = pok && c < g.C;
        copy4(dst + (ch * kBM + 4 * pg) * sizeof(T), ok ? xq + c * static_cast<int64_t>(ohw) : x,
              ok);
      }
      load_b(s, bst(slot));
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) load_step(s, s);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // step s landed; step s - 1 converted and multiplied by all
      const int slot = s % kStages, ahead = s + kStages - 1;
      if (ahead < steps) load_step(ahead, ahead % kStages);
      cp_async_commit();
      uint32_t* words = aw(s & 1) + cg * kAS + 4 * pg;
      if (s * kBK + 4 * cg < g.C) {
        const T* rs = reinterpret_cast<const T*>(raw(slot));
        float v[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) load4_shared(rs + (4 * cg + q) * kBM + 4 * pg, v[q]);
        store_words(words, v, a_s, rcp);
      } else {  // past C: zeros
        *reinterpret_cast<uint4*>(words) = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
      mma_step(aw(s & 1), bst(slot));
    }
  } else {
    auto bst = [&](int buf) { return smem + buf * Smem::kB; };
    auto aw = [&](int buf) {
      return reinterpret_cast<uint32_t*>(smem + 2 * Smem::kB + buf * Smem::kA);
    };
    GatherStage stage;
    stage.init(g, m0 + 4 * pg, M);
    auto load_a = [&](int s) {
      const int k0 = s * kBK + 4 * cg;
      const int tap = k0 / cp;
      const int i = tap / g.kw;
      // past the last tap: channel C, all zeros
      stage.load(x, g, tap < taps ? k0 - tap * cp : g.C, i, tap - i * g.kw);
    };
    load_a(0);
    load_b(0, bst(0));
    cp_async_commit();
    store_words(aw(0) + cg * kAS + 4 * pg, stage.v, a_s, rcp);
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<0>();
      __syncthreads();  // step s staged by all; step s - 1's reads done
      const int cur = s & 1;
      const bool next = s + 1 < steps;
      if (next) {
        load_a(s + 1);
        load_b(s + 1, bst(cur ^ 1));
        cp_async_commit();
      }
      mma_step(aw(cur), bst(cur));
      if (next) store_words(aw(cur ^ 1) + cg * kAS + 4 * pg, stage.v, a_s, rcp);
    }
  }
  epilogue();
}

// ------------------------------------------------------------ depthwise

// A block: image b, channels c0 .. c0 + CG - 1, output rows oh0 .. oh0 + RB - 1.
// The tile holds, a channel, IR = (RB - 1) sh + kh input rows from
// oh0 sh - pt, each IWS bytes wide with input column iw at ML + iw (ML >= pl,
// a multiple of 4); what lies outside the image stays 0. The block's weights
// follow it: with K compiled in, each kernel row as [taps 0-3 packed in a
// word, tap 4], [CG][K][2]; else as ints, [CG][kh*kw].
struct DwPlan {
  int CG, RB, IR, IWS, ML, QPR, n_cg, n_band;
};

constexpr int kDwUnroll = 4;  // loads a thread keeps in flight

// K, S: the kernel size and stride compiled in (kh = kw = K, sh = sw = S);
// 0: read from g
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
conv_dw_sm90_kernel(const T* __restrict__ x, float a_s, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias, Geometry g,
                    DwPlan p, void* __restrict__ out, int kind, int vec_in, int vec_out) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  int8_t* tile = reinterpret_cast<int8_t*>(dw_smem);
  const int kh = K ? K : g.kh, kw = K ? K : g.kw;
  const int sh = S ? S : g.sh, sw = S ? S : g.sw;
  const int taps = kh * kw;
  const int tid = threadIdx.x;
  const int band = static_cast<int>(blockIdx.x % p.n_band);
  const int rest = static_cast<int>(blockIdx.x / p.n_band);
  const int c0 = (rest % p.n_cg) * p.CG, b = rest / p.n_cg;
  const int oh0 = band * p.RB;
  const int ih_start = oh0 * sh - g.pt;
  const int tile_bytes = p.CG * p.IR * p.IWS;  // a multiple of 16
  const float rcp = __frcp_rn(a_s);
  int* wts = reinterpret_cast<int*>(dw_smem + tile_bytes);

  for (int e = 16 * tid; e < tile_bytes; e += 16 * kThreads)
    *reinterpret_cast<uint4*>(tile + e) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // the weights and the band's rows, their loads in flight together: x 4
  // elements a load where W is a multiple of 4, else 1; kDwUnroll loads in
  // flight a thread
  if constexpr (K > 0) {  // a kernel row i as [taps 0-3 packed, tap 4], [CG][K][2]
    for (int e = tid; e < p.CG * K; e += kThreads) {
      const int ch = e / K, c = c0 + ch;
      const int8_t* wr = w + (static_cast<int64_t>(c) * K + e - ch * K) * K;
      int tap[5] = {0, 0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < K; ++j) tap[j] = c < g.C ? static_cast<int>(__ldg(wr + j)) : 0;
      wts[2 * e] = static_cast<int>(pack4(tap[0], tap[1], tap[2], tap[3]));
      wts[2 * e + 1] = tap[4];
    }
  } else {
    for (int e = tid; e < p.CG * taps; e += kThreads) {
      const int ch = e / taps, c = c0 + ch;
      wts[e] = c < g.C ? static_cast<int>(__ldg(w + static_cast<int64_t>(c) * taps + e - ch * taps))
                       : 0;
    }
  }
  const int lpr = vec_in ? g.W / 4 : g.W;  // loads a row
  const int n_loads = p.CG * p.IR * lpr;
  for (int e0 = tid; e0 < n_loads; e0 += kThreads * kDwUnroll) {
    float v[kDwUnroll][4];
    int8_t* dst[kDwUnroll];
#pragma unroll
    for (int u = 0; u < kDwUnroll; ++u) {
      dst[u] = nullptr;
      const int e = e0 + u * kThreads;
      if (e >= n_loads) continue;
      const int rr = e / lpr, q = e - rr * lpr;
      const int ch = rr / p.IR, r = rr - ch * p.IR;
      const int c = c0 + ch, ih = ih_start + r;
      if (c >= g.C || ih < 0 || ih >= g.H) continue;
      const T* src = x + ((static_cast<int64_t>(b) * g.C + c) * g.H + ih) * g.W;
      if (vec_in) {
        load4(src + 4 * q, v[u]);
        dst[u] = tile + rr * p.IWS + p.ML + 4 * q;
      } else {
        v[u][0] = load1(src + q);
        dst[u] = tile + rr * p.IWS + p.ML + q;
      }
    }
#pragma unroll
    for (int u = 0; u < kDwUnroll; ++u) {
      if (dst[u] == nullptr) continue;
      if (vec_in) {
        *reinterpret_cast<uint32_t*>(dst[u]) =
            pack4(quantize(v[u][0], a_s, rcp), quantize(v[u][1], a_s, rcp),
                  quantize(v[u][2], a_s, rcp), quantize(v[u][3], a_s, rcp));
      } else {
        *dst[u] = static_cast<int8_t>(quantize(v[u][0], a_s, rcp));
      }
    }
  }
  __syncthreads();

  // 4 outputs along W a thread (quad q of a row), the rows of the block in
  // strides of rpp: a thread keeps one q, so no division an item
  const int rows = p.CG * p.RB;
  const int rpp = p.QPR >= kThreads ? 1 : kThreads / p.QPR;  // rows a pass
  // K > 0: a row's window as words, shifted once by the tile's misalignment
  // (the window of quad q starts at byte ML - pl + 4 q S of its row), then
  // taps 0-3 of each output by __dp4a on the packed kernel row
  constexpr int NA = K > 0 ? (3 * S + K + 3) / 4 : 1;  // aligned window words
  const int mis = (p.ML - g.pl) & 3;
  int wk[K > 0 ? K : 1][2];  // the packed kernel rows of channel wch
  int wch = -1;
  for (int e = tid; e < rpp * p.QPR; e += kThreads) {
    const int q = e % p.QPR, ow0 = 4 * q;
    int row = e / p.QPR;
    int ch = row / p.RB, r = row - ch * p.RB;
    for (; row < rows; row += rpp) {
      const int c = c0 + ch, oh = oh0 + r;
      if (c < g.C && oh < g.OH) {
        int acc[4] = {0, 0, 0, 0};
        const int off = (ch * p.IR + r * sh) * p.IWS + p.ML - g.pl + ow0 * sw;
        if constexpr (K > 0) {
          if (ch != wch) {
#pragma unroll
            for (int i = 0; i < K; ++i) {
              wk[i][0] = wts[2 * (ch * K + i)];
              wk[i][1] = wts[2 * (ch * K + i) + 1];
            }
            wch = ch;
          }
          const uint32_t* src = reinterpret_cast<const uint32_t*>(tile + (off & ~3));
#pragma unroll
          for (int i = 0; i < K; ++i) {
            uint32_t raw[NA + 1], win[NA];
#pragma unroll
            for (int e2 = 0; e2 <= NA; ++e2) raw[e2] = src[i * (p.IWS / 4) + e2];
#pragma unroll
            for (int e2 = 0; e2 < NA; ++e2)
              win[e2] = __funnelshift_r(raw[e2], raw[e2 + 1], 8 * mis);
#pragma unroll
            for (int o = 0; o < 4; ++o) {
              const int b0 = o * S;  // output o's taps start at byte b0 of win
              const uint32_t taps03 =
                  (b0 & 3) == 0 ? win[b0 >> 2]
                                : __funnelshift_r(win[b0 >> 2], win[(b0 >> 2) + 1], 8 * (b0 & 3));
              acc[o] = __dp4a(static_cast<int>(taps03), wk[i][0], acc[o]);
              if constexpr (K == 5) {
                const int b4 = b0 + 4;
                acc[o] += static_cast<int>(static_cast<int8_t>(win[b4 >> 2] >> (8 * (b4 & 3)))) *
                          wk[i][1];
              }
            }
          }
        } else {
          const int8_t* src = tile + off;
          const int* wc = wts + ch * taps;
          for (int i = 0; i < kh; ++i)
            for (int j = 0; j < kw; ++j) {
              const int wv = wc[i * kw + j];
#pragma unroll
              for (int o = 0; o < 4; ++o) acc[o] += src[i * p.IWS + o * sw + j] * wv;
            }
        }
        const float sc = kind == kSums ? 0.0f : __ldg(scale + c);
        const int64_t idx = ((static_cast<int64_t>(b) * g.C + c) * g.OH + oh) * g.OW + ow0;
        if (vec_out) {  // OW a multiple of 4
          store4(out, kind, idx, acc, sc, bias, c);
        } else {
#pragma unroll
          for (int o = 0; o < 4; ++o)
            if (ow0 + o < g.OW) store1(out, kind, idx + o, acc[o], sc, bias, c);
        }
      }
      r += rpp;
      while (r >= p.RB) {
        r -= p.RB;
        ++ch;
      }
    }
  }
}

// ----------------------------------------------------------------- host

inline bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// Dynamic shared memory above 48 KB needs the kernel's attribute: set where
// `device_set`, the caller's record for this kernel, is another device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& device_set) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == device_set || bytes <= 48 * 1024) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) device_set = device;
  return err;
}

struct DensePlan {
  int nt;       // BN / 32
  int n_tiles;  // blocks along Co
};

// BN: Co in as few tiles of at most 256 channels as it takes (each tile
// quantises its pixels' x again), split further while the grid would leave
// SMs idle; the gather path rounds BN up to a power of two
DensePlan dense_plan(int64_t m_tiles, int Co, bool vec) {
  auto bn_for = [&](int n_tiles) {
    int bn = ((Co + n_tiles - 1) / n_tiles + 31) / 32 * 32;
    if (!vec) {
      int p2 = 32;
      while (p2 < bn) p2 *= 2;
      bn = p2;
    }
    return bn;
  };
  int n_tiles = (Co + 32 * kMaxNT - 1) / (32 * kMaxNT);
  int bn = bn_for(n_tiles);
  while (m_tiles * n_tiles < kSMs && bn > 32) {
    ++n_tiles;
    bn = bn_for(n_tiles);
  }
  return {bn / 32, (Co + bn - 1) / bn};
}

template <typename T, int NT, bool VEC>
cudaError_t launch_dense_nt(const T* x, float a_s, const int8_t* wp, int w_rows,
                            const float* scale, const float* bias, const Geometry& g,
                            int64_t m_tiles, int n_tiles, void* out, int kind, cudaStream_t s) {
  const int64_t blocks = m_tiles * n_tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int steps = (g.kh * g.kw * ((g.C + 3) / 4 * 4) + kBK - 1) / kBK;
  const int smem = DenseSmem<T, NT>::bytes(VEC, steps < kStages ? steps : kStages);
  auto kernel = conv_dense_sm90_kernel<T, NT, VEC>;
  static int device_set = -1;  // this instantiation's
  const cudaError_t err = allow_smem(kernel, DenseSmem<T, NT>::bytes(VEC, kStages), device_set);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(x, a_s, wp, w_rows, scale, bias,
                                                               g, n_tiles, out, kind);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dense(const T* x, float a_s, const int8_t* wp, int w_rows,
                         const float* scale, const float* bias, const Geometry& g, void* out,
                         int kind, cudaStream_t s) {
  if (misaligned(wp)) return cudaErrorMisalignedAddress;  // cp.async takes 16 bytes
  const bool vec = g.kh == 1 && g.kw == 1 && g.sh == 1 && g.sw == 1 && g.pt == 0 &&
                   g.pl == 0 && g.OH == g.H && g.OW == g.W && (g.H * g.W) % 4 == 0 &&
                   aligned(x, 4 * sizeof(T));
  const int64_t M = static_cast<int64_t>(g.B) * g.OH * g.OW;
  const int64_t m_tiles = (M + kBM - 1) / kBM;
  const DensePlan p = dense_plan(m_tiles, g.Co, vec);
#define MLAD_DENSE(NT, VEC)                                                                    \
  return launch_dense_nt<T, NT, VEC>(x, a_s, wp, w_rows, scale, bias, g, m_tiles, p.n_tiles, \
                                     out, kind, s)
  if (vec) {
    switch (p.nt) {
      case 1: MLAD_DENSE(1, true);
      case 2: MLAD_DENSE(2, true);
      case 3: MLAD_DENSE(3, true);
      case 4: MLAD_DENSE(4, true);
      case 5: MLAD_DENSE(5, true);
      case 6: MLAD_DENSE(6, true);
      case 7: MLAD_DENSE(7, true);
      default: MLAD_DENSE(8, true);
    }
  }
  switch (p.nt) {
    case 1: MLAD_DENSE(1, false);
    case 2: MLAD_DENSE(2, false);
    case 4: MLAD_DENSE(4, false);
    default: MLAD_DENSE(8, false);
  }
#undef MLAD_DENSE
}

int dw_smem_bytes(const DwPlan& p, int taps) { return p.CG * p.IR * p.IWS + 4 * p.CG * taps; }

DwPlan dw_plan(const Geometry& g) {
  DwPlan p;
  p.QPR = (g.OW + 3) / 4;
  p.RB = kDwQuads / p.QPR;
  p.RB = p.RB < 1 ? 1 : p.RB > g.OH ? g.OH : p.RB;
  p.RB = (g.OH + (g.OH + p.RB - 1) / p.RB - 1) / ((g.OH + p.RB - 1) / p.RB);  // bands alike
  p.CG = 1;
  if (p.RB == g.OH) {
    p.CG = kDwQuads / (g.OH * p.QPR);
    p.CG = p.CG < 1 ? 1 : p.CG > g.C ? g.C : p.CG;
  }
  p.ML = (g.pl + 3) / 4 * 4;
  // the windows' bytes, and 8 more for their word-wide reads
  const int need = p.ML - g.pl + (4 * p.QPR - 1) * g.sw + g.kw + 8;
  p.IWS = round16(need > p.ML + g.W ? need : p.ML + g.W);
  for (;;) {  // shrink the block until its tile fits
    p.IR = (p.RB - 1) * g.sh + g.kh;
    if (dw_smem_bytes(p, g.kh * g.kw) <= kDwSmem) break;
    if (p.CG > 1) {
      p.CG = (p.CG + 1) / 2;
    } else if (p.RB > 1) {
      p.RB = (p.RB + 1) / 2;
    } else {
      break;
    }
  }
  p.n_cg = (g.C + p.CG - 1) / p.CG;
  p.n_band = (g.OH + p.RB - 1) / p.RB;
  return p;
}

template <typename T, int K, int S>
cudaError_t launch_dw_ks(const T* x, float a_s, const int8_t* w, const float* scale,
                         const float* bias, const Geometry& g, const DwPlan& p, void* out,
                         int kind, int vec_in, int vec_out, cudaStream_t s) {
  const int64_t blocks = static_cast<int64_t>(g.B) * p.n_cg * p.n_band;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int smem = dw_smem_bytes(p, g.kh * g.kw);
  conv_dw_sm90_kernel<T, K, S><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      x, a_s, w, scale, bias, g, p, out, kind, vec_in, vec_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const T* x, float a_s, const int8_t* w, const float* scale,
                      const float* bias, const Geometry& g, void* out, int kind,
                      cudaStream_t s) {
  const DwPlan p = dw_plan(g);
  if (dw_smem_bytes(p, g.kh * g.kw) > kDwSmem) return cudaErrorInvalidValue;
  const int vec_in = g.W % 4 == 0 && aligned(x, 4 * sizeof(T));
  const int vec_out = g.OW % 4 == 0 && aligned(out, 16);
  const bool square = g.kh == g.kw && g.sh == g.sw;
  if (square && g.kh == 3 && g.sh == 1)
    return launch_dw_ks<T, 3, 1>(x, a_s, w, scale, bias, g, p, out, kind, vec_in, vec_out, s);
  if (square && g.kh == 3 && g.sh == 2)
    return launch_dw_ks<T, 3, 2>(x, a_s, w, scale, bias, g, p, out, kind, vec_in, vec_out, s);
  if (square && g.kh == 5 && g.sh == 1)
    return launch_dw_ks<T, 5, 1>(x, a_s, w, scale, bias, g, p, out, kind, vec_in, vec_out, s);
  if (square && g.kh == 5 && g.sh == 2)
    return launch_dw_ks<T, 5, 2>(x, a_s, w, scale, bias, g, p, out, kind, vec_in, vec_out, s);
  return launch_dw_ks<T, 0, 0>(x, a_s, w, scale, bias, g, p, out, kind, vec_in, vec_out, s);
}

template <typename T>
cudaError_t run(const T* x, float a_s, const int8_t* w, int w_rows, const float* scale,
                const float* bias, const Geometry& g, int depthwise, void* out, int kind,
                cudaStream_t s) {
  if (depthwise) return launch_dw(x, a_s, w, scale, bias, g, out, kind, s);
  return launch_dense(x, a_s, w, w_rows, scale, bias, g, out, kind, s);
}

}  // namespace

// x: float32 (x_bf16 = 0) or bf16 (1), NCHW; w: dense, the packed weights
// [w_rows >= Co][Kp] (`pack_int8_weights`: Kp = kh*kw*Cp padded to 64, Cp = C
// padded to 4), 16-byte aligned;
// depthwise, [C, 1, kh, kw] int8 (w_rows unused); out: [B, Co, OH, OW] of
// `kind` (0 float32, 1 bf16, 2 the int32 sums, no dequantisation); bias may
// be null. One launch on `stream`; returns its cudaError_t.
extern "C" int mlad_conv_int8_sm90(const void* x, int x_bf16, float a_s, const int8_t* w,
                                   int w_rows, const float* scale, const float* bias, int B,
                                   int C, int H, int W, int Co, int kh, int kw, int sh, int sw,
                                   int pt, int pl, int OH, int OW, int depthwise, void* out,
                                   int kind, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || Co < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      OH < 1 || OW < 1 || pt < 0 || pl < 0 || kind < 0 || kind > 2 ||
      (depthwise && Co != C) || (!depthwise && w_rows < Co))
    return cudaErrorInvalidValue;
  const Geometry g{B, C, H, W, Co, kh, kw, sh, sw, pt, pl, OH, OW};
  const auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return run(static_cast<const bf16*>(x), a_s, w, w_rows, scale, bias, g, depthwise, out,
               kind, s);
  }
  return run(static_cast<const float*>(x), a_s, w, w_rows, scale, bias, g, depthwise, out, kind,
             s);
}
