// Fused frozen (eval-mode) MBConv block: forward and input gradient.
//
// Replaces the Pallas TPU kernels of tools/experiments/fused_mbconv.py:
// `_fwd_kernel` (:212, called through `_mbconv_fwd_pallas`) and the dx
// `_bwd_kernel` (:282, through `_mbconv_bwd_pallas`). It computes what
// `mbconv_plain` and `mbconv_dx_plain` of
// mladversarialobjectdetection_torch/ops/mbconv.py compute, in float32 (or
// bf16, note 9), with the three BatchNorms folded into the convs
// (`fold_block`):
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
// What bounds the kernels. Per output pixel the forward does 2 (C E + E Co)
// operations in the 1x1 products and 2 k^2 E in the depthwise; dx twice the
// products and twice the depthwise. On an H100 the products are the bulk
// (86-97% at lite4's shapes), so the float32 pipe (67 TFLOP/s) bounds a
// kernel that runs them as FMAs; the bytes (x, g and the output once) are a
// few percent of that. The first version (one 8x8 tile per 256-thread block,
// E in chunks of 32, x re-staged by scalar loads for every chunk, the
// project summed in shared memory, z0 summed with separate multiplies and
// adds) ran at 1.8-10% of that bound. This design:
//
//   1. The 1x1 products (the expand x . We, the project d . Wp, and dx's
//      g . Wp^T and ge . We^T) run on the tensor cores as 3xTF32:
//      a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and
//      lo.hi + hi.lo + hi.hi summed in fp32 accumulators by three
//      `mma.sync.m16n8k8` (`warp_gemm`), which keeps float32 accuracy (the
//      dropped lo.lo term is 2^-22 of a product). Never 1xTF32, whatever
//      torch.backends says. The TF32 pipe's 495 TFLOP/s / 3 then bounds them.
//   2. The project's sum (and dx's ge . We^T) stays in the MMA accumulator
//      registers across the whole E loop; a block covers a slice of the
//      output channels (`n_per_slice`) so that the sum fits its registers.
//   3. Operands are staged by `cp.async` into a double-buffered ring: the
//      haloed x (or g) tile in chunks of KC (16 or 32) channels, and the We
//      / Wp chunk; E is walked in chunks of EC (32 or 64 in the forward, 32
//      in dx). Each block tabulates its staged rows' offsets once. Pixels
//      outside the image and channels past the end are zero-filled through
//      the copy's src-size operand. 16-byte copies where C, E and Co are
//      multiples of 4 (`V16`), 4-byte copies otherwise.
//   4. Only the haloed pixels inside the image are expanded: the rows of the
//      expand's MMA are the image-clipped halo region, packed.
//   5. The host picks a tile plan per shape (ops/mbconv_cuda.py `plan_fwd`,
//      `plan_dx`): the output tile (8x8, 16x8, 16x16), the width of the
//      accumulator (`NPW` n-tiles per warp) with its EC and KC (a template
//      instance, `MLAD_MBCONV_FWD_CONFIGS` / `_DX_CONFIGS`), a split of
//      E across `split` blocks and a slice of the output channels. With a
//      split, each block writes its partial sum into a workspace and
//      `mbconv_reduce_kernel` adds the partials in split order (plus bias and
//      residual): deterministic, no atomics; the wrapper counts the pair as
//      one launch.
//   6. The depthwise and its transpose stay on the CUDA cores as FMAs, one
//      E channel per lane, taps in a fixed order (bd, then row by row).
//   7. z0 and z1 at a pixel do not depend on the tile that computes them:
//      the expand's k order is C ascending in steps of 8 for every row, and
//      the taps are in one order. So the relu6 / relu masks of a centre pixel
//      are the ones its neighbours used in their halo. With the tensor cores
//      z0 is no longer bit-equal to the plain version's ordered sum: where it
//      lies within rounding of a kink the mask can flip. The `MASKS`
//      instance writes act'(z0) and act'(z1) of its centre pixels as bytes,
//      so that dx can be held to the plain dx fed the same masks
//      (`mbconv_dx_plain(masks=...)`).
//   8. `TC = false` is the ablation: the same kernel with the 1x1 products
//      as register-tiled SIMT FMAs over the same accumulator layout. It is not
//      on the main path; chip_smoke.py times it beside the main kernel.
//   9. The element type T is float or bf16 (the Pallas kernels' bf16
//      instance, which bf16 mixed precision runs: fused_mbconv.py:212-242,
//      :282-339 with bf16 inputs). At bf16, x, We, Wp and the output (dx: x,
//      g, We, Wp and dx) are bf16 in device memory, the biases and wd stay
//      float32. Each 1x1 product is one `mma.sync.m16n8k16` bf16 product with
//      float32 accumulators (`warp_gemm_bf16`): a product of two bf16 values
//      is exact in float32, so the 3xTF32 split has nothing to recover, and
//      k runs in steps of 16, zero-padded by the staging. e and d are stored
//      in shared memory as bf16, rounded to nearest even where the Pallas
//      kernel rounds them (after the activation); the depthwise and its
//      transpose are float32 FMAs with float32 wd, and the residual is added
//      in float32 before the output's one rounding. In dx, gd is rounded as
//      it is stored and ge as the last product reads it (both live in float
//      buffers, which hold act'(z1) and act'(z0) first); the relu masks come
//      from the float32 z0 and z1, as in float32. A split of E keeps float32
//      partials and rounds after `mbconv_reduce_kernel`'s fixed-order sum.
//      16-byte copies hold 8 bf16, so `V16` needs C, E and Co multiples of 8;
//      other shapes stage by plain loads (cp.async moves no 2 bytes).
//
// What bounds them now (chip_smoke.py phase 6a, H100 SXM at 700 W, lite4 at
// 640, batch 24): 5-7% of the 3xTF32 bound and 9-16% of the fp32 one, and
// the ablation within 6% of the tensor-core kernels, so neither pipe does:
// the per-stage work does (issuing the copies, two barriers per stage, 8 warps
// per SM). Larger stages (EC 64, KC 32) and the offset tables cut it most.
//
// The dx kernel recomputes e on the tile with a halo of 2h and z1, g . Wp^T
// and gd with a halo of h (fused_mbconv.py:282-339), saving nothing but x in
// the forward. The main path runs the float32 instances everywhere; in bf16
// it runs the Hopper kernels, mbconv_fwd_sm90.cu and mbconv_dx_sm90.cu, at
// every shape their rules take (C, E and Co multiples of 8 whose plan fits:
// all of lite4's), and this template's bf16 instances only elsewhere
// (ops/mbconv_cuda.py picks by shape); chip_smoke.py times the instances
// beside the Hopper kernels. This file builds the forward's entry, `mlad_mbconv_fwd`;
// with MLAD_MBCONV_PART defined, mbconv_dx.cu (1, `mlad_mbconv_dx`) and
// mbconv_simt_fwd.cu / mbconv_simt_dx.cu (2 / 3, the ablation) and
// mbconv_bf16.cu / mbconv_bf16_dx.cu (4 / 5, `mlad_mbconv_fwd_bf16`,
// `mlad_mbconv_dx_bf16`) include it and build the other entries, so that the
// six compile in parallel.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEC = 32;            // dx: expanded channels per chunk
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block can use
using bf16 = __nv_bfloat16;
// Row strides in shared memory (elements of T, float or bf16) that keep the
// MMA fragment reads free of bank conflicts: a staged [pixels][KC] tile, a
// staged We chunk [KC][EC], e / d / gd / ge [pixels][EC]. Each pads a row by
// 16 bytes (ld_w by 32 in float32, 16 in bf16), so rows stay 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int ld_x(int kc) { return kc + 16 / static_cast<int>(sizeof(T)); }
__host__ __device__ constexpr int ld_w(int ec) { return ec + 8; }
template <typename T>
__host__ __device__ constexpr int ld_e(int ec) { return ec + 16 / static_cast<int>(sizeof(T)); }

template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

// float <-> T, the bf16 rounding to nearest even (cvt.rn.bf16.f32)
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (kBf16<T>) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}
// v rounded to T, kept as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

enum Act { kRelu6 = 0, kRelu = 1, kSwish = 2 };

__device__ __forceinline__ float act_fn(int act, float z) {
  if (act == kRelu6) return fminf(fmaxf(z, 0.0f), 6.0f);
  if (act == kRelu) return fmaxf(z, 0.0f);
  return z * (1.0f / (1.0f + expf(-z)));
}

__device__ __forceinline__ float dact_fn(int act, float z) {
  if (act == kRelu6) return (z > 0.0f && z < 6.0f) ? 1.0f : 0.0f;
  if (act == kRelu) return z > 0.0f ? 1.0f : 0.0f;
  const float s = 1.0f / (1.0f + expf(-z));
  return s * (1.0f + z * (1.0f - s));
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
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

// dst[r * ld_dst + j] = src[row_off(r) + col0 + j] for r < rows, j < n_cols,
// zero-filled where row_off(r) is -1 or col0 + j >= col_end. V16 moves 16
// bytes per copy (4 floats or 8 bf16: n_cols, col0, col_end and the row
// offsets multiples of that), else one element: a 4-byte cp.async for a
// float, a plain load and store for a bf16 (cp.async moves no 2 bytes).
// NCOLS > 0 fixes n_cols at compile time, which keeps the index arithmetic
// to shifts. The copies join the thread's current cp.async group.
template <bool V16, int NCOLS, typename T, typename RowOff>
__device__ __forceinline__ void stage_rows(T* dst, int ld_dst, int rows, int n_cols,
                                           const T* __restrict__ src, int col0,
                                           int col_end, RowOff row_off) {
  constexpr int kVec = V16 ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int per_row = (NCOLS > 0 ? NCOLS : n_cols) / kVec;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / per_row, j = (i - r * per_row) * kVec;
    const int64_t off = row_off(r);
    const bool ok = off >= 0 && col0 + j < col_end;
    const T* s = ok ? src + off + col0 + j : src;
    if constexpr (V16) {
      cp_async16(dst + r * ld_dst + j, s, ok);
    } else if constexpr (kBf16<T>) {
      dst[r * ld_dst + j] = ok ? *s : from_f<T>(0.0f);
    } else {
      cp_async4(dst + r * ld_dst + j, s, ok);
    }
  }
}

// ------------------------------------------------------------ 1x1 products

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

// One warp's share of C[M x N] += A[M x kdim] . B[kdim x N] out of shared
// memory: m-tiles m_tile[i] (16 rows; < 0 skips), each with the n-tiles
// n0[i] + n_step * j (8 columns; >= n_tiles skips). A(r, k) = a[r * lda + k]; B(k, n) =
// b[k * ldb + n], or b[n * ldb + k] with BT. Accumulators in the m16n8
// layout: acc[i][j][0..3] hold rows gid, gid, gid + 8, gid + 8 and columns
// 2 tig, 2 tig + 1 (gid = lane / 4, tig = lane % 4). TC: 3xTF32 on the
// tensor cores, k in steps of 8 ascending; else the same sums as FMAs.
template <bool TC, bool BT, int MPW, int NPW>
__device__ __forceinline__ void warp_gemm(float (&acc)[MPW][NPW][4], const int (&m_tile)[MPW],
                                          const int (&n0)[MPW], const float* a, int lda,
                                          const float* b, int ldb, int kdim, int n_step,
                                          int n_tiles) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  for (int k0 = 0; k0 < kdim; k0 += 8) {
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (m_tile[i] < 0) continue;
      const float* ar = a + (m_tile[i] * 16 + gid) * lda + k0;
      if constexpr (TC) {
        uint32_t ahi[4], alo[4];
        split_tf32(ar[tig], ahi[0], alo[0]);
        split_tf32(ar[8 * lda + tig], ahi[1], alo[1]);
        split_tf32(ar[tig + 4], ahi[2], alo[2]);
        split_tf32(ar[8 * lda + tig + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          const int n = n0[i] + n_step * j;
          if (n >= n_tiles) break;
          const int col = n * 8 + gid;
          const float b0 = BT ? b[col * ldb + k0 + tig] : b[(k0 + tig) * ldb + col];
          const float b1 = BT ? b[col * ldb + k0 + tig + 4] : b[(k0 + tig + 4) * ldb + col];
          uint32_t bhi0, blo0, bhi1, blo1;
          split_tf32(b0, bhi0, blo0);
          split_tf32(b1, bhi1, blo1);
          mma_tf32(acc[i][j], alo, bhi0, bhi1);
          mma_tf32(acc[i][j], ahi, blo0, blo1);
          mma_tf32(acc[i][j], ahi, bhi0, bhi1);
        }
      } else {
        float a0[8], a1[8];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          a0[kk] = ar[kk];
          a1[kk] = ar[8 * lda + kk];
        }
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          const int n = n0[i] + n_step * j;
          if (n >= n_tiles) break;
          const int col = n * 8 + 2 * tig;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const float b0 = BT ? b[col * ldb + k0 + kk] : b[(k0 + kk) * ldb + col];
            const float b1 = BT ? b[(col + 1) * ldb + k0 + kk] : b[(k0 + kk) * ldb + col + 1];
            acc[i][j][0] = fmaf(a0[kk], b0, acc[i][j][0]);
            acc[i][j][1] = fmaf(a0[kk], b1, acc[i][j][1]);
            acc[i][j][2] = fmaf(a1[kk], b0, acc[i][j][2]);
            acc[i][j][3] = fmaf(a1[kk], b1, acc[i][j][3]);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive elements (k, k + 1) as one bf16x2 register, the lower k in
// the low half: a 32-bit load of two bf16, or two floats rounded to nearest
// even (exact where they already hold bf16 values)
__device__ __forceinline__ uint32_t bf16_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t bf16_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t bf16_pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// warp_gemm's bf16 instance: one m16n8k16 bf16 product per (m-tile,
// n-tile, 16 k), summed in the float32 accumulators. A product of two bf16
// values is exact in float32, so there is nothing for a split to recover.
// A (bf16, or float rounded to bf16 as it is read) is row-major; B is bf16
// and, as in warp_gemm, B(k, n) = b[k * ldb + n] or b[n * ldb + k] with BT.
// kdim is a multiple of 16, zero-padded by the staging.
template <bool BT, int MPW, int NPW, typename TA>
__device__ __forceinline__ void warp_gemm_bf16(float (&acc)[MPW][NPW][4],
                                               const int (&m_tile)[MPW],
                                               const int (&n0)[MPW], const TA* a, int lda,
                                               const bf16* b, int ldb, int kdim, int n_step,
                                               int n_tiles) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  for (int k0 = 0; k0 < kdim; k0 += 16) {
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (m_tile[i] < 0) continue;
      const TA* ar = a + (m_tile[i] * 16 + gid) * lda + k0 + 2 * tig;
      const uint32_t af[4] = {bf16_pair(ar), bf16_pair(ar + 8 * lda), bf16_pair(ar + 8),
                              bf16_pair(ar + 8 * lda + 8)};
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int n = n0[i] + n_step * j;
        if (n >= n_tiles) break;
        const int col = n * 8 + gid;
        uint32_t b0, b1;
        if constexpr (BT) {
          const bf16* br = b + col * ldb + k0 + 2 * tig;
          b0 = bf16_pair(br);
          b1 = bf16_pair(br + 8);
        } else {
          const bf16* br = b + (k0 + 2 * tig) * ldb + col;
          b0 = bf16_pack(br[0], br[ldb]);
          b1 = bf16_pack(br[8 * ldb], br[9 * ldb]);
        }
        mma_bf16(acc[i][j], af, b0, b1);
      }
    }
  }
}

// C += A . B in the instance of the element type: bf16 products for bf16
// (A may be a float buffer whose values are rounded as they are read),
// warp_gemm for float
template <typename T, bool TC, bool BT, int MPW, int NPW, typename TA>
__device__ __forceinline__ void gemm(float (&acc)[MPW][NPW][4], const int (&m_tile)[MPW],
                                     const int (&n0)[MPW], const TA* a, int lda, const T* b,
                                     int ldb, int kdim, int n_step, int n_tiles) {
  if constexpr (kBf16<T>) {
    warp_gemm_bf16<BT>(acc, m_tile, n0, a, lda, b, ldb, kdim, n_step, n_tiles);
  } else {
    warp_gemm<TC, BT>(acc, m_tile, n0, a, lda, b, ldb, kdim, n_step, n_tiles);
  }
}

template <int MPW, int NPW>
__device__ __forceinline__ void zero_acc(float (&acc)[MPW][NPW][4]) {
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
}

// The image-clipped region of a tile's halo: rows [y0, y0 + ny), columns
// [x0, x0 + nx); packed row r is pixel (y0 + r / nx, x0 + r % nx).
struct Region {
  int y0, x0, ny, nx;
  __device__ Region(int ty0, int tx0, int th, int tw, int halo, int H, int W) {
    y0 = max(ty0 - halo, 0);
    x0 = max(tx0 - halo, 0);
    ny = min(ty0 + th + halo, H) - y0;
    nx = min(tx0 + tw + halo, W) - x0;
  }
  __device__ int count() const { return ny * nx; }
};

// Tile shapes of a block: output tile TH x TW, with the 1x1 product sums of
// the output (the project in the forward, ge . We^T in dx) as MPW_P m-tiles
// by NPW n-tiles of 8 channels per warp.
template <int TH, int TW>
struct Tile {
  static constexpr int TP = TH * TW;                       // output pixels
  static constexpr int MT = TP / 16;                       // their m-tiles
  static constexpr int WPM = MT >= kWarps ? 1 : kWarps / MT;  // warps per m-tile
  static constexpr int MPW = MT >= kWarps ? MT / kWarps : 1;  // m-tiles per warp
  // this warp's output m-tiles (-1 for one whose pixels all lie below the
  // image) and the first of its n-tiles
  __device__ static void m_tiles(int (&m)[MPW], int (&n0)[MPW], int ty0, int H) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      const int t = (warp / WPM) * MPW + i;
      m[i] = ty0 + t * 16 / TW < H ? t : -1;
      n0[i] = warp % WPM;
    }
  }
};

// The units of a product over a packed region of `rows` pixels by NG groups
// of 4 n-tiles (32 columns): unit u = warp + 8 i is m-tile u / NG and the
// n-tiles from 4 (u % NG); the units spread the m-tiles evenly over the warps.
template <int UPW, int NG>
__device__ __forceinline__ void region_units(int (&m)[UPW], int (&n0)[UPW], int rows) {
  const int warp = threadIdx.x >> 5, units = (rows + 15) / 16 * NG;
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = warp + kWarps * i;
    m[i] = u < units ? u / NG : -1;
    n0[i] = u % NG * 4;
  }
}

// kdim of a staged chunk of KC channels whose channels start at c0 of n: the
// channels left, rounded up to the product's k step (8 in float32, 16 in
// bf16; the staging zero-fills the rest of the chunk)
template <typename T, int KC>
__device__ __forceinline__ int chunk_k(int c0, int n) {
  constexpr int kStep = kBf16<T> ? 16 : 8;
  return min(KC, (n - c0 + kStep - 1) & ~(kStep - 1));
}

// Shared memory (bytes) of the forward's block: the packed rows' x offsets
// (ints), then in T the x ring, the We ring, e, d and the Wp chunk, whose row
// stride keeps the B fragments conflict-free (a multiple of 32 plus 8); n_cols
// is the widest output slice. Every part is a multiple of 16 bytes.
template <typename T>
__host__ __device__ size_t fwd_smem_bytes(int k, int th, int tw, int ec, int kc, int n_cols) {
  const int h = k / 2, fnh = (th + 2 * h) * (tw + 2 * h), nhp = (fnh + 15) / 16 * 16;
  const int ldp = ((n_cols + 7) / 8 * 8 + 31) / 32 * 32 + 8;
  const size_t elems = static_cast<size_t>(2 * nhp * ld_x<T>(kc) + 2 * kc * ld_w(ec) +
                                           fnh * ld_e<T>(ec) + th * tw * ld_e<T>(ec) + ec * ldp);
  return sizeof(int) * static_cast<size_t>(nhp) + sizeof(T) * elems;
}

// dx: the packed rows' x and g offsets (ints), the staging region in T (the
// x ring and We ring of the expand, then the g ring and Wp ring of g . Wp^T,
// then the We^T chunk), e in T, and in float act'(z1) / gd, act'(z0) / ge
template <typename T>
__host__ __device__ size_t dx_region_elems(int k, int th, int tw, int kc, int n_cols) {
  const int h = k / 2;
  const int n2 = (th + 4 * h) * (tw + 4 * h), n2p = (n2 + 15) / 16 * 16;
  const int n1 = (th + 2 * h) * (tw + 2 * h), n1p = (n1 + 15) / 16 * 16;
  const int a = 2 * n2p * ld_x<T>(kc) + 2 * kc * ld_w(kEC);
  const int b = 2 * n1p * ld_x<T>(kc) + 2 * kEC * ld_x<T>(kc);
  const int c = (n_cols + 7) / 8 * 8 * ld_e<T>(kEC);
  return static_cast<size_t>(a > b ? (a > c ? a : c) : (b > c ? b : c));
}

template <typename T>
__host__ __device__ size_t dx_smem_bytes(int k, int th, int tw, int kc, int n_cols) {
  const int h = k / 2;
  const int n2 = (th + 4 * h) * (tw + 4 * h), n1 = (th + 2 * h) * (tw + 2 * h);
  const int n2p = (n2 + 15) / 16 * 16, n1p = (n1 + 15) / 16 * 16;
  return sizeof(int) * static_cast<size_t>(n2p + n1p) +
         sizeof(T) * (dx_region_elems<T>(k, th, tw, kc, n_cols) +
                      static_cast<size_t>(n2 * ld_e<T>(kEC))) +
         sizeof(float) * static_cast<size_t>((n1 + th * tw) * ld_e<float>(kEC));
}

// The forward: E in chunks of EC (32 or 64), x and We staged KC (16 or 32)
// channels at a time. T is the element type of x, We, Wp, e, d and the
// output (float, or bf16 with float32 sums); the biases and wd are float.
template <typename T, int K, int TH, int TW, int NPW, int EC, int KC, bool V16, bool TC>
__global__ void __launch_bounds__(kThreads, 1)
mbconv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ we,
                  const float* __restrict__ be, const float* __restrict__ wd,
                  const float* __restrict__ bd, const T* __restrict__ wp,
                  const float* __restrict__ bp, int H, int W, int C, int E, int Co,
                  int act, int residual, int e_per_split, int n_per_slice,
                  int n_slices, T* __restrict__ out, float* __restrict__ ws) {
  constexpr int h = K / 2;
  constexpr int LX = ld_x<T>(KC), LW = ld_w(EC), LE = ld_e<T>(EC);
  constexpr int FW = TW + 2 * h, FNH = (TH + 2 * h) * FW;  // haloed tile
  constexpr int MT_E = (FNH + 15) / 16, NHP = MT_E * 16;
  constexpr int NG = EC / 32;                              // n-groups of the expand
  constexpr int UPW = (MT_E * NG + kWarps - 1) / kWarps;   // its units per warp
  using Tl = Tile<TH, TW>;
  extern __shared__ float4 smem4[];
  int* s_xoff = reinterpret_cast<int*>(smem4);   // [NHP] x offset of a packed row
  T* s_x = reinterpret_cast<T*>(s_xoff + NHP);   // 2 x [NHP][LX]
  T* s_w = s_x + 2 * NHP * LX;                   // 2 x [KC][LW]
  T* s_e = s_w + 2 * KC * LW;                    // [FNH][LE]
  T* s_d = s_e + FNH * LE;                       // [TP][LE]
  T* s_wp = s_d + Tl::TP * LE;                   // [EC][ldp]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int split = blockIdx.z / n_slices, slice = blockIdx.z % n_slices;
  const int e_begin = split * e_per_split, e_end = min(E, e_begin + e_per_split);
  const int o0 = slice * n_per_slice, o_end = min(Co, o0 + n_per_slice);
  const int nt_p = (o_end - o0 + 7) / 8;
  const int ldp = (nt_p * 8 + 31) / 32 * 32 + 8;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const T* xb = x + blockIdx.y * HW * C;
  const Region reg(ty0, tx0, TH, TW, h, H, W);
  const int n_rows = reg.count();

  for (int i = threadIdx.x; i < FNH * LE; i += kThreads) s_e[i] = from_f<T>(0.0f);
  for (int r = threadIdx.x; r < NHP; r += kThreads) {
    s_xoff[r] = r < n_rows ? ((reg.y0 + r / reg.nx) * W + reg.x0 + r % reg.nx) * C : -1;
  }
  __syncthreads();
  int m_e[UPW], n_e[UPW], m_p[Tl::MPW], n_p[Tl::MPW];
  region_units<UPW, NG>(m_e, n_e, n_rows);
  Tl::m_tiles(m_p, n_p, ty0, H);
  float acc_p[Tl::MPW][NPW][4];
  zero_acc(acc_p);
  const int n_kc = (C + KC - 1) / KC;
  const auto x_row = [&](int r) -> int64_t { return s_xoff[r]; };

  for (int e0 = e_begin; e0 < e_end; e0 += EC) {
    const auto stage = [&](int kc) {
      const int c0 = kc * KC, buf = kc & 1;
      stage_rows<V16, KC>(s_x + buf * NHP * LX, LX, NHP, KC, xb, c0, C, x_row);
      stage_rows<V16, EC>(s_w + buf * KC * LW, LW, KC, EC, we, e0, e_end,
                      [&](int r) -> int64_t { return c0 + r < C ? static_cast<int64_t>(c0 + r) * E : -1; });
    };
    // the project's Wp chunk travels with the first expand stage
    stage_rows<V16, 0>(s_wp, ldp, EC, nt_p * 8, wp, o0, o_end,
                    [&](int r) -> int64_t { return e0 + r < e_end ? static_cast<int64_t>(e0 + r) * Co : -1; });
    stage(0);
    cp_commit();
    // (1) z0 = x . We on the image-clipped haloed tile
    float acc_e[UPW][4][4];
    zero_acc(acc_e);
    for (int kc = 0; kc < n_kc; ++kc) {
      if (kc + 1 < n_kc) stage(kc + 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      gemm<T, TC, false>(acc_e, m_e, n_e, s_x + (kc & 1) * NHP * LX, LX,
                         s_w + (kc & 1) * KC * LW, LW, chunk_k<T, KC>(kc * KC, C), 1, 4 * NG);
      __syncthreads();
    }
    // (2) e = act(z0 + be) into the haloed layout (zero outside the image)
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      if (m_e[i] < 0) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m_e[i] * 16 + gid + 8 * half;
        if (r >= n_rows) continue;
        const int p = (reg.y0 + r / reg.nx - ty0 + h) * FW + reg.x0 + r % reg.nx - tx0 + h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = (n_e[i] + j) * 8 + 2 * tig + q, e = e0 + col;
            s_e[p * LE + col] = from_f<T>(
                e < e_end ? act_fn(act, acc_e[i][j][2 * half + q] + __ldg(be + e)) : 0.0f);
          }
        }
      }
    }
    __syncthreads();
    // (3) d = act(bd + depthwise(e)), one channel per lane in each group of 32
#pragma unroll
    for (int grp = 0; grp < NG; ++grp) {
      const int col = grp * 32 + lane, e = e0 + col;
      const bool e_ok = e < e_end;
      float wk[K * K];
#pragma unroll
      for (int t = 0; t < K * K; ++t) wk[t] = e_ok ? __ldg(wd + static_cast<int64_t>(t) * E + e) : 0.0f;
      const float bdv = e_ok ? __ldg(bd + e) : 0.0f;
#pragma unroll 4
      for (int i = 0; i < Tl::TP / kWarps; ++i) {
        const int q = warp + kWarps * i, qy = q / TW, qx = q % TW;
        float a = bdv;
#pragma unroll
        for (int ky = 0; ky < K; ++ky)
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
            a = fmaf(to_f(s_e[((qy + ky) * FW + qx + kx) * LE + col]), wk[ky * K + kx], a);
        s_d[q * LE + col] = from_f<T>(e_ok ? act_fn(act, a) : 0.0f);
      }
    }
    cp_wait<0>();
    __syncthreads();
    // (4) the project into the accumulator registers
    gemm<T, TC, false>(acc_p, m_p, n_p, s_d, LE, s_wp, ldp, EC, Tl::WPM, nt_p);
    __syncthreads();
  }

  const int n_split = gridDim.z / n_slices;
  const int64_t img = blockIdx.y * HW;
#pragma unroll
  for (int i = 0; i < Tl::MPW; ++i) {
    if (m_p[i] < 0) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = m_p[i] * 16 + gid + 8 * half;
      const int y = ty0 + q / TW, xx = tx0 + q % TW;
      if (y >= H || xx >= W) continue;
      const int64_t pix = img + static_cast<int64_t>(y) * W + xx;
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int n = n_p[i] + Tl::WPM * j;
        if (n >= nt_p) break;
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int o = o0 + n * 8 + 2 * tig + qq;
          if (o >= o_end) continue;
          float v = acc_p[i][j][2 * half + qq];
          if (n_split == 1) {
            v += __ldg(bp + o);
            if (residual) v += to_f(x[pix * C + o]);
            out[pix * Co + o] = from_f<T>(v);
          } else {
            ws[(split * gridDim.y * HW + pix) * Co + o] = v;
          }
        }
      }
    }
  }
}

// MASKS: also write act'(z0) != 0 and act'(z1) != 0 of the centre pixels as
// bytes into masks [2][B, H, W, E] (relu6 / relu). T as in the forward: x,
// g, We, Wp, e and dx; gd and ge are float buffers whose values are rounded
// to T (gd as it is stored, ge as the product reads it).
template <typename T, int K, int TH, int TW, int NPW, int KC, bool V16, bool TC, bool MASKS>
__global__ void __launch_bounds__(kThreads, 1)
mbconv_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const T* __restrict__ we, const float* __restrict__ be,
                 const float* __restrict__ wd, const float* __restrict__ bd,
                 const T* __restrict__ wp, int H, int W, int C, int E, int Co,
                 int act, int residual, int e_per_split, int n_per_slice, int n_slices,
                 T* __restrict__ dx, float* __restrict__ ws,
                 uint8_t* __restrict__ masks) {
  constexpr int h = K / 2;
  // LE: e and the We^T chunk (T); LF: act'(z1) / gd and act'(z0) / ge (float)
  constexpr int LX = ld_x<T>(KC), LW = ld_w(kEC), LE = ld_e<T>(kEC), LF = ld_e<float>(kEC);
  constexpr int T2W = TW + 4 * h, N2 = (TH + 4 * h) * T2W;  // halo 2h: x, e
  constexpr int T1W = TW + 2 * h, N1 = (TH + 2 * h) * T1W;  // halo h: g, z1, gd
  constexpr int MT2 = (N2 + 15) / 16, N2P = MT2 * 16;
  constexpr int N1P = (N1 + 15) / 16 * 16;
  constexpr int MPW_E = (MT2 + kWarps - 1) / kWarps;
  using Tl = Tile<TH, TW>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int split = blockIdx.z / n_slices, slice = blockIdx.z % n_slices;
  const int e_begin = split * e_per_split, e_end = min(E, e_begin + e_per_split);
  const int c0s = slice * n_per_slice, c_end = min(C, c0s + n_per_slice);
  const int nt_p = (c_end - c0s + 7) / 8;
  const int64_t HW = static_cast<int64_t>(H) * W, img = blockIdx.y * HW;
  const T* xb = x + img * C;
  const T* gb = g + img * Co;

  extern __shared__ float4 smem4[];
  int* s_xoff = reinterpret_cast<int*>(smem4);   // [N2P] x offset of a packed row
  int* s_goff = s_xoff + N2P;                    // [N1P] g offset of a packed row
  T* s_r = reinterpret_cast<T*>(s_goff + N1P);   // staging, then We^T
  T* s_e = s_r + dx_region_elems<T>(K, TH, TW, KC, min(n_per_slice, C));  // [N2][LE]
  float* s_g1 = reinterpret_cast<float*>(s_e + N2 * LE);  // [N1][LF]: act'(z1), then gd
  float* s_q = s_g1 + N1 * LF;  // [TP][LF]: act'(z0), then ge
  for (int i = threadIdx.x; i < N2 * LE; i += kThreads) s_e[i] = from_f<T>(0.0f);
  for (int i = threadIdx.x; i < (N1 + Tl::TP) * LF; i += kThreads) s_g1[i] = 0.0f;

  const Region reg2(ty0, tx0, TH, TW, 2 * h, H, W), reg1(ty0, tx0, TH, TW, h, H, W);
  const int rows2 = reg2.count(), rows1 = reg1.count();
  for (int r = threadIdx.x; r < N2P; r += kThreads) {
    s_xoff[r] = r < rows2 ? ((reg2.y0 + r / reg2.nx) * W + reg2.x0 + r % reg2.nx) * C : -1;
  }
  for (int r = threadIdx.x; r < N1P; r += kThreads) {
    s_goff[r] = r < rows1 ? ((reg1.y0 + r / reg1.nx) * W + reg1.x0 + r % reg1.nx) * Co : -1;
  }
  __syncthreads();
  int m2[MPW_E], n2[MPW_E], m1[MPW_E], n1[MPW_E], m_p[Tl::MPW], n_p[Tl::MPW];
  region_units<MPW_E, 1>(m2, n2, rows2);
  region_units<MPW_E, 1>(m1, n1, rows1);
  Tl::m_tiles(m_p, n_p, ty0, H);
  float acc_p[Tl::MPW][NPW][4];
  zero_acc(acc_p);
  const int n_kc = (C + KC - 1) / KC, n_oc = (Co + KC - 1) / KC;
  const auto x_row = [&](int r) -> int64_t { return s_xoff[r]; };
  const auto g_row = [&](int r) -> int64_t { return s_goff[r]; };
  uint8_t* masks0 = masks;
  uint8_t* masks1 = masks + gridDim.y * HW * E;

  for (int e0 = e_begin; e0 < e_end; e0 += kEC) {
    const auto stage_x = [&](int kc) {
      const int c0 = kc * KC, buf = kc & 1;
      stage_rows<V16, KC>(s_r + buf * N2P * LX, LX, N2P, KC, xb, c0, C, x_row);
      stage_rows<V16, kEC>(s_r + 2 * N2P * LX + buf * KC * LW, LW, KC, kEC, we, e0, e_end,
                      [&](int r) -> int64_t { return c0 + r < C ? static_cast<int64_t>(c0 + r) * E : -1; });
    };
    const auto stage_g = [&](int oc) {
      const int c0 = oc * KC, buf = oc & 1;
      stage_rows<V16, KC>(s_r + buf * N1P * LX, LX, N1P, KC, gb, c0, Co, g_row);
      stage_rows<V16, KC>(s_r + 2 * N1P * LX + buf * kEC * LX, LX, kEC, KC, wp, c0, Co,
                      [&](int r) -> int64_t { return e0 + r < e_end ? static_cast<int64_t>(e0 + r) * Co : -1; });
    };
    // (1) z0 = x . We on the image-clipped tile with a halo of 2h
    float acc[MPW_E][4][4];
    zero_acc(acc);
    stage_x(0);
    cp_commit();
    for (int kc = 0; kc < n_kc; ++kc) {
      if (kc + 1 < n_kc) stage_x(kc + 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      gemm<T, TC, false>(acc, m2, n2, s_r + (kc & 1) * N2P * LX, LX,
                         s_r + 2 * N2P * LX + (kc & 1) * KC * LW, LW,
                         chunk_k<T, KC>(kc * KC, C), 1, 4);
      __syncthreads();
    }
    stage_g(0);  // the first g . Wp^T stage flies during (2) and (3)
    cp_commit();
    // (2) e = act(z0) (zero outside the image) and act'(z0) of the centre
#pragma unroll
    for (int i = 0; i < MPW_E; ++i) {
      if (m2[i] < 0) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m2[i] * 16 + gid + 8 * half;
        if (r >= rows2) continue;
        const int y = reg2.y0 + r / reg2.nx, xx = reg2.x0 + r % reg2.nx;
        const int p = (y - ty0 + 2 * h) * T2W + xx - tx0 + 2 * h;
        const bool centre = y >= ty0 && y < ty0 + TH && xx >= tx0 && xx < tx0 + TW;
        const int q = (y - ty0) * TW + xx - tx0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const int col = j * 8 + 2 * tig + qq, e = e0 + col;
            const bool e_ok = e < e_end;
            const float z0 = acc[i][j][2 * half + qq] + (e_ok ? __ldg(be + e) : 0.0f);
            s_e[p * LE + col] = from_f<T>(e_ok ? act_fn(act, z0) : 0.0f);
            if (centre) {
              const float m = e_ok ? dact_fn(act, z0) : 0.0f;
              s_q[q * LF + col] = m;
              if (MASKS && e_ok) {
                masks0[(img + static_cast<int64_t>(y) * W + xx) * E + e] = m != 0.0f;
              }
            }
          }
        }
      }
    }
    __syncthreads();
    // (3) act'(z1) on the tile with a halo of h, one channel per lane
    const int e = e0 + lane;
    const bool e_ok = e < e_end;
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = e_ok ? __ldg(wd + static_cast<int64_t>(t) * E + e) : 0.0f;
    {
      const float bdv = e_ok ? __ldg(bd + e) : 0.0f;
#pragma unroll 2
      for (int p = warp; p < N1; p += kWarps) {
        const int py = p / T1W, px = p % T1W;
        const int y = ty0 - h + py, xx = tx0 - h + px;
        if (y < 0 || y >= H || xx < 0 || xx >= W) continue;  // gd stays 0 there
        float a = bdv;
#pragma unroll
        for (int ky = 0; ky < K; ++ky)
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
            a = fmaf(to_f(s_e[((py + ky) * T2W + px + kx) * LE + lane]), wk[ky * K + kx], a);
        const float m = e_ok ? dact_fn(act, a) : 0.0f;
        s_g1[p * LF + lane] = m;
        if (MASKS && e_ok && py >= h && py < h + TH && px >= h && px < h + TW) {
          masks1[(img + static_cast<int64_t>(y) * W + xx) * E + e] = m != 0.0f;
        }
      }
    }
    // (4) gd = (g . Wp^T) * act'(z1) on the same pixels
    zero_acc(acc);
    for (int oc = 0; oc < n_oc; ++oc) {
      if (oc + 1 < n_oc) stage_g(oc + 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      gemm<T, TC, true>(acc, m1, n1, s_r + (oc & 1) * N1P * LX, LX,
                        s_r + 2 * N1P * LX + (oc & 1) * kEC * LX, LX,
                        chunk_k<T, KC>(oc * KC, Co), 1, 4);
      __syncthreads();
    }
    // the project's We^T chunk [c][e] flies during (4)'s epilogue and (5)
    stage_rows<V16, kEC>(s_r, LE, nt_p * 8, kEC, we, e0, e_end,
                    [&](int r) -> int64_t { return c0s + r < c_end ? static_cast<int64_t>(c0s + r) * E : -1; });
    cp_commit();
#pragma unroll
    for (int i = 0; i < MPW_E; ++i) {
      if (m1[i] < 0) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m1[i] * 16 + gid + 8 * half;
        if (r >= rows1) continue;
        const int p = (reg1.y0 + r / reg1.nx - ty0 + h) * T1W + reg1.x0 + r % reg1.nx - tx0 + h;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const int col = j * 8 + 2 * tig + qq;
            s_g1[p * LF + col] = round_to<T>(acc[i][j][2 * half + qq] * s_g1[p * LF + col]);
          }
      }
    }
    __syncthreads();
    // (5) ge = dwconv^T(gd) * act'(z0) on the centre
#pragma unroll 4
    for (int i = 0; i < Tl::TP / kWarps; ++i) {
      const int q = warp + kWarps * i, qy = q / TW, qx = q % TW;
      float a = 0.0f;
#pragma unroll
      for (int ky = 0; ky < K; ++ky)
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
          a = fmaf(s_g1[((qy + 2 * h - ky) * T1W + qx + 2 * h - kx) * LF + lane],
                   wk[ky * K + kx], a);
      s_q[q * LF + lane] = a * s_q[q * LF + lane];
    }
    cp_wait<0>();
    __syncthreads();
    // (6) dx += ge . We^T into the accumulator registers (a bf16 instance
    // rounds ge to bf16 as it reads it)
    gemm<T, TC, true>(acc_p, m_p, n_p, s_q, LF, s_r, LE, kEC, Tl::WPM, nt_p);
    __syncthreads();
  }

  const int n_split = gridDim.z / n_slices;
#pragma unroll
  for (int i = 0; i < Tl::MPW; ++i) {
    if (m_p[i] < 0) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = m_p[i] * 16 + gid + 8 * half;
      const int y = ty0 + q / TW, xx = tx0 + q % TW;
      if (y >= H || xx >= W) continue;
      const int64_t pix = img + static_cast<int64_t>(y) * W + xx;
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int n = n_p[i] + Tl::WPM * j;
        if (n >= nt_p) break;
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int c = c0s + n * 8 + 2 * tig + qq;
          if (c >= c_end) continue;
          float v = acc_p[i][j][2 * half + qq];
          if (n_split == 1) {
            if (residual) v += to_f(g[pix * Co + c]);
            dx[pix * C + c] = from_f<T>(v);
          } else {
            ws[(split * gridDim.y * HW + pix) * C + c] = v;
          }
        }
      }
    }
  }
}

// out[i] = the n_split partials of ws in split order [+ bias[i % n_ch]]
// [+ res[i]]: the deterministic reduction of a split of E, in float32; the
// output is rounded to T once, after it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mbconv_reduce_kernel(const float* __restrict__ ws, int n_split, int64_t n, int n_ch,
                     const float* __restrict__ bias, const T* __restrict__ res,
                     T* __restrict__ out) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    float v = ws[i];
    for (int s = 1; s < n_split; ++s) v += ws[s * n + i];
    if (bias != nullptr) v += __ldg(bias + i % n_ch);
    if (res != nullptr) v += to_f(res[i]);
    out[i] = from_f<T>(v);
  }
}

// ------------------------------------------------------------------ host

// x, g, We, Wp and out in the instance's element type; the rest float
struct Args {
  const void *x, *g, *we;
  const float *be, *wd, *bd;
  const void* wp;
  const float* bp;
  int B, H, W, C, E, Co, k, act, residual;
  int th, tw, npw, split, e_per_split, n_per_slice;
  void* out;
  float* ws;
  uint8_t* masks;
  cudaStream_t stream;
};

// The instances built: (TH, TW, NPW, EC, KC) of the main path with 16-byte
// copies, a subset with 4-byte copies, and one for the masks (`built`). The
// planner of ops/mbconv_cuda.py lists the same (`FWD_CONFIGS`, `DX_CONFIGS`,
// `built`). dx takes E in chunks of kEC = 32.
#define MLAD_MBCONV_FWD_CONFIGS(X) \
  X(8, 8, 8, 64, 32) X(8, 8, 20, 64, 32) X(8, 8, 28, 32, 32) X(16, 8, 8, 64, 32) \
  X(16, 8, 20, 32, 32) X(16, 16, 4, 32, 32)
#define MLAD_MBCONV_DX_CONFIGS(X) \
  X(8, 8, 8, 32, 32) X(8, 8, 20, 32, 32) X(8, 8, 28, 32, 32) X(16, 8, 8, 32, 16) \
  X(16, 8, 20, 32, 16) X(16, 16, 4, 32, 16)

template <int K, int TH, int TW, int NPW, bool V16, bool TC, bool MASKS, bool DX>
constexpr bool built() {
  if (MASKS) return DX && TC && TH == 8 && TW == 8 && NPW == 8;
  if (!V16) return TC && TH == 8 && TW == 8 && (NPW == 8 || NPW == 28);
  return !(DX && K == 5 && TH == 16 && TW == 16);  // over 227 KB
}

int n_slices(int n_out, int per_slice) { return (n_out + per_slice - 1) / per_slice; }

// Refuse a plan the instance cannot run: the accumulator must cover the
// slice, every split must hold channels, shared memory must fit.
bool bad_plan(const Args& a, int n_out, int wpm, size_t smem_bytes) {
  return a.split < 1 || a.split > 8 || a.e_per_split < kEC || a.e_per_split % kEC != 0 ||
         static_cast<int64_t>(a.split - 1) * a.e_per_split >= a.E ||
         static_cast<int64_t>(a.split) * a.e_per_split < a.E ||
         a.n_per_slice < 8 || a.n_per_slice % 8 != 0 ||
         a.npw * wpm * 8 < (a.n_per_slice < n_out ? a.n_per_slice : n_out) ||
         static_cast<int64_t>(a.split) * n_slices(n_out, a.n_per_slice) > 65535 ||
         (a.split > 1 && a.ws == nullptr) || smem_bytes > kMaxSmem;
}

template <typename T>
cudaError_t reduce(const Args& a, int n_ch, const float* bias, const void* res) {
  const int64_t n = static_cast<int64_t>(a.B) * a.H * a.W * n_ch;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 1056 ? blocks : 1056);  // 8 per SM
  mbconv_reduce_kernel<T><<<grid, kThreads, 0, a.stream>>>(
      a.ws, a.split, n, n_ch, bias, static_cast<const T*>(res), static_cast<T*>(a.out));
  return cudaGetLastError();
}

template <typename Kernel, typename... KArgs>
cudaError_t launch(Kernel kern, const Args& a, int n_out, size_t smem_bytes, KArgs... args) {
  const int smem = static_cast<int>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.H + a.th - 1) / a.th) * ((a.W + a.tw - 1) / a.tw), a.B,
                  a.split * n_slices(n_out, a.n_per_slice));
  kern<<<grid, kThreads, smem, a.stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int K, int TH, int TW, int NPW, int EC, int KC, bool V16, bool TC>
cudaError_t run_fwd(const Args& a) {
  const size_t smem =
      fwd_smem_bytes<T>(K, TH, TW, EC, KC, a.n_per_slice < a.Co ? a.n_per_slice : a.Co);
  if (bad_plan(a, a.Co, Tile<TH, TW>::WPM, smem)) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(a.x);
  cudaError_t err = launch(mbconv_fwd_kernel<T, K, TH, TW, NPW, EC, KC, V16, TC>, a, a.Co,
                           smem, x, static_cast<const T*>(a.we), a.be, a.wd, a.bd,
                           static_cast<const T*>(a.wp), a.bp, a.H, a.W, a.C, a.E, a.Co,
                           a.act, a.residual, a.e_per_split, a.n_per_slice,
                           n_slices(a.Co, a.n_per_slice), static_cast<T*>(a.out), a.ws);
  if (err != cudaSuccess || a.split == 1) return err;
  return reduce<T>(a, a.Co, a.bp, a.residual ? a.x : nullptr);
}

template <typename T, int K, int TH, int TW, int NPW, int KC, bool V16, bool TC, bool MASKS>
cudaError_t run_dx(const Args& a) {
  const size_t smem =
      dx_smem_bytes<T>(K, TH, TW, KC, a.n_per_slice < a.C ? a.n_per_slice : a.C);
  if (bad_plan(a, a.C, Tile<TH, TW>::WPM, smem)) return cudaErrorInvalidValue;
  cudaError_t err = launch(mbconv_dx_kernel<T, K, TH, TW, NPW, KC, V16, TC, MASKS>, a, a.C,
                           smem, static_cast<const T*>(a.x), static_cast<const T*>(a.g),
                           static_cast<const T*>(a.we), a.be, a.wd, a.bd,
                           static_cast<const T*>(a.wp), a.H, a.W, a.C, a.E, a.Co, a.act,
                           a.residual, a.e_per_split, a.n_per_slice,
                           n_slices(a.C, a.n_per_slice), static_cast<T*>(a.out), a.ws,
                           a.masks);
  if (err != cudaSuccess || a.split == 1) return err;
  return reduce<T>(a, a.C, nullptr, a.residual ? a.g : nullptr);
}

template <typename T, int K, bool V16, bool TC, bool MASKS, bool DX>
cudaError_t dispatch(const Args& a) {
#define MLAD_TRY(TH, TW, NPW, EC, KC)                                             \
  if constexpr (built<K, TH, TW, NPW, V16, TC, MASKS, DX>()) {                    \
    if (a.th == TH && a.tw == TW && a.npw == NPW) {                               \
      if constexpr (DX) return run_dx<T, K, TH, TW, NPW, KC, V16, TC, MASKS>(a);  \
      else return run_fwd<T, K, TH, TW, NPW, EC, KC, V16, TC>(a);                 \
    }                                                                             \
  }
  if constexpr (DX) {
    MLAD_MBCONV_DX_CONFIGS(MLAD_TRY)
  } else {
    MLAD_MBCONV_FWD_CONFIGS(MLAD_TRY)
  }
#undef MLAD_TRY
  return cudaErrorInvalidValue;  // no such instance
}

bool misaligned(const Args& a) {
  for (const void* p : {a.x, a.g, a.we, static_cast<const void*>(a.be),
                        static_cast<const void*>(a.wd), static_cast<const void*>(a.bd), a.wp,
                        static_cast<const void*>(a.bp), static_cast<const void*>(a.out),
                        static_cast<const void*>(a.ws)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  }
  return false;
}

bool bad_args(const Args& a) {
  return a.B < 1 || a.B > 65535 || a.H < 1 || a.W < 1 || a.C < 1 || a.E < 1 || a.Co < 1 ||
         (a.k != 3 && a.k != 5) || a.act < kRelu6 || a.act > kSwish ||
         (a.residual && a.C != a.Co) || a.th < 1 || a.tw < 1 ||
         static_cast<int64_t>(a.H) * a.W * (a.C > a.Co ? a.C : a.Co) > 2147483647LL ||
         static_cast<int64_t>((a.H + a.th - 1) / a.th) * ((a.W + a.tw - 1) / a.tw) >
             2147483647LL ||
         misaligned(a);
}

// The main path (TC) or the SIMT ablation of one kernel in element type T
// (the ablation is float only): picks the 16-byte or element-wise copies
// (16-byte ones need C, E and Co multiples of 16 bytes' elements) and k.
template <typename T, bool TC, bool DX>
int entry(const Args& a) {
  static_assert(TC || !kBf16<T>, "the SIMT ablation has no bf16 instance");
  if (bad_args(a) || (a.masks != nullptr && (!DX || !TC || a.act == kSwish))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const bool v16 = a.C % kVec == 0 && a.E % kVec == 0 && a.Co % kVec == 0;
  cudaError_t err;
  if (a.masks != nullptr) {
    if constexpr (DX && TC) {
      err = v16 ? (a.k == 3 ? dispatch<T, 3, true, true, true, true>(a)
                            : dispatch<T, 5, true, true, true, true>(a))
                : (a.k == 3 ? dispatch<T, 3, false, true, true, true>(a)
                            : dispatch<T, 5, false, true, true, true>(a));
    } else {
      err = cudaErrorInvalidValue;
    }
  } else if (v16) {
    err = a.k == 3 ? dispatch<T, 3, true, TC, false, DX>(a)
                   : dispatch<T, 5, true, TC, false, DX>(a);
  } else if constexpr (TC) {
    err = a.k == 3 ? dispatch<T, 3, false, TC, false, DX>(a)
                   : dispatch<T, 5, false, TC, false, DX>(a);
  } else {
    err = cudaErrorInvalidValue;  // the ablation takes 16-byte shapes only
  }
  return static_cast<int>(err);
}

Args make_args(const void* x, const void* g, const void* we, const float* be,
               const float* wd, const float* bd, const void* wp, const float* bp, int B,
               int H, int W, int C, int E, int Co, int k, int act, int residual, int th,
               int tw, int npw, int split, int e_per_split, int n_per_slice, void* out,
               float* ws, uint8_t* masks, void* stream) {
  return Args{x, g, we, be, wd, bd, wp, bp, B, H, W, C, E, Co, k, act, residual, th, tw,
              npw, split, e_per_split, n_per_slice, out, ws, masks,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// act: 0 relu6, 1 relu, 2 swish. The plan (th, tw, npw, split, e_per_split,
// n_per_slice) comes from ops/mbconv_cuda.py `plan_fwd` / `plan_dx`; ws is a
// [split, B, H, W, Co] (dx: C) float workspace, null when split is 1. Returns
// a cudaError_t: 1 (invalid value) for arguments or a plan the kernels do not
// take, without launching.
#if !defined(MLAD_MBCONV_PART)
extern "C" int mlad_mbconv_fwd(const float* x, const float* we, const float* be,
                               const float* wd, const float* bd, const float* wp,
                               const float* bp, int B, int H, int W, int C, int E, int Co,
                               int k, int act, int residual, int th, int tw, int npw,
                               int split, int e_per_split, int n_per_slice, float* out,
                               float* ws, void* stream) {
  return entry<float, true, false>(make_args(x, x, we, be, wd, bd, wp, bp, B, H, W, C, E,
                                             Co, k, act, residual, th, tw, npw, split,
                                             e_per_split, n_per_slice, out, ws, nullptr,
                                             stream));
}
#elif MLAD_MBCONV_PART == 1

// masks_out: null on the main path; else [2, B, H, W, E] bytes that receive
// act'(z0) != 0 and act'(z1) != 0 (relu6 / relu only).
extern "C" int mlad_mbconv_dx(const float* x, const float* g, const float* we,
                              const float* be, const float* wd, const float* bd,
                              const float* wp, int B, int H, int W, int C, int E, int Co,
                              int k, int act, int residual, int th, int tw, int npw,
                              int split, int e_per_split, int n_per_slice, float* dx,
                              float* ws, uint8_t* masks_out, void* stream) {
  return entry<float, true, true>(make_args(x, g, we, be, wd, bd, wp, be, B, H, W, C, E,
                                            Co, k, act, residual, th, tw, npw, split,
                                            e_per_split, n_per_slice, dx, ws, masks_out,
                                            stream));
}
#elif MLAD_MBCONV_PART == 2
extern "C" int mlad_mbconv_fwd_simt(const float* x, const float* we, const float* be,
                                    const float* wd, const float* bd, const float* wp,
                                    const float* bp, int B, int H, int W, int C, int E,
                                    int Co, int k, int act, int residual, int th, int tw,
                                    int npw, int split, int e_per_split, int n_per_slice,
                                    float* out, float* ws, void* stream) {
  return entry<float, false, false>(make_args(x, x, we, be, wd, bd, wp, bp, B, H, W, C, E,
                                              Co, k, act, residual, th, tw, npw, split,
                                              e_per_split, n_per_slice, out, ws, nullptr,
                                              stream));
}
#elif MLAD_MBCONV_PART == 3
extern "C" int mlad_mbconv_dx_simt(const float* x, const float* g, const float* we,
                                   const float* be, const float* wd, const float* bd,
                                   const float* wp, int B, int H, int W, int C, int E,
                                   int Co, int k, int act, int residual, int th, int tw,
                                   int npw, int split, int e_per_split, int n_per_slice,
                                   float* dx, float* ws, uint8_t* masks_out, void* stream) {
  return entry<float, false, true>(make_args(x, g, we, be, wd, bd, wp, be, B, H, W, C, E,
                                             Co, k, act, residual, th, tw, npw, split,
                                             e_per_split, n_per_slice, dx, ws, masks_out,
                                             stream));
}
#elif MLAD_MBCONV_PART == 4

// The bf16 instances: x, We, Wp and out (dx: x, g, We, Wp and dx) are bf16
// (__nv_bfloat16 bits), the biases and wd float32, ws float32.
extern "C" int mlad_mbconv_fwd_bf16(const void* x, const void* we, const float* be,
                                    const float* wd, const float* bd, const void* wp,
                                    const float* bp, int B, int H, int W, int C, int E,
                                    int Co, int k, int act, int residual, int th, int tw,
                                    int npw, int split, int e_per_split, int n_per_slice,
                                    void* out, float* ws, void* stream) {
  return entry<bf16, true, false>(make_args(x, x, we, be, wd, bd, wp, bp, B, H, W, C, E, Co,
                                            k, act, residual, th, tw, npw, split,
                                            e_per_split, n_per_slice, out, ws, nullptr,
                                            stream));
}
#elif MLAD_MBCONV_PART == 5
extern "C" int mlad_mbconv_dx_bf16(const void* x, const void* g, const void* we,
                                   const float* be, const float* wd, const float* bd,
                                   const void* wp, int B, int H, int W, int C, int E, int Co,
                                   int k, int act, int residual, int th, int tw, int npw,
                                   int split, int e_per_split, int n_per_slice, void* dx,
                                   float* ws, uint8_t* masks_out, void* stream) {
  return entry<bf16, true, true>(make_args(x, g, we, be, wd, bd, wp, be, B, H, W, C, E, Co,
                                           k, act, residual, th, tw, npw, split,
                                           e_per_split, n_per_slice, dx, ws, masks_out,
                                           stream));
}
#endif
