// Channel-major 3x3 SAME convolution in bf16, written for Hopper (sm_90a): the bf16 instance
// the plan picks (ops/cmconv_cuda.py, "sm90").
//
// Replaces the Pallas TPU kernel `_kernel` of tools/proto_cmconv.py:28 (`pallas_call` at :64,
// through `cmconv`) at its own dtypes. It computes what `cmconv_plain` of
// mladversarialobjectdetection_torch/ops/cmconv.py computes for a bf16 x:
//
//   s[b,co,y,x] = sum_{dy, dx, c} x[b, c, y+dy-1, x+dx-1] * w[dy, dx, c, co]   (float32 sums)
//   out         = bf16(s), then bf16(out + bias[co]) where a bias is given
//
// with x [B, C, H, W] bf16 (NCHW, contiguous), w [3, 3, C, Co] float32 (HWIO), an optional
// bias [Co] bf16, zero padding outside the image, 1 <= C, Co <= 32 and any B, H, W >= 1. The
// defender's bf16 U-Net runs it for its ConvBlocks (C 3..32, Co 8 or 16 at 640x640 and
// 320x320; the packed U-Net 12 -> 32, 32 -> 32 and 32 -> 12), forward and, with w flipped in
// both spatial axes and C / Co swapped, for the input gradient.
//
// What bounds it on an H100 (published rates: 3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s
// float32 outside the tensor cores): the bytes. At batch 24 a defender step's 15 launches move
// x and the output at 2 bytes a value in 1.121 ms, and their exact products take 0.199 ms on
// the bf16 tensor cores. The template's bf16 instance (cmconv_bf16.cu, kept as the ablation)
// sums every product with float32 FMAs, which alone take 2.938 ms a step: no tuning of it
// passes about 38% of the byte bound. This design moves the products to the tensor cores and
// streams x and the output:
//
//   1. Implicit GEMM on `mma.sync.m16n8k16` bf16 -> float32. M is 16 output pixels along a
//      row, N the output channels in n-tiles of 8 (Co padded; padded columns have zero weights
//      and are never stored), K the 9 taps x C in groups of 8 channels: for each dy, the
//      groups (dx, channel block) of its row, two a k16 chunk, the last of a row padded by a
//      group that reads a zero line where the row has an odd count (CP8 = C's blocks of 8
//      odd). Every pixel sums the chunks in (dy, chunk) order from a zero accumulator, so two
//      launches are bit-equal and a pixel's sum does not depend on its tile.
//   2. w is float32 in the signature: each weight is split into bf16 terms hi = bf16(w) and
//      lo = bf16(w - hi), which leave out at most 2^-16 of |w|, and each chunk runs the hi
//      products, then the lo ones; each product of two bf16 values is exact in float32. A
//      block packs the terms once, in its prologue, into B-fragment order in shared memory
//      (no host-side op), and where every lo term is 0 (the U-Net's kernels hold bf16 values)
//      it skips the lo products: both sides compute the same function.
//      `ops/cmconv.cmconv_rounding_bound` bounds the output elementwise (the sums' float32
//      error over this K order, the split's residual, the roundings).
//   3. A channels-last halo tile, staged once. A block's output tile is TH x 64; its input,
//      rows y0 - 1 .. y0 + TH and columns x0 - 8 .. x0 + 71 (8-aligned, for 16-byte copies),
//      is staged channel-major by `cp.async` (16-byte copies where W % 8 == 0 and x is 16-byte
//      aligned, element loads otherwise), zero outside the image and past C (the channels past
//      C zeroed once): the SAME padding. `ldmatrix.trans` then turns each 8 channels x 8
//      columns into channel pairs per pixel, stored into a channels-last tile of the 66
//      columns x0 - 1 .. x0 + 64, whose rows of 8 channels `ldmatrix` reads as the A operand
//      at any tap's shift. Pitches of an odd number of 16-byte units (staged channel,
//      channels-last pixel) keep both conflict-free.
//   4. Shared-memory traffic. Where C and Co are at most 16 (CP8, NT <= 2: 12 of the step's
//      15 launches) a warp owns a column of TH / 2 output rows: each A fragment of a
//      channels-last row feeds the three output rows it is a dy tap of, and the hi B
//      fragments stay in registers, so a row's A is read once from shared memory, not three
//      times; elsewhere a warp holds TH / 2 tiles of consecutive rows and reloads B a chunk.
//   5. Output through shared memory: each float32 sum rounded to bf16 and the bias added in
//      bf16, one rounding of the exact sum (as `store_strip` of cmconv.cu rounds float(s) +
//      float(bias), the same value for two bf16 operands), written by `stmatrix.trans` into a
//      [row][channel][64] tile in the room of the channels-last one, then stored as 16-byte
//      vectors along W (2-byte stores where W % 8 != 0).
//   6. Persistent blocks, two a SM (at most 113 KB of shared memory and 128 registers each),
//      walk the tiles: the weights are packed once a block, and a ring of up to 4 staged
//      tiles keeps the next tiles' copies in flight while a block transposes, multiplies and
//      stores this one. TH is 16 (C, Co <= 8), 8 (C <= 8, Co <= 16), 6 (C <= 16, Co <= 16),
//      2 (C > 24, Co > 16), else 4: as many rows as leave the ring at least two slots and a
//      warp at most 32 accumulators.
//
// A tile's time goes to instructions and shared memory, not to waiting on device memory: on
// an H100 80GB HBM3 at 700 W (ops/cmconv_profile.py, the step's b24 shapes) the ring wait takes
// 1-3% of it, the staging issue 22-37%, the products 16-34%, the transpose 14-21% and the
// store 15-24%; a defender step's 15 launches take 66% of their byte bound (PERF.md).

#include <cstdint>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 64;         // output tile width
constexpr int kSCols = 80;      // staged columns: x0 - 8 .. x0 + 71
constexpr int kGroupsRow = kSCols / 8;
constexpr int kCLW = kTW + 2;   // channels-last pixels a row: x0 - 1 .. x0 + 64
constexpr int kOutLd = kTW + 8;  // output tile row: 72 bf16, 144 bytes (9 units of 16)

template <int TH, int CP8, int NT>
struct Cfg {
  static constexpr int kCp = 8 * CP8;  // staged channels, C padded to 8
  static constexpr int kRows = TH + 2;
  // staged channel pitch (bf16) and channels-last pixel pitch (bytes): odd 16-byte units
  static constexpr int kChs = ((kRows * kSCols / 8) | 1) * 8;
  static constexpr int kPix = 16 * (CP8 | 1);
  // K: for each dy, the k8 groups (dx, channel block) of its row, two a k16 chunk
  static constexpr int kRowGroups = 3 * CP8;
  static constexpr int kRC = (kRowGroups + 1) / 2;  // chunks a dy row
  static constexpr int kChunks = 3 * kRC;
  static constexpr int kMT = TH / 2;                 // m16 tiles a warp: TH x 4 over 8 warps
  // a warp owns a column of TH / 2 rows and reuses each A fragment across the three dy taps,
  // its B (hi) fragments held in registers; else TH / 2 tiles of consecutive rows
  static constexpr bool kRowReuse = CP8 <= 2 && NT <= 2;
  static constexpr int kCo = 8 * NT;
  static constexpr int kStageBytes = kCp * kChs * 2;
  static constexpr int kClBytes = kRows * kCLW * kPix;
  static constexpr int kOutBytes = TH * kCo * kOutLd * 2;
  static constexpr int kRegionBytes = kClBytes > kOutBytes ? kClBytes : kOutBytes;
  static constexpr int kWWords = kChunks * NT * 32 * 2;  // one of hi, lo: a uint2 per lane
  // staged tiles in the ring: as many as two blocks a SM leave room for, at most 4
  static constexpr int kFree = kMaxSmem2 - 16 - kRegionBytes - 2 * 4 * kWWords;
  static constexpr int kStages = kFree / kStageBytes < 4 ? kFree / kStageBytes : 4;
  static constexpr int kSmem = 16 + kStages * kStageBytes + kRegionBytes + 2 * 4 * kWWords;
  static_assert(TH * 4 == kWarps * kMT, "one m16 tile group a warp");
  static_assert(kStages >= 2 && kSmem <= kMaxSmem2, "two blocks a SM");
};

struct Params {
  const bf16* x;
  const float* w;
  const bf16* bias;  // or null
  bf16* out;
  int B, C, Co, H, W;
  int ntx, nty;      // tiles along W and H
  int tiles;         // B * nty * ntx
  int vx, vout;      // 16-byte copies of x, 16-byte stores of out
};

// byte offset of the A rows of group gi of a dy row (dx = gi / CP8, channel block gi % CP8)
// from a pixel's channels-last address in that row
template <typename CF>
__host__ __device__ constexpr int row_off(int gi) {
  return (gi / (CF::kCp / 8)) * CF::kPix + (gi % (CF::kCp / 8)) * 16;
}

// the output row and m16 column of a warp's u-th accumulator tile
template <typename CF>
__device__ __forceinline__ void warp_tile(int warp, int u, int& r, int& mt) {
  if constexpr (CF::kRowReuse) {
    mt = warp & 3;
    r = (warp >> 2) * CF::kMT + u;
  } else {
    const int idx = warp * CF::kMT + u;
    r = idx >> 2;
    mt = idx & 3;
  }
}

// w split into bf16 terms: hi = bf16(w), lo = bf16(w - hi) (w - hi is exact in float32); lo 0
// where hi is not finite, so that an infinite weight gives the plain version's products
__device__ __forceinline__ void split_w(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  const float h = __bfloat162float(hi);
  lo = __float2bfloat16_rn(isfinite(h) ? v - h : 0.0f);
}

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// a tile's image b, first output row y0 and column x0 (tiles along W first, then H, then B)
template <typename CF>
__device__ __forceinline__ void tile_origin(const Params& p, int tile, int& b, int& y0, int& x0) {
  const int rest = tile / p.ntx;
  x0 = (tile - rest * p.ntx) * kTW;
  b = rest / p.nty;
  y0 = (rest - b * p.nty) * (CF::kRows - 2);
}

// Stage a tile's input channel-major: stage[c * kChs + r * kSCols + s] = x[b, c, y0 - 1 + r,
// x0 - 8 + s] for c < C, zero outside the image (channels past C are zeroed once, in the
// prologue). 16-byte copies, ten lanes a staged row, lie wholly inside or outside the image
// (W % 8 == 0, columns 8-aligned); otherwise a warp a staged row, element by element.
template <typename CF>
__device__ __forceinline__ void stage_tile(bf16* stage, const Params& p, int tile) {
  int b, y0, x0;
  tile_origin<CF>(p, tile, b, y0, x0);
  const bf16* xb = p.x + static_cast<int64_t>(b) * p.C * p.H * p.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = p.C * CF::kRows;
  if (p.vx) {
    const int sub = lane / kGroupsRow, q = lane - sub * kGroupsRow;
    const int x = x0 - 8 + 8 * q;
    if (sub < 3) {
      for (int row = 3 * warp + sub; row < rows; row += 3 * kWarps) {
        const int c = row / CF::kRows, r = row - c * CF::kRows, y = y0 - 1 + r;
        const bool ok = y >= 0 && y < p.H && x >= 0 && x < p.W;
        const bf16* src = ok ? xb + static_cast<int64_t>(c * p.H + y) * p.W + x : p.x;
        cp_async16(stage + c * CF::kChs + r * kSCols + 8 * q, src, ok);
      }
    }
  } else {
    for (int row = warp; row < rows; row += kWarps) {
      const int c = row / CF::kRows, r = row - c * CF::kRows, y = y0 - 1 + r;
      const bool row_ok = y >= 0 && y < p.H;
      const bf16* src = xb + (row_ok ? static_cast<int64_t>(c * p.H + y) * p.W : 0);
      bf16* dst = stage + c * CF::kChs + r * kSCols;
      for (int s = lane; s < kSCols; s += 32) {
        const int x = x0 - 8 + s;
        dst[s] = row_ok && x >= 0 && x < p.W ? src[x] : __ushort_as_bfloat16(0);
      }
    }
  }
}

// The staged tile to channels-last, a warp a staged row of 8 channels (cb, r): `ldmatrix.trans`
// of its 8 channels x 8 columns blocks q hands a thread channels 2t, 2t + 1 of staged column
// 8 q + g, which is channels-last column 8 q + g - 7; the columns 0 .. 65 are kept.
template <typename CF>
__device__ __forceinline__ void transpose(const bf16* stage, uint8_t* cl, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int row = warp; row < (CF::kCp / 8) * CF::kRows; row += kWarps) {
    const int cb = row / CF::kRows, r = row - cb * CF::kRows;
    const bf16* src = stage + (cb * 8 + (lane & 7)) * CF::kChs + r * kSCols + 8 * (lane >> 3);
    uint8_t* dst = cl + (r * kCLW + g + 1) * CF::kPix + cb * 16 + 4 * t;  // at q = 1
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int qb = j == 2 ? 6 : 4 * j;  // blocks qb .. qb + 3; the last pass keeps 8 and 9
      uint32_t v[4];
      ldsm_x4_trans(v, src + 8 * qb);
#pragma unroll
      for (int m = j == 2 ? 2 : 0; m < 4; ++m) {
        const int q = qb + m;
        if ((q != 0 || g == 7) && (q != 9 || g == 0)) {
          *reinterpret_cast<uint32_t*>(dst + (8 * q - 8) * CF::kPix) = v[m];
        }
      }
    }
  }
}

// The products of a warp's m16 tiles over every chunk, in one order for every pixel: chunk
// (dy, j) = dy * kRC + j ascending, its hi products, then (with LO) its lo ones. A rows come
// by `ldmatrix` from the channels-last tile (lanes 0-15 address a chunk's first group, 16-31
// its second, a padded group the zero line).
//
// Row reuse (kRowReuse): the warp's column of R output rows r0 .. r0 + R - 1 reads
// channels-last rows r0 .. r0 + R + 1; each A fragment of row rr feeds output rows rr - dy
// for dy = 0, 1, 2, so a row's three dy taps load it once; B (hi) is in registers.
template <typename CF, int NT, bool LO>
__device__ __forceinline__ void products_rows(float (&acc)[CF::kMT][NT][4], uint32_t cl,
                                              uint32_t zero, const uint2 (&bh)[3][CF::kRC][NT],
                                              const uint2* wl, int warp, int lane) {
  constexpr int R = CF::kMT, RC = CF::kRC;
  const int h = lane >> 4;
  const uint32_t base =
      cl + (((warp >> 2) * R) * kCLW + (warp & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
               CF::kPix;
#pragma unroll
  for (int rr = 0; rr < R + 2; ++rr) {
    uint32_t a[RC][4];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const bool pad = 2 * j + h >= CF::kRowGroups;
      const int off = h ? row_off<CF>(2 * j + 1) : row_off<CF>(2 * j);
      ldsm_x4(a[j], pad ? zero : base + rr * kCLW * CF::kPix + off);
    }
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int u = rr - dy;
      if (u < 0 || u >= R) continue;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(acc[u][nt], a[j], bh[dy][j][nt].x, bh[dy][j][nt].y);
          if constexpr (LO) {
            const uint2 bl = wl[((dy * RC + j) * NT + nt) * 32 + lane];
            mma_bf16(acc[u][nt], a[j], bl.x, bl.y);
          }
        }
      }
    }
  }
}

// Tiles of consecutive rows: per chunk, every A fragment of the warp's tiles, then their
// products with the chunk's B fragments.
template <typename CF, int NT, bool LO>
__device__ __forceinline__ void products(float (&acc)[CF::kMT][NT][4], uint32_t cl,
                                         uint32_t zero, const uint2* wh, const uint2* wl,
                                         int warp, int lane) {
  constexpr int MT = CF::kMT;
  const int h = lane >> 4;
  uint32_t base[MT];  // shared addresses of the lane's A row at tap (0, 0), channel block 0
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    int r, mt;
    warp_tile<CF>(warp, u, r, mt);
    base[u] = cl + (r * kCLW + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * CF::kPix;
  }
#pragma unroll
  for (int kc = 0; kc < CF::kChunks; ++kc) {
    const int dy = kc / CF::kRC, gi = 2 * (kc % CF::kRC);
    const bool pad = gi + h >= CF::kRowGroups;
    const int off = dy * kCLW * CF::kPix + (h ? row_off<CF>(gi + 1) : row_off<CF>(gi));
    uint2 bh[NT], bl[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bh[nt] = wh[(kc * NT + nt) * 32 + lane];
      if constexpr (LO) bl[nt] = wl[(kc * NT + nt) * 32 + lane];
    }
    uint32_t a[MT][4];  // every A fragment of the chunk before its products
#pragma unroll
    for (int u = 0; u < MT; ++u) ldsm_x4(a[u], pad ? zero : base[u] + off);
#pragma unroll
    for (int u = 0; u < MT; ++u) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(acc[u][nt], a[u], bh[nt].x, bh[nt].y);
        if constexpr (LO) mma_bf16(acc[u][nt], a[u], bl[nt].x, bl[nt].y);
      }
    }
  }
}

template <int TH, int CP8, int NT>
__global__ void __launch_bounds__(kThreads, 2) cmconv3x3_bf16_sm90_kernel(const Params p) {
  using CF = Cfg<TH, CP8, NT>;
  constexpr int MT = CF::kMT, S = CF::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* zero = smem;                                         // 16 zero bytes
  bf16* stage = reinterpret_cast<bf16*>(smem + 16);             // S x [kCp][kChs]
  uint8_t* region = smem + 16 + S * CF::kStageBytes;            // channels-last tile / output
  uint32_t* wh = reinterpret_cast<uint32_t*>(region + CF::kRegionBytes);
  uint32_t* wl = wh + CF::kWWords;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the ring: the block's k-th tile, blockIdx.x + k * gridDim.x, is staged in slot k % S,
  // S - 1 tiles ahead; one cp.async group a tile (empty past the last)
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    const int t = blockIdx.x + k * gridDim.x;
    if (t < p.tiles) stage_tile<CF>(stage + k * (CF::kStageBytes / 2), p, t);
    cp_async_commit();
  }
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0;
  // staged channels past C: zero in every slot, for good
  const int pad_vecs = (CF::kCp - p.C) * CF::kChs / 8;
  for (int i = threadIdx.x; i < S * pad_vecs; i += kThreads) {
    const int k = i / pad_vecs;
    reinterpret_cast<uint4*>(stage + k * (CF::kStageBytes / 2) + p.C * CF::kChs)[i - k * pad_vecs] =
        make_uint4(0, 0, 0, 0);
  }

  // B fragments of chunk kc = dy * kRC + j, n-tile nt for lane (g, t): word 0 holds B[2t,
  // 2t + 1][g] (the chunk's first group, 2j), word 1 B[2t + 8, 2t + 9][g] (its second); B[k][n]
  // of group gi of row dy is w[dy][gi / CP8][(gi % CP8) * 8 + k % 8][nt * 8 + n], zero past C,
  // Co and the row's groups
  int lo_any = 0;
  for (int i = threadIdx.x; i < CF::kWWords; i += kThreads) {
    const int word = i & 1, e = i >> 1;
    const int ln = e & 31, nt = (e >> 5) % NT, kc = (e >> 5) / NT;
    const int gi = 2 * (kc % CF::kRC) + word, co = nt * 8 + (ln >> 2);
    const int tap = (kc / CF::kRC) * 3 + gi / CP8;
    bf16 hi[2], lo[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = (gi % CP8) * 8 + 2 * (ln & 3) + q;
      const float v = gi < CF::kRowGroups && co < p.Co && c < p.C
                          ? p.w[(tap * p.C + c) * p.Co + co] : 0.0f;
      split_w(v, hi[q], lo[q]);
      lo_any |= __bfloat162float(lo[q]) != 0.0f;
    }
    wh[i] = pack2(hi[0], hi[1]);
    wl[i] = pack2(lo[0], lo[1]);
  }
  // the bias of the thread's accumulator columns nt * 8 + 2t, + 1
  __nv_bfloat162 bias[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = nt * 8 + 2 * (lane & 3);
    bias[nt].x = p.bias != nullptr && co < p.Co ? p.bias[co] : __ushort_as_bfloat16(0);
    bias[nt].y = p.bias != nullptr && co + 1 < p.Co ? p.bias[co + 1] : __ushort_as_bfloat16(0);
  }
  lo_any = __syncthreads_or(lo_any);
  const uint2* whv = reinterpret_cast<const uint2*>(wh);
  const uint2* wlv = reinterpret_cast<const uint2*>(wl);
  // with row reuse, the hi B fragments of every chunk in registers for good
  uint2 bh[3][CF::kRC][CF::kRowReuse ? NT : 1];
  if constexpr (CF::kRowReuse) {
#pragma unroll
    for (int kc = 0; kc < CF::kChunks; ++kc)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) bh[kc / CF::kRC][kc % CF::kRC][nt] = whv[(kc * NT + nt) * 32 + lane];
  }

  int slot = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    cp_async_wait<S - 2>();
    __syncthreads();  // this tile is staged; the last output tile is stored
    transpose<CF>(stage + slot * (CF::kStageBytes / 2), region, warp, lane);
    __syncthreads();  // the slot is free: it takes the tile S - 1 ahead
    const int ahead = tile + (S - 1) * gridDim.x;
    if (ahead < p.tiles) {
      stage_tile<CF>(stage + (slot == 0 ? S - 1 : slot - 1) * (CF::kStageBytes / 2), p, ahead);
    }
    cp_async_commit();
    slot = slot == S - 1 ? 0 : slot + 1;

    float acc[MT][NT][4];
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][nt][q] = 0.0f;
    if constexpr (CF::kRowReuse) {
      if (lo_any) {
        products_rows<CF, NT, true>(acc, smem_addr(region), smem_addr(zero), bh, wlv, warp, lane);
      } else {
        products_rows<CF, NT, false>(acc, smem_addr(region), smem_addr(zero), bh, wlv, warp, lane);
      }
    } else if (lo_any) {
      products<CF, NT, true>(acc, smem_addr(region), smem_addr(zero), whv, wlv, warp, lane);
    } else {
      products<CF, NT, false>(acc, smem_addr(region), smem_addr(zero), whv, wlv, warp, lane);
    }
    __syncthreads();  // the channels-last tile is read: its room takes the output tile

    // out tile [r][co][kOutLd]: the sums rounded to bf16, the bias added in bf16 and rounded
    // again; stmatrix.trans writes 8 pixels of one channel a row
#pragma unroll
    for (int u = 0; u < MT; ++u) {
      int r, mt;
      warp_tile<CF>(warp, u, r, mt);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // pixels g and g + 8, channels 2t, 2t + 1; bf16 + bf16 rounds the exact sum once,
        // which for two bf16 values is bf16(float(a) + float(b))
        __nv_bfloat162 s0 = __floats2bfloat162_rn(acc[u][nt][0], acc[u][nt][1]);
        __nv_bfloat162 s1 = __floats2bfloat162_rn(acc[u][nt][2], acc[u][nt][3]);
        if (p.bias != nullptr) {
          s0 = __hadd2(s0, bias[nt]);
          s1 = __hadd2(s1, bias[nt]);
        }
        const int row = (r * CF::kCo + nt * 8 + (lane & 7)) * kOutLd + mt * 16 + ((lane >> 3) & 1) * 8;
        stsm_x2_trans(region + 2 * row, *reinterpret_cast<const uint32_t*>(&s0),
                      *reinterpret_cast<const uint32_t*>(&s1));
      }
    }
    __syncthreads();

    // 16 bytes a lane, 8 lanes a row of 64 outputs of one channel
    int b, y0, x0;
    tile_origin<CF>(p, tile, b, y0, x0);
    const bf16* ot = reinterpret_cast<const bf16*>(region);
    bf16* ob = p.out + static_cast<int64_t>(b) * p.Co * p.H * p.W;
    const int q = lane & 7, x = x0 + 8 * q;
    if (x < p.W) {
      for (int rc = 4 * warp + (lane >> 3); rc < TH * CF::kCo; rc += 4 * kWarps) {
        const int r = rc / CF::kCo, co = rc - r * CF::kCo, y = y0 + r;
        if (co >= p.Co || y >= p.H) continue;
        const bf16* src = ot + rc * kOutLd + 8 * q;
        bf16* dst = ob + static_cast<int64_t>(co * p.H + y) * p.W + x;
        if (p.vout) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          const int n = p.W - x < 8 ? p.W - x : 8;
          for (int k = 0; k < n; ++k) dst[k] = src[k];
        }
      }
    }
  }
}

template <int TH, int CP8, int NT>
cudaError_t launch(Params p, cudaStream_t stream) {
  using CF = Cfg<TH, CP8, NT>;
  auto kern = cmconv3x3_bf16_sm90_kernel<TH, CP8, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, CF::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  p.ntx = (p.W + kTW - 1) / kTW;
  p.nty = (p.H + TH - 1) / TH;
  if (static_cast<int64_t>(p.B) * p.ntx * p.nty > INT32_MAX) return cudaErrorInvalidValue;
  p.tiles = p.B * p.ntx * p.nty;
  const int grid = p.tiles < 2 * sms ? p.tiles : 2 * sms;
  kern<<<static_cast<unsigned>(grid), kThreads, CF::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// the tile rows for CP8 channel blocks and NT n-tiles (ops/cmconv_cuda.py `sm90_tile_h`
// mirrors it): as many as leave two blocks a SM a ring of at least two staged tiles (three
// where C <= 16) and a warp at most 32 accumulators
template <int CP8>
cudaError_t dispatch_nt(const Params& p, int nt, cudaStream_t s) {
  constexpr int TH1 = CP8 == 1 ? 16 : (CP8 == 2 ? 6 : 4), TH2 = CP8 == 1 ? 8 : TH1;
  constexpr int TH34 = CP8 <= 3 ? 4 : 2;
  switch (nt) {
    case 1: return launch<TH1, CP8, 1>(p, s);
    case 2: return launch<TH2, CP8, 2>(p, s);
    case 3: return launch<TH34, CP8, 3>(p, s);
    default: return launch<TH34, CP8, 4>(p, s);
  }
}

}  // namespace

// x [B, C, H, W] bf16, w [3, 3, C, Co] float32, bias [Co] bf16 or null -> out [B, Co, H, W]
// bf16 (all as raw pointers). Returns cudaErrorInvalidValue, launching nothing, unless
// 1 <= C, Co <= 32, B, H, W >= 1 and the row and tile indices fit 32 bits (C * H and the
// tile count below 2^31); otherwise launches on `stream` and returns the launch's cudaError_t.
extern "C" int mlad_cmconv3x3_bf16_sm90(const void* x, const float* w, const void* bias, int B,
                                        int C, int Co, int H, int W, void* out, void* stream) {
  if (B < 1 || C < 1 || C > 32 || Co < 1 || Co > 32 || H < 1 || W < 1 ||
      static_cast<int64_t>(C > Co ? C : Co) * (H + 8) > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{static_cast<const bf16*>(x), w, static_cast<const bf16*>(bias), static_cast<bf16*>(out),
           B, C, Co, H, W, 0, 0, 0, W % 8 == 0 && !misaligned(x), W % 8 == 0 && !misaligned(out)};
  const int cp8 = (C + 7) / 8, nt = (Co + 7) / 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cp8) {
    case 1: err = dispatch_nt<1>(p, nt, s); break;
    case 2: err = dispatch_nt<2>(p, nt, s); break;
    case 3: err = dispatch_nt<3>(p, nt, s); break;
    default: err = dispatch_nt<4>(p, nt, s); break;
  }
  return static_cast<int>(err);
}
