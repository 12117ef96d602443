// Fused frozen (eval-mode) MBConv forward in bf16, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// tools/experiments/fused_mbconv.py:212 (`pallas_call` at :263) with bf16
// inputs, the kernel bf16 mixed precision runs. It computes what
// `mbconv_plain` of mladversarialobjectdetection_torch/ops/mbconv.py computes
// for a bf16 `FoldedBlock`:
//
//   z0 = x . We + be            e = bf16(act(z0)), zero outside the image
//   z1 = bd + dwconv_kxk(e)     d = bf16(act(z1))        ('SAME', stride 1)
//   y  = bf16(d . Wp + bp [+ x])
//
// x [B, H, W, C] bf16 (NHWC, contiguous), We [C, E] and Wp [E, Co] bf16,
// be [E], wd [k, k, E], bd [E] and bp [Co] float32; C, E and Co multiples of
// 8; k 3 or 5; act relu6, relu or swish. The kernel reads We, Wp, be, bd and
// wd as one packed buffer of per-chunk slot images (ops/mbconv_cuda.py
// `sm90_pack`, made once per fold and chunk width). Every product of two
// bf16 values is exact in float32 and summed in float32; the SAME padding
// pads e, not x.
// Shapes outside that rule run the template's bf16 instance
// (mbconv_bf16.cu), which ops/mbconv_cuda.py picks by shape alone.
//
// What bounds it on an H100 (lite4 at 640, batch 24, the 25 fused blocks of a
// pass): the bf16 products take 0.416 ms at 989 TFLOP/s, the depthwise,
// biases and residual 0.522 ms on the FP32 pipe at 67 TFLOP/s, the bytes
// 0.196 ms; so the bound, 0.938 ms, is set mostly by CUDA-core work. The
// template's bf16 instance took 26.0 ms a pass: one block of 8 warps per SM
// that issued the copies, waited, multiplied and ran the depthwise in turn;
// x re-staged for every chunk of E in 32-channel pieces with two barriers a
// piece; a depthwise of one channel a lane that reloaded and converted a
// bf16 e for each of its FMAs. This design:
//
//   1. x once, weights in a ring. A block stages its image-clipped haloed x
//      tile once, by 16-byte `cp.async` copies (each staged row's offset
//      tabulated once) into a row stride that `ldmatrix` reads without bank
//      conflicts, zero-filled past C and past the region. Each chunk of EC
//      expanded channels (We[:, chunk], Wp[chunk, :], and be, bd and wd of
//      the chunk in float32) streams through a ring of STAGES slots,
//      STAGES - 1 chunks ahead: the packed buffer holds each chunk's slot
//      image, padding and zeros past E included, so one thread fills a slot
//      with one `cp.async.bulk` copy of the TMA unit that completes on the
//      slot's `mbarrier` (expect-tx), and a block waits once per chunk.
//      (Staging the weights row by row, one bulk copy a row from a producer
//      warp and then 16-byte `cp.async` copies from every thread, cost more
//      in issuing the copies than the waits saved; with no producer warp a
//      block is 8 warps whose registers are capped at 255, not 168.)
//   2. A depthwise that feeds the FP32 pipe. A thread owns a pair of E
//      channels and a run of R output pixels along W: each e word (bf16x2)
//      of a row is loaded and converted once and feeds up to k taps of R
//      outputs; the sums are float32 FMAs with float32 wd (from the slot),
//      bd first and the taps row by row.
//   3. Overlap of the two pipes and of the latencies: where a block fits in
//      128 registers a thread and 113 KB (MINB = 2), two blocks share an SM,
//      so one block's products, depthwise, staging and epilogue overlap the
//      other's. (The other way, two groups of 4 warps on alternate chunks,
//      each with its own ring and buffers, measured no faster than one group
//      at lite4's b24 shapes and slower than two blocks a SM, so it went.)
//   4. The planner (ops/mbconv_cuda.py `plan_fwd_sm90`) picks the instance
//      (tile, EC, accumulator shape, stages, blocks a SM), the warps' split
//      of the output channels and a split of E over blocks where the grid
//      would not fill the card; a split writes float32 partials that
//      `sm90_reduce_kernel` adds in split order (the pair counts as one
//      launch).
//
// The products are `mma.sync.m16n8k16` bf16 with float32 accumulators, fed
// by `ldmatrix`. The expand's k runs over C in ascending steps of 16 for
// every row, from a zero accumulator, and be is added after; the depthwise
// sums in one order. So z0 and z1 at a pixel do not depend on the tile or
// the plan that computes them, and the relu masks of a centre pixel
// are the ones its neighbours used in their halo (the property the dx
// kernel's masks rely on).

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

struct Params {
  const bf16* x;
  const uint8_t* packed;  // [ceil(E / EC)][slot_bytes]: each chunk's slot image
  const float* bp;
  bf16* out;
  float* ws;  // [split, B, H, W, Co] float32 partials, or null
  int B, H, W, C, E, Co, act, residual;
  int wn;           // warps along the output channels
  int e_per_split;  // E channels of a block (a multiple of EC)
  int nhp;          // rows of the staged x tile: the largest clipped halo region, padded to 16
};

// Shared memory, in bytes and in this order: the barriers, each staged row's
// haloed position and pixel offset (int), the x tile (bf16), the ring of
// `stages` slots, then e and d (bf16). A slot holds the chunk's We
// [round16(C)][EC + 8] and Wp [EC][round16(Co) + 8] in bf16, then be, bd and
// wd [k * k] of the chunk [EC each] in float32, zero in the padding and past
// E (so e and d are zero there). bf16 rows pad by 8 (16 bytes), which keeps
// every row 16-byte aligned and an odd number of 16-byte units long:
// ldmatrix's 8 rows fall in 8 distinct bank groups.
__host__ __device__ constexpr int ld_x(int c) { return round16(c) + 8; }
__host__ __device__ constexpr int ld_p(int co) { return round16(co) + 8; }
__host__ __device__ constexpr size_t slot_bytes(int k, int c, int co, int ec) {
  return 2 * (static_cast<size_t>(round16(c)) * (ec + 8) + static_cast<size_t>(ec) * ld_p(co)) +
         4 * static_cast<size_t>(2 + k * k) * ec;
}
__host__ __device__ constexpr size_t smem_bytes(int k, int th, int tw, int ec, int stages, int c,
                                                int co, int nhp) {
  return kBarBytes + 8 * static_cast<size_t>(nhp) + 2 * static_cast<size_t>(nhp) * ld_x(c) +
         stages * slot_bytes(k, c, co, ec) +
         2 * static_cast<size_t>(ec + 8) * ((th + k - 1) * (tw + k - 1) + round16(th * tw));
}

// One block: the output tile TH x TW of one image, all Co output channels,
// E channels [split * e_per_split, ...) in chunks of EC through a ring of
// STAGES slots; each warp's share of the project's sum is MPW m-tiles (16
// pixels) by NPW n-tiles (8 channels), the 8 warps laid out WM x WN (WN =
// p.wn at run time) over them. MINB blocks share an SM (2: registers
// capped at 128 and at most 113 KB of shared memory a block).
template <int K, int TH, int TW, int EC, int MPW, int NPW, int STAGES, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) mbconv_fwd_sm90_kernel(const Params p) {
  constexpr int h = K / 2;
  constexpr int FW = TW + 2 * h, FNH = (TH + 2 * h) * FW;  // the haloed tile
  constexpr int TP = TH * TW, MTP = (TP + 15) / 16, TPP = MTP * 16;
  constexpr int LE = EC + 8, LW = EC + 8;                  // e / d rows, We rows
  constexpr int NG = EC / 32;                              // the expand's n-groups of 4 n-tiles
  constexpr int NPAIR = EC / 2;                            // channel pairs of a chunk
  // the depthwise's run of outputs along W: 8, or 4 where 8 leaves threads idle
  constexpr int R = (NPAIR * TH * (TW / 8) >= kThreads) ? 8 : 4;
  constexpr int NRUN = TW / R;
  static_assert(TW % 8 == 0 && TP % 16 == 0 && EC % 32 == 0, "tile and chunk shapes");
  static_assert(STAGES * 8 <= kBarBytes, "the barriers' room");

  extern __shared__ __align__(128) uint8_t smem[];
  const int H = p.H, W = p.W, C = p.C, E = p.E, Co = p.Co;
  const int LX = ld_x(C), LP = ld_p(Co), C16 = round16(C);
  const int slot = static_cast<int>(slot_bytes(K, C, Co, EC));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [STAGES]
  int* s_pos = reinterpret_cast<int*>(smem + kBarBytes);
  int* s_off = s_pos + p.nhp;  // a staged row's pixel in the image, or -1
  bf16* s_x = reinterpret_cast<bf16*>(s_off + p.nhp);
  uint8_t* ring = reinterpret_cast<uint8_t*>(s_x + p.nhp * LX);
  bf16* s_e = reinterpret_cast<bf16*>(ring + STAGES * slot);
  bf16* s_d = s_e + FNH * LE;

  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int img = blockIdx.y, split = blockIdx.z;
  const int e_begin = split * p.e_per_split, e_end = min(E, e_begin + p.e_per_split);
  const int n_chunks = (e_end - e_begin + EC - 1) / EC;
  // the image-clipped region of the haloed tile: rows [ry0, ry0 + ny), columns [rx0, rx0 + nx)
  const int ry0 = max(ty0 - h, 0), rx0 = max(tx0 - h, 0);
  const int ny = min(ty0 + TH + h, H) - ry0, nx = min(tx0 + TW + h, W) - rx0;
  const int n_rows = ny * nx;
  const int64_t img_px = static_cast<int64_t>(img) * H * W;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool swish = p.act == kSwish;
  const float hi = p.act == kRelu6 ? 6.0f : __int_as_float(0x7f800000);  // the clamp's top

  // e outside the image stays zero; each staged row's haloed position and
  // pixel offset; the barriers, each filled by one bulk copy
  for (uint4* q = reinterpret_cast<uint4*>(s_e) + threadIdx.x;
       q < reinterpret_cast<uint4*>(s_d); q += kThreads) {
    *q = make_uint4(0, 0, 0, 0);
  }
  for (int r = threadIdx.x; r < p.nhp; r += kThreads) {
    const bool in = r < n_rows;
    const int ry = ry0 + (in ? r / nx : 0), rx = rx0 + (in ? r % nx : 0);
    s_pos[r] = in ? (ry - ty0 + h) * FW + rx - tx0 + h : -1;
    s_off[r] = in ? ry * W + rx : -1;
  }
  if (threadIdx.x == 0) {
    for (int b = 0; b < STAGES; ++b) mbar_init(&full[b], 1);
    fence_barrier_init();
  }
  __syncthreads();  // the tables and the barriers are set up
  // the x tile in 16-byte pieces of 8 channels, piece i = r * per_row + q
  // stepping by kThreads: zero past C and past the region
  {
    const int per_row = C16 / 8, dr = kThreads / per_row, dq = kThreads % per_row;
    for (int r = threadIdx.x / per_row, q = threadIdx.x % per_row; r < p.nhp;) {
      const int off = s_off[r], c = q * 8;
      const bool ok = off >= 0 && c < C;
      cp_async16(s_x + r * LX + c, ok ? p.x + (img_px + off) * C + c : p.x, ok);
      r += dr;
      q += dq;
      if (q >= per_row) {
        q -= per_row;
        ++r;
      }
    }
  }

  // chunk j (of this split) goes to slot j % STAGES, one bulk copy
  const uint8_t* packed = p.packed + static_cast<int64_t>(e_begin / EC) * slot;
  const auto fill = [&](int j) {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&full[j % STAGES], slot);
      bulk_copy(ring + (j % STAGES) * slot, packed + static_cast<int64_t>(j) * slot, slot,
                &full[j % STAGES]);
    }
  };
  for (int j = 0; j < STAGES - 1 && j < n_chunks; ++j) fill(j);
  cp_async_wait_all();  // this thread's x pieces have landed
  __syncthreads();      // and every thread's: the x tile is whole

  const int WN = p.wn, WM = kWarps / WN, wm = warp / WN, wn = warp % WN;
  const int NT = Co / 8;
  const uint32_t* e_words = reinterpret_cast<const uint32_t*>(s_e);
  uint32_t* d_words = reinterpret_cast<uint32_t*>(s_d);

  float acc[MPW][NPW][4];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  const int mte = (n_rows + 15) / 16;  // the expand's m-tiles
  for (int j = 0; j < n_chunks; ++j) {
    const int ev = min(EC, e_end - e_begin - j * EC);  // the chunk's channels
    // every thread is past the project of chunk j - 1: its slot takes chunk
    // j + STAGES - 1, a whole chunk ahead
    __syncthreads();
    if (j + STAGES - 1 < n_chunks) fill(j + STAGES - 1);
    mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
    const uint8_t* sl = ring + (j % STAGES) * slot;
    const bf16* sw = reinterpret_cast<const bf16*>(sl);
    const bf16* sp = sw + C16 * LW;
    const float* s_be = reinterpret_cast<const float*>(sp + EC * LP);
    const float* s_bd = s_be + EC;
    const float* s_wd = s_bd + EC;

    // (1) z0 = x . We on the staged rows, in units of one m-tile by 4 n-tiles;
    // e = act(z0 + be) into the haloed layout (0 past E: its We, be are 0)
    for (int u = warp; u < mte * NG; u += kWarps) {
      const int mt = u / NG, ng = u % NG;
      float2 bias[4];  // be of this lane's columns
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        bias[jj] = *reinterpret_cast<const float2*>(s_be + ng * 32 + jj * 8 + 2 * tig);
      }
      float z[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) z[jj][r] = 0.0f;
      const bf16* a_ptr = s_x + (mt * 16 + (lane & 15)) * LX + (lane >> 4) * 8;
      const bf16* b_ptr = sw + (lane & 15) * LW + ng * 32 + (lane >> 4) * 8;
#pragma unroll 2
      for (int k0 = 0; k0 < C16; k0 += 16) {
        uint32_t a[4], b0[4], b1[4];
        ldsm_x4(a, a_ptr + k0);
        ldsm_x4_trans(b0, b_ptr + k0 * LW);
        ldsm_x4_trans(b1, b_ptr + k0 * LW + 16);
        mma_bf16(z[0], a, b0[0], b0[1]);
        mma_bf16(z[1], a, b0[2], b0[3]);
        mma_bf16(z[2], a, b1[0], b1[1]);
        mma_bf16(z[3], a, b1[2], b1[3]);
      }
      const auto store_e = [&](auto swish_tag) {
        constexpr bool SW = decltype(swish_tag)::value;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + gid + 8 * half;
          if (r >= n_rows) continue;
          uint32_t* e_row = reinterpret_cast<uint32_t*>(s_e + s_pos[r] * LE);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int col = ng * 32 + jj * 8 + 2 * tig;
            e_row[col / 2] = pack_bf16(act_fn<SW>(z[jj][2 * half] + bias[jj].x, hi),
                                       act_fn<SW>(z[jj][2 * half + 1] + bias[jj].y, hi));
          }
        }
      };
      if (swish) {
        store_e(std::true_type{});
      } else {
        store_e(std::false_type{});
      }
    }
    __syncthreads();

    // (2) d = act(bd + the depthwise of e): a thread takes a channel pair and
    // a run of R outputs of one row; each e word of a row is converted once
    for (int it = threadIdx.x; it < NPAIR * TH * NRUN; it += kThreads) {
      const int pr = it % NPAIR, rest = it / NPAIR;
      const int run = rest % NRUN, qy = rest / NRUN;
      const int col = 2 * pr;
      const float2 bias = *reinterpret_cast<const float2*>(s_bd + col);
      float s0[R], s1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s0[r] = bias.x;
        s1[r] = bias.y;
      }
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const uint32_t* row = e_words + ((qy + ky) * FW + run * R) * (LE / 2) + pr;
        float v0[R + K - 1], v1[R + K - 1];
#pragma unroll
        for (int c = 0; c < R + K - 1; ++c) {
          const uint32_t w = row[c * (LE / 2)];
          v0[c] = lo_f(w);
          v1[c] = hi_f(w);
        }
        float2 wk[K];
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          wk[kx] = *reinterpret_cast<const float2*>(s_wd + (ky * K + kx) * EC + col);
        }
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s0[r] = fmaf(v0[r + kx], wk[kx].x, s0[r]);
            s1[r] = fmaf(v1[r + kx], wk[kx].y, s1[r]);
          }
        }
      }
      const auto store_d = [&](auto swish_tag) {
        constexpr bool SW = decltype(swish_tag)::value;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int q = qy * TW + run * R + r;
          d_words[q * (LE / 2) + pr] = pack_bf16(act_fn<SW>(s0[r], hi), act_fn<SW>(s1[r], hi));
        }
      };
      if (swish) {
        store_d(std::true_type{});
      } else {
        store_d(std::false_type{});
      }
    }
    __syncthreads();

    // (3) the project into the accumulator registers: k over the chunk's
    // channels in steps of 16, two n-tiles per ldmatrix
    for (int k0 = 0; k0 < ev; k0 += 16) {
      uint32_t a[MPW][4];
#pragma unroll
      for (int i2 = 0; i2 < MPW; ++i2) {
        const int m = wm + WM * i2;
        if (m < MTP) ldsm_x4(a[i2], s_d + (m * 16 + (lane & 15)) * LE + k0 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < NPW; jj += 2) {
        const int na = wn + WN * jj, nb = wn + WN * (jj + 1);
        if (na >= NT) continue;
        const bool two = jj + 1 < NPW && nb < NT;
        uint32_t b[4];
        ldsm_x4_trans(b, sp + (k0 + (lane & 15)) * LP + ((lane >> 4) && two ? nb : na) * 8);
#pragma unroll
        for (int i2 = 0; i2 < MPW; ++i2) {
          if (wm + WM * i2 >= MTP) continue;
          mma_bf16(acc[i2][jj], a[i2], b[0], b[1]);
          if (jj + 1 < NPW && two) mma_bf16(acc[i2][jj + 1], a[i2], b[2], b[3]);
        }
      }
    }
  }

  // y = acc + bp [+ x], rounded once; with a split, the float32 partial
  const bool whole = gridDim.z == 1;
  float2 bias[NPW];  // bp of this lane's columns
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    const int n = wn + WN * j;
    bias[j] = whole && n < NT ? __ldg(reinterpret_cast<const float2*>(p.bp + n * 8 + 2 * tig))
                              : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
    const int m = wm + WM * i;
    if (m >= MTP) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = m * 16 + gid + 8 * half;
      const int y = ty0 + q / TW, xx = tx0 + q % TW;
      if (y >= H || xx >= W) continue;
      const int64_t pix = img_px + static_cast<int64_t>(y) * W + xx;
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int n = wn + WN * j;
        if (n >= NT) continue;
        const int o = n * 8 + 2 * tig;
        float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (whole) {
          v0 += bias[j].x;
          v1 += bias[j].y;
          if (p.residual) {  // x of the pixel, from the staged tile
            const int row = (y - ry0) * nx + xx - rx0;
            const uint32_t xr = *reinterpret_cast<const uint32_t*>(s_x + row * LX + o);
            v0 += lo_f(xr);
            v1 += hi_f(xr);
          }
          *reinterpret_cast<uint32_t*>(p.out + pix * Co + o) = pack_bf16(v0, v1);
        } else {
          *reinterpret_cast<float2*>(p.ws + (static_cast<int64_t>(split) * p.B * H * W + pix) *
                                                Co + o) = make_float2(v0, v1);
        }
      }
    }
  }
}

// out[i] = the n_split partials of ws in split order + bp[i % Co] [+ x[i]],
// rounded to bf16 once: the deterministic reduction of a split of E
__global__ void __launch_bounds__(256) sm90_reduce_kernel(const float* __restrict__ ws,
                                                          int n_split, int64_t n, int co,
                                                          const float* __restrict__ bp,
                                                          const bf16* __restrict__ res,
                                                          bf16* __restrict__ out) {
  for (int64_t i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    float v = ws[i];
    for (int s = 1; s < n_split; ++s) v += ws[s * n + i];
    v += __ldg(bp + i % co);
    if (res != nullptr) v += __bfloat162float(res[i]);
    out[i] = __float2bfloat16_rn(v);
  }
}

// ------------------------------------------------------------------ host

// The instances built, (TH, TW, EC, MPW, NPW, STAGES, MINB): the planner of
// ops/mbconv_cuda.py lists the same (`SM90_CONFIGS`).
#define MLAD_SM90_CONFIGS(X)                                                  \
  X(16, 16, 32, 2, 4, 3, 2) X(16, 8, 32, 1, 7, 3, 2) X(8, 8, 32, 4, 3, 2, 2)  \
  X(8, 8, 64, 4, 3, 2, 1) X(8, 8, 32, 4, 7, 2, 1)

// The largest image-clipped halo region of a th x tw tile, padded to 16 rows.
int region_rows(int H, int W, int th, int tw, int k) {
  const int h = k / 2;
  int my = 0, mx = 0;
  for (int y = 0; y < H; y += th) my = std::max(my, std::min(y + th + h, H) - std::max(y - h, 0));
  for (int x = 0; x < W; x += tw) mx = std::max(mx, std::min(x + tw + h, W) - std::max(x - h, 0));
  return round16(my * mx);
}

template <int K, int TH, int TW, int EC, int MPW, int NPW, int STAGES, int MINB>
cudaError_t run(Params p, int split, cudaStream_t stream) {
  const int nt = p.Co / 8, mtp = (TH * TW + 15) / 16;
  if (p.wn < 1 || kWarps % p.wn != 0) return cudaErrorInvalidValue;
  const int wm = kWarps / p.wn;
  if ((nt + p.wn - 1) / p.wn > NPW || (mtp + wm - 1) / wm > MPW) return cudaErrorInvalidValue;
  if (p.e_per_split % EC != 0 || p.e_per_split < EC ||
      static_cast<int64_t>(split) * p.e_per_split < p.E ||
      static_cast<int64_t>(split - 1) * p.e_per_split >= p.E) {
    return cudaErrorInvalidValue;
  }
  p.nhp = region_rows(p.H, p.W, TH, TW, K);
  const size_t smem = smem_bytes(K, TH, TW, EC, STAGES, p.C, p.Co, p.nhp);
  if (smem > (MINB == 1 ? kMaxSmem : kMaxSmem2)) return cudaErrorInvalidValue;
  auto kern = mbconv_fwd_sm90_kernel<K, TH, TW, EC, MPW, NPW, STAGES, MINB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((p.H + TH - 1) / TH) * ((p.W + TW - 1) / TW), p.B, split);
  kern<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const int64_t n = static_cast<int64_t>(p.B) * p.H * p.W * p.Co;
  const int64_t blocks = (n + 255) / 256;
  sm90_reduce_kernel<<<static_cast<int>(blocks < 1056 ? blocks : 1056), 256, 0, stream>>>(
      p.ws, split, n, p.Co, p.bp, p.residual ? p.x : nullptr, p.out);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(const Params& p, int th, int tw, int ec, int npw, int split,
                     cudaStream_t stream) {
#define MLAD_TRY(TH, TW, EC, MPW, NPW, S, MINB)                       \
  if (th == TH && tw == TW && ec == EC && npw == NPW) {              \
    return run<K, TH, TW, EC, MPW, NPW, S, MINB>(p, split, stream);  \
  }
  MLAD_SM90_CONFIGS(MLAD_TRY)
#undef MLAD_TRY
  return cudaErrorInvalidValue;  // no such instance
}

}  // namespace

// act: 0 relu6, 1 relu, 2 swish. packed: `sm90_pack` of the fold at the
// plan's ec. The plan (th, tw, ec, npw, wn, split, e_per_split) comes from
// ops/mbconv_cuda.py `plan_fwd_sm90`; ws is a
// [split, B, H, W, Co] float32 workspace, null when split is 1. Returns a
// cudaError_t: 1 (invalid value) for arguments or a plan the kernel does not
// take, without launching.
extern "C" int mlad_mbconv_fwd_sm90(const void* x, const void* packed, const float* bp, int B,
                                    int H, int W, int C, int E, int Co,
                                    int k, int act, int residual, int th, int tw, int ec,
                                    int npw, int wn, int split, int e_per_split, void* out,
                                    float* ws, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 8 || E < 8 || Co < 8 || C % 8 || E % 8 ||
      Co % 8 || (k != 3 && k != 5) || act < kRelu6 || act > kSwish || (residual && C != Co) ||
      split < 1 || split > kMaxSplit || (split > 1 && ws == nullptr) ||
      static_cast<int64_t>(B) * H * W * (C > Co ? C : Co) > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const void* ptr : {x, packed, static_cast<const void*>(bp), static_cast<const void*>(out),
                          static_cast<const void*>(ws)}) {
    if (misaligned(ptr)) return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed), bp,
           static_cast<bf16*>(out), ws, B, H, W, C, E, Co, act, residual, wn, e_per_split, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = k == 3 ? dispatch<3>(p, th, tw, ec, npw, split, s)
                                 : dispatch<5>(p, th, tw, ec, npw, split, s);
  return static_cast<int>(err);
}
