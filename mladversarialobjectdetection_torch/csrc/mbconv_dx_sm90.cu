// Input gradient of the fused frozen (eval-mode) MBConv block in bf16, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of tools/experiments/fused_mbconv.py:282
// (`pallas_call` at :382) with bf16 inputs, the kernel bf16 mixed precision runs. It computes
// what `mbconv_dx_plain` of mladversarialobjectdetection_torch/ops/mbconv.py computes for a bf16
// `FoldedBlock`, given g = dL/dy:
//
//   z0 = x . We + be            e  = bf16(act(z0)), zero outside the image
//   z1 = bd + dwconv_kxk(e)     gd = bf16((g . Wp^T) * act'(z1))     ('SAME', stride 1)
//   ge = dwconv^T(gd) * act'(z0), rounded to bf16 as the last product reads it
//   dx = bf16(ge . We^T [+ g])
//
// x [B, H, W, C] and g [B, H, W, Co] bf16 (NHWC, contiguous); C, E and Co multiples of 8; k 3
// or 5; act relu6, relu or swish. The kernel reads We, Wp, be, bd and wd as the packed per-chunk
// slot images of the Hopper forward (ops/mbconv_cuda.py `sm90_pack`, made once per fold and
// chunk width): the slot's We [C][chunk] rows feed the expand through `ldmatrix.trans` and the
// last product ge . We^T through `ldmatrix`, its Wp [chunk][Co] rows g . Wp^T through `ldmatrix`.
// The rounding points are the template's bf16 instance's (mbconv.cu note 9). Shapes outside
// that rule run the template's bf16 instance (mbconv_bf16_dx.cu), which ops/mbconv_cuda.py picks
// by shape alone.
//
// What bounds it on an H100 (lite4 at 640, batch 24, the 25 fused blocks of a pass): the bf16
// products take 0.620 ms at 989 TFLOP/s, the two depthwise passes, act' and the residual 1.037
// ms on the FP32 pipe at 67 TFLOP/s, the bytes little; so the bound, 1.657 ms, is set mostly by
// CUDA-core work. The template's bf16 instance took 61.7 ms a pass: for every 32 channels of E
// it re-staged the 2h-haloed x tile and then the h-haloed g tile over all of C and Co in
// pieces, two barriers a piece; one block of 8 warps per SM that issued the copies, waited and
// computed in turn; both depthwise passes one E channel a lane, reloading and converting a bf16
// value for each FMA. This design:
//
//   1. x and g once. A block stages its image-clipped x tile with a halo of 2h and its g tile
//      with a halo of h once, by 16-byte `cp.async` copies (each staged row's offset tabulated
//      once) into row strides that `ldmatrix` reads without bank conflicts, zero past C (Co) and
//      past the region. A 4x8 output tile keeps both in 227 KB at lite4's widest shapes.
//   2. Weights through a ring. Each chunk of EC expanded channels (its slot image) streams
//      through a ring of STAGES slots, filled by one thread with one `cp.async.bulk` copy of the
//      TMA unit that completes on the slot's expect-tx `mbarrier`; a block waits once per chunk.
//      The copy of chunk j + STAGES starts once every thread is past chunk j's last product.
//   3. Depthwise passes that feed the FP32 pipe. In the z1 recompute and in the transpose a
//      thread owns a pair of E channels and a run of R output pixels along W: each e word
//      (bf16x2) or gd pair of a row is loaded (and converted) once and feeds every tap that reads
//      it; float32 FMAs with float32 wd from the slot, in one fixed order.
//   4. The dx sum (the tile's pixels by all of C) stays in `mma.sync.m16n8k16` registers across
//      the whole E loop. A block is 16 warps (128 registers a thread), or 8 where two blocks
//      share an SM (128 registers and 113 KB each), so that more warps hide the latencies of
//      each phase.
//   5. The planner (ops/mbconv_cuda.py `plan_dx_sm90`) picks the instance (tile, EC,
//      accumulator shape, stages, blocks a SM, warps), the warps' split of C and a split of E
//      over blocks where the grid would not fill the card; a split writes float32 partials that
//      `dx_reduce_kernel` adds in split order (the pair counts as one launch).
//
// Per chunk j, behind three barriers: (B) z1 on the h-haloed pixels inside the image, gd =
// bf16((g . Wp^T) * act'(z1)) in place of g . Wp^T; (C) ge = bf16(dwconv^T(gd) * act'(z0)) on
// the centre; then in one phase (D) dx += ge . We^T beside (A) of chunk j + 1: z0 = x . We on the
// staged x rows, e = bf16(act(z0)) into the 2h-haloed layout and act'(z0) of the centre pixels,
// and g . Wp^T on the staged g rows (float32). The expand's k runs over C in ascending steps of
// 16 from a zero accumulator and be is added after, as in the Hopper forward; z1 sums bd first,
// then the taps row by row. So z0 and z1 at a pixel do not depend on the tile or the plan, and a
// centre pixel's relu masks are the ones its neighbours use in their halos. Given `masks`, the
// kernel writes act'(z0) != 0 and act'(z1) != 0 of its centre pixels as bytes [2][B, H, W, E]
// (relu6 / relu), so that dx can be held to `mbconv_dx_plain(masks=...)`.
//
// Where the time goes (clock64 stamps in a copy of this kernel, lite4's b24 shapes, H100): a
// chunk's (A)+(D) 55-65%, bound by the shared-memory traffic of the mma.sync fragments (each
// m-tile re-reads the We fragments); (B) 20-40% and (C) about 10%, latency-bound with one block
// an SM; the ring's waits about 3% (the bulk copies land in time) and the barriers under 1%.
// Tried and not kept: units of two m-tiles in (A), which share the We fragments (2% faster at
// 40x40 C160, 5-13% slower at the 20x20 and 40x40 C112 shapes, spilling under the 128-register
// cap; four m-tiles slower everywhere), and (A) transposed so that one We^T fragment serves four
// pixel n-tiles (its epilogue's single-element stores cost more than the reuse saved).

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

// act'(z): swish's derivative, or 1 inside the clamp's open interval (0, hi) and 0 elsewhere
template <bool SWISH>
__device__ __forceinline__ float dact_fn(float z, float hi) {
  if constexpr (SWISH) {
    const float s = 1.0f / (1.0f + expf(-z));
    return s * (1.0f + z * (1.0f - s));
  } else {
    return (z > 0.0f && z < hi) ? 1.0f : 0.0f;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The run of outputs along a row that a depthwise thread takes: a divisor of the row's `width`
// of at most 8, the one with the least work for the busiest of `threads` (rounds of items times
// the loads and FMAs of one), the longest among equals.
__host__ __device__ constexpr int run_len(int width, int rows_by_pairs, int k, int threads) {
  int best = 1;
  long long best_cost = -1;
  for (int r = 1; r <= 8 && r <= width; ++r) {
    if (width % r != 0) continue;
    const long long rounds = (static_cast<long long>(rows_by_pairs) * (width / r) + threads - 1) /
                             threads;
    const long long cost = rounds * k * (r + k - 1 + 2 * r * k);
    if (best_cost < 0 || cost <= best_cost) {
      best = r;
      best_cost = cost;
    }
  }
  return best;
}

struct Params {
  const bf16* x;
  const bf16* g;
  const uint8_t* packed;  // [ceil(E / EC)][slot_bytes]: each chunk's slot image (`sm90_pack`)
  bf16* out;
  float* ws;        // [split, B, H, W, C] float32 partials, or null
  uint8_t* masks;   // [2][B, H, W, E] act'(z0) != 0, act'(z1) != 0, or null
  int B, H, W, C, E, Co, act, residual;
  int wn;           // warps along the output channels
  int e_per_split;  // E channels of a block (a multiple of EC)
  int n2p, n1p;     // rows of the staged x tile (halo 2h) and g tile (halo h), padded to 16
};

// Shared memory, in bytes and in this order: the barriers; each staged x row's position in the
// e layout and pixel offset, then each staged g row's (int); the x tile [n2p][C16 + 8] and the g
// tile [n1p][Co16 + 8] (bf16); the ring of `stages` slots (`sm90_pack`'s layout: We
// [C16][EC + 8] and Wp [EC][Co16 + 8] bf16, then be, bd and wd [k * k] of the chunk in float32);
// e on the tile with a halo of 2h [(TH + 4h)(TW + 4h)][EC + 8] (bf16); act'(z1), then gd, on the
// tile with a halo of h [(TH + 2h)(TW + 2h)][EC + 4] (float32); act'(z0) of the centre
// [TH TW][EC + 4] (float32); ge [TH TW][EC + 8] (bf16). bf16 rows pad by 8 (16 bytes): 16-byte
// aligned and an odd number of 16-byte units long, so ldmatrix's 8 rows fall in 8 bank groups.
__host__ __device__ constexpr int ld_x(int c) { return round16(c) + 8; }
__host__ __device__ constexpr size_t slot_bytes(int k, int c, int co, int ec) {
  return 2 * (static_cast<size_t>(round16(c)) * (ec + 8) + static_cast<size_t>(ec) * ld_x(co)) +
         4 * static_cast<size_t>(2 + k * k) * ec;
}
__host__ __device__ constexpr size_t smem_bytes(int k, int th, int tw, int ec, int stages, int c,
                                                int co, int n2p, int n1p) {
  return kBarBytes + 8 * static_cast<size_t>(n2p + n1p) +
         2 * (static_cast<size_t>(n2p) * ld_x(c) + static_cast<size_t>(n1p) * ld_x(co)) +
         stages * slot_bytes(k, c, co, ec) +
         2 * static_cast<size_t>(ec + 8) * ((th + 4 * (k / 2)) * (tw + 4 * (k / 2)) + th * tw) +
         4 * static_cast<size_t>(ec + 4) * ((th + 2 * (k / 2)) * (tw + 2 * (k / 2)) + th * tw);
}

// Stage rows [0, n_rows_padded) of a tile, 16-byte pieces of 8 channels, piece i = r * per_row +
// q stepping by NT threads: row r from the pixel at off[r] (or zero where off[r] < 0), zero past
// n_ch channels.
template <int NT>
__device__ __forceinline__ void stage_tile(bf16* dst, int ld, int n_rows, int n_ch,
                                           const bf16* src, int64_t img_px, const int* off) {
  const int per_row = round16(n_ch) / 8, dr = NT / per_row, dq = NT % per_row;
  for (int r = threadIdx.x / per_row, q = threadIdx.x % per_row; r < n_rows;) {
    const int o = off[r], c = q * 8;
    const bool ok = o >= 0 && c < n_ch;
    cp_async16(dst + r * ld + c, ok ? src + (img_px + o) * n_ch + c : src, ok);
    r += dr;
    q += dq;
    if (q >= per_row) {
      q -= per_row;
      ++r;
    }
  }
}

// One block of NW warps: the output tile TH x TW of one image, all C output channels, E channels
// [split * e_per_split, ...) in chunks of EC through a ring of STAGES slots; each warp's share of
// the dx sum is MPW m-tiles (16 pixels) by NPW n-tiles (8 channels), the warps laid out WM x WN
// (WN = p.wn at run time) over them. MINB blocks share an SM; the registers are capped at 65536
// over MINB * NW * 32 threads (128 with 16 warps, or with two blocks of 8), and two blocks have
// at most 113 KB of shared memory each.
template <int K, int TH, int TW, int EC, int MPW, int NPW, int STAGES, int MINB, int NW>
__global__ void __launch_bounds__(32 * NW, MINB) mbconv_dx_sm90_kernel(const Params p) {
  constexpr int kWarps = NW, kThreads = 32 * NW;
  constexpr int h = K / 2;
  constexpr int F2W = TW + 4 * h, F2 = (TH + 4 * h) * F2W;  // e: a halo of 2h
  constexpr int F1H = TH + 2 * h, F1W = TW + 2 * h, F1 = F1H * F1W;  // act'(z1), gd: a halo of h
  constexpr int TP = TH * TW, MTP = TP / 16;
  constexpr int LE = EC + 8, LF = EC + 4, LW = EC + 8;  // e / ge rows, float rows, We rows
  constexpr int GN = EC >= 32 ? 4 : EC / 8;  // n-tiles of a unit of the expand and of g . Wp^T
  constexpr int NG = EC / (8 * GN);
  constexpr int NPAIR = EC / 2;  // channel pairs of a chunk
  constexpr int R1 = run_len(F1W, NPAIR * F1H, K, kThreads), NR1 = F1W / R1;  // the z1 pass's runs
  constexpr int R2 = 4, NR2 = TW / R2;  // the transpose's runs
  static_assert(TP % 16 == 0 && TW % R2 == 0 && EC % 16 == 0 && GN % 2 == 0 && NG * GN * 8 == EC,
                "tile and chunk shapes");
  static_assert(STAGES * 8 <= kBarBytes, "the barriers' room");

  extern __shared__ __align__(128) uint8_t smem[];
  const int H = p.H, W = p.W, C = p.C, E = p.E, Co = p.Co;
  const int LX = ld_x(C), LG = ld_x(Co), LP = ld_x(Co), C16 = round16(C), Co16 = round16(Co);
  const int slot = static_cast<int>(slot_bytes(K, C, Co, EC));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [STAGES]
  int* s_pos2 = reinterpret_cast<int*>(smem + kBarBytes);
  int* s_off2 = s_pos2 + p.n2p;  // a staged x row's pixel in the image, or -1
  int* s_pos1 = s_off2 + p.n2p;
  int* s_off1 = s_pos1 + p.n1p;  // a staged g row's pixel in the image, or -1
  bf16* s_x = reinterpret_cast<bf16*>(s_off1 + p.n1p);
  bf16* s_g = s_x + p.n2p * LX;
  uint8_t* ring = reinterpret_cast<uint8_t*>(s_g + p.n1p * LG);
  bf16* s_e = reinterpret_cast<bf16*>(ring + STAGES * slot);
  bf16* s_ge = s_e + F2 * LE;
  float* s_f = reinterpret_cast<float*>(s_ge + TP * LE);  // act'(z1), then gd
  float* s_dz0 = s_f + F1 * LF;
  float* s_end = s_dz0 + TP * LF;

  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int img = blockIdx.y, split = blockIdx.z;
  const int e_begin = split * p.e_per_split, e_end = min(E, e_begin + p.e_per_split);
  const int n_chunks = (e_end - e_begin + EC - 1) / EC;
  // the image-clipped regions: x with a halo of 2h, g with a halo of h
  const int ry2 = max(ty0 - 2 * h, 0), rx2 = max(tx0 - 2 * h, 0);
  const int nx2 = min(tx0 + TW + 2 * h, W) - rx2;
  const int n2 = (min(ty0 + TH + 2 * h, H) - ry2) * nx2;
  const int ry1 = max(ty0 - h, 0), rx1 = max(tx0 - h, 0);
  const int nx1 = min(tx0 + TW + h, W) - rx1;
  const int n1 = (min(ty0 + TH + h, H) - ry1) * nx1;
  const int64_t img_px = static_cast<int64_t>(img) * H * W;
  const int64_t plane = static_cast<int64_t>(p.B) * H * W * E;  // one mask of [2][B, H, W, E]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool swish = p.act == kSwish;
  const float hi = p.act == kRelu6 ? 6.0f : __int_as_float(0x7f800000);  // the clamp's top

  // e, ge, act'(z1) / gd and act'(z0) start at zero (outside the image they stay zero); the
  // staged rows' positions and offsets; the barriers, each filled by one bulk copy
  for (uint4* q = reinterpret_cast<uint4*>(s_e) + threadIdx.x; q < reinterpret_cast<uint4*>(s_end);
       q += kThreads) {
    *q = make_uint4(0, 0, 0, 0);
  }
  for (int r = threadIdx.x; r < p.n2p; r += kThreads) {
    const bool in = r < n2;
    const int ry = ry2 + (in ? r / nx2 : 0), rx = rx2 + (in ? r % nx2 : 0);
    s_pos2[r] = in ? (ry - ty0 + 2 * h) * F2W + rx - tx0 + 2 * h : -1;
    s_off2[r] = in ? ry * W + rx : -1;
  }
  for (int r = threadIdx.x; r < p.n1p; r += kThreads) {
    const bool in = r < n1;
    const int ry = ry1 + (in ? r / nx1 : 0), rx = rx1 + (in ? r % nx1 : 0);
    s_pos1[r] = in ? (ry - ty0 + h) * F1W + rx - tx0 + h : -1;
    s_off1[r] = in ? ry * W + rx : -1;
  }
  if (threadIdx.x == 0) {
    for (int b = 0; b < STAGES; ++b) mbar_init(&full[b], 1);
    fence_barrier_init();
  }
  __syncthreads();  // the tables and the barriers are set up
  stage_tile<kThreads>(s_x, LX, p.n2p, C, p.x, img_px, s_off2);
  stage_tile<kThreads>(s_g, LG, p.n1p, Co, p.g, img_px, s_off1);

  // chunk j (of this split) goes to slot j % STAGES, one bulk copy
  const uint8_t* packed = p.packed + static_cast<int64_t>(e_begin / EC) * slot;
  const auto fill = [&](int j) {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&full[j % STAGES], slot);
      bulk_copy(ring + (j % STAGES) * slot, packed + static_cast<int64_t>(j) * slot, slot,
                &full[j % STAGES]);
    }
  };
  for (int j = 0; j < STAGES && j < n_chunks; ++j) fill(j);
  cp_async_wait_all();  // this thread's x and g pieces have landed
  __syncthreads();      // and every thread's: the tiles are whole

  const int WN = p.wn, WM = kWarps / WN, wm = warp / WN, wn = warp % WN;
  const int NT = C / 8;
  const uint32_t* e_words = reinterpret_cast<const uint32_t*>(s_e);
  uint32_t* ge_words = reinterpret_cast<uint32_t*>(s_ge);

  float acc[MPW][NPW][4];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  const auto slot_of = [&](int j) { return reinterpret_cast<const bf16*>(ring + (j % STAGES) * slot); };

  // (A) of chunk j: the tensor cores' first products, in units of one m-tile by GN n-tiles over
  // the staged x rows, then over the staged g rows. z0 = x . We: e = act(z0 + be) into the
  // haloed layout (0 past E: its We, be are 0) and act'(z0) of the centre pixels; g . Wp^T, as a
  // float, where gd goes
  const int mt2 = (n2 + 15) / 16, mt1 = (n1 + 15) / 16;
  const auto phase_a = [&](int j) {
    const int e0 = e_begin + j * EC, ev = min(EC, e_end - e0);
    const bf16* sw = slot_of(j);     // We [C16][LW]
    const bf16* sp = sw + C16 * LW;  // Wp [EC][LP]
    const float* s_be = reinterpret_cast<const float*>(sp + EC * LP);
    for (int u = warp; u < (mt2 + mt1) * NG; u += kWarps) {
      const bool expand = u < mt2 * NG;
      const int mt = (expand ? u : u - mt2 * NG) / NG, ng = u % NG;
      float z[GN][4];
#pragma unroll
      for (int jj = 0; jj < GN; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) z[jj][r] = 0.0f;
      if (expand) {
        const bf16* a_ptr = s_x + (mt * 16 + (lane & 15)) * LX + (lane >> 4) * 8;
        const bf16* b_ptr = sw + (lane & 15) * LW + ng * GN * 8 + (lane >> 4) * 8;
#pragma unroll 2
        for (int k0 = 0; k0 < C16; k0 += 16) {
          uint32_t a[4];
          ldsm_x4(a, a_ptr + k0);
#pragma unroll
          for (int q = 0; q < GN / 2; ++q) {
            uint32_t b[4];
            ldsm_x4_trans(b, b_ptr + k0 * LW + q * 16);
            mma_bf16(z[2 * q], a, b[0], b[1]);
            mma_bf16(z[2 * q + 1], a, b[2], b[3]);
          }
        }
      } else {
        const bf16* a_ptr = s_g + (mt * 16 + (lane & 15)) * LG + (lane >> 4) * 8;
        const bf16* b_ptr =
            sp + (ng * GN * 8 + (lane & 7) + ((lane >> 4) << 3)) * LP + ((lane >> 3) & 1) * 8;
#pragma unroll 2
        for (int k0 = 0; k0 < Co16; k0 += 16) {
          uint32_t a[4];
          ldsm_x4(a, a_ptr + k0);
#pragma unroll
          for (int q = 0; q < GN / 2; ++q) {
            uint32_t b[4];
            ldsm_x4(b, b_ptr + q * 16 * LP + k0);
            mma_bf16(z[2 * q], a, b[0], b[1]);
            mma_bf16(z[2 * q + 1], a, b[2], b[3]);
          }
        }
      }
      const auto store = [&](auto swish_tag) {
        constexpr bool SW = decltype(swish_tag)::value;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + gid + 8 * half;
          if (r >= (expand ? n2 : n1)) continue;
          if (!expand) {
            float* f_row = s_f + s_pos1[r] * LF;
#pragma unroll
            for (int jj = 0; jj < GN; ++jj) {
              const int col = (ng * GN + jj) * 8 + 2 * tig;
              *reinterpret_cast<float2*>(f_row + col) =
                  make_float2(z[jj][2 * half], z[jj][2 * half + 1]);
            }
            continue;
          }
          const int pos = s_pos2[r];
          const int py = pos / F2W - 2 * h, px = pos % F2W - 2 * h;
          const bool centre = py >= 0 && py < TH && px >= 0 && px < TW;
          uint32_t* e_row = reinterpret_cast<uint32_t*>(s_e + pos * LE);
#pragma unroll
          for (int jj = 0; jj < GN; ++jj) {
            const int col = (ng * GN + jj) * 8 + 2 * tig;
            const float2 bias = *reinterpret_cast<const float2*>(s_be + col);
            const float za = z[jj][2 * half] + bias.x, zb = z[jj][2 * half + 1] + bias.y;
            e_row[col / 2] = pack_bf16(act_fn<SW>(za, hi), act_fn<SW>(zb, hi));
            if (centre) {
              const float da = dact_fn<SW>(za, hi), db = dact_fn<SW>(zb, hi);
              *reinterpret_cast<float2*>(s_dz0 + (py * TW + px) * LF + col) = make_float2(da, db);
              if (p.masks != nullptr) {
                uint8_t* m = p.masks + (img_px + s_off2[r]) * E + e0 + col;
                if (col < ev) m[0] = da != 0.0f;
                if (col + 1 < ev) m[1] = db != 0.0f;
              }
            }
          }
        }
      };
      if (swish) {
        store(std::true_type{});
      } else {
        store(std::false_type{});
      }
    }
  };

  // (D) of chunk j: dx += ge . We^T into the accumulator registers, k over the chunk's channels
  // in steps of 16, two n-tiles (We rows) per ldmatrix
  const auto phase_d = [&](int j) {
    const int ev = min(EC, e_end - e_begin - j * EC);
    const bf16* sw = slot_of(j);
    for (int k0 = 0; k0 < ev; k0 += 16) {
      uint32_t a[MPW][4];
#pragma unroll
      for (int i2 = 0; i2 < MPW; ++i2) {
        const int m = wm + WM * i2;
        if (m < MTP) ldsm_x4(a[i2], s_ge + (m * 16 + (lane & 15)) * LE + k0 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < NPW; jj += 2) {
        const int na = wn + WN * jj, nb = wn + WN * (jj + 1);
        if (na >= NT) continue;
        const bool two = jj + 1 < NPW && nb < NT;
        uint32_t b[4];
        ldsm_x4(b, sw + ((((lane >> 4) && two) ? nb : na) * 8 + (lane & 7)) * LW + k0 +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i2 = 0; i2 < MPW; ++i2) {
          if (wm + WM * i2 >= MTP) continue;
          mma_bf16(acc[i2][jj], a[i2], b[0], b[1]);
          if (jj + 1 < NPW && two) mma_bf16(acc[i2][jj + 1], a[i2], b[2], b[3]);
        }
      }
    }
  };

  // Per chunk three barriers: (B) and (C) of chunk j, then (A) of chunk j + 1 beside (D) of
  // chunk j in one phase (they touch no common buffer). The ring starts with chunks 0 to
  // STAGES - 1; chunk j + STAGES goes into chunk j's slot once every thread is past (D) of
  // chunk j.
  if (n_chunks > 0) {
    mbar_wait(&full[0], 0);
    phase_a(0);
  }
  __syncthreads();
  for (int j = 0; j < n_chunks; ++j) {
    const int e0 = e_begin + j * EC, ev = min(EC, e_end - e0);
    const bf16* sp = slot_of(j) + C16 * LW;
    const float* s_bd = reinterpret_cast<const float*>(sp + EC * LP) + EC;
    const float* s_wd = s_bd + EC;

    // (B) gd = bf16((g . Wp^T) * act'(z1)) on the pixels of the h-haloed tile inside the image,
    // z1 = bd + the depthwise of e: a thread takes a channel pair and a run of R1 of one row;
    // each e word of a row is converted once
    for (int it = threadIdx.x; it < NPAIR * F1H * NR1; it += kThreads) {
      const int pr = it % NPAIR, rest = it / NPAIR;
      const int run = rest % NR1, qy = rest / NR1;
      const int y = ty0 - h + qy;
      if (y < 0 || y >= H) continue;
      const int col = 2 * pr;
      const float2 bias = *reinterpret_cast<const float2*>(s_bd + col);
      float s0[R1], s1[R1];
#pragma unroll
      for (int r = 0; r < R1; ++r) {
        s0[r] = bias.x;
        s1[r] = bias.y;
      }
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const uint32_t* row = e_words + ((qy + ky) * F2W + run * R1) * (LE / 2) + pr;
        float v0[R1 + K - 1], v1[R1 + K - 1];
#pragma unroll
        for (int c = 0; c < R1 + K - 1; ++c) {
          const uint32_t w = row[c * (LE / 2)];
          v0[c] = lo_f(w);
          v1[c] = hi_f(w);
        }
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float2 wk = *reinterpret_cast<const float2*>(s_wd + (ky * K + kx) * EC + col);
#pragma unroll
          for (int r = 0; r < R1; ++r) {
            s0[r] = fmaf(v0[r + kx], wk.x, s0[r]);
            s1[r] = fmaf(v1[r + kx], wk.y, s1[r]);
          }
        }
      }
      const auto store_gd = [&](auto swish_tag) {
        constexpr bool SW = decltype(swish_tag)::value;
#pragma unroll
        for (int r = 0; r < R1; ++r) {
          const int px = run * R1 + r, xx = tx0 - h + px;
          if (xx < 0 || xx >= W) continue;
          const float da = dact_fn<SW>(s0[r], hi), db = dact_fn<SW>(s1[r], hi);
          float2* f = reinterpret_cast<float2*>(s_f + (qy * F1W + px) * LF + col);
          const float2 gw = *f;
          *f = make_float2(round_bf16(gw.x * da), round_bf16(gw.y * db));
          if (p.masks != nullptr && qy >= h && qy < h + TH && px >= h && px < h + TW) {
            uint8_t* m = p.masks + plane + (img_px + static_cast<int64_t>(y) * W + xx) * E + e0 + col;
            if (col < ev) m[0] = da != 0.0f;
            if (col + 1 < ev) m[1] = db != 0.0f;
          }
        }
      };
      if (swish) {
        store_gd(std::true_type{});
      } else {
        store_gd(std::false_type{});
      }
    }
    __syncthreads();

    // (C) ge = bf16(dwconv^T(gd) * act'(z0)) on the centre: a thread takes a channel pair and a
    // run of R2 of one row; each gd pair of a row is loaded once. Taps from a zero sum, ky then
    // kx ascending
    for (int it = threadIdx.x; it < NPAIR * TH * NR2; it += kThreads) {
      const int pr = it % NPAIR, rest = it / NPAIR;
      const int run = rest % NR2, qy = rest / NR2;
      const int col = 2 * pr;
      float s0[R2], s1[R2];
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        s0[r] = 0.0f;
        s1[r] = 0.0f;
      }
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const float* row = s_f + ((qy + 2 * h - ky) * F1W + run * R2) * LF + col;
        float2 v[R2 + K - 1];
#pragma unroll
        for (int c = 0; c < R2 + K - 1; ++c) v[c] = *reinterpret_cast<const float2*>(row + c * LF);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float2 wk = *reinterpret_cast<const float2*>(s_wd + (ky * K + kx) * EC + col);
#pragma unroll
          for (int r = 0; r < R2; ++r) {
            s0[r] = fmaf(v[r + 2 * h - kx].x, wk.x, s0[r]);
            s1[r] = fmaf(v[r + 2 * h - kx].y, wk.y, s1[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        const int q = qy * TW + run * R2 + r;
        const float2 dz = *reinterpret_cast<const float2*>(s_dz0 + q * LF + col);
        ge_words[q * (LE / 2) + pr] = pack_bf16(s0[r] * dz.x, s1[r] * dz.y);
      }
    }
    __syncthreads();

    // (A) of chunk j + 1 beside (D) of chunk j
    if (j + 1 < n_chunks) {
      mbar_wait(&full[(j + 1) % STAGES], ((j + 1) / STAGES) & 1);
      phase_a(j + 1);
    }
    phase_d(j);
    __syncthreads();
    // every thread is past (D) of chunk j: its slot takes chunk j + STAGES
    if (j + STAGES < n_chunks) fill(j + STAGES);
  }

  // dx = acc [+ g], rounded once; with a split, the float32 partial
  const bool whole = gridDim.z == 1;
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
        const int c = n * 8 + 2 * tig;
        float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (whole) {
          if (p.residual) {  // g of the pixel, from the staged tile
            const int row = (y - ry1) * nx1 + xx - rx1;
            const uint32_t gr = *reinterpret_cast<const uint32_t*>(s_g + row * LG + c);
            v0 += lo_f(gr);
            v1 += hi_f(gr);
          }
          *reinterpret_cast<uint32_t*>(p.out + pix * C + c) = pack_bf16(v0, v1);
        } else {
          *reinterpret_cast<float2*>(p.ws + (static_cast<int64_t>(split) * p.B * H * W + pix) * C +
                                     c) = make_float2(v0, v1);
        }
      }
    }
  }
}

// out[i] = the n_split partials of ws in split order [+ res[i]], rounded to bf16 once: the
// deterministic reduction of a split of E
__global__ void __launch_bounds__(256) dx_reduce_kernel(const float* __restrict__ ws, int n_split,
                                                        int64_t n, const bf16* __restrict__ res,
                                                        bf16* __restrict__ out) {
  for (int64_t i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    float v = ws[i];
    for (int s = 1; s < n_split; ++s) v += ws[s * n + i];
    if (res != nullptr) v += __bfloat162float(res[i]);
    out[i] = __float2bfloat16_rn(v);
  }
}

// ------------------------------------------------------------------ host

// The instances built, (TH, TW, EC, MPW, NPW, STAGES, MINB, NW): the planner of
// ops/mbconv_cuda.py lists the same (`DX_SM90_CONFIGS`); (TH, TW, EC, NPW) names one.
#define MLAD_DX_SM90_CONFIGS(X)                                                        \
  X(16, 16, 32, 1, 4, 2, 1, 16) X(8, 8, 16, 1, 7, 2, 2, 8) X(8, 8, 32, 1, 4, 2, 1, 16) \
  X(8, 8, 16, 1, 5, 2, 1, 16) X(4, 8, 16, 1, 5, 2, 1, 16)

// The largest image-clipped region of a th x tw tile with a halo of `halo`, padded to 16 rows.
int region_rows(int H, int W, int th, int tw, int halo) {
  int my = 0, mx = 0;
  for (int y = 0; y < H; y += th) {
    my = std::max(my, std::min(y + th + halo, H) - std::max(y - halo, 0));
  }
  for (int x = 0; x < W; x += tw) {
    mx = std::max(mx, std::min(x + tw + halo, W) - std::max(x - halo, 0));
  }
  return round16(my * mx);
}

template <int K, int TH, int TW, int EC, int MPW, int NPW, int STAGES, int MINB, int NW>
cudaError_t run(Params p, int split, cudaStream_t stream) {
  const int nt = p.C / 8, mtp = TH * TW / 16;
  if (p.wn < 1 || NW % p.wn != 0) return cudaErrorInvalidValue;
  const int wm = NW / p.wn;
  if ((nt + p.wn - 1) / p.wn > NPW || (mtp + wm - 1) / wm > MPW) return cudaErrorInvalidValue;
  if (p.e_per_split % EC != 0 || p.e_per_split < EC ||
      static_cast<int64_t>(split) * p.e_per_split < p.E ||
      static_cast<int64_t>(split - 1) * p.e_per_split >= p.E) {
    return cudaErrorInvalidValue;
  }
  p.n2p = region_rows(p.H, p.W, TH, TW, 2 * (K / 2));
  p.n1p = region_rows(p.H, p.W, TH, TW, K / 2);
  const size_t smem = smem_bytes(K, TH, TW, EC, STAGES, p.C, p.Co, p.n2p, p.n1p);
  if (smem > (MINB == 1 ? kMaxSmem : kMaxSmem2)) return cudaErrorInvalidValue;
  auto kern = mbconv_dx_sm90_kernel<K, TH, TW, EC, MPW, NPW, STAGES, MINB, NW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((p.H + TH - 1) / TH) * ((p.W + TW - 1) / TW), p.B, split);
  kern<<<grid, 32 * NW, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const int64_t n = static_cast<int64_t>(p.B) * p.H * p.W * p.C;
  const int64_t blocks = (n + 255) / 256;
  dx_reduce_kernel<<<static_cast<int>(blocks < 1056 ? blocks : 1056), 256, 0, stream>>>(
      p.ws, split, n, p.residual ? p.g : nullptr, p.out);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(const Params& p, int th, int tw, int ec, int npw, int split,
                     cudaStream_t stream) {
#define MLAD_TRY(TH, TW, EC, MPW, NPW, S, MINB, NW)                      \
  if (th == TH && tw == TW && ec == EC && npw == NPW) {                  \
    return run<K, TH, TW, EC, MPW, NPW, S, MINB, NW>(p, split, stream);  \
  }
  MLAD_DX_SM90_CONFIGS(MLAD_TRY)
#undef MLAD_TRY
  return cudaErrorInvalidValue;  // no such instance
}

}  // namespace

// act: 0 relu6, 1 relu, 2 swish. packed: `sm90_pack` of the fold at the plan's ec. The plan (th,
// tw, ec, npw, wn, split, e_per_split) comes from ops/mbconv_cuda.py `plan_dx_sm90`; ws is a
// [split, B, H, W, C] float32 workspace, null when split is 1. masks: null on the main path;
// else [2, B, H, W, E] bytes that receive act'(z0) != 0 and act'(z1) != 0 (relu6 / relu only).
// Returns a cudaError_t: 1 (invalid value) for arguments or a plan the kernel does not take,
// without launching.
extern "C" int mlad_mbconv_dx_sm90(const void* x, const void* g, const void* packed, int B, int H,
                                   int W, int C, int E, int Co, int k, int act, int residual,
                                   int th, int tw, int ec, int npw, int wn, int split,
                                   int e_per_split, void* dx, float* ws, uint8_t* masks,
                                   void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 8 || E < 8 || Co < 8 || C % 8 || E % 8 ||
      Co % 8 || (k != 3 && k != 5) || act < kRelu6 || act > kSwish || (residual && C != Co) ||
      (masks != nullptr && act == kSwish) || split < 1 || split > kMaxSplit ||
      (split > 1 && ws == nullptr) ||
      static_cast<int64_t>(B) * H * W * (C > Co ? C : Co) > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const void* ptr : {x, g, packed, static_cast<const void*>(dx),
                          static_cast<const void*>(ws)}) {
    if (misaligned(ptr)) return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
           static_cast<const uint8_t*>(packed), static_cast<bf16*>(dx), ws, masks,
           B, H, W, C, E, Co, act, residual, wn, e_per_split, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = k == 3 ? dispatch<3>(p, th, tw, ec, npw, split, s)
                                 : dispatch<5>(p, th, tw, ec, npw, split, s);
  return static_cast<int>(err);
}
