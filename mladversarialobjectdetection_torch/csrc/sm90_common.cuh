// Helpers shared by the Hopper bf16 kernels, mbconv_fwd_sm90.cu (the MBConv forward),
// mbconv_dx_sm90.cu (its input gradient) and cmconv_bf16_sm90.cu (the 3x3 conv): the limits of
// a block, the activations, bf16 packing, the PTX wrappers (mbarriers, bulk and 16-byte
// asynchronous copies, ldmatrix, stmatrix, bf16 mma.sync) and the bounded mbarrier wait. Each
// source includes it into its own translation unit.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBarBytes = 128;    // the mbarriers, first in shared memory
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can use
constexpr int kMaxSmem2 = 115712;  // each of two blocks on an SM: 228 KB, 1 KB reserved a block
constexpr int kMaxSplit = 16;

enum Act { kRelu6 = 0, kRelu = 1, kSwish = 2 };

// swish, or relu6 / relu as a clamp to [0, hi] (hi 6 or infinity): the
// epilogues pick SWISH once per unit, outside their loops
template <bool SWISH>
__device__ __forceinline__ float act_fn(float z, float hi) {
  if constexpr (SWISH) {
    return z * (1.0f / (1.0f + expf(-z)));
  } else {
    return fminf(fmaxf(z, 0.0f), hi);
  }
}

// two floats rounded to nearest even as one bf16x2 word, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (the bulk copies)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the TMA unit; completes `bytes` of the barrier's expect-tx
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes from global to shared memory, or 16 zero bytes where !ok (the
// copy's src-size 0); one of this thread's cp.async operations
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  ldsm_x4(r, smem_addr(p));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two 8x8 b16 matrices stored transposed: lanes 0-7 give the row addresses of the first, 8-15
// of the second; memory row j of a matrix takes column j of the fragments (r0, then r1)
__device__ __forceinline__ void stsm_x2_trans(const void* p, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(
                   smem_addr(p)),
               "r"(r0), "r"(r1)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------- end PTX wrappers

// Wait for the phase of `parity` to complete. A copy that never lands would
// hang the card: after about two seconds the wait traps, which fails the
// launch with an error instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// the C entries take only 16-byte aligned pointers (cp.async, bulk copies)
inline bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace
