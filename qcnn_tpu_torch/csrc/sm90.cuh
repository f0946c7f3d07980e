// sm90.cuh: PTX wrappers that the Hopper (sm_90a) kernels of this
// directory share: mbarriers, 16-byte `cp.async` (arriving on an mbarrier,
// or in commit groups), the generic-to-async proxy fence, the `wgmma` fence,
// commit and wait, `setmaxnreg`, register keep-alives, shared-memory loads,
// and the 128-byte-swizzled tile that `wgmma` reads through a descriptor.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pq {

// ---- PTX wrappers ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes global -> shared; !ok writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// this thread arrives on `bar` once all its earlier cp.async have landed
// (the arrival is one of the count the barrier was initialised with)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// close this thread's open cp.async copies into a group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed cp.async groups are
// still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) become
// visible to the async proxy that `wgmma` reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers a warpgroup may use from here on (a multiple of 8): the
// producer gives some up, the consumers take them
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// tell the compiler a register that an in-flight wgmma reads or writes is
// live (and may have changed) up to here
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// ---- the 128-byte-swizzled tile -----------------------------------------

// Byte offset of 16-byte group `c16` (0..7) of row `row` in a tile of
// 128-byte rows stored with the 128-byte swizzle; the tile starts on a
// 1024-byte boundary. (ops/cuda/_plan.py mirrors it for the CPU tests.)
__device__ __forceinline__ uint32_t swizzle128(int row, int c16) {
  return static_cast<uint32_t>(row * 128 + ((c16 ^ (row & 7)) << 4));
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile at
// `addr` (1024-byte aligned; + 32 bytes per k16 step): 8-row groups 1024
// bytes apart, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// The same tile read as an MN-major B operand (`wgmma` with its transpose
// flag set): its 128-byte rows run along K, each 64 bf16 of N, and a k16
// step advances 16 rows (2048 bytes). Along K the 8-row groups lie 1024
// bytes apart; with N <= 64 there is no second 64-wide group along N, so
// both offsets of the descriptor hold 1024 bytes.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (64ull << 16) |
         (64ull << 32) | (1ull << 62);
}

}  // namespace pq
