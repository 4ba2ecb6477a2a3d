// Asynchronous copies, shared-memory barriers (sm_80+ cp.async, sm_90
// mbarrier) as thin PTX wrappers, and the shared-memory budget, shared by
// kkt.cu and fused_factor.cu.
//
// The copies move ONE element (4 bytes for float, 8 for double) each:
// cp.async.ca takes 4, 8 or 16 bytes, and the ranges these kernels stage
// (a 13 x 13 float block is 676 bytes, a 38 x 17 G slab 2,584, a lane's L
// and C blocks 33,124) start at addresses that are rarely 16-byte aligned,
// so element-sized copies are the ones that fit every range without
// rounding it out past the tensor's end. cho_solve_vec's ranges (a warp's
// 32 blocks) start 16-byte aligned when the tensor does, and take 16-byte
// copies there (cp_async_16).

#pragma once

#include <stddef.h>
#include <stdint.h>

// Shared memory a CTA keeps to let two CTAs share an SM (227 KB of shared
// memory a block at most, 228 KB an SM, 1 KB of it reserved per CTA).
constexpr size_t kTwoPerSm = 112 * 1024;

__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dst (shared) <- src (global), one element, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

// dst (shared) <- src (global), 16 bytes, asynchronously; both addresses
// 16-byte aligned. For contiguous ranges whose start is aligned
// (cho_solve_vec's staging).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Wait until every cp.async this thread issued has landed (the caller then
// syncs the threads that read the data).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close this thread's group of cp.async copies issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this thread's committed groups is in flight
// (the caller then syncs the threads that read the data).
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the initialized barriers visible before any thread uses them (the
// caller then syncs the threads).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival (release: this thread's earlier shared-memory writes are
// visible to a thread whose wait sees the phase complete).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival, made when every cp.async this thread issued so far has
// landed (.noinc: the arrival counts against the barrier's expected count).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
