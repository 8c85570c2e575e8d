// Asynchronous global-to-shared copies (cp.async), shared by the kernels
// that stream z-planes into shared-memory rings (mwd.cu: K1, fused.cu: K3).
//
// A copy is issued by each thread for its own elements, committed as a
// group, and waited for by the same thread; a block barrier after the wait
// makes every thread's copies visible to the block.

#pragma once

#include <stdint.h>

template <typename S>
__device__ __forceinline__ void copy_async(S* dst, const S* src) {
  if constexpr (sizeof(S) == 4 || sizeof(S) == 8) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"((int)sizeof(S)) : "memory");
  } else {
    *dst = *src;            // cp.async moves 4, 8 or 16 bytes, not 2
  }
}

// copy n elements from global to shared memory: 16-byte cp.async where
// both ends are 16-byte aligned (they are together or not at all when the
// row strides are multiples of 16 bytes), else one element at a time
template <typename S>
__device__ __forceinline__ void copy_row(S* dst, const S* src, int n,
                                         int lane) {
  constexpr int E = 16 / sizeof(S);
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0
      && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    head = n / E * E;
    for (int x = lane * E; x < head; x += 32 * E) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + x);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(d), "l"(src + x) : "memory");
    }
  }
  for (int x = head + lane; x < n; x += 32) copy_async(dst + x, src + x);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0 or 1) committed groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
