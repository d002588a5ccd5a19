// Asynchronous 4-byte copies from global to shared memory (cp.async), shared
// by the kernels that stage tiles: every copy of a thread is in flight at
// once, where a load-then-store loop waits for each load in turn.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes, or 4 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
