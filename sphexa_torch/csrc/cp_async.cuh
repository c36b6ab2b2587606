// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the pair engines (engine_window.cuh) and the gravity near field
// (gravity_p2p.cu).

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the most recent N has landed (this thread's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// first position >= fill of a window or tile that thread t of G stages
// (pos % G == t)
__device__ __forceinline__ int first_own(int fill, int t, int G) {
    int off = (t - fill) % G;
    if (off < 0) off += G;
    return fill + off;
}
