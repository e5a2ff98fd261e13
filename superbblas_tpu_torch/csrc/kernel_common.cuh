// Device helpers of the streaming kernels (stencil_site.cu, permute.cu,
// stencil_schedules.cu): asynchronous copies of 16 bytes or one element into
// shared memory, and division by a
// divisor fixed at launch for decoding a flat work index every item.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// cp.async of 16 bytes from device memory into shared memory (L1 bypassed)
__device__ __forceinline__ void copy16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
// cp.async of one element of 4 or 8 bytes (through L1); one of 2 bytes, which
// cp.async does not move, by a plain load and store
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src) {
    if constexpr (sizeof(T) == 4 || sizeof(T) == 8) {
        const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                     "n"(sizeof(T)) : "memory");
    } else {
        *dst = *src;
    }
}
__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n / d by one multiply-high, an add and a shift in place of a 32-bit
// division (about 20 instructions) or a 64-bit one (about 70):
// round-towards-zero quotients of n < 2^31 by 1 <= d < 2^31, with the
// magic number computed on the host (the method of Granlund and
// Montgomery, as PyTorch's IntDivider has it)
struct FastDiv {
    uint32_t d = 1, m = 1, s = 0;

    FastDiv() = default;
    explicit FastDiv(uint32_t divisor) : d(divisor) {
        while (s < 31 && (1u << s) < d) ++s;
        const uint64_t one = 1;
        m = static_cast<uint32_t>(((one << 32) * ((one << s) - d)) / d + 1);
    }

    __device__ __forceinline__ uint32_t div(uint32_t n) const {
        return (__umulhi(n, m) + n) >> s;
    }
};

}  // namespace
