// bf16 roll-plus-add for Hopper (sm_90a), E2.
//
// Replaces the Pallas TPU probe experiments/stencil_bf16_roll_probe.py
// (run :88, its pl.pallas_call :90; kernels k_roll_f32, k_roll_bf16 and
// k_roll_pair).  On bf16 x [R, Z, T], as rows of T:
//   y[r, z, t] = x[r, z, (t - 1) mod T] + x[r, z, t]
// which is pltpu.roll(x, 1, 2) + x, the probe's `want`.  It asks, for the
// stencil kernel's bf16/bf16 path, whether native bf16 arithmetic pays on
// this card.  Two variants:
//  * f32 (k_roll_f32): convert to f32, add, round once to bf16; bit-exact
//    against the plain version;
//  * bf16x2 (k_roll_pair, k_roll_bf16): native __nv_bfloat162 adds on
//    32-bit pair loads, the rolled pair (x[t-1], x[t]) rebuilt in
//    registers from the previous pair's high half and this pair's low
//    half.  An add of two bf16 values rounds once from the exact sum, the
//    f32 route rounds to f32 first: the two can differ by one bf16 ulp
//    where the f32 sum itself rounds.
// Both even-T variants do the same loads (this pair and the one before
// it, 32 bits each) and differ only in the arithmetic.  An odd T leaves
// the rows unaligned for pair loads: the f32 variant then runs one thread
// an element, and the bf16x2 variant refuses it.
//
// What bounds it on the H100: bytes, 2 read and 2 written an element
// (4 MB at the probe's [256, 32, 256]: about 2.5 us at 3.35 TB/s, so the
// probe's shape measures the launch; [4096, 32, 256] resolves).
//
// Plain C interface (loaded with ctypes); the call returns the
// cudaError_t of its launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// one thread per output pair (t, t+1), t even, of rows of T = 2*T2
template <bool kNative>
__global__ void __launch_bounds__(256) roll_add_pair_kernel(
    const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ y, int64_t pairs,
    int T2) {
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= pairs) return;
    const int q = (int)(p % T2);
    const __nv_bfloat162 cur = x[p];
    const __nv_bfloat162 prev = x[q == 0 ? p + T2 - 1 : p - 1];
    if constexpr (kNative) {
        y[p] = __hadd2(__halves2bfloat162(__high2bfloat16(prev), __low2bfloat16(cur)), cur);
    } else {
        const float a = __bfloat162float(__high2bfloat16(prev));
        const float b = __bfloat162float(__low2bfloat16(cur));
        const float c = __bfloat162float(__high2bfloat16(cur));
        y[p] = __floats2bfloat162_rn(a + b, b + c);
    }
}

// one thread an element, any T (the f32 variant)
__global__ void __launch_bounds__(256) roll_add_kernel(const __nv_bfloat16* __restrict__ x,
                                                       __nv_bfloat16* __restrict__ y,
                                                       int64_t total, int T) {
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= total) return;
    const int t = (int)(e % T);
    const float a = __bfloat162float(x[t == 0 ? e + T - 1 : e - 1]);
    y[e] = __float2bfloat16_rn(a + __bfloat162float(x[e]));
}

}  // namespace

extern "C" {

// x, y: contiguous bf16 [rows, T]; native: 1 for the bf16x2 variant (even
// T only), 0 for the f32 one.
int sbt_roll_add(int native, int64_t rows, int64_t T, const void* x, void* y, void* stream) {
    if (rows < 1 || T < 1 || T > INT32_MAX || (native && T % 2 != 0))
        return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T % 2 == 0) {
        const int64_t pairs = rows * (T / 2);
        const unsigned grid = (unsigned)((pairs + 255) / 256);
        const auto* xp = static_cast<const __nv_bfloat162*>(x);
        auto* yp = static_cast<__nv_bfloat162*>(y);
        if (native)
            roll_add_pair_kernel<true><<<grid, 256, 0, st>>>(xp, yp, pairs, (int)(T / 2));
        else
            roll_add_pair_kernel<false><<<grid, 256, 0, st>>>(xp, yp, pairs, (int)(T / 2));
    } else {
        const int64_t total = rows * T;
        roll_add_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), total,
            (int)T);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
