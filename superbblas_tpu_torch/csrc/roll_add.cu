// bf16 roll-plus-add for Hopper (sm_90a), E2.
//
// Replaces the Pallas TPU probe experiments/stencil_bf16_roll_probe.py
// (run :88, its pl.pallas_call :90; kernels k_roll_f32, k_roll_bf16 and
// k_roll_pair).  On bf16 x [R, Z, T], as rows of T:
//   y[r, z, t] = x[r, z, (t - 1) mod T] + x[r, z, t]
// which is pltpu.roll(x, 1, 2) + x, the probe's `want`.  It asks, for the
// stencil kernel's bf16/bf16 path, whether native bf16 arithmetic pays on
// this card.  Two variants, on the same loads:
//  * f32 (k_roll_f32): convert to f32, add, round once to bf16; bit-exact
//    against the plain version;
//  * bf16x2 (k_roll_pair, k_roll_bf16): native __nv_bfloat162 adds
//    (__hadd2) on the rolled pairs (x[t-1], x[t]), rebuilt in registers
//    from the previous pair's high half and this pair's low half.  An add
//    of two bf16 values rounds once from the exact sum, the f32 route
//    rounds to f32 first: the two can differ by one bf16 ulp where the f32
//    sum itself rounds.
//
// What bounds it on the H100: bytes, 2 read and 2 written an element
// (134 MB at [4096, 32, 256]: 0.0401 ms at 3.35 TB/s; 4 MB at the probe's
// [256, 32, 256], 2.5 us, which measures the launch).
//
// Three forms, which ops/roll_add.py picks from the shape and the
// pointers' alignment alone:
//  * vec16 (T % 8 == 0, both pointers 16-byte aligned).  A thread loads
//    and stores 16-byte words of 8 bf16 (ld.global.nc, st.global.cs), a
//    warp 32 consecutive words of a chunk, two chunks in flight a warp an
//    iteration, in a grid-stride loop of 8 blocks of 256 threads an SM
//    (64 KB of loads in flight an SM, enough to cover device memory's
//    latency at its full rate).  The element rolled into a word is the last
//    bf16 of the word before it in the row: lane - 1 holds it
//    (__shfl_up_sync) unless the lane is the warp's first or the word the
//    row's first.  Where a row is a whole number of words that divides 32
//    (T = 8, 16, .., 256), the warp's chunks hold whole rows and the row's
//    wrap is a rotation within the row's lanes (T = 256: lane 0 takes lane
//    31's word): one __shfl_sync and no other load.  Elsewhere those lanes
//    load the one element (2 bytes, from L1/L2: its word is read by
//    another lane of the same or the previous chunk).  Each output pair is
//    one byte permute (PRMT) of two loaded words and one add.
//  * pair (even T otherwise, 4-byte aligned pointers): the first design, one
//    thread per output pair with 4-byte loads of this pair and the one
//    before it.
//  * elem (any T, the f32 variant only): one thread an element.
//
// Plain C interface (loaded with ctypes); the call returns the
// cudaError_t of its launch.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// 32-word chunks a warp has in flight an iteration of the vec16 form
constexpr int kChunks = 2;
// blocks of the vec16 grid an SM: 2048 threads, the SM's most
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
    __nv_bfloat162 r;
    static_assert(sizeof(r) == sizeof(v), "a bf16 pair is 32 bits");
    memcpy(&r, &v, sizeof(v));
    return r;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
    uint32_t r;
    memcpy(&r, &v, sizeof(v));
    return r;
}

// rolled + cur on two bf16 pairs held in 32 bits (the low half the first
// element)
template <bool kNative>
__device__ __forceinline__ uint32_t add_pair(uint32_t rolled, uint32_t cur) {
    if constexpr (kNative) {
        return as_u32(__hadd2(as_bf2(rolled), as_bf2(cur)));
    } else {
        // a bf16 is the high half of the f32 of the same value
        const float lo = __uint_as_float(rolled << 16) + __uint_as_float(cur << 16);
        const float hi = __uint_as_float(rolled & 0xffff0000u) +
                         __uint_as_float(cur & 0xffff0000u);
        return as_u32(__floats2bfloat162_rn(lo, hi));
    }
}

// y word of x word c, with prev's high half the element rolled into c's
// first slot: pair k of the rolled word is (high half of pair k - 1, low
// half of pair k), one byte permute
template <bool kNative>
__device__ __forceinline__ uint4 add_word(uint32_t prev, uint4 c) {
    uint4 r;
    r.x = add_pair<kNative>(__byte_perm(prev, c.x, 0x5432), c.x);
    r.y = add_pair<kNative>(__byte_perm(c.x, c.y, 0x5432), c.y);
    r.z = add_pair<kNative>(__byte_perm(c.y, c.z, 0x5432), c.z);
    r.w = add_pair<kNative>(__byte_perm(c.z, c.w, 0x5432), c.w);
    return r;
}

// vec16: rows of W = T / 8 words; whole_rows when W divides 32
template <bool kNative>
__global__ void __launch_bounds__(kThreads) roll_add_vec16_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ y, int64_t words, int W,
    bool whole_rows) {
    const int lane = threadIdx.x & 31;
    const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
    const int64_t step = ((int64_t)gridDim.x * kThreads >> 5) * (32 * kChunks);
    const unsigned short* xe = reinterpret_cast<const unsigned short*>(x);
    // every lane of a warp runs the same iterations: the shuffles see all 32
    for (int64_t base = warp * (32 * kChunks); base < words; base += step) {
        uint4 c[kChunks];
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
            const int64_t w = base + u * 32 + lane;
            c[u] = w < words ? __ldg(x + w) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
            const int64_t w = base + u * 32 + lane;
            uint32_t prev;
            if (whole_rows) {
                // chunks start at multiples of 32 words, so a row is lanes
                // [q0, q0 + W) and the word before the row's first is its last
                const int q = lane & (W - 1);
                prev = __shfl_sync(0xffffffffu, c[u].w, q == 0 ? lane + W - 1 : lane - 1);
            } else {
                prev = __shfl_up_sync(0xffffffffu, c[u].w, 1);
                const int q = (int)(w % W);
                if ((lane == 0 || q == 0) && w < words) {
                    const int64_t pw = q == 0 ? w + W - 1 : w - 1;
                    prev = (uint32_t)__ldg(xe + pw * 8 + 7) << 16;
                }
            }
            if (w < words) __stcs(y + w, add_word<kNative>(prev, c[u]));
        }
    }
}

// pair: one thread per output pair (t, t+1), t even, of rows of T = 2*T2
template <bool kNative>
__global__ void __launch_bounds__(kThreads) roll_add_pair_kernel(
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

// elem: one thread an element, any T (the f32 variant)
__global__ void __launch_bounds__(kThreads) roll_add_kernel(const __nv_bfloat16* __restrict__ x,
                                                            __nv_bfloat16* __restrict__ y,
                                                            int64_t total, int T) {
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= total) return;
    const int t = (int)(e % T);
    const float a = __bfloat162float(x[t == 0 ? e + T - 1 : e - 1]);
    y[e] = __float2bfloat16_rn(a + __bfloat162float(x[e]));
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

}  // namespace

extern "C" {

// x, y: contiguous bf16 [rows, T]; native: 1 for the bf16x2 variant, 0 for
// the f32 one; form: 0 vec16 (T % 8 == 0, 16-byte aligned pointers), 1
// pair (even T, 4-byte aligned pointers), 2 elem (the f32 variant); sms:
// the card's SM count (vec16's grid).
int sbt_roll_add(int native, int form, int64_t rows, int64_t T, const void* x, void* y,
                 int sms, void* stream) {
    if (rows < 1 || T < 1 || T > INT32_MAX || sms < 1) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (form == 0) {
        if (T % 8 != 0 || !aligned(x, 16) || !aligned(y, 16)) return cudaErrorInvalidValue;
        const int W = (int)(T / 8);
        const int64_t words = rows * W;
        const int64_t need = (words + kThreads * kChunks - 1) / (kThreads * kChunks);
        const int64_t most = (int64_t)sms * kBlocksPerSm;
        const unsigned grid = (unsigned)(need < most ? need : most);
        const bool whole = 32 % W == 0;
        const auto* xp = static_cast<const uint4*>(x);
        auto* yp = static_cast<uint4*>(y);
        if (native)
            roll_add_vec16_kernel<true><<<grid, kThreads, 0, st>>>(xp, yp, words, W, whole);
        else
            roll_add_vec16_kernel<false><<<grid, kThreads, 0, st>>>(xp, yp, words, W, whole);
    } else if (form == 1) {
        if (T % 2 != 0 || !aligned(x, 4) || !aligned(y, 4)) return cudaErrorInvalidValue;
        const int64_t pairs = rows * (T / 2);
        const unsigned grid = (unsigned)((pairs + kThreads - 1) / kThreads);
        const auto* xp = static_cast<const __nv_bfloat162*>(x);
        auto* yp = static_cast<__nv_bfloat162*>(y);
        if (native)
            roll_add_pair_kernel<true><<<grid, kThreads, 0, st>>>(xp, yp, pairs, (int)(T / 2));
        else
            roll_add_pair_kernel<false><<<grid, kThreads, 0, st>>>(xp, yp, pairs, (int)(T / 2));
    } else if (form == 2 && !native) {
        const int64_t total = rows * T;
        roll_add_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), total, (int)T);
    } else {
        return cudaErrorInvalidValue;
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
