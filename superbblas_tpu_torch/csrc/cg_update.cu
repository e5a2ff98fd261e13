// The vector updates and inner products of one conjugate-gradient
// iteration (solvers.cg) on split-complex f32 fields, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these passes to XLA, which
// fuses them; in the port they were PyTorch's elementwise and reduction
// passes, 78 planes and 36 launches an iteration.  With A p given, three
// kernels, a field being its re and im planes, each treated as one flat
// array of n floats:
//   cg_dot: pAp = Re<p, Ap>                                      4 planes read
//   cg_xr:  alpha = rs / max(pAp, 1e-30); x' = x + alpha p;
//           r' = r - alpha Ap; rs' = |r'|^2                      8 read, 4 written
//   cg_p:   beta = rs' / max(rs, 1e-30); p' = r' + beta p;
//           ratio = rs' / bs (the convergence test's)            4 read, 2 written
// 22 planes an iteration.  The scalars stay on the device: each kernel
// reads the ones it needs from device memory and writes its result there.
//
// What bounds it on the H100: bytes (a plane of the 12-rhs clover solve is
// 1.21 GB, 0.36 ms at 3.35 TB/s).  The design streams at copy rate:
//  * 16-byte loads and stores (ld.global.cs, st.global.cs: each word is
//    touched once) where every plane pointer is 16-byte aligned, with an
//    element tail for n % 4; one element a step otherwise;
//  * a grid-stride loop over a grid the wrapper caps at four blocks of 256
//    threads an SM, all resident at once (launch bounds): 128 KB of cg_xr's
//    loads in flight an SM, several times what device memory's latency
//    needs, and one wave, so no block waits for a second;
//  * reductions in f32: four accumulators a thread (one a lane of the
//    word), the thread's sum, a warp-shuffle tree and a shared-memory tree
//    over the block's warps, one partial a block into the workspace; the
//    last block to finish (an integer ticket) sums the partials in block
//    order and writes the scalar.  No float atomics: a launch repeats bit
//    for bit.
// Products and sums round as PyTorch's separate passes round them
// (__fmul_rn and __fadd_rn: nothing is contracted into an FMA), so the
// updated fields equal those passes' bit for bit given the same scalars;
// the sums add in another order.
//
// Outputs may be their inputs (x' = x, r' = r, p' = p: updates in place):
// a thread reads an element before it writes it and no other thread
// touches it, so no pointer is __restrict__.
//
// Plain C interface (loaded with ctypes); each call returns the
// cudaError_t of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks an SM the launch bounds keep resident (64 registers a thread)
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ float4 load4(const float* p, int64_t j) {
    return __ldcs(reinterpret_cast<const float4*>(p) + j);
}

__device__ __forceinline__ void store4(float* p, int64_t j, float4 v) {
    __stcs(reinterpret_cast<float4*>(p) + j, v);
}

// y + a x, rounded after the product and after the sum
__device__ __forceinline__ float axpy(float y, float a, float x) {
    return __fadd_rn(y, __fmul_rn(a, x));
}

// ar br + ai bi, as PyTorch's a.re * b.re + a.im * b.im rounds it
__device__ __forceinline__ float dot2(float ar, float br, float ai, float bi) {
    return __fadd_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
}

__device__ __forceinline__ float clamp30(float v) {
    return v < 1e-30f ? 1e-30f : v;   // torch.clamp_min(v, 1e-30): NaN stays NaN
}

// the block's sum of v, in thread 0
__device__ float block_sum(float v, float* sh) {
    __syncthreads();                  // sh free from a previous call
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) sh[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < kWarps ? sh[lane] : 0.0f;
        for (int o = kWarps / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    }
    return v;
}

// Each block's sum of v into partial[blockIdx.x]; the last block to arrive
// sums partial[0 .. gridDim.x) in order into *out and resets the ticket
__device__ void finish(float v, float* partial, unsigned* ticket, float* out) {
    __shared__ float sh[kWarps];
    __shared__ bool last;
    v = block_sum(v, sh);
    if (threadIdx.x == 0) {
        partial[blockIdx.x] = v;
        __threadfence();
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
        if (last) __threadfence();
    }
    __syncthreads();
    if (!last) return;
    float s = 0.0f;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) s += __ldcg(partial + i);
    s = block_sum(s, sh);
    if (threadIdx.x == 0) {
        *out = s;
        *ticket = 0u;
    }
}

// cg_dot: Re<p, q> = sum(pr qr + pi qi)
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) cg_dot_kernel(
    const float* pr, const float* pi, const float* qr, const float* qi, int64_t n,
    float* partial, unsigned* ticket, float* out) {
    const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    float s = 0.0f;
    int64_t i = tid;
    if constexpr (kVec) {
        const int64_t nv = n >> 2;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int64_t j = tid; j < nv; j += stride) {
            const float4 a = load4(pr, j), b = load4(qr, j), c = load4(pi, j), d = load4(qi, j);
            acc.x += dot2(a.x, b.x, c.x, d.x);
            acc.y += dot2(a.y, b.y, c.y, d.y);
            acc.z += dot2(a.z, b.z, c.z, d.z);
            acc.w += dot2(a.w, b.w, c.w, d.w);
        }
        s = (acc.x + acc.y) + (acc.z + acc.w);
        i = (nv << 2) + tid;
    }
    for (; i < n; i += stride) s += dot2(pr[i], qr[i], pi[i], qi[i]);
    finish(s, partial, ticket, out);
}

// cg_xr: x' = x + alpha p, r' = r - alpha q, and |r'|^2
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) cg_xr_kernel(
    const float* xr, const float* xi, const float* pr, const float* pi, const float* rr,
    const float* ri, const float* qr, const float* qi, float* xor_, float* xoi, float* ror,
    float* roi, int64_t n, const float* rs, const float* pap, float* partial,
    unsigned* ticket, float* out) {
    const float a = *rs / clamp30(*pap), na = -a;
    const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    float s = 0.0f;
    int64_t i = tid;
    if constexpr (kVec) {
        const int64_t nv = n >> 2;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int64_t j = tid; j < nv; j += stride) {
            const float4 x0 = load4(xr, j), x1 = load4(xi, j), p0 = load4(pr, j),
                         p1 = load4(pi, j), r0 = load4(rr, j), r1 = load4(ri, j),
                         q0 = load4(qr, j), q1 = load4(qi, j);
            store4(xor_, j, make_float4(axpy(x0.x, a, p0.x), axpy(x0.y, a, p0.y),
                                        axpy(x0.z, a, p0.z), axpy(x0.w, a, p0.w)));
            store4(xoi, j, make_float4(axpy(x1.x, a, p1.x), axpy(x1.y, a, p1.y),
                                       axpy(x1.z, a, p1.z), axpy(x1.w, a, p1.w)));
            const float4 s0 = make_float4(axpy(r0.x, na, q0.x), axpy(r0.y, na, q0.y),
                                          axpy(r0.z, na, q0.z), axpy(r0.w, na, q0.w));
            const float4 s1 = make_float4(axpy(r1.x, na, q1.x), axpy(r1.y, na, q1.y),
                                          axpy(r1.z, na, q1.z), axpy(r1.w, na, q1.w));
            store4(ror, j, s0);
            store4(roi, j, s1);
            acc.x += dot2(s0.x, s0.x, s1.x, s1.x);
            acc.y += dot2(s0.y, s0.y, s1.y, s1.y);
            acc.z += dot2(s0.z, s0.z, s1.z, s1.z);
            acc.w += dot2(s0.w, s0.w, s1.w, s1.w);
        }
        s = (acc.x + acc.y) + (acc.z + acc.w);
        i = (nv << 2) + tid;
    }
    for (; i < n; i += stride) {
        const float p0 = pr[i], p1 = pi[i], q0 = qr[i], q1 = qi[i];
        xor_[i] = axpy(xr[i], a, p0);
        xoi[i] = axpy(xi[i], a, p1);
        const float s0 = axpy(rr[i], na, q0), s1 = axpy(ri[i], na, q1);
        ror[i] = s0;
        roi[i] = s1;
        s += dot2(s0, s0, s1, s1);
    }
    finish(s, partial, ticket, out);
}

// cg_p: p' = r + beta p, and ratio = rs' / bs from the first thread
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) cg_p_kernel(
    const float* rr, const float* ri, const float* pr, const float* pi, float* por,
    float* poi, int64_t n, const float* rs_new, const float* rs, const float* bs,
    float* ratio) {
    const float b = *rs_new / clamp30(*rs);
    const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    if (tid == 0) *ratio = *rs_new / *bs;
    int64_t i = tid;
    if constexpr (kVec) {
        const int64_t nv = n >> 2;
        for (int64_t j = tid; j < nv; j += stride) {
            const float4 r0 = load4(rr, j), r1 = load4(ri, j), p0 = load4(pr, j),
                         p1 = load4(pi, j);
            store4(por, j, make_float4(axpy(r0.x, b, p0.x), axpy(r0.y, b, p0.y),
                                       axpy(r0.z, b, p0.z), axpy(r0.w, b, p0.w)));
            store4(poi, j, make_float4(axpy(r1.x, b, p1.x), axpy(r1.y, b, p1.y),
                                       axpy(r1.z, b, p1.z), axpy(r1.w, b, p1.w)));
        }
        i = (nv << 2) + tid;
    }
    for (; i < n; i += stride) {
        const float p0 = pr[i], p1 = pi[i];
        por[i] = axpy(rr[i], b, p0);
        poi[i] = axpy(ri[i], b, p1);
    }
}

// blocks for n elements a plane: one word (or element) a thread, at most cap
unsigned grid_of(int vec, int64_t n, int cap) {
    const int64_t items = vec ? (n >> 2) : n;
    const int64_t need = (items + kThreads - 1) / kThreads;
    return (unsigned)(need < 1 ? 1 : need < cap ? need : cap);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// n: floats a plane; vec: 1 for the 16-byte form (every plane pointer
// 16-byte aligned), 0 for one element a step; cap: the most blocks a grid
// takes (the card's SMs times the blocks an SM the wrapper allows, at most
// kBlocksPerSm); ws: cap floats of block partials, then one unsigned ticket,
// zero before the first launch (each reduction leaves it zero); stream: the
// launch's cudaStream_t.  Scalars (rs, pap, rs_new, bs) are device pointers
// to one float; out and ratio receive one.

int sbt_cg_dot(int vec, int64_t n, const float* pr, const float* pi, const float* qr,
               const float* qi, void* ws, int cap, float* out, void* stream) {
    if (n < 1 || cap < 1) return cudaErrorInvalidValue;
    if (vec && !(aligned16(pr) && aligned16(pi) && aligned16(qr) && aligned16(qi)))
        return cudaErrorInvalidValue;
    const unsigned grid = grid_of(vec, n, cap);
    float* partial = static_cast<float*>(ws);
    unsigned* ticket = reinterpret_cast<unsigned*>(partial + cap);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        cg_dot_kernel<true><<<grid, kThreads, 0, st>>>(pr, pi, qr, qi, n, partial, ticket, out);
    else
        cg_dot_kernel<false><<<grid, kThreads, 0, st>>>(pr, pi, qr, qi, n, partial, ticket, out);
    return static_cast<int>(cudaGetLastError());
}

int sbt_cg_xr(int vec, int64_t n, const float* xr, const float* xi, const float* pr,
              const float* pi, const float* rr, const float* ri, const float* qr,
              const float* qi, float* xor_, float* xoi, float* ror, float* roi,
              const float* rs, const float* pap, void* ws, int cap, float* out, void* stream) {
    if (n < 1 || cap < 1) return cudaErrorInvalidValue;
    const void* ptrs[] = {xr, xi, pr, pi, rr, ri, qr, qi, xor_, xoi, ror, roi};
    if (vec)
        for (const void* p : ptrs)
            if (!aligned16(p)) return cudaErrorInvalidValue;
    const unsigned grid = grid_of(vec, n, cap);
    float* partial = static_cast<float*>(ws);
    unsigned* ticket = reinterpret_cast<unsigned*>(partial + cap);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        cg_xr_kernel<true><<<grid, kThreads, 0, st>>>(xr, xi, pr, pi, rr, ri, qr, qi, xor_,
                                                      xoi, ror, roi, n, rs, pap, partial,
                                                      ticket, out);
    else
        cg_xr_kernel<false><<<grid, kThreads, 0, st>>>(xr, xi, pr, pi, rr, ri, qr, qi, xor_,
                                                       xoi, ror, roi, n, rs, pap, partial,
                                                       ticket, out);
    return static_cast<int>(cudaGetLastError());
}

int sbt_cg_p(int vec, int64_t n, const float* rr, const float* ri, const float* pr,
             const float* pi, float* por, float* poi, const float* rs_new, const float* rs,
             const float* bs, float* ratio, int cap, void* stream) {
    if (n < 1 || cap < 1) return cudaErrorInvalidValue;
    const void* ptrs[] = {rr, ri, pr, pi, por, poi};
    if (vec)
        for (const void* p : ptrs)
            if (!aligned16(p)) return cudaErrorInvalidValue;
    const unsigned grid = grid_of(vec, n, cap);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        cg_p_kernel<true><<<grid, kThreads, 0, st>>>(rr, ri, pr, pi, por, poi, n, rs_new, rs,
                                                     bs, ratio);
    else
        cg_p_kernel<false><<<grid, kThreads, 0, st>>>(rr, ri, pr, pi, por, poi, n, rs_new, rs,
                                                      bs, ratio);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
