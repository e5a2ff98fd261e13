// The s5 terms of the SoA domain-wall apply (models/domain_wall.py,
// _apply_dw_soa) on split-complex f32 or f64 fields, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these terms to XLA, which
// fuses them; in the port they were PyTorch's rolls, broadcast products and
// sums, about 120 planes and 45 launches a Moebius CGNE iteration.  A field
// is [n, Ls, 12, V] (V the 4-d sites), a re and an im plane.  With
//   H v|_s = hp_{s,f} v_{s+1} + hm_{s,f} v_{s-1},
//   hp_{s,f} = lam+_s wp_f,  hm_{s,f} = lam-_s wm_f,
// lam+_s = wall at s = Ls-1 (the wrap to 0) and bulk elsewhere, lam-_s =
// wall at s = 0 (the wrap to Ls-1) and bulk elsewhere, one pass takes x
// (and y, where the pass has one), forms a direct part d and the field v
// that H acts on from each s-slice, and writes out = finish(d, H v):
//   pass 0, Moebius right before K1:  d = b5 x,      v = x,          out = d + c5 Hv
//   pass 1, Moebius right after K1:   d = y + x,     v = x,          out = d - Hv
//   pass 2, Moebius left after K1:    d = b5 y + x,  v = c5 y - x,   out = d + Hv
//   pass 3, Shamir after K1:          d = y,         v = x,          out = d + Hv
// (Moebius: bulk 1, wall -m_f; Shamir: bulk -1, wall m_f; y = D_W x or
// D_W z, K1's output).  Planes read and written: 4, 6, 6 and 6; a Moebius
// CGNE iteration runs passes 0, 1 and 2: 16 planes.
//
// What bounds it on the H100: bytes (a plane of the Moebius cell, 16^3x32 x
// Ls 12, is 75.5 MB: 6 planes take 0.135 ms at 3.35 TB/s).  The design:
//  * a thread owns one (column, channel, W sites) and walks s from 0 to
//    Ls-1, keeping in registers the slices of v it needs again (the
//    previous, the current and the first; the last, read first for the
//    wrap at s = 0, until s reaches it): each input element is read once
//    and each output element written once;
//  * neighbouring threads own neighbouring sites of one plane, so each
//    step's loads and stores are coalesced; 16-byte loads and stores
//    (ld.global.cs, st.global.cs: nothing is touched twice; W = 4 f32 or 2
//    f64 sites) where V % W == 0 and every plane pointer is 16-byte
//    aligned, one element a step otherwise;
//  * a grid-stride loop over a grid the wrapper caps at the blocks the
//    launch bounds keep resident on every SM: one wave.
// Products and sums round as PyTorch's separate passes round them
// (__fmul_rn, __fadd_rn, __fsub_rn or their f64 forms: nothing is
// contracted into an FMA), with the scalars, walls and weights formed as
// the plain version forms them (each rounded to the field's type, then
// lam * w), so the result equals the plain version's (ops/dw_s5.py
// dw_s5_reference) bit for bit.
//
// The outputs are new planes (the wrapper allocates them): no output is
// an input, so the pointers are __restrict__.
//
// Plain C interface (loaded with ctypes); each call returns the
// cudaError_t of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// blocks an SM the launch bounds keep resident (128 registers a thread)
constexpr int kBlocksPerSm = 2;
constexpr int kFeatures = 12;

template <typename T>
struct Args {
    const T* __restrict__ xr;
    const T* __restrict__ xi;
    const T* __restrict__ yr;
    const T* __restrict__ yi;
    T* __restrict__ outr;
    T* __restrict__ outi;
    const T* __restrict__ wp;   // [12] weights of v_{s+1}
    const T* __restrict__ wm;   // [12] weights of v_{s-1}
    int64_t V;
    int n, Ls;
    T b5, c5, bulk, wall;
};

// W consecutive sites of one plane, re and im
template <typename T, int W>
struct Slice {
    T re[W], im[W];
};

// the roundings of PyTorch's separate passes, f32 and f64
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// W elements at p + i: one 16-byte access where W > 1
__device__ __forceinline__ void load(const float* __restrict__ p, int64_t i, float (&v)[4]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p + i));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
}

__device__ __forceinline__ void load(const double* __restrict__ p, int64_t i, double (&v)[2]) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p + i));
    v[0] = a.x;
    v[1] = a.y;
}

template <typename T>
__device__ __forceinline__ void load(const T* __restrict__ p, int64_t i, T (&v)[1]) {
    v[0] = __ldcs(p + i);
}

__device__ __forceinline__ void store(float* __restrict__ p, int64_t i, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p + i), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store(double* __restrict__ p, int64_t i, const double (&v)[2]) {
    __stcs(reinterpret_cast<double2*>(p + i), make_double2(v[0], v[1]));
}

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ p, int64_t i, const T (&v)[1]) {
    __stcs(p + i, v[0]);
}

// d and v of one element from its x and y
template <int kPass, typename T>
__device__ __forceinline__ void prepare(T y, T x, T b5, T c5, T& d, T& v) {
    if constexpr (kPass == 0) {
        d = mul(b5, x);
        v = x;
    } else if constexpr (kPass == 1) {
        d = add(y, x);
        v = x;
    } else if constexpr (kPass == 2) {
        d = add(mul(b5, y), x);
        v = sub(mul(c5, y), x);
    } else {
        d = y;
        v = x;
    }
}

// hp v_{s+1} + hm v_{s-1}, rounded after each product and after the sum
template <typename T>
__device__ __forceinline__ T H(T hp, T next, T hm, T prev) {
    return add(mul(hp, next), mul(hm, prev));
}

template <int kPass, typename T>
__device__ __forceinline__ T finish(T d, T h, T c5) {
    if constexpr (kPass == 0)
        return add(d, mul(c5, h));
    else if constexpr (kPass == 1)
        return sub(d, h);
    else
        return add(d, h);
}

// d and v of the W sites at offset i of slice s's planes
template <int kPass, typename T, int W>
__device__ __forceinline__ void fetch(const Args<T>& a, int64_t i, Slice<T, W>& d,
                                      Slice<T, W>& v) {
    T xr[W], xi[W], yr[W] = {}, yi[W] = {};
    load(a.xr, i, xr);
    load(a.xi, i, xi);
    if constexpr (kPass != 0) {
        load(a.yr, i, yr);
        load(a.yi, i, yi);
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
        prepare<kPass>(yr[k], xr[k], a.b5, a.c5, d.re[k], v.re[k]);
        prepare<kPass>(yi[k], xi[k], a.b5, a.c5, d.im[k], v.im[k]);
    }
}

template <int kPass, typename T, int W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) dw_s5_kernel(const Args<T> a) {
    const int64_t words = a.V / W, step = kFeatures * a.V;   // step: one s-slice
    const int64_t items = (int64_t)a.n * kFeatures * words;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    const int last = a.Ls - 1;
    for (int64_t it = (int64_t)blockIdx.x * kThreads + threadIdx.x; it < items; it += stride) {
        const int64_t nf = it / words;
        const int f = (int)(nf % kFeatures);
        const int64_t base =
            ((nf / kFeatures) * a.Ls * kFeatures + f) * a.V + (it - nf * words) * W;
        const T wp = a.wp[f], wm = a.wm[f];
        Slice<T, W> d_last, v_last, d_cur, v_cur, d_next, v_next;
        fetch<kPass>(a, base + last * step, d_last, v_last);
        if (last > 0) {
            fetch<kPass>(a, base, d_cur, v_cur);
        } else {
            d_cur = d_last;
            v_cur = v_last;
        }
        const Slice<T, W> v_first = v_cur;
        Slice<T, W> v_prev = v_last;
        for (int s = 0; s <= last; ++s) {
            if (s + 1 < last) {
                fetch<kPass>(a, base + (s + 1) * step, d_next, v_next);
            } else if (s + 1 == last) {
                d_next = d_last;
                v_next = v_last;
            } else {
                v_next = v_first;               // s = Ls-1: v_{s+1} wraps to v_0
            }
            const T hp = mul(s == last ? a.wall : a.bulk, wp);
            const T hm = mul(s == 0 ? a.wall : a.bulk, wm);
            Slice<T, W> out;
#pragma unroll
            for (int k = 0; k < W; ++k) {
                out.re[k] = finish<kPass>(d_cur.re[k], H(hp, v_next.re[k], hm, v_prev.re[k]), a.c5);
                out.im[k] = finish<kPass>(d_cur.im[k], H(hp, v_next.im[k], hm, v_prev.im[k]), a.c5);
            }
            store(a.outr, base + s * step, out.re);
            store(a.outi, base + s * step, out.im);
            v_prev = v_cur;
            v_cur = v_next;
            d_cur = d_next;
        }
    }
}

template <int kPass, int kVec, typename T>
void launch(int vec, unsigned grid, cudaStream_t st, const Args<T>& a) {
    if (vec)
        dw_s5_kernel<kPass, T, kVec><<<grid, kThreads, 0, st>>>(a);
    else
        dw_s5_kernel<kPass, T, 1><<<grid, kThreads, 0, st>>>(a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int run(int pass, int vec, int n, int Ls, int64_t V, const void* xr, const void* xi,
        const void* yr, const void* yi, void* outr, void* outi, const void* wp, const void* wm,
        double b5, double c5, double bulk, double wall, int cap, void* stream) {
    constexpr int kVec = 16 / sizeof(T);    // sites a 16-byte access
    if (vec) {
        if (V % kVec != 0) return cudaErrorInvalidValue;
        const void* ptrs[] = {xr, xi, outr, outi};
        for (const void* p : ptrs)
            if (!aligned16(p)) return cudaErrorInvalidValue;
        if (pass != 0 && !(aligned16(yr) && aligned16(yi))) return cudaErrorInvalidValue;
    }
    // the scalars rounded to T, as PyTorch rounds a Python number it
    // multiplies a T tensor by or fills one with
    const Args<T> a{static_cast<const T*>(xr), static_cast<const T*>(xi),
                    static_cast<const T*>(yr), static_cast<const T*>(yi),
                    static_cast<T*>(outr), static_cast<T*>(outi),
                    static_cast<const T*>(wp), static_cast<const T*>(wm), V, n, Ls,
                    static_cast<T>(b5), static_cast<T>(c5), static_cast<T>(bulk),
                    static_cast<T>(wall)};
    const int64_t items = (int64_t)n * kFeatures * (vec ? V / kVec : V);
    const int64_t need = (items + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(need < cap ? need : cap);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pass) {
        case 0: launch<0, kVec>(vec, grid, st, a); break;
        case 1: launch<1, kVec>(vec, grid, st, a); break;
        case 2: launch<2, kVec>(vec, grid, st, a); break;
        default: launch<3, kVec>(vec, grid, st, a); break;
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pass: 0-3 as above; f64: 1 for f64 planes and weights, 0 for f32; vec:
// 1 for the 16-byte form (V a multiple of the sites a 16-byte access holds,
// 4 or 2, and every plane pointer 16-byte aligned), 0 for one element a
// step; n, Ls, V: the fields' columns, s-slices and sites (12 channels
// between s and the sites); xr..outi: the planes (yr, yi unread by pass
// 0); wp, wm: device pointers to the 12 channel weights, of the planes'
// type; b5, c5, bulk, wall: the pass's scalars (rounded to the planes'
// type here); cap: the most blocks a grid takes (the card's SMs times at
// most kBlocksPerSm); stream: the launch's cudaStream_t.
int sbt_dw_s5(int pass, int f64, int vec, int n, int Ls, int64_t V, const void* xr,
              const void* xi, const void* yr, const void* yi, void* outr, void* outi,
              const void* wp, const void* wm, double b5, double c5, double bulk, double wall,
              int cap, void* stream) {
    if (pass < 0 || pass > 3 || n < 1 || Ls < 1 || V < 1 || cap < 1) return cudaErrorInvalidValue;
    if (pass != 0 && (yr == nullptr || yi == nullptr)) return cudaErrorInvalidValue;
    return (f64 ? run<double> : run<float>)(pass, vec, n, Ls, V, xr, xi, yr, yi, outr, outi, wp,
                                             wm, b5, c5, bulk, wall, cap, stream);
}

}  // extern "C"
