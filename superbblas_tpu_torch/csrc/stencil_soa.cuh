// Shared per-site math of the SoA stencil kernels (stencil_soa.cu: K1 at
// the clover term's shape in f64, stencil_rt.cu: K1's runtime-shape route,
// stencil_site.cu: the clover term's block-streaming kernel,
// stencil_schedules.cu: the X-inside and X-streaming schedules at every
// shape but the two of the spin plan, whose math is stencil_plan.cuh).
//
// All three compute, over a periodic 4-D lattice s = (X, Y, Z, T) with
// one-hot +-1 offsets o_d, in split complex (separate re/im planes),
//
//   y[n, a*BI+i, s] = sum_d sum_j B_d[i, j](s) * sum_b K_d[a, b] * x[n, b*BD+j, s+o_d]
//
// and differ only in where the neighbour values x[., ., s+o_d] come from.
// site_matvec() is the whole sum for one (site, column); the caller hands
// it a fetch functor that fills the F = KD*BD features of direction d's
// neighbour.  Every product and sum is an explicit fmaf in one fixed
// order, so the compiler cannot contract them differently in different
// kernels: these kernels give the same bits for the same inputs, and the
// tiled kernel does too where no direction of its spin plan factors.
//
// Types.  Blocks have a storage type ST and fields a field type FT; the
// sums run in acc_t<ST, FT>: f32 for every pair with f32 or bf16 (bf16
// converted on load, rounded on store), f64 for f64 blocks with f64
// fields.  The kron factors come in the sum's type.  K1 and the schedules
// take the five pairs of kPair below.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDirs = 16;

// (storage, field) type pair of a launch, as ops/stencil.py KERNEL_DTYPES
// orders them
enum kPair { kF32F32 = 0, kBf16F32 = 1, kBf16Bf16 = 2, kF32Bf16 = 3, kF64F64 = 4 };

// the type a (storage, field) pair sums in
template <typename ST, typename FT> struct AccOf { using type = float; };
template <> struct AccOf<double, double> { using type = double; };
template <typename ST, typename FT> using acc_t = typename AccOf<ST, FT>::type;

__device__ __forceinline__ float fma_a(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_a(double a, double b, double c) { return fma(a, b, c); }

struct Dirs {
    int ndir;
    int axis[kMaxDirs];   // 0..3 for X, Y, Z, T; -1 for the centre
    int sign[kMaxDirs];   // +1, -1, or 0 for the centre
    int packed;           // checkerboard parity of a packed-X operand; -1: none
};

// offsets: host array [ndir, 4] of one-hot +-1 (or all-zero) offsets.
inline cudaError_t parse_dirs(int ndir, const int* offsets, int packed, Dirs* dirs) {
    if (ndir < 1 || ndir > kMaxDirs || packed < -1 || packed > 1)
        return cudaErrorInvalidValue;
    dirs->ndir = ndir;
    dirs->packed = packed;
    for (int d = 0; d < ndir; ++d) {
        dirs->axis[d] = -1;
        dirs->sign[d] = 0;
        for (int a = 0; a < 4; ++a) {
            const int o = offsets[4 * d + a];
            if (o == 0) continue;
            if ((o != 1 && o != -1) || dirs->sign[d] != 0) return cudaErrorInvalidValue;
            dirs->axis[d] = a;
            dirs->sign[d] = o;
        }
    }
    return cudaSuccess;
}

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load_f(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_f(double v) { return v; }
// a value of x: from device memory (the read-only path) or, kSh, from
// shared memory
template <bool kSh, typename FT> __device__ __forceinline__ auto load_x(const FT* p) {
    if constexpr (kSh) return to_f(*p);
    else return load_f(p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// the F features of flat site nb of one column's field planes (re, im)
template <int F, typename FT, typename A>
__device__ __forceinline__ void load_site(const FT* xr, const FT* xi, int64_t V, int64_t nb,
                                          A (&v_re)[F], A (&v_im)[F]) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
        v_re[f] = load_f(xr + f * V + nb);
        v_im[f] = load_f(xi + f * V + nb);
    }
}

// the KO outputs of flat site s of column col into y [n, KO, V] (re, im)
template <int KO, typename FT, typename A>
__device__ __forceinline__ void store_site(FT* y_re, FT* y_im, int col, int64_t V, int64_t s,
                                           const A (&acc_re)[KO], const A (&acc_im)[KO]) {
    FT* yr = y_re + (int64_t)col * KO * V + s;
    FT* yi = y_im + (int64_t)col * KO * V + s;
#pragma unroll
    for (int o = 0; o < KO; ++o) {
        store_f(yr + o * V, acc_re[o]);
        store_f(yi + o * V, acc_im[o]);
    }
}

// index of the neighbour of flat index s one step along an axis whose
// coordinate is c, extent L and stride st, with periodic wrap
__device__ __forceinline__ int64_t shift_site(int64_t s, int c, int L, int64_t st, int sg) {
    if (sg > 0) return s + ((c == L - 1) ? -(int64_t)(L - 1) * st : st);
    return s + ((c == 0) ? (int64_t)(L - 1) * st : -st);
}

// flat index of the neighbour of site s = (cx, cy, cz, ct) in direction d
// on the torus; with a packed parity an X step moves only on the sites
// whose image parity m = (packed + cy + cz + ct) mod 2 asks for it (+x when
// m = 1, -x when m = 0)
__device__ __forceinline__ int64_t neighbour(const Dirs& dirs, int d, int64_t s, int cx,
                                             int cy, int cz, int ct, int X, int Y, int Z,
                                             int T) {
    const int ax = dirs.axis[d];
    const int sg = dirs.sign[d];
    bool move = sg != 0;
    if (move && ax == 0 && dirs.packed >= 0) {
        const bool odd = ((dirs.packed + cy + cz + ct) & 1) != 0;
        move = sg > 0 ? odd : !odd;
    }
    if (!move) return s;
    const int c = ax == 0 ? cx : ax == 1 ? cy : ax == 2 ? cz : ct;
    const int L = ax == 0 ? X : ax == 1 ? Y : ax == 2 ? Z : T;
    const int64_t st = ax == 0 ? (int64_t)Y * Z * T
                     : ax == 1 ? (int64_t)Z * T
                     : ax == 2 ? (int64_t)T : 1;
    return shift_site(s, c, L, st, sg);
}

// index within one X plane (Y*Z*T sites, T fastest) of the neighbour of
// plane site p = (cy*Z + cz)*T + ct along axis ax in 1..3
__device__ __forceinline__ int64_t shift_plane(int64_t p, int ax, int sg, int cy, int cz,
                                               int ct, int Y, int Z, int T) {
    if (ax == 1) return shift_site(p, cy, Y, (int64_t)Z * T, sg);
    if (ax == 2) return shift_site(p, cz, Z, T, sg);
    return shift_site(p, ct, T, 1, sg);
}

// the kron factors [2, ndir, KI, KD] into shared memory, by all threads
// of the block (nullptr: K_d = 1)
template <typename A>
__device__ __forceinline__ void stage_kron(A* skron, const A* k_re, const A* k_im, int nk) {
    const int nt = blockDim.x * blockDim.y * blockDim.z;
    const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
    for (int i = tid; i < nk; i += nt) {
        skron[i] = k_re ? k_re[i] : A(1);
        skron[nk + i] = k_im ? k_im[i] : A(0);
    }
}

// acc[a*BI+i] = sum_d sum_j B_d[i, j](s) sum_b K_d[a, b] x_d[b*BD+j] for
// one (site, column); fetch(d, re, im) fills x_d, the neighbour's F
// features; blocks are read at flat site s of a lattice of V sites; the
// sums run in A (acc_t of the launch's pair).
template <int KI, int KD, int BI, int BD, typename ST, typename A, typename Fetch>
__device__ __forceinline__ void site_matvec(const ST* __restrict__ b_re,
                                            const ST* __restrict__ b_im, int64_t V,
                                            int64_t s, const A* kre, const A* kim,
                                            int ndir, Fetch&& fetch,
                                            A (&acc_re)[KI * BI], A (&acc_im)[KI * BI]) {
    constexpr int F = KD * BD;
    constexpr int KK = KI * KD;
#pragma unroll
    for (int o = 0; o < KI * BI; ++o) acc_re[o] = acc_im[o] = A(0);

#pragma unroll 1
    for (int d = 0; d < ndir; ++d) {
        A xv_re[F], xv_im[F];
        fetch(d, xv_re, xv_im);

        // spin factor first: z[a][j] = sum_b K_d[a, b] x[b*BD + j]
        const A* kr = kre + d * KK;
        const A* ki = kim + d * KK;
        A z_re[KI][BD], z_im[KI][BD];
#pragma unroll
        for (int a = 0; a < KI; ++a) {
#pragma unroll
            for (int j = 0; j < BD; ++j) {
                A zr = A(0), zi = A(0);
#pragma unroll
                for (int b = 0; b < KD; ++b) {
                    const A cr = kr[a * KD + b], cim = ki[a * KD + b];
                    const A vr = xv_re[b * BD + j], vi = xv_im[b * BD + j];
                    zr = fma_a(cr, vr, zr);
                    zr = fma_a(-cim, vi, zr);
                    zi = fma_a(cr, vi, zi);
                    zi = fma_a(cim, vr, zi);
                }
                z_re[a][j] = zr;
                z_im[a][j] = zi;
            }
        }

        // then the colour block of this site: acc[a*BI+i] += B_d[i, j] z[a][j]
        const int64_t boff = (int64_t)d * BI * BD * V + s;
#pragma unroll
        for (int i = 0; i < BI; ++i) {
#pragma unroll
            for (int j = 0; j < BD; ++j) {
                const A br = load_f(b_re + boff + (i * BD + j) * V);
                const A bim = load_f(b_im + boff + (i * BD + j) * V);
#pragma unroll
                for (int a = 0; a < KI; ++a) {
                    A& ar = acc_re[a * BI + i];
                    A& ai = acc_im[a * BI + i];
                    ar = fma_a(br, z_re[a][j], ar);
                    ar = fma_a(-bim, z_im[a][j], ar);
                    ai = fma_a(br, z_im[a][j], ai);
                    ai = fma_a(bim, z_re[a][j], ai);
                }
            }
        }
    }
}

// The runtime-shape arithmetic, shared by the runtime-shape route
// (stencil_rt.cu) and the schedules (stencil_schedules.cu), so that both
// give the same bits: z[a][j] = sum_b K_d[a, b] x[b*BD + j] for b
// ascending (rt_zterm, from z = 0; rt_z), then (ar, ai) += B_d[i, j]
// z[a][j] for j ascending (rt_acc), the four fma_a of each complex product
// in site_matvec's order.
// kr, kim: row a of K_d (nullptr: K_d = 1); xr, xi: x[j] of the neighbour
// with feature stride xs (kSh: in shared memory).
// one term of z: (zr, zi) += (cr + i cim) (vr + i vi)
template <typename A>
__device__ __forceinline__ void rt_zterm(A cr, A cim, A vr, A vi, A& zr, A& zi) {
    zr = fma_a(cr, vr, zr);
    zr = fma_a(-cim, vi, zr);
    zi = fma_a(cr, vi, zi);
    zi = fma_a(cim, vr, zi);
}
template <bool kSh, typename I, typename FT, typename A>
__device__ __forceinline__ void rt_z(const A* kr, const A* kim, int KD, int BD, const FT* xr,
                                     const FT* xi, I xs, A& zr, A& zi) {
    zr = A(0);
    zi = A(0);
    for (int b = 0; b < KD; ++b)
        rt_zterm(kr ? kr[b] : A(1), kim ? kim[b] : A(0), A(load_x<kSh>(xr + b * BD * xs)),
                 A(load_x<kSh>(xi + b * BD * xs)), zr, zi);
}
template <typename A>
__device__ __forceinline__ void rt_acc(A b_r, A b_i, A zr, A zi, A& ar, A& ai) {
    ar = fma_a(b_r, zr, ar);
    ar = fma_a(-b_i, zi, ar);
    ai = fma_a(b_r, zi, ai);
    ai = fma_a(b_i, zr, ai);
}

// The runtime-shape sum of one direction d for one output a*BI + i of one
// (site, column), at run-time KD, BD: (ar, ai) += sum_j B_d[i, j] z[a][j]
// (rt_z, rt_acc).  br, bi: B_d[i, 0](s) with entry stride bs.
template <bool kSh, typename I, typename ST, typename FT, typename A>
__device__ __forceinline__ void rt_direction(const A* kr, const A* kim, int KD, int BD,
                                             const FT* xr, const FT* xi, I xs,
                                             const ST* br, const ST* bi, I bs, A& ar,
                                             A& ai) {
    for (int j = 0; j < BD; ++j) {
        A zr, zi;
        rt_z<kSh>(kr, kim, KD, BD, xr + j * xs, xi + j * xs, xs, zr, zi);
        rt_acc(A(load_f(br + j * bs)), A(load_f(bi + j * bs)), zr, zi, ar, ai);
    }
}

// the (storage, field) type instantiations of one (KI, KD, BI, BD)
// shape: calls Launch<KI, KD, BI, BD, ST, FT>::run(args...) for the kPair
// ``pair``; kAllPairs adds f32/bf16 and f64/f64 to the first three
template <template <int, int, int, int, typename, typename> class Launch, int KI, int KD,
          int BI, int BD, bool kAllPairs, typename... Args>
cudaError_t dispatch_types(int pair, Args... args) {
    switch (pair) {
        case kF32F32: return Launch<KI, KD, BI, BD, float, float>::run(args...);
        case kBf16F32: return Launch<KI, KD, BI, BD, __nv_bfloat16, float>::run(args...);
        case kBf16Bf16:
            return Launch<KI, KD, BI, BD, __nv_bfloat16, __nv_bfloat16>::run(args...);
        default: break;
    }
    if constexpr (kAllPairs) {
        if (pair == kF32Bf16) return Launch<KI, KD, BI, BD, float, __nv_bfloat16>::run(args...);
        if (pair == kF64F64) return Launch<KI, KD, BI, BD, double, double>::run(args...);
    }
    return cudaErrorInvalidValue;
}

// the (KI, KD, BI, BD) shapes the tiled kernel and the schedules are
// instantiated at (K1's templated kernel takes (1, 1, 12, 12) in
// stencil_soa.cu), each with its type pairs
template <template <int, int, int, int, typename, typename> class Launch, bool kAllPairs,
          typename... Args>
cudaError_t dispatch(int ki, int kd, int bi, int bd, int pair, Args... args) {
    if (ki == 4 && kd == 4 && bi == 3 && bd == 3)
        return dispatch_types<Launch, 4, 4, 3, 3, kAllPairs>(pair, args...);
    if (ki == 1 && kd == 1 && bi == 3 && bd == 3)
        return dispatch_types<Launch, 1, 1, 3, 3, kAllPairs>(pair, args...);
    return cudaErrorInvalidValue;
}

// the arguments every stencil entry point takes, after the type pair; the
// kron factors are of the pair's acc_t
struct Operands {
    const void *b_re, *b_im;
    const void *k_re, *k_im;
    const void *x_re, *x_im;
    void *y_re, *y_im;
    int n, X, Y, Z, T;
};

}  // namespace
