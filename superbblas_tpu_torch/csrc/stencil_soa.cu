// SoA nearest-neighbour Kron-BSR stencil matvec for Hopper (sm_90a), K1.
//
// Replaces the Pallas TPU kernel superbblas_tpu/ops/stencil_pallas.py
// stencil_matvec_soa (_kernel, _matvec_body).  It computes the sum of
// stencil_soa.cuh over a periodic 4-D lattice, in split complex:
//   x       [n, KD*BD, X, Y, Z, T]   field dtype FT
//   blocks  [ndir, BI*BD, X, Y, Z, T] storage dtype ST
//   kron    [ndir, KI, KD]           acc_t<ST, FT>, runtime values
//                                    (nullptr: K_d = 1)
//   y       [n, KI*BI, X, Y, Z, T]   field dtype; sums in acc_t<ST, FT>.
// (ST, FT) is one of five pairs (stencil_soa.cuh kPair): f32/f32,
// bf16/f32, bf16/bf16 and f32/bf16 (the TPU kernel's pairs, summed in
// f32, bf16 converted on load and rounded on store), and f64/f64, summed
// in f64 (the port's own: the JAX package computes an f64 SoA operator
// through its reference).  The f64 route is there to be right, not fast:
// it moves twice the bytes and runs at the card's f64 FMA rate, and the
// templated (4, 4, 3, 3) instantiation holds 12 complex inputs, 12 complex
// sums and a 4x3 complex spin product in double registers (PERF.md says
// whether it spills).
//
// Two routes take every shape the TPU kernel takes (KI*KD*BI*BD <= 256):
// the templated kernel, with the sums unrolled for (4, 4, 3, 3) (Wilson,
// twisted mass, domain wall), (1, 1, 3, 3) (staggered) and (1, 1, 12, 12)
// (the clover term: 12 inputs, 12 outputs, 144 block loads a site), and
// the runtime-shape kernel stencil_soa_rt_kernel for every other shape.
//
// Packed parity.  With packed_parity p in {0, 1} the operands hold one
// checkerboard parity with X halved (site (x, y, z, t) at xh = x / 2), and
// an X shift moves to the packed slot of the image site's neighbour: with
// m = (p + y + z + t) mod 2, +x reads slot xh+1 (wrapped) when m = 1, else
// xh; -x reads slot xh when m = 1, else xh-1 (wrapped).  Y, Z and T shifts
// are unchanged.  This is the parity-select X shift of the TPU kernel
// (stencil_pallas.py _kernel, packed_parity) and of the plain version.
//
// What bounds it on the H100.  By its counts, bytes: per site and column,
// f32 Wilson (ndir=9, KI=KD=4, BI=BD=3) does 6048 flops
// (flops_per_matvec) against at least 273 B of device memory traffic
// (x 96 B + y 96 B + links 648 B shared by 8 columns), about 22 flop/B,
// near the card's f32 ridge.  As measured (PERF.md), not bytes: bf16
// links and fields halve the bytes and leave the time unchanged, and the
// kernel moves about 17% of the card's HBM bandwidth.  It is bound by
// issue and latency, at 128 registers a thread and about 25% occupancy.
//
// What the design does about the traffic:
//  * one thread per (site, column); the flat site index is T-fastest, so
//    a warp reads 32 consecutive T addresses of every SoA plane;
//  * the columns of a block share its sites (threadIdx.y = column), so
//    the links B_d(s) a warp loads are served to the other columns from
//    L1 instead of device memory;
//  * neighbours are addressed directly with periodic wrap per axis; the
//    reuse of x between neighbouring sites is left to L1/L2 (no halo
//    copy, no shared-memory tiling; the schedules of stencil_schedules.cu
//    stage the X neighbours in shared memory instead);
//  * kron factors are staged once per block in shared memory;
//  * bf16 operands are converted on load, results rounded on store;
//  * one template over the type pair, so the f64 route is the same code
//    with double registers and fma in place of fmaf.
// Constant-folded gamma entries and the rank-2 half-spinor projection of
// the TPU kernel's _factor_kron are not done here.
//
// Plain C interface (loaded with ctypes); every call returns the
// cudaError_t of its launch.

#include "stencil_soa.cuh"

namespace {

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
__global__ void __launch_bounds__(256) stencil_soa_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im,
    const acc_t<ST, FT>* __restrict__ k_re, const acc_t<ST, FT>* __restrict__ k_im,
    const FT* __restrict__ x_re, const FT* __restrict__ x_im,
    FT* __restrict__ y_re, FT* __restrict__ y_im,
    int n, int X, int Y, int Z, int T, const __grid_constant__ Dirs dirs) {
    using A = acc_t<ST, FT>;
    constexpr int F = KD * BD;    // input features
    constexpr int KO = KI * BI;   // output features

    extern __shared__ __align__(16) unsigned char smem_raw[];
    A* skron = reinterpret_cast<A*>(smem_raw);   // [2, ndir, KI, KD]
    const int nk = dirs.ndir * KI * KD;
    stage_kron(skron, k_re, k_im, nk);
    __syncthreads();

    const int64_t V = (int64_t)X * Y * Z * T;
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int col = blockIdx.y * blockDim.y + threadIdx.y;
    if (s >= V || col >= n) return;

    const int ct = (int)(s % T);
    const int cz = (int)((s / T) % Z);
    const int cy = (int)((s / ((int64_t)T * Z)) % Y);
    const int cx = (int)(s / ((int64_t)T * Z * Y));
    const FT* xr = x_re + (int64_t)col * F * V;
    const FT* xi = x_im + (int64_t)col * F * V;

    // neighbour site s + o_d on the torus, read from device memory
    auto fetch = [&](int d, A (&v_re)[F], A (&v_im)[F]) {
        load_site<F>(xr, xi, V, neighbour(dirs, d, s, cx, cy, cz, ct, X, Y, Z, T), v_re,
                     v_im);
    };

    A acc_re[KO], acc_im[KO];
    site_matvec<KI, KD, BI, BD, ST>(b_re, b_im, V, s, skron, skron + nk, dirs.ndir, fetch,
                                    acc_re, acc_im);
    store_site<KO>(y_re, y_im, col, V, s, acc_re, acc_im);
}

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
struct LaunchK1 {
    static cudaError_t run(const Operands& a, const Dirs& dirs, cudaStream_t stream) {
        // columns of a block share its sites (link reuse in L1); 256 threads
        const int cols = a.n < 8 ? a.n : 8;
        int sites = (256 / cols) / 32 * 32;
        if (sites < 32) sites = 32;
        const int64_t V = (int64_t)a.X * a.Y * a.Z * a.T;
        const dim3 block(sites, cols);
        const dim3 grid((unsigned)((V + sites - 1) / sites),
                        (unsigned)((a.n + cols - 1) / cols));
        using A = acc_t<ST, FT>;
        const size_t smem = 2 * sizeof(A) * dirs.ndir * KI * KD;
        stencil_soa_kernel<KI, KD, BI, BD, ST, FT><<<grid, block, smem, stream>>>(
            static_cast<const ST*>(a.b_re), static_cast<const ST*>(a.b_im),
            static_cast<const A*>(a.k_re), static_cast<const A*>(a.k_im),
            static_cast<const FT*>(a.x_re), static_cast<const FT*>(a.x_im),
            static_cast<FT*>(a.y_re), static_cast<FT*>(a.y_im), a.n, a.X, a.Y, a.Z, a.T,
            dirs);
        return cudaGetLastError();
    }
};

// The runtime-shape route: any (KI, KD, BI, BD) with KI*KD*BI*BD <= 256.
// One thread per (site, column, output feature o = a*BI + i), looping over
// d, j and b at run time: y[., o, s] = sum_d sum_j B_d[i, j](s) *
// sum_b K_d[a, b] x[., b*BD + j, s + o_d].  The products and sums are the
// fma_a of site_matvec in its order, so at a templated shape this route
// gives the templated route's bits.  Row a of every K_d sits in shared
// memory; x and the blocks are read from device memory, their reuse
// across the outputs of a site left to L1/L2.
template <typename ST, typename FT>
__global__ void __launch_bounds__(256) stencil_soa_rt_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im,
    const acc_t<ST, FT>* __restrict__ k_re, const acc_t<ST, FT>* __restrict__ k_im,
    const FT* __restrict__ x_re, const FT* __restrict__ x_im,
    FT* __restrict__ y_re, FT* __restrict__ y_im, int KI, int KD, int BI, int BD,
    int X, int Y, int Z, int T, const __grid_constant__ Dirs dirs) {
    using A = acc_t<ST, FT>;
    const int o = blockIdx.y;   // output feature a*BI + i
    const int a = o / BI, i = o - a * BI;
    const int col = blockIdx.z;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    A* skron = reinterpret_cast<A*>(smem_raw);   // [2, ndir, KD]: row a of each K_d
    const int nk = dirs.ndir * KD;
    for (int t = threadIdx.x; t < nk; t += blockDim.x) {
        const int d = t / KD, b = t - d * KD;
        skron[t] = k_re ? k_re[(d * KI + a) * KD + b] : A(1);
        skron[nk + t] = k_im ? k_im[(d * KI + a) * KD + b] : A(0);
    }
    __syncthreads();

    const int64_t V = (int64_t)X * Y * Z * T;
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= V) return;
    const int ct = (int)(s % T);
    const int cz = (int)((s / T) % Z);
    const int cy = (int)((s / ((int64_t)T * Z)) % Y);
    const int cx = (int)(s / ((int64_t)T * Z * Y));
    const int F = KD * BD;
    const FT* xr = x_re + (int64_t)col * F * V;
    const FT* xi = x_im + (int64_t)col * F * V;

    A ar = A(0), ai = A(0);
    for (int d = 0; d < dirs.ndir; ++d) {
        const int64_t nb = neighbour(dirs, d, s, cx, cy, cz, ct, X, Y, Z, T);
        const A* kr = skron + d * KD;
        const A* kim = skron + nk + d * KD;
        const int64_t boff = ((int64_t)d * BI * BD + (int64_t)i * BD) * V + s;
        for (int j = 0; j < BD; ++j) {
            A zr = A(0), zi = A(0);
            for (int b = 0; b < KD; ++b) {
                const A cr = kr[b], cim = kim[b];
                const A vr = load_f(xr + (b * BD + j) * V + nb);
                const A vi = load_f(xi + (b * BD + j) * V + nb);
                zr = fma_a(cr, vr, zr);
                zr = fma_a(-cim, vi, zr);
                zi = fma_a(cr, vi, zi);
                zi = fma_a(cim, vr, zi);
            }
            const A br = load_f(b_re + boff + j * V);
            const A bim = load_f(b_im + boff + j * V);
            ar = fma_a(br, zr, ar);
            ar = fma_a(-bim, zi, ar);
            ai = fma_a(br, zi, ai);
            ai = fma_a(bim, zr, ai);
        }
    }
    const int64_t out = ((int64_t)col * KI * BI + o) * V + s;
    store_f(y_re + out, ar);
    store_f(y_im + out, ai);
}

template <typename ST, typename FT>
cudaError_t launch_rt(const Operands& a, const Dirs& dirs, int KI, int KD, int BI, int BD,
                      cudaStream_t stream) {
    const int64_t V = (int64_t)a.X * a.Y * a.Z * a.T;
    const dim3 grid((unsigned)((V + 255) / 256), (unsigned)(KI * BI), (unsigned)a.n);
    using A = acc_t<ST, FT>;
    const size_t smem = 2 * sizeof(A) * dirs.ndir * KD;
    stencil_soa_rt_kernel<ST, FT><<<grid, 256, smem, stream>>>(
        static_cast<const ST*>(a.b_re), static_cast<const ST*>(a.b_im),
        static_cast<const A*>(a.k_re), static_cast<const A*>(a.k_im),
        static_cast<const FT*>(a.x_re), static_cast<const FT*>(a.x_im),
        static_cast<FT*>(a.y_re), static_cast<FT*>(a.y_im), KI, KD, BI, BD, a.X, a.Y, a.Z,
        a.T, dirs);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// pair: the kPair of (storage, field) types; offsets: host array [ndir,
// 4] of one-hot +-1 (or all-zero) offsets; packed_parity: 0 or 1 for
// checkerboard-packed operands, -1 for none.  The templated route: (KI,
// KD, BI, BD) in (4, 4, 3, 3), (1, 1, 3, 3), (1, 1, 12, 12).
int sbt_stencil_soa(int ki, int kd, int bi, int bd, int pair,
                    const void* b_re, const void* b_im,
                    const void* k_re, const void* k_im, const void* x_re,
                    const void* x_im, void* y_re, void* y_im, int n, int X,
                    int Y, int Z, int T, int ndir, const int* offsets,
                    int packed_parity, void* stream) {
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, packed_parity, &dirs);
    if (err != cudaSuccess) return err;
    const Operands a{b_re, b_im, k_re, k_im, x_re, x_im, y_re, y_im, n, X, Y, Z, T};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (ki == 1 && kd == 1 && bi == 12 && bd == 12)
        return dispatch_types<LaunchK1, 1, 1, 12, 12, true>(pair, a, dirs, st);
    return dispatch<LaunchK1, true>(ki, kd, bi, bd, pair, a, dirs, st);
}

// The runtime-shape route: any shape with ki*kd*bi*bd <= 256, n <= 65535.
int sbt_stencil_soa_rt(int ki, int kd, int bi, int bd, int pair,
                       const void* b_re, const void* b_im,
                       const void* k_re, const void* k_im, const void* x_re,
                       const void* x_im, void* y_re, void* y_im, int n, int X,
                       int Y, int Z, int T, int ndir, const int* offsets,
                       int packed_parity, void* stream) {
    if (ki < 1 || kd < 1 || bi < 1 || bd < 1 || ki * kd * bi * bd > 256 || n < 1 ||
        n > 65535)
        return cudaErrorInvalidValue;
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, packed_parity, &dirs);
    if (err != cudaSuccess) return err;
    const Operands a{b_re, b_im, k_re, k_im, x_re, x_im, y_re, y_im, n, X, Y, Z, T};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
        case kF32F32: return launch_rt<float, float>(a, dirs, ki, kd, bi, bd, st);
        case kBf16F32: return launch_rt<__nv_bfloat16, float>(a, dirs, ki, kd, bi, bd, st);
        case kBf16Bf16:
            return launch_rt<__nv_bfloat16, __nv_bfloat16>(a, dirs, ki, kd, bi, bd, st);
        case kF32Bf16: return launch_rt<float, __nv_bfloat16>(a, dirs, ki, kd, bi, bd, st);
        case kF64F64: return launch_rt<double, double>(a, dirs, ki, kd, bi, bd, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // extern "C"
