// SoA nearest-neighbour Kron-BSR stencil matvec for Hopper (sm_90a), K1,
// at the clover term's shape in f64.
//
// Replaces the Pallas TPU kernel superbblas_tpu/ops/stencil_pallas.py
// stencil_matvec_soa (_kernel, _matvec_body) at (1, 1, 12, 12) for the
// f64/f64 pair.  The Wilson and staggered shapes run the tiled kernel with
// the spin plan (stencil_tiled.cu), the clover term's at the f32-summed
// pairs the block-streaming kernel (stencil_site.cu), every other shape
// the runtime-shape route (stencil_rt.cu).  It computes the sum of
// stencil_soa.cuh over a periodic 4-D lattice, in split complex:
//   x       [n, KD*BD, X, Y, Z, T]   field dtype FT
//   blocks  [ndir, BI*BD, X, Y, Z, T] storage dtype ST
//   kron    [ndir, KI, KD]           acc_t<ST, FT>, runtime values
//                                    (nullptr: K_d = 1)
//   y       [n, KI*BI, X, Y, Z, T]   field dtype; sums in acc_t<ST, FT>.
// The kernel is templated over the type pair; it is instantiated for
// f64/f64, summed in f64 (the port's own: the JAX package computes an f64
// SoA operator through its reference), which is there to be right, not
// fast.  Its sums are site_matvec's, so it gives the runtime-shape
// route's bits.
//
// Packed parity.  With packed_parity p in {0, 1} the operands hold one
// checkerboard parity with X halved (site (x, y, z, t) at xh = x / 2), and
// an X shift moves to the packed slot of the image site's neighbour: with
// m = (p + y + z + t) mod 2, +x reads slot xh+1 (wrapped) when m = 1, else
// xh; -x reads slot xh when m = 1, else xh-1 (wrapped).  Y, Z and T shifts
// are unchanged.  This is the parity-select X shift of the TPU kernel
// (stencil_pallas.py _kernel, packed_parity) and of the plain version.
//
// What bounds it on the H100.  The clover term by bytes (144 block
// entries a site against 12 inputs and 12 outputs a column); at f32 the
// templated kernel ran at 3.3-4.5x that bound (PERF.md), which is why the
// f32-summed pairs moved to stencil_site.cu.
//
// What the design does about the traffic:
//  * one thread per (site, column); the flat site index is T-fastest, so
//    a warp reads 32 consecutive T addresses of every SoA plane;
//  * the columns of a block share its sites (threadIdx.y = column), so
//    the links B_d(s) a warp loads are served to the other columns from
//    L1 instead of device memory;
//  * neighbours are addressed directly with periodic wrap per axis; the
//    reuse of x between neighbouring sites is left to L1/L2;
//  * kron factors are staged once per block in shared memory, as runtime
//    values (the spin plan is the tiled kernel's);
//  * bf16 operands are converted on load, results rounded on store;
//  * one template over the type pair, so the f64 route is the same code
//    with double registers and fma in place of fmaf.
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
    if (s >= V) return;

    const int ct = (int)(s % T);
    const int cz = (int)((s / T) % Z);
    const int cy = (int)((s / ((int64_t)T * Z)) % Y);
    const int cx = (int)(s / ((int64_t)T * Z * Y));
    // the columns walk grid.y in strides of the whole grid's columns, so
    // any n fits the 65535 blocks grid.y allows
    for (int64_t col = (int64_t)blockIdx.y * blockDim.y + threadIdx.y; col < n;
         col += (int64_t)gridDim.y * blockDim.y) {
        const FT* xr = x_re + col * F * V;
        const FT* xi = x_im + col * F * V;

        // neighbour site s + o_d on the torus, read from device memory
        auto fetch = [&](int d, A (&v_re)[F], A (&v_im)[F]) {
            load_site<F>(xr, xi, V, neighbour(dirs, d, s, cx, cy, cz, ct, X, Y, Z, T), v_re,
                         v_im);
        };

        A acc_re[KO], acc_im[KO];
        site_matvec<KI, KD, BI, BD, ST>(b_re, b_im, V, s, skron, skron + nk, dirs.ndir,
                                        fetch, acc_re, acc_im);
        store_site<KO>(y_re, y_im, static_cast<int>(col), V, s, acc_re, acc_im);
    }
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
        const int col_blocks = (a.n + cols - 1) / cols;
        const dim3 grid((unsigned)((V + sites - 1) / sites),
                        (unsigned)(col_blocks < 65535 ? col_blocks : 65535));
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

}  // namespace

extern "C" {

// pair: the kPair of (storage, field) types; offsets: host array [ndir,
// 4] of one-hot +-1 (or all-zero) offsets; packed_parity: 0 or 1 for
// checkerboard-packed operands, -1 for none.  The templated route: (KI,
// KD, BI, BD) = (1, 1, 12, 12) at f64/f64 (stencil_site.cu takes the
// other pairs); stencil_tiled.cu takes (4, 4, 3, 3) and (1, 1, 3, 3).
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
    if (ki == 1 && kd == 1 && bi == 12 && bd == 12 && pair == kF64F64)
        return LaunchK1<1, 1, 12, 12, double, double>::run(a, dirs, st);
    return cudaErrorInvalidValue;
}

}  // extern "C"
