// SoA nearest-neighbour Kron-BSR stencil matvec for Hopper (sm_90a), K1.
//
// Replaces the Pallas TPU kernel superbblas_tpu/ops/stencil_pallas.py
// stencil_matvec_soa (_kernel, _matvec_body).  It computes the sum of
// stencil_soa.cuh over a periodic 4-D lattice, in split complex:
//   x       [n, KD*BD, X, Y, Z, T]   field dtype (f32 or bf16)
//   blocks  [ndir, BI*BD, X, Y, Z, T] storage dtype (f32 or bf16)
//   kron    [ndir, KI, KD]           f32, runtime values (nullptr: K_d = 1)
//   y       [n, KI*BI, X, Y, Z, T]   field dtype; accumulation in f32.
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
//  * bf16 operands are converted on load, results rounded on store.
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
    const float* __restrict__ k_re, const float* __restrict__ k_im,
    const FT* __restrict__ x_re, const FT* __restrict__ x_im,
    FT* __restrict__ y_re, FT* __restrict__ y_im,
    int n, int X, int Y, int Z, int T, const __grid_constant__ Dirs dirs) {
    constexpr int F = KD * BD;    // input features
    constexpr int KO = KI * BI;   // output features

    extern __shared__ float skron[];   // [2, ndir, KI, KD]
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
    auto fetch = [&](int d, float (&v_re)[F], float (&v_im)[F]) {
        int64_t nb = s;
        const int ax = dirs.axis[d];
        const int sg = dirs.sign[d];
        bool move = sg != 0;
        if (move && ax == 0 && dirs.packed >= 0) {
            const bool odd = ((dirs.packed + cy + cz + ct) & 1) != 0;
            move = sg > 0 ? odd : !odd;
        }
        if (move) {
            const int c = ax == 0 ? cx : ax == 1 ? cy : ax == 2 ? cz : ct;
            const int L = ax == 0 ? X : ax == 1 ? Y : ax == 2 ? Z : T;
            const int64_t st = ax == 0 ? (int64_t)Y * Z * T
                             : ax == 1 ? (int64_t)Z * T
                             : ax == 2 ? (int64_t)T : 1;
            nb = shift_site(s, c, L, st, sg);
        }
        load_site<F>(xr, xi, V, nb, v_re, v_im);
    };

    float acc_re[KO], acc_im[KO];
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
        const size_t smem = 2 * sizeof(float) * dirs.ndir * KI * KD;
        stencil_soa_kernel<KI, KD, BI, BD, ST, FT><<<grid, block, smem, stream>>>(
            static_cast<const ST*>(a.b_re), static_cast<const ST*>(a.b_im), a.k_re, a.k_im,
            static_cast<const FT*>(a.x_re), static_cast<const FT*>(a.x_im),
            static_cast<FT*>(a.y_re), static_cast<FT*>(a.y_im), a.n, a.X, a.Y, a.Z, a.T,
            dirs);
        return cudaGetLastError();
    }
};

}  // namespace

extern "C" {

// offsets: host array [ndir, 4] of one-hot +-1 (or all-zero) offsets;
// packed_parity: 0 or 1 for checkerboard-packed operands, -1 for none.
int sbt_stencil_soa(int ki, int kd, int bi, int bd, int storage_bf16,
                    int field_bf16, const void* b_re, const void* b_im,
                    const void* k_re, const void* k_im, const void* x_re,
                    const void* x_im, void* y_re, void* y_im, int n, int X,
                    int Y, int Z, int T, int ndir, const int* offsets,
                    int packed_parity, void* stream) {
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, packed_parity, &dirs);
    if (err != cudaSuccess) return err;
    const Operands a{b_re, b_im, static_cast<const float*>(k_re),
                     static_cast<const float*>(k_im), x_re, x_im, y_re, y_im,
                     n, X, Y, Z, T};
    return dispatch<LaunchK1>(ki, kd, bi, bd, storage_bf16, field_bf16, a, dirs,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
