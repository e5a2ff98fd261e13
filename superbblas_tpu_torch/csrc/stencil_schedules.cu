// Two other schedules of the SoA stencil matvec K1 for Hopper (sm_90a):
// the X-inside kernel (K4a) and the X-streaming kernel (K4b).
//
// Replace the Pallas TPU kernels superbblas_tpu/ops/stencil_pallas.py
// stencil_matvec_soa_xin (_kernel_xin) and stencil_matvec_soa_stream
// (_kernel_stream).  Both compute exactly what K1 (stencil_soa.cu)
// computes, with the same operands and contract (no packed parity), and
// share its per-site math (site_matvec in stencil_soa.cuh), so they sum in
// the same order and give the same bits.  They differ in where the X
// neighbours come from: K1 reads x(s-x), x(s) and x(s+x) from device
// memory (three reads of every x value, the reuse left to L1/L2); these
// stage the X line of each (y, z, t) site and column in shared memory, so
// x is read from device memory about once for the centre and X terms.
// Y, Z and T neighbours are read from device memory, as in K1.
//
// What bounds them: what bounds K1 (instruction rate and latency at low
// occupancy, PERF.md); these
// save bytes, and K1 is not bound by bytes.  Both keep one thread per
// (site, column) pair of a tile, so their occupancy is set by the shared
// memory a tile needs.
//
// K4a, X inside.  A block owns a tile of S (y, z, t) sites x C columns
// and the whole X extent: it loads the tile's X lines (X x C x F x 2
// values of the field type) into shared memory once, then XG thread
// groups compute the X planes in turn; +-x neighbours wrap within the
// block.  X x 96 B per pair in f32 (F = 12), so at X = 32 at most 75
// pairs fit in 227 KB; the wrapper picks (S, C, XG) and raises where no
// tile fits, as the TPU wrapper does.
//
// K4b, X streaming.  The TPU kernel walks X in sequential grid steps and
// carries two planes in VMEM scratch; here blocks run in no order, so a
// loop over x inside the block takes the place of the sequential grid
// axis.  A block owns S sites x C columns and keeps a ring of four X
// planes of its tile: x-1, x and x+1 for the plane it computes, and x+2,
// which is loaded with cp.async (f32 fields) while plane x is computed.
// The ring is primed with planes X-1, 0 and 1; no plane is computed
// twice.  Each thread copies and reads only its own (site, column) line,
// so the ring needs no barrier: cp.async.wait_group orders each thread's
// own copies.  4 x 96 B per pair in f32.  bf16 fields are copied with
// plain loads (cp.async moves 4, 8 or 16 bytes; one bf16 is 2).
//
// Plain C interface (loaded with ctypes); every call returns the
// cudaError_t of its launch.

#include "stencil_soa.cuh"

namespace {

// The "memory" clobbers keep the compiler from moving the ring's ordinary
// shared-memory reads across these asm statements: no read of a slot moves
// above the wait that lands it, nor below the copy that refills it.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async(__nv_bfloat16* dst, const __nv_bfloat16* src) {
    *dst = *src;
}
__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest committed group of this thread's copies have landed
__device__ __forceinline__ void copy_wait_but_newest() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the F features of one (site, column) slot of a line in shared memory:
// feature f's re part at l[2f*S], its im part at l[(2f+1)*S]
template <int F, typename FT>
__device__ __forceinline__ void load_slot(const FT* l, int S, float (&v_re)[F],
                                          float (&v_im)[F]) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
        v_re[f] = to_f(l[(2 * f) * S]);
        v_im[f] = to_f(l[(2 * f + 1) * S]);
    }
}

// floats of the kron stage, rounded up to 16 bytes
__host__ __device__ __forceinline__ int kron_floats(int nk) { return (2 * nk + 3) / 4 * 4; }

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
__global__ void __launch_bounds__(256) stencil_soa_xin_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im,
    const float* __restrict__ k_re, const float* __restrict__ k_im,
    const FT* __restrict__ x_re, const FT* __restrict__ x_im,
    FT* __restrict__ y_re, FT* __restrict__ y_im,
    int n, int X, int Y, int Z, int T, const __grid_constant__ Dirs dirs) {
    constexpr int F = KD * BD;
    constexpr int KO = KI * BI;
    const int S = blockDim.x, C = blockDim.y, XG = blockDim.z;

    extern __shared__ float smem[];
    const int nk = dirs.ndir * KI * KD;
    float* skron = smem;                                     // [2, ndir, KI, KD]
    FT* lines = reinterpret_cast<FT*>(smem + kron_floats(nk));   // [X, C, F, 2, S]
    stage_kron(skron, k_re, k_im, nk);

    const int64_t Vp = (int64_t)Y * Z * T;   // sites of one X plane
    const int64_t V = X * Vp;
    const int64_t p0 = (int64_t)blockIdx.x * S;
    const int col0 = blockIdx.y * C;

    // the tile's X lines, by all threads: row r = ((xx*C + c)*F + f)*2 + part
    // of S sites, thread x taking site x of every row (coalesced)
    if (p0 + threadIdx.x < Vp) {
        const int rows = X * C * F * 2;
        for (int r = threadIdx.z * C + threadIdx.y; r < rows; r += C * XG) {
            const int part = r & 1;
            const int f = (r >> 1) % F;
            const int c = (r / (2 * F)) % C;
            const int xx = r / (2 * F * C);
            if (col0 + c < n)
                lines[(int64_t)r * S + threadIdx.x] = (part ? x_im : x_re)[
                    ((int64_t)(col0 + c) * F + f) * V + xx * Vp + p0 + threadIdx.x];
        }
    }
    __syncthreads();

    const int sl = threadIdx.x, c = threadIdx.y;
    const int64_t p = p0 + sl;
    const int col = col0 + c;
    if (p >= Vp || col >= n) return;
    const int ct = (int)(p % T);
    const int cz = (int)((p / T) % Z);
    const int cy = (int)(p / ((int64_t)T * Z));
    const FT* xr = x_re + (int64_t)col * F * V;
    const FT* xi = x_im + (int64_t)col * F * V;
    const FT* line = lines + (int64_t)c * F * 2 * S + sl;   // + (xx*C*F + f)*2*S + part*S
    const int64_t xstride = (int64_t)C * F * 2 * S;

    for (int xx = threadIdx.z; xx < X; xx += XG) {
        const int64_t s = xx * Vp + p;
        auto fetch = [&](int d, float (&v_re)[F], float (&v_im)[F]) {
            const int ax = dirs.axis[d];
            const int sg = dirs.sign[d];
            if (sg == 0 || ax == 0) {
                const int xn = sg == 0 ? xx
                             : sg > 0 ? (xx == X - 1 ? 0 : xx + 1)
                                      : (xx == 0 ? X - 1 : xx - 1);
                load_slot<F>(line + xn * xstride, S, v_re, v_im);
            } else {
                load_site<F>(xr, xi, V, xx * Vp + shift_plane(p, ax, sg, cy, cz, ct, Y, Z, T),
                             v_re, v_im);
            }
        };
        float acc_re[KO], acc_im[KO];
        site_matvec<KI, KD, BI, BD, ST>(b_re, b_im, V, s, skron, skron + nk, dirs.ndir,
                                        fetch, acc_re, acc_im);
        store_site<KO>(y_re, y_im, col, V, s, acc_re, acc_im);
    }
}

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
__global__ void __launch_bounds__(256) stencil_soa_stream_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im,
    const float* __restrict__ k_re, const float* __restrict__ k_im,
    const FT* __restrict__ x_re, const FT* __restrict__ x_im,
    FT* __restrict__ y_re, FT* __restrict__ y_im,
    int n, int X, int Y, int Z, int T, const __grid_constant__ Dirs dirs) {
    constexpr int F = KD * BD;
    constexpr int KO = KI * BI;
    const int S = blockDim.x, C = blockDim.y;

    extern __shared__ float smem[];
    const int nk = dirs.ndir * KI * KD;
    float* skron = smem;                                    // [2, ndir, KI, KD]
    FT* ring = reinterpret_cast<FT*>(smem + kron_floats(nk));   // [4, C, F, 2, S]
    stage_kron(skron, k_re, k_im, nk);
    __syncthreads();

    const int64_t Vp = (int64_t)Y * Z * T;
    const int64_t V = X * Vp;
    const int sl = threadIdx.x, c = threadIdx.y;
    const int64_t p = (int64_t)blockIdx.x * S + sl;
    const int col = blockIdx.y * C + c;
    // from here on each thread works on its own line alone: no barrier
    if (p >= Vp || col >= n) return;
    const int ct = (int)(p % T);
    const int cz = (int)((p / T) % Z);
    const int cy = (int)(p / ((int64_t)T * Z));
    const FT* xr = x_re + (int64_t)col * F * V;
    const FT* xi = x_im + (int64_t)col * F * V;
    FT* mine = ring + (int64_t)c * F * 2 * S + sl;   // + (slot*C*F + f)*2*S + part*S
    const int64_t slot_stride = (int64_t)C * F * 2 * S;

    // ring position q holds plane (q - 1) mod X in slot q % 4
    auto load_plane = [&](int q) {
        const int xx = q == 0 ? X - 1 : (q - 1) % X;
        FT* dst = mine + (q & 3) * slot_stride;
#pragma unroll
        for (int f = 0; f < F; ++f) {
            copy_async(dst + (2 * f) * S, xr + f * V + xx * Vp + p);
            copy_async(dst + (2 * f + 1) * S, xi + f * V + xx * Vp + p);
        }
    };
    load_plane(0);
    load_plane(1);
    load_plane(2);
    copy_commit();

    for (int xx = 0; xx < X; ++xx) {
        if (xx + 3 <= X + 1) load_plane(xx + 3);   // plane x+2, while x is computed
        copy_commit();
        copy_wait_but_newest();                    // positions up to xx + 2 landed
        const int64_t s = xx * Vp + p;
        auto fetch = [&](int d, float (&v_re)[F], float (&v_im)[F]) {
            const int ax = dirs.axis[d];
            const int sg = dirs.sign[d];
            if (sg == 0 || ax == 0) {
                // centre: position xx + 1; +x: xx + 2; -x: xx
                load_slot<F>(mine + ((xx + 1 + sg) & 3) * slot_stride, S, v_re, v_im);
            } else {
                load_site<F>(xr, xi, V, xx * Vp + shift_plane(p, ax, sg, cy, cz, ct, Y, Z, T),
                             v_re, v_im);
            }
        };
        float acc_re[KO], acc_im[KO];
        site_matvec<KI, KD, BI, BD, ST>(b_re, b_im, V, s, skron, skron + nk, dirs.ndir,
                                        fetch, acc_re, acc_im);
        store_site<KO>(y_re, y_im, col, V, s, acc_re, acc_im);
    }
    copy_wait_all();
}

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
cudaError_t launch_kernel(bool stream_schedule, dim3 grid, dim3 block, size_t smem,
                          const Operands& a, const Dirs& dirs, cudaStream_t stream) {
    auto kernel = stream_schedule ? stencil_soa_stream_kernel<KI, KD, BI, BD, ST, FT>
                                  : stencil_soa_xin_kernel<KI, KD, BI, BD, ST, FT>;
    // above 48 KB only after the opt-in, per kernel
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, block, smem, stream>>>(
        static_cast<const ST*>(a.b_re), static_cast<const ST*>(a.b_im),
        static_cast<const float*>(a.k_re), static_cast<const float*>(a.k_im),
        static_cast<const FT*>(a.x_re), static_cast<const FT*>(a.x_im),
        static_cast<FT*>(a.y_re), static_cast<FT*>(a.y_im), a.n, a.X, a.Y, a.Z, a.T, dirs);
    return cudaGetLastError();
}

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
struct LaunchXin {
    static cudaError_t run(const Operands& a, const Dirs& dirs, int S, int C, int XG,
                           cudaStream_t stream) {
        if (S < 1 || C < 1 || XG < 1 || S * C * XG > 256) return cudaErrorInvalidValue;
        const int64_t Vp = (int64_t)a.Y * a.Z * a.T;
        const size_t smem = sizeof(float) * kron_floats(dirs.ndir * KI * KD)
                          + sizeof(FT) * (size_t)a.X * C * KD * BD * 2 * S;
        const dim3 grid((unsigned)((Vp + S - 1) / S), (unsigned)((a.n + C - 1) / C));
        return launch_kernel<KI, KD, BI, BD, ST, FT>(false, grid, dim3(S, C, XG), smem, a,
                                                     dirs, stream);
    }
};

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
struct LaunchStream {
    static cudaError_t run(const Operands& a, const Dirs& dirs, cudaStream_t stream) {
        // the tile of K1's blocks: up to 8 columns sharing 256 threads
        const int C = a.n < 8 ? a.n : 8;
        int S = (256 / C) / 32 * 32;
        if (S < 32) S = 32;
        const int64_t Vp = (int64_t)a.Y * a.Z * a.T;
        const size_t smem = sizeof(float) * kron_floats(dirs.ndir * KI * KD)
                          + sizeof(FT) * (size_t)4 * C * KD * BD * 2 * S;
        const dim3 grid((unsigned)((Vp + S - 1) / S), (unsigned)((a.n + C - 1) / C));
        return launch_kernel<KI, KD, BI, BD, ST, FT>(true, grid, dim3(S, C), smem, a,
                                                     dirs, stream);
    }
};

}  // namespace

extern "C" {

// K4a. pair: kF32F32, kBf16F32 or kBf16Bf16; offsets: host array [ndir, 4] of one-hot +-1 (or all-zero)
// offsets; (S, C, XG): sites, columns and X groups of a block (the
// wrapper's tile, S * C * XG <= 256).
int sbt_stencil_soa_xin(int ki, int kd, int bi, int bd, int pair,
                        const void* b_re, const void* b_im,
                        const void* k_re, const void* k_im, const void* x_re,
                        const void* x_im, void* y_re, void* y_im, int n, int X,
                        int Y, int Z, int T, int ndir, const int* offsets, int S,
                        int C, int XG, void* stream) {
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, -1, &dirs);
    if (err != cudaSuccess) return err;
    const Operands a{b_re, b_im, k_re, k_im, x_re, x_im, y_re, y_im, n, X, Y, Z, T};
    return dispatch<LaunchXin, false>(ki, kd, bi, bd, pair, a, dirs, S, C, XG,
                                      static_cast<cudaStream_t>(stream));
}

// K4b. offsets: as sbt_stencil_soa_xin.
int sbt_stencil_soa_stream(int ki, int kd, int bi, int bd, int pair,
                           const void* b_re, const void* b_im,
                           const void* k_re, const void* k_im, const void* x_re,
                           const void* x_im, void* y_re, void* y_im, int n, int X,
                           int Y, int Z, int T, int ndir, const int* offsets,
                           void* stream) {
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, -1, &dirs);
    if (err != cudaSuccess) return err;
    const Operands a{b_re, b_im, k_re, k_im, x_re, x_im, y_re, y_im, n, X, Y, Z, T};
    return dispatch<LaunchStream, false>(ki, kd, bi, bd, pair, a, dirs,
                                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
