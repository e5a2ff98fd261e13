// K1 at the Wilson (4, 4, 3, 3) and staggered (1, 1, 3, 3) shapes for
// Hopper (sm_90a): the tiled stencil kernel with the spin plan.
//
// Replaces the Pallas TPU kernel superbblas_tpu/ops/stencil_pallas.py
// stencil_matvec_soa (_kernel, _matvec_body, _factor_kron) at these two
// shapes.  It computes, over a periodic 4-D lattice in split complex,
//   y[n, a*BI+i, s] = sum_d sum_j B_d[i, j](s) sum_b K_d[a, b] x[n, b*BD+j, s+o_d]
// with x [n, KD*BD, X, Y, Z, T] and y [n, KI*BI, ...] of the field type
// FT, blocks [ndir, BI*BD, ...] of the storage type ST, sums in
// acc_t<ST, FT> (f32, or f64 for f64/f64; the five pairs of kPair), and
// packed parity as stencil_soa.cu has it.
//
// The spin factors come from the plan (ops/stencil.py kernel_plan: the
// TPU kernel's _factor_kron, built once per kron tensor), one PlanDir a
// direction, read by every thread with uniform loads; the plan math is
// stencil_plan.cuh, shared with the X-inside and X-streaming schedules:
//  * a factored direction K_d = R_d P_d of rank 2 (every Wilson hop at
//    r = 1) projects x onto two half-spinor slots with P_d, multiplies
//    them by the 3x3 colour block (18 complex FMAs, not 36), and adds R_d
//    times the result to the four output slots;
//  * a direct direction multiplies K_d's rows into x and the colour block
//    into those, in site_matvec's order of sums (stencil_soa.cuh), so where
//    no direction factors the kernel gives the runtime route's bits.
// Two forms of one kernel, chosen by the plan: the sparse form reads the
// plan's nonzeros only (four terms of x a direction: a direct row's one
// entry, or two entries of each P row, scaled to a first coefficient of
// 1; one entry of each R row), the Wilson family's plan; the dense form
// multiplies K_d, P_d and R_d whole and takes every kron (random factors,
// r != 1).  Per site and column the sparse form does about 8 x 144 + 192
// = 1344 FMAs on a Wilson operator where the PR 1 kernel did 3024.
//
// What bounds it on the H100: bytes, at both shapes, once the hops are
// projected.  Wilson, 32^3x64 x 8 f32: 2184 B a site (links 648, x 768,
// y 768) against 1536 x 8 columns FMAs, 1.37 ms of bytes against 0.38 ms
// of FMAs at the data sheet's rates; staggered: links 648 B a site
// against x and y 384 B, 0.65 ms of bytes.  What each choice does:
//  * 32-bit coordinates from the block's tile: blockIdx gives the tile
//    (columns, T, Z, Y, X) and threadIdx the site in it, with no 64-bit
//    division; 64-bit arithmetic only for a direction's and a column's
//    base pointers, so in-plane offsets stay 32-bit up to 2^31 values a
//    column's field or a direction's blocks (kPlanes);
//  * the order of the blocks keeps x in L2 for its nine reads: columns
//    fastest (a site's links are read from device memory once for all its
//    columns), then T, Z, then yc rows of Y, then X, then the rest of Y;
//    yc (x_chunk in ops/stencil.py) keeps the traffic between a block and
//    its +-X neighbours' blocks within a third of L2, where the PR 1 order
//    put the +-X planes a whole X plane apart (about 90 MB at 32^3x64 x 8)
//    and read x from device memory about three times;
//  * the columns of a site are adjacent threads of a block: the link
//    loads of the other columns hit L1; at (1, 1, 3, 3) a thread takes
//    two columns, so a direction's nine links are loaded once for two;
//  * every direction's links are prefetched into L2 when the thread
//    starts, and at (4, 4, 3, 3) the direction loop is unrolled by two,
//    so two directions' x and link loads are in flight before their sums
//    (at (1, 1, 3, 3) the unroll loses, PERF.md section 6); the
//    f32 forms fit in 128 registers (80 at (1, 1, 3, 3)) so that two
//    (three) blocks of 256 threads share an SM (__launch_bounds__; f64
//    takes one);
//  * no shared memory and no barrier: x's reuse between the tile's sites
//    is left to L1 and L2.  Staging was measured and loses (PERF.md
//    section 6; the variants are in git history): an X-walk
//    block with a four-slot ring of x lines and the plane's links in
//    shared memory holds one block of 256 threads an SM (160 KB) and runs
//    1.4x this kernel's time; the links alone staged by cp.async, or
//    direction d + 1's x loaded before d's sums, gain nothing.  With x
//    read at the site itself and one direction's links (a diagnostic)
//    it still runs 0.8x its time: issue and latency at 16 warps an SM,
//    not bytes, hold it above the bound.
//
// Plain C interface (loaded with ctypes); every call returns the
// cudaError_t of its launch.

#include "stencil_plan.cuh"

namespace {

// a launch's lattice and tiling
struct Tile {
    int n, X, Y, Z, T;
    int yc;       // Y rows the blocks cover at one x before stepping X
    int bt, bz;   // a block's tile: bt T sites x bz Z rows
    int ncb;      // column blocks: blockIdx.x = cb + ncb * (T tile)
    int nz;       // Z tiles: blockIdx.y = (Z tile) + nz * (Y row within yc)
    int sY, sX;   // site strides of Y and X (Z*T, Y*Z*T)
};

// The design's constants, as the bring-up sweep chose them (PERF.md
// section 6), with the links' L2 prefetch and the direction loop's unroll in the
// kernel: column groups a block (at most)
constexpr int kColGroups = 8;
// columns a thread takes: one at (4, 4, 3, 3) (24 sums), two at
// (1, 1, 3, 3), which share each direction's nine link entries
template <int KI> constexpr int kCols = KI == 1 ? 2 : 1;
// blocks of 256 threads an SM should hold: two at (4, 4, 3, 3) in f32
// (128 registers), three at (1, 1, 3, 3) (85), one in f64
template <int KI, typename A> constexpr int kMinBlocks =
    sizeof(A) == 8 ? 1 : KI == 1 ? 3 : 2;

// a launch's directions as site steps on its tile's lattice
Hops hops_of(const Dirs& dirs, const Tile& g) { return make_hops(dirs, g.X, g.Y, g.Z, g.T); }

template <int KI, int KD, int BI, int BD, bool kSparse, typename ST, typename FT>
__global__ void __launch_bounds__(256, kMinBlocks<KI, acc_t<ST, FT>>) stencil_tiled_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im,
    const PlanDir<acc_t<ST, FT>>* __restrict__ plan, const FT* __restrict__ x_re,
    const FT* __restrict__ x_im, FT* __restrict__ y_re, FT* __restrict__ y_im,
    const __grid_constant__ Tile g, const __grid_constant__ Hops hops) {
    using A = acc_t<ST, FT>;
    static_assert(KI == KD && (KI == 1 || KI == kS), "the tiled kernel's spin shapes");
    constexpr int F = KD * BD, KO = KI * BI, NB = BI * BD, CT = kCols<KI>;

    // the block's tile and the thread's site in it, in 32 bits
    const int cb = blockIdx.x % g.ncb, tt = blockIdx.x / g.ncb;
    const int tz = blockIdx.y % g.nz, yi = blockIdx.y / g.nz;
    const int cx = blockIdx.z % g.X, yo = blockIdx.z / g.X;
    const int ct = tt * g.bt + threadIdx.x % g.bt;
    const int cz = tz * g.bz + threadIdx.x / g.bt;
    const int cy = yo * g.yc + yi;
    const int col0 = (cb * blockDim.y + threadIdx.y) * CT;
    const int s = cx * g.sX + cy * g.sY + cz * g.T + ct;
    const int V = g.X * g.sX;   // in-plane offsets: kPlanes planes are < 2^31 values
    if (ct >= g.T || cz >= g.Z || col0 >= g.n) return;
    const int ncols = g.n - col0 < CT ? g.n - col0 : CT;

    // every direction's links of the site into L2 first, shared out among
    // the block's column groups: the loads of each direction then wait on
    // L2 rather than on device memory
    for (int d = threadIdx.y; d < hops.ndir; d += blockDim.y)
        for (int ij = 0; ij < NB; ++ij) {
            prefetch_l2(b_re + (int64_t)d * NB * V + (s + ij * V));
            prefetch_l2(b_im + (int64_t)d * NB * V + (s + ij * V));
        }

    A acc_re[CT][KO], acc_im[CT][KO];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int o = 0; o < KO; ++o) acc_re[c][o] = acc_im[c][o] = A(0);

    // the image parity m of a packed X step: +x moves where m = 1, -x where m = 0
    const bool odd = ((hops.packed + cy + cz + ct) & 1) != 0;
    // the neighbour s + o_d on the torus
    auto nb_of = [&](int d) {
        int nb = s;
        const int ax = hops.axis[d];
        if (ax >= 0 && !(ax == 0 && hops.packed >= 0 && odd != (hops.step[d] > 0))) {
            const int c = ax == 0 ? cx : ax == 1 ? cy : ax == 2 ? cz : ct;
            nb += c == hops.edge[d] ? hops.wrap[d] : hops.step[d];
        }
        return nb;
    };
    // one direction's sums
    auto step = [&](int d) {
        const int nb = nb_of(d);
        // the colour block B_d(s), from the direction's base in 64 bits
        A br[NB], bi[NB];
        const ST* bdr = b_re + (int64_t)d * NB * V + s;
        const ST* bdi = b_im + (int64_t)d * NB * V + s;
#pragma unroll
        for (int ij = 0; ij < NB; ++ij) {
            br[ij] = load_f(bdr + ij * V);
            bi[ij] = load_f(bdi + ij * V);
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) {
            if (c >= ncols) break;
            const FT* xr = x_re + (int64_t)(col0 + c) * F * V + nb;   // the column's base
            const FT* xi = x_im + (int64_t)(col0 + c) * F * V + nb;
            direction<KI, BI, BD, kSparse, false>(plan, d, xr, xi, V, br, bi, acc_re[c],
                                                  acc_im[c]);
        }
    };
    // the direction loop unrolled by two at (4, 4, 3, 3) only
    if constexpr (KI == 1) {
#pragma unroll 1
        for (int d = 0; d < hops.ndir; ++d) step(d);
    } else {
#pragma unroll 2
        for (int d = 0; d < hops.ndir; ++d) step(d);
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) {
        if (c >= ncols) break;
        FT* yr = y_re + (int64_t)(col0 + c) * KO * V + s;
        FT* yi = y_im + (int64_t)(col0 + c) * KO * V + s;
#pragma unroll
        for (int o = 0; o < KO; ++o) {
            store_f(yr + o * V, acc_re[c][o]);
            store_f(yi + o * V, acc_im[c][o]);
        }
    }
}

// the most values one in-plane offset spans: a column's x or y, or one
// direction's links; the kernels take lattices where that is under 2^31
// values (ops/stencil.py check_kernel_case raises above)
template <int KI, int KD, int BI, int BD>
constexpr int kPlanes = (KD * BD > KI * BI ? KD * BD : KI * BI) > BI * BD
    ? (KD * BD > KI * BI ? KD * BD : KI * BI) : BI * BD;

// the tile's T extent: 32 where T is a multiple of 32 (else 16 or 8 if T
// is one of those, else 32 masked); below 32 the power of two >= T
inline int tile_t(int T) {
    if (T >= 32) return T % 32 == 0 ? 32 : T % 16 == 0 ? 16 : T % 8 == 0 ? 8 : 32;
    int bt = 1;
    while (bt < T) bt *= 2;
    return bt;
}

// a launch's grid, block and tile; false where the grid cannot hold the
// lattice (kPlanes values a site under 2^31, Y a multiple of yc, grid.y
// and grid.z <= 65535); at most max_sites sites a block
template <int KI, int KD, int BI, int BD>
bool tiling(int n, int X, int Y, int Z, int T, int yc, dim3* grid, dim3* block, Tile* g,
            int max_sites = 256) {
    if (n < 1 || X < 1 || Y < 1 || Z < 1 || T < 1 || yc < 1 || Y % yc != 0) return false;
    if ((int64_t)X * Y * Z * T * kPlanes<KI, KD, BI, BD> > INT32_MAX) return false;
    constexpr int CT = kCols<KI>;
    const int groups = (n + CT - 1) / CT;
    const int cg = groups < kColGroups ? groups : kColGroups;
    int sites = 256 / cg / 32 * 32;                      // column groups x sites a block
    if (sites < 32) sites = 32;
    if (sites > max_sites) sites = max_sites;
    const int bt = tile_t(T), bz = sites / bt;
    const int ncb = (groups + cg - 1) / cg, nt = (T + bt - 1) / bt, nz = (Z + bz - 1) / bz;
    const int64_t gy = (int64_t)nz * yc, gz = (int64_t)X * (Y / yc);
    if (gy > 65535 || gz > 65535 || (int64_t)ncb * nt > INT32_MAX) return false;
    *grid = dim3((unsigned)(ncb * nt), (unsigned)gy, (unsigned)gz);
    *block = dim3((unsigned)sites, (unsigned)cg);
    *g = Tile{n, X, Y, Z, T, yc, bt, bz, ncb, nz, Z * T, Y * Z * T};
    return true;
}

struct TiledArgs {
    const void *b_re, *b_im, *plan;
    const void *x_re, *x_im;
    void *y_re, *y_im;
    int n, X, Y, Z, T, yc;
    bool sparse;
};

// the kernel of a launch: the sparse form where the plan takes it (only
// at KI = 4), else the dense one
template <int KI, int KD, int BI, int BD, typename ST, typename FT>
auto tiled_kernel(bool sparse) {
    if constexpr (KI == 1) {
        return stencil_tiled_kernel<KI, KD, BI, BD, false, ST, FT>;
    } else {
        return sparse ? stencil_tiled_kernel<KI, KD, BI, BD, true, ST, FT>
                      : stencil_tiled_kernel<KI, KD, BI, BD, false, ST, FT>;
    }
}

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
struct LaunchTiled {
    static cudaError_t run(const TiledArgs& a, const Dirs& dirs, cudaStream_t stream) {
        dim3 grid, block;
        Tile g;
        if (!tiling<KI, KD, BI, BD>(a.n, a.X, a.Y, a.Z, a.T, a.yc, &grid, &block, &g))
            return cudaErrorInvalidValue;
        using A = acc_t<ST, FT>;
        auto kernel = tiled_kernel<KI, KD, BI, BD, ST, FT>(a.sparse);
        kernel<<<grid, block, 0, stream>>>(
            static_cast<const ST*>(a.b_re), static_cast<const ST*>(a.b_im),
            static_cast<const PlanDir<A>*>(a.plan), static_cast<const FT*>(a.x_re),
            static_cast<const FT*>(a.x_im), static_cast<FT*>(a.y_re),
            static_cast<FT*>(a.y_im), g, hops_of(dirs, g));
        return cudaGetLastError();
    }
};

// out: registers a thread, local (spill and stack) bytes a thread, threads
// a block and resident blocks an SM of the launch ``a`` would make
template <int KI, int KD, int BI, int BD, typename ST, typename FT>
struct AttrsTiled {
    static cudaError_t run(const TiledArgs& a, int* out) {
        dim3 grid, block;
        Tile g;
        if (!tiling<KI, KD, BI, BD>(a.n, a.X, a.Y, a.Z, a.T, a.yc, &grid, &block, &g))
            return cudaErrorInvalidValue;
        auto kernel = tiled_kernel<KI, KD, BI, BD, ST, FT>(a.sparse);
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return err;
        const int threads = (int)(block.x * block.y);
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
        out[0] = attr.numRegs;
        out[1] = (int)attr.localSizeBytes;
        out[2] = threads;
        out[3] = blocks;
        return err;
    }
};

}  // namespace

extern "C" {

// The tiled route of K1: (KI, KD, BI, BD) in (4, 4, 3, 3), (1, 1, 3, 3);
// pair: the kPair of (storage, field) types; plan: the device table of
// PlanDir records in the pair's sum type (nullptr: no kron, K_d = 1;
// needed at (4, 4, 3, 3)); sparse: the plan takes the sparse form;
// offsets: host array [ndir, 4]; packed_parity: 0, 1 or -1; yc: Y rows a
// block walk covers at one x (a divisor of Y).
int sbt_stencil_tiled(int ki, int kd, int bi, int bd, int pair, const void* b_re,
                      const void* b_im, const void* plan, const void* x_re,
                      const void* x_im, void* y_re, void* y_im, int n, int X, int Y, int Z,
                      int T, int ndir, const int* offsets, int packed_parity, int sparse,
                      int yc, void* stream) {
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, packed_parity, &dirs);
    if (err != cudaSuccess) return err;
    if (ki == 4 && plan == nullptr) return cudaErrorInvalidValue;
    const TiledArgs a{b_re, b_im, plan, x_re, x_im, y_re, y_im, n, X, Y, Z, T, yc,
                      sparse != 0};
    return dispatch<LaunchTiled, true>(ki, kd, bi, bd, pair, a, dirs,
                                       static_cast<cudaStream_t>(stream));
}

// The registers, local bytes, threads a block and resident blocks an SM of
// the tiled kernel a launch with these arguments would run (out[4]).
int sbt_stencil_tiled_attrs(int ki, int kd, int bi, int bd, int pair, int sparse, int n,
                            int X, int Y, int Z, int T, int yc, int* out) {
    const TiledArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      n, X, Y, Z, T, yc, sparse != 0};
    return dispatch<AttrsTiled, true>(ki, kd, bi, bd, pair, a, out);
}

}  // extern "C"
