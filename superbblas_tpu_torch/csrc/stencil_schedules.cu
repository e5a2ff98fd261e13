// Two other schedules of the SoA stencil matvec K1 for Hopper (sm_90a):
// the X-inside kernel (K4a) and the X-streaming kernel (K4b).
//
// Replace the Pallas TPU kernels superbblas_tpu/ops/stencil_pallas.py
// stencil_matvec_soa_xin (_kernel_xin) and stencil_matvec_soa_stream
// (_kernel_stream).  Both compute what K1 computes, with its operands and
// contract but no packed parity, at every (KI, KD, BI, BD) with
// KI*KD*BI*BD <= 256 and every (storage, field) pair of kPair (sums in
// f32, in f64 for f64/f64), and differ from K1 in where x comes from: a
// block stages x in shared memory and reads there the neighbours its tile
// holds; the others come from device memory as in K1.
//
// The sums of a (site, column) are K1's own code, in K1's order, so the
// schedules give K1's bits:
//  * at the Wilson (4, 4, 3, 3) and staggered (1, 1, 3, 3) shapes the
//    spin plan, stencil_plan.cuh direction() (the TPU kernels'
//    kfact=_factor_kron: a rank-2 hop projected onto two half-spinors,
//    sparse form for the Wilson family's plan, dense form for any kron):
//    the bits of K1's tiled route (stencil_tiled.cu);
//  * at every other shape the runtime route's sum of one output,
//    stencil_soa.cuh rt_direction(): the bits of stencil_matvec_soa_rt.
//
// K4a, X inside.  A block owns a tile of S consecutive sites of an X plane
// (flat (y, z, t) index, T fastest) and holds the tile's whole X lines of
// one group of C columns in shared memory, so +-x wrap inside the block.
// Two stages: group g + 1's lines load with 16-byte cp.async while group g
// is summed, one barrier a group (one stage where one group covers the
// columns).  A block walks two groups (kXinGroups); the blocks of a
// tile are adjacent in the grid, so they run together and read the tile's
// links from L2 where one block walking all the groups read them from
// device memory again for each (1.3x slower at 32^3x64 x 8 f32).
// ops/stencil.py xin_tile gives a stage half of a block's shared memory
// and fills it with sites first (32 of one column at 32^3x64 f32, 192 KB
// for both stages), and raises where one X line cannot fit.  One block of
// 512 threads (16 warps) an SM; 256 at f64.
//
// K4b, X streaming.  The TPU kernel walks X in sequential grid steps and
// carries two planes in VMEM scratch; blocks here run in no order, so a
// loop over x inside the block takes the place of the sequential grid
// axis.  A block owns R rows (y, z) of S T-sites and C columns, and keeps
// a ring of four X planes of that tile, widened by a T halo of one site a
// side: x - 1, x and x + 1 for the plane it sums, x + 2 in flight.  All
// threads stage a plane once, with 16-byte cp.async (the halo with element
// copies), one barrier a plane; the centre, +-X
// and +-T come from the ring, +-Y and +-Z from device memory.  An item
// prefetches its site's links into L2 first, its C columns sharing the
// directions out, as K1 does.  Where the tiles are too few to fill the
// SMs, the X walk is split into chunks, each of which loads one plane at
// either end again.  ops/stencil.py stream_tile keeps the ring within a
// quarter of the SM's shared memory (55 KB at 32^3x64 f32: four blocks of
// 128 threads, 16 warps, an SM).
//
// Common to both:
//  * items (site, column) (and output, at the runtime-shape form) with the
//    tile's sites on adjacent lanes and the columns of a group in other
//    warps of the block, as in K1: a warp's loads from device memory touch
//    one or two lines, and the columns' link loads meet in L1.  A site's
//    columns on adjacent lanes make a link load one request but spread
//    the other loads over C lines, and K4a's warps over several X planes:
//    measured slower (PERF.md section 6);
//  * 16-byte cp.async copies where a row of the tile is 16-byte aligned
//    in device memory (the wrapper's wide flag), element copies through
//    registers otherwise, as stencil_site.cu's two forms;
//  * coordinates in 32 bits, decoded with FastDiv; 64-bit arithmetic only
//    for a column's base; lattices under 2^31 values a column's field or a
//    direction's blocks (ops/stencil.py raises above).
//
// What bounds them on the H100: bytes at best, as K1 (1.37 ms at Wilson
// 32^3x64 x 8 f32), but they run at 3-4x that, K1 at 2.6x (PERF.md).  K4a
// still reads each site's links once a column group, from L2; K4b stages x
// once a plane, and +-Y, +-Z and the links come from L2 and device memory
// as in K1.  Neither has the counters on the card's machine to say more.
//
// Plain C interface (loaded with ctypes); every call returns the
// cudaError_t of its launch.

#include "kernel_common.cuh"
#include "stencil_plan.cuh"

namespace {

// The design's constants, as their bring-up sweep chose them (PERF.md
// section 6), with the direction loop not unrolled and K4b's links prefetched
// into L2: threads a block of the X-streaming kernel, column groups a
// K4a block walks
constexpr int kStreamThreads = 128;
constexpr int kXinGroups = 2;
constexpr int kRing = 4;         // K4b's ring: x - 1, x, x + 1 and x + 2 in flight
constexpr int kStreamWaves = 4;  // blocks an SM below which K4b splits its X walk
// threads a block of K4a: 512 at the f32-summed pairs, 256 at f64 (its
// sums take twice the registers: 512 threads would spill)
template <typename ST, typename FT> constexpr int kXinThreads =
    sizeof(acc_t<ST, FT>) == 8 ? 256 : 512;
// blocks an SM the launch bounds ask for: K4a's one block; K4b's four
// blocks of 128 threads (up to 128 registers), three for the dense plan
// at (4, 4, 3, 3) (164 registers); one at f64
template <int KI, bool kSparse, typename ST, typename FT> constexpr int kStreamMinB =
    sizeof(acc_t<ST, FT>) == 8 ? 1 : KI == 4 && !kSparse ? 3 : 4;

// a schedule's launch: lattice, shape, tile and form
struct Sched {
    int n, X, Y, Z, T;
    int Vp, V;            // sites of an X plane (Y*Z*T) and of the lattice
    int KI, KD, BI, BD;   // the shape (read at the runtime-shape form)
    int S;                // K4a: plane sites of a tile; K4b: T sites of a row
    int R;                // K4b: rows (y, z) of a tile (K4a: 1)
    int C;                // columns of a group
    int rs;               // elements from one row of the tile to the next in shared memory
    int wide;             // 16-byte copies
    int ngroups;          // K4a: column groups (K4b: one a block)
    int gpb;              // K4a: column groups a block walks (the tile's blocks are adjacent)
    int ntt;              // K4b: T tiles of a row
    int xc;               // K4b: X planes of a chunk
    int per;              // copies a row (S / 16-byte width + halo, or S + halo sites)
    int items;            // sums of a group (K4a) or plane (K4b): (KO at the runtime form) x X x S x C or R x S x C
    FastDiv dT, dZ, dX, dS, dC, dR, dper, dsite, dntt, dncg;   // dncg, K4a: blocks a tile
};

// where one direction's neighbour of an item lies: in shared memory (sh)
// or in device memory, its re and im parts and the stride of its features
template <typename FT> struct Nb {
    bool sh;
    const FT* re;
    const FT* im;
    int stride;
};

// the links of flat site ``site`` into L2 for directions c, c + C, ...:
// the C columns of a site share the directions out, as K1's column groups
// do (stencil_tiled.cu)
template <int NB, typename ST>
__device__ __forceinline__ void prefetch_links(const ST* b_re, const ST* b_im, int ndir, int V,
                                               int site, int c, int C) {
    for (int d = c; d < ndir; d += C) {
        const ST* br = b_re + (int64_t)d * NB * V + site;
        const ST* bi = b_im + (int64_t)d * NB * V + site;
#pragma unroll
        for (int ij = 0; ij < NB; ++ij) {
            prefetch_l2(br + ij * V);
            prefetch_l2(bi + ij * V);
        }
    }
}

// the sums of one (site, column) item at a shape of the spin plan: every
// output, one direction at a time in K1's order (stencil_tiled.cu), links
// read at flat site ``site``; where(d) gives direction d's neighbour
template <int KI, int BI, int BD, bool kSparse, typename ST, typename FT, typename A,
          typename Where>
__device__ __forceinline__ void planned_item(const ST* __restrict__ b_re,
                                             const ST* __restrict__ b_im,
                                             const PlanDir<A>* __restrict__ plan, int ndir,
                                             int V, int site, Where&& where, FT* yr, FT* yi) {
    constexpr int KO = KI * BI, NB = BI * BD;
    A acc_re[KO], acc_im[KO];
#pragma unroll
    for (int o = 0; o < KO; ++o) acc_re[o] = acc_im[o] = A(0);
#pragma unroll 1
    for (int d = 0; d < ndir; ++d) {
        A br[NB], bi[NB];
        const ST* bdr = b_re + (int64_t)d * NB * V + site;
        const ST* bdi = b_im + (int64_t)d * NB * V + site;
#pragma unroll
        for (int ij = 0; ij < NB; ++ij) {
            br[ij] = load_f(bdr + ij * V);
            bi[ij] = load_f(bdi + ij * V);
        }
        const Nb<FT> nb = where(d);
        if (nb.sh)
            direction<KI, BI, BD, kSparse, true>(plan, d, nb.re, nb.im, nb.stride, br, bi,
                                                 acc_re, acc_im);
        else
            direction<KI, BI, BD, kSparse, false>(plan, d, nb.re, nb.im, nb.stride, br, bi,
                                                  acc_re, acc_im);
    }
#pragma unroll
    for (int o = 0; o < KO; ++o) {
        store_f(yr + site + o * V, acc_re[o]);
        store_f(yi + site + o * V, acc_im[o]);
    }
}

// the sum of output o = a*BI + i of one (site, column) item at a runtime
// shape, as stencil_matvec_soa_rt sums it (kron: [ndir, KI, KD] in the sum
// type, nullptr for K_d = 1)
template <typename ST, typename FT, typename A, typename Where>
__device__ __forceinline__ void rt_item(const Sched& g, const ST* __restrict__ b_re,
                                        const ST* __restrict__ b_im,
                                        const A* __restrict__ k_re,
                                        const A* __restrict__ k_im, int ndir, int o,
                                        int site, Where&& where, FT* yr, FT* yi) {
    const int a = o / g.BI, i = o - a * g.BI;
    const int V = g.V;
    A ar = A(0), ai = A(0);
    for (int d = 0; d < ndir; ++d) {
        const int krow = (d * g.KI + a) * g.KD;
        const A* kr = k_re ? k_re + krow : nullptr;
        const A* ki = k_im ? k_im + krow : nullptr;
        const int64_t boff = (int64_t)(d * g.BI + i) * g.BD * V + site;
        const Nb<FT> nb = where(d);
        if (nb.sh)
            rt_direction<true>(kr, ki, g.KD, g.BD, nb.re, nb.im, nb.stride, b_re + boff,
                               b_im + boff, V, ar, ai);
        else
            rt_direction<false>(kr, ki, g.KD, g.BD, nb.re, nb.im, nb.stride, b_re + boff,
                                b_im + boff, V, ar, ai);
    }
    store_f(yr + site + o * V, ar);
    store_f(yi + site + o * V, ai);
}

// the neighbour of flat site ``site`` = (cy, cz, ct) of plane x along a Y,
// Z or T hop d, in device memory (xr, xi: the column's field)
template <typename FT>
__device__ __forceinline__ Nb<FT> from_device(const Hops& h, int d, int site, int cy, int cz,
                                              int ct, const FT* xr, const FT* xi, int V) {
    const int ax = h.axis[d];
    const int c = ax == 1 ? cy : ax == 2 ? cz : ct;
    const int nb = site + (c == h.edge[d] ? h.wrap[d] : h.step[d]);
    return Nb<FT>{false, xr + nb, xi + nb, V};
}

// K4a.  blockIdx.x: the tile; the block walks the column groups.
template <int KI, int KD, int BI, int BD, bool kSparse, typename ST, typename FT>
__global__ void __launch_bounds__(kXinThreads<ST, FT>, 1)
stencil_xin_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im,
    const PlanDir<acc_t<ST, FT>>* __restrict__ plan, const acc_t<ST, FT>* __restrict__ k_re,
    const acc_t<ST, FT>* __restrict__ k_im, const FT* __restrict__ x_re,
    const FT* __restrict__ x_im, FT* __restrict__ y_re, FT* __restrict__ y_im,
    const __grid_constant__ Sched g, const __grid_constant__ Hops hops) {
    constexpr int kVec = 16 / sizeof(FT), kThreads = kXinThreads<ST, FT>;
    const int F = KI ? KD * BD : g.KD * g.BD;
    const int KO = KI ? KI * BI : g.KI * g.BI;
    // a stage: [part][f][x][c][rs] of the field type, plane x's row of
    // column c at (x*C + c)*rs
    const int fs = g.X * g.C * g.rs;   // elements from one feature to the next
    extern __shared__ __align__(16) unsigned char smem_raw[];
    FT* const stages = reinterpret_cast<FT*>(smem_raw);
    const int stage_elems = 2 * F * fs;
    // blockIdx.x = (blocks of a tile) x tile + the block's groups
    const int tile = g.dncg.div(blockIdx.x), gb = blockIdx.x - tile * (int)g.dncg.d;
    const int p0 = tile * g.S;
    const int grp0 = gb * g.gpb, grp1 = min(g.ngroups, grp0 + g.gpb);
    const int tid = threadIdx.x;

    // column group grp's X lines of the tile into stage st: rows (part, f,
    // x, c) of S sites, 16-byte copies (wide) or element copies
    auto load_group = [&](int grp, FT* st) {
        const int rows = 2 * F * g.X * g.C;
        for (int q = tid; q < rows * g.per; q += kThreads) {
            const int row = g.dper.div(q), k = q - row * g.per;
            const int rc = g.dC.div(row), c = row - rc * g.C;
            const int f2 = g.dX.div(rc), x = rc - f2 * g.X;
            const int part = f2 >= F, f = f2 - part * F;
            const int col = grp * g.C + c;
            const int p = p0 + (g.wide ? k * kVec : k);
            if (col >= g.n || p >= g.Vp) continue;
            const FT* src = (part ? x_im : x_re) + (int64_t)col * F * g.V + (f * g.X + x) * g.Vp
                            + p;
            FT* dst = st + row * g.rs + p - p0;
            if (g.wide) copy16(dst, src);
            else *dst = *src;
        }
    };

    load_group(grp0, stages);
    copy_commit();
    for (int grp = grp0; grp < grp1; ++grp) {
        // group grp landed for every thread, and every thread is done with
        // grp - 1's stage, which grp + 1 fills next
        copy_wait<0>();
        __syncthreads();
        if (grp + 1 < grp1) load_group(grp + 1, stages + ((grp + 1 - grp0) & 1) * stage_elems);
        copy_commit();
        const FT* st = stages + ((grp - grp0) & 1) * stage_elems;
        for (int w = tid; w < g.items; w += kThreads) {
            const int o = KI ? 0 : g.dsite.div(w);
            const int r = w - o * (g.X * g.S * g.C);
            const int rs = g.dS.div(r), s = r - rs * g.S;
            const int x = g.dC.div(rs), c = rs - x * g.C;
            const int col = grp * g.C + c, p = p0 + s;
            if (col >= g.n || p >= g.Vp) continue;
            const int q1 = g.dT.div(p), ct = p - q1 * g.T;
            const int cy = g.dZ.div(q1), cz = q1 - cy * g.Z;
            const int site = x * g.Vp + p;
            const FT* xr = x_re + (int64_t)col * F * g.V;
            const FT* xi = x_im + (int64_t)col * F * g.V;
            const FT* mine = st + (x * g.C + c) * g.rs + s;   // plane x, this column and site
            const int xstep = g.C * g.rs;                      // one plane on
            auto where = [&](int d) {
                const int ax = hops.axis[d];
                if (ax > 0) return from_device(hops, d, site, cy, cz, ct, xr, xi, g.V);
                int dx = 0;
                if (ax == 0)
                    dx = hops.step[d] > 0 ? (x == g.X - 1 ? 1 - g.X : 1) : (x == 0 ? g.X - 1 : -1);
                const FT* sp = mine + dx * xstep;
                return Nb<FT>{true, sp, sp + F * fs, fs};
            };
            FT* yr = y_re + (int64_t)col * KO * g.V;
            FT* yi = y_im + (int64_t)col * KO * g.V;
            if constexpr (KI != 0)
                planned_item<KI, BI, BD, kSparse>(b_re, b_im, plan, hops.ndir, g.V, site, where,
                                                  yr, yi);
            else
                rt_item(g, b_re, b_im, k_re, k_im, hops.ndir, o, site, where, yr, yi);
        }
    }
}

// K4b.  blockIdx.x: column group (fastest), T tile, row tile; blockIdx.y:
// the chunk of the X walk.
template <int KI, int KD, int BI, int BD, bool kSparse, typename ST, typename FT>
__global__ void __launch_bounds__(kStreamThreads, kStreamMinB<KI, kSparse, ST, FT>)
stencil_stream_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im,
    const PlanDir<acc_t<ST, FT>>* __restrict__ plan, const acc_t<ST, FT>* __restrict__ k_re,
    const acc_t<ST, FT>* __restrict__ k_im, const FT* __restrict__ x_re,
    const FT* __restrict__ x_im, FT* __restrict__ y_re, FT* __restrict__ y_im,
    const __grid_constant__ Sched g, const __grid_constant__ Hops hops) {
    constexpr int kVec = 16 / sizeof(FT);
    const int F = KI ? KD * BD : g.KD * g.BD;
    const int KO = KI ? KI * BI : g.KI * g.BI;
    // a plane: [part][f][r][c][rs], site t of row r and column c at slot
    // kVec + t - t0 of its row, the T halo at kVec - 1 and at kVec + len:
    // rows rs = S + kVec apart, so a full row's right halo takes the next
    // row's slot 0, which no row uses (and a plane kVec elements more)
    const int fs = g.R * g.C * g.rs;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    FT* const ring = reinterpret_cast<FT*>(smem_raw);
    const int plane_elems = 2 * F * fs + kVec;
    const int tid = threadIdx.x;

    const int b1 = g.dncg.div(blockIdx.x), cg = blockIdx.x - b1 * (int)g.dncg.d;
    const int rt = g.dntt.div(b1), tt = b1 - rt * g.ntt;
    const int t0 = tt * g.S, len = min(g.S, g.T - t0);
    const int row0 = rt * g.R, rows_yz = g.Y * g.Z;
    const int xa = blockIdx.y * g.xc, xb = min(g.X, xa + g.xc);

    // ring position pos holds plane xa - 1 + pos (mod X)
    auto load_plane = [&](int pos) {
        int xx = xa - 1 + pos;
        xx = xx < 0 ? xx + g.X : xx >= g.X ? xx - g.X : xx;
        FT* pl = ring + (pos & (kRing - 1)) * plane_elems;
        const int rows = 2 * F * g.R * g.C;
        const int body = len / kVec;   // wide: 16-byte copies of the row's sites
        for (int q = tid; q < rows * g.per; q += kStreamThreads) {
            const int row = g.dper.div(q), k = q - row * g.per;
            const int rc = g.dC.div(row), c = row - rc * g.C;
            const int f2 = g.dR.div(rc), r = rc - f2 * g.R;
            const int part = f2 >= F, f = f2 - part * F;
            const int col = cg * g.C + c, yz = row0 + r;
            if (col >= g.n || yz >= rows_yz) continue;
            const FT* src = (part ? x_im : x_re) + (int64_t)col * F * g.V + f * g.V + xx * g.Vp
                            + yz * g.T;
            FT* dst = pl + row * g.rs;
            if (g.wide && k > 0 && k <= body) {
                // the sites, 16 bytes a copy
                copy16(dst + k * kVec, src + t0 + (k - 1) * kVec);
            } else {
                // element copies: wide, copy 0 is the left halo and body + 1
                // the right one; else copy k is site t0 - 1 + k
                const int j = !g.wide ? k : k == 0 ? 0 : len + 1;
                if ((g.wide && k > body + 1) || j > len + 1) continue;
                int t = t0 - 1 + j;
                t = t < 0 ? t + g.T : t >= g.T ? t - g.T : t;
                copy_elem(dst + kVec - 1 + j, src + t);
            }
        }
    };

    load_plane(0);
    load_plane(1);
    copy_commit();
    load_plane(2);
    copy_commit();
    for (int x = xa; x < xb; ++x) {
        const int pos = x - xa + 1;
        // planes up to x + 1 landed for every thread, and every thread is
        // done with plane x - 2's slot, which plane x + 2 fills next
        copy_wait<0>();
        __syncthreads();
        if (x + 2 <= xb) load_plane(pos + 2);
        copy_commit();
        for (int w = tid; w < g.items; w += kStreamThreads) {
            const int o = KI ? 0 : g.dsite.div(w);
            const int u = w - o * (g.R * g.S * g.C);
            const int rs = g.dS.div(u), s = u - rs * g.S;
            const int r = g.dC.div(rs), c = rs - r * g.C;
            const int col = cg * g.C + c, yz = row0 + r;
            if (col >= g.n || yz >= rows_yz || s >= len) continue;
            const int cy = g.dZ.div(yz), cz = yz - cy * g.Z, ct = t0 + s;
            const int site = x * g.Vp + yz * g.T + ct;
            const FT* xr = x_re + (int64_t)col * F * g.V;
            const FT* xi = x_im + (int64_t)col * F * g.V;
            const FT* mine = ring + (r * g.C + c) * g.rs + kVec + s;
            auto where = [&](int d) {
                const int ax = hops.axis[d];
                if (ax == 1 || ax == 2) return from_device(hops, d, site, cy, cz, ct, xr, xi, g.V);
                const int sg = hops.step[d] > 0 ? 1 : -1;
                const int p = ax == 0 ? pos + sg : pos;   // the plane's ring position
                const FT* sp = mine + (p & (kRing - 1)) * plane_elems + (ax == 3 ? sg : 0);
                return Nb<FT>{true, sp, sp + F * fs, fs};
            };
            FT* yr = y_re + (int64_t)col * KO * g.V;
            FT* yi = y_im + (int64_t)col * KO * g.V;
            if constexpr (KI != 0) {
                prefetch_links<BI * BD>(b_re, b_im, hops.ndir, g.V, site, c, g.C);
                planned_item<KI, BI, BD, kSparse>(b_re, b_im, plan, hops.ndir, g.V, site, where,
                                                  yr, yi);
            }
            else
                rt_item(g, b_re, b_im, k_re, k_im, hops.ndir, o, site, where, yr, yi);
        }
    }
}

// the kernel of a launch: the spin plan's forms at (4, 4, 3, 3) (sparse
// or dense) and (1, 1, 3, 3), the runtime-shape form (KI = 0) elsewhere
template <bool kStream, int KI, int KD, int BI, int BD, bool kSparse, typename ST, typename FT>
constexpr auto kernel_of() {
    if constexpr (kStream) return stencil_stream_kernel<KI, KD, BI, BD, kSparse, ST, FT>;
    else return stencil_xin_kernel<KI, KD, BI, BD, kSparse, ST, FT>;
}

template <bool kStream, typename ST, typename FT>
auto pick_kernel(int ki, int kd, int bi, int bd, bool sparse) {
    if (ki == 4 && kd == 4 && bi == 3 && bd == 3)
        return sparse ? kernel_of<kStream, 4, 4, 3, 3, true, ST, FT>()
                      : kernel_of<kStream, 4, 4, 3, 3, false, ST, FT>();
    if (ki == 1 && kd == 1 && bi == 3 && bd == 3)
        return kernel_of<kStream, 1, 1, 3, 3, false, ST, FT>();
    return kernel_of<kStream, 0, 0, 0, 0, false, ST, FT>();
}

// a call's arguments (the tile: ops/stencil.py xin_tile or stream_tile)
struct SchedArgs {
    bool stream;
    int ki, kd, bi, bd;
    const void *b_re, *b_im, *plan, *k_re, *k_im, *x_re, *x_im;
    void *y_re, *y_im;
    int n, X, Y, Z, T;
    bool sparse;
    int S, R, C, rs;
    bool wide;
};

// shared memory of a launch: two stages (K4a; one where one column group
// covers the columns) or the ring (K4b)
template <typename FT> size_t smem_of(const SchedArgs& a) {
    const size_t F = (size_t)a.kd * a.bd;
    const size_t stages = a.n > a.C ? 2 : 1;
    return a.stream ? sizeof(FT) * kRing * (2 * F * a.R * a.C * a.rs + 16 / sizeof(FT))
                    : sizeof(FT) * stages * 2 * F * a.X * a.C * a.rs;
}

// the launch's grid and Sched; false where the arguments are outside the
// kernels' limits
template <typename FT> bool plan_launch(const SchedArgs& a, int sms, dim3* grid, Sched* g) {
    constexpr int kVec = 16 / sizeof(FT);
    const int64_t Vp = (int64_t)a.Y * a.Z * a.T, V = a.X * Vp;
    const int F = a.kd * a.bd, KO = a.ki * a.bi, NB = a.bi * a.bd;
    const int most = F > KO ? (F > NB ? F : NB) : (KO > NB ? KO : NB);   // values a site
    if (a.n < 1 || a.X < 1 || a.Y < 1 || a.Z < 1 || a.T < 1 || a.S < 1 || a.C < 1 || a.R < 1)
        return false;
    if (V * most > INT32_MAX || (int64_t)a.ki * a.kd * a.bi * a.bd > 256) return false;
    const bool tiled = (a.ki == 4 || a.ki == 1) && a.ki == a.kd && a.bi == 3 && a.bd == 3;
    const int64_t units = tiled ? 1 : KO;
    if (smem_of<FT>(a) > 232448) return false;
    Sched s{};
    s.n = a.n; s.X = a.X; s.Y = a.Y; s.Z = a.Z; s.T = a.T;
    s.Vp = (int)Vp; s.V = (int)V;
    s.KI = a.ki; s.KD = a.kd; s.BI = a.bi; s.BD = a.bd;
    s.S = a.S; s.C = a.C; s.rs = a.rs; s.wide = a.wide;
    if (a.stream) {
        if (a.rs < a.S + kVec || a.rs % kVec || (a.wide && (a.T % kVec || a.S % kVec)))
            return false;
        s.R = a.R;
        s.ntt = (a.T + a.S - 1) / a.S;
        const int64_t nrt = (Vp / a.T + a.R - 1) / a.R, ncg = (a.n + a.C - 1) / a.C;
        const int64_t tiles = ncg * s.ntt * nrt;
        s.per = a.wide ? a.S / kVec + 2 : a.S + 2;
        s.items = (int)(units * a.R * a.S * a.C);
        if (tiles > INT32_MAX || (int64_t)2 * F * a.R * a.C * s.per > INT32_MAX ||
            units * a.R * a.S * a.C > INT32_MAX)
            return false;
        // chunks of the X walk where the tiles leave SMs idle
        const int64_t want = (int64_t)sms * kStreamWaves;
        int chunks = tiles >= want ? 1 : (int)((want + tiles - 1) / tiles);
        if (chunks > a.X) chunks = a.X;
        s.xc = (a.X + chunks - 1) / chunks;
        chunks = (a.X + s.xc - 1) / s.xc;
        if (chunks > 65535) return false;
        s.dR = FastDiv(a.R);
        s.dntt = FastDiv(s.ntt);
        s.dncg = FastDiv((uint32_t)ncg);
        s.dsite = FastDiv(a.R * a.S * a.C);
        *grid = dim3((unsigned)tiles, (unsigned)chunks);
    } else {
        if (a.rs < a.S || (a.wide && (a.S % kVec || Vp % kVec || a.rs % kVec))) return false;
        s.R = 1;
        s.ngroups = (a.n + a.C - 1) / a.C;
        s.gpb = kXinGroups < s.ngroups ? kXinGroups : s.ngroups;
        const int bpt = (s.ngroups + s.gpb - 1) / s.gpb;   // blocks a tile
        s.per = a.wide ? a.S / kVec : a.S;
        const int64_t tiles = (Vp + a.S - 1) / a.S;
        if (tiles * bpt > INT32_MAX || units * a.X * a.S * a.C > INT32_MAX ||
            (int64_t)2 * F * a.X * a.C * s.per > INT32_MAX)
            return false;
        s.items = (int)(units * a.X * a.S * a.C);
        s.dsite = FastDiv(a.X * a.S * a.C);
        s.dncg = FastDiv(bpt);
        *grid = dim3((unsigned)(tiles * bpt));
    }
    s.dT = FastDiv(a.T);
    s.dZ = FastDiv(a.Z);
    s.dX = FastDiv(a.X);
    s.dS = FastDiv(a.S);
    s.dC = FastDiv(a.C);
    s.dper = FastDiv(s.per);
    *g = s;
    return true;
}

template <typename ST, typename FT> struct Launch {
    static cudaError_t run(const SchedArgs& a, const Dirs& dirs, cudaStream_t stream) {
        using A = acc_t<ST, FT>;
        int dev = 0, sms = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
        dim3 grid;
        Sched g;
        if (!plan_launch<FT>(a, sms, &grid, &g)) return cudaErrorInvalidValue;
        if (a.wide && (((uintptr_t)a.x_re | (uintptr_t)a.x_im) & 15)) return cudaErrorInvalidValue;
        if (a.ki == 4 && a.kd == 4 && a.bi == 3 && a.bd == 3 && a.plan == nullptr)
            return cudaErrorInvalidValue;
        const size_t smem = smem_of<FT>(a);
        auto kernel = a.stream ? pick_kernel<true, ST, FT>(a.ki, a.kd, a.bi, a.bd, a.sparse)
                               : pick_kernel<false, ST, FT>(a.ki, a.kd, a.bi, a.bd, a.sparse);
        // above 48 KB only after the opt-in, per kernel
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return err;
        kernel<<<grid, a.stream ? kStreamThreads : kXinThreads<ST, FT>, smem, stream>>>(
            static_cast<const ST*>(a.b_re), static_cast<const ST*>(a.b_im),
            static_cast<const PlanDir<A>*>(a.plan), static_cast<const A*>(a.k_re),
            static_cast<const A*>(a.k_im), static_cast<const FT*>(a.x_re),
            static_cast<const FT*>(a.x_im), static_cast<FT*>(a.y_re), static_cast<FT*>(a.y_im),
            g, make_hops(dirs, a.X, a.Y, a.Z, a.T));
        return cudaGetLastError();
    }
};

// out: registers a thread, local (spill and stack) bytes a thread, threads
// a block and resident blocks an SM of the kernel a launch with these
// arguments runs, at its shared memory
template <typename ST, typename FT> struct Attrs {
    static cudaError_t run(const SchedArgs& a, int* out) {
        auto kernel = a.stream ? pick_kernel<true, ST, FT>(a.ki, a.kd, a.bi, a.bd, a.sparse)
                               : pick_kernel<false, ST, FT>(a.ki, a.kd, a.bi, a.bd, a.sparse);
        const size_t smem = smem_of<FT>(a);
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        cudaFuncAttributes attr;
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return err;
        const int threads = a.stream ? kStreamThreads : kXinThreads<ST, FT>;
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
        out[0] = attr.numRegs;
        out[1] = (int)attr.localSizeBytes;
        out[2] = threads;
        out[3] = blocks;
        return err;
    }
};

// Op<ST, FT>::run(args...) for the kPair ``pair``
template <template <typename, typename> class Op, typename... Args>
cudaError_t by_pair(int pair, Args... args) {
    switch (pair) {
        case kF32F32: return Op<float, float>::run(args...);
        case kBf16F32: return Op<__nv_bfloat16, float>::run(args...);
        case kBf16Bf16: return Op<__nv_bfloat16, __nv_bfloat16>::run(args...);
        case kF32Bf16: return Op<float, __nv_bfloat16>::run(args...);
        case kF64F64: return Op<double, double>::run(args...);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// K4a.  pair: the kPair of (storage, field) types; plan: the device table
// of the kron's PlanDir records in the pair's sum type (ops/stencil.py
// spin_plan; needed at (4, 4, 3, 3), nullptr at (1, 1, 3, 3) without a
// kron); k_re, k_im: the kron [ndir, KI, KD] in the sum type at the other
// shapes (nullptr: K_d = 1); offsets: host array [ndir, 4] of one-hot +-1
// (or all-zero) offsets; sparse: the plan takes the sparse form; (S, C,
// rs): the tile (ops/stencil.py xin_tile); wide: 16-byte copies.
int sbt_stencil_soa_xin(int ki, int kd, int bi, int bd, int pair, const void* b_re,
                        const void* b_im, const void* plan, const void* k_re, const void* k_im,
                        const void* x_re, const void* x_im, void* y_re, void* y_im, int n,
                        int X, int Y, int Z, int T, int ndir, const int* offsets, int sparse,
                        int S, int C, int rs, int wide, void* stream) {
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, -1, &dirs);
    if (err != cudaSuccess) return err;
    const SchedArgs a{false, ki, kd, bi, bd, b_re, b_im, plan, k_re, k_im, x_re, x_im,
                      y_re, y_im, n, X, Y, Z, T, sparse != 0, S, 1, C, rs, wide != 0};
    return by_pair<Launch>(pair, a, dirs, static_cast<cudaStream_t>(stream));
}

// K4b.  The arguments of sbt_stencil_soa_xin; the tile (S, R, C, rs) from
// ops/stencil.py stream_tile.
int sbt_stencil_soa_stream(int ki, int kd, int bi, int bd, int pair, const void* b_re,
                           const void* b_im, const void* plan, const void* k_re,
                           const void* k_im, const void* x_re, const void* x_im, void* y_re,
                           void* y_im, int n, int X, int Y, int Z, int T, int ndir,
                           const int* offsets, int sparse, int S, int R, int C, int rs,
                           int wide, void* stream) {
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, -1, &dirs);
    if (err != cudaSuccess) return err;
    const SchedArgs a{true, ki, kd, bi, bd, b_re, b_im, plan, k_re, k_im, x_re, x_im,
                      y_re, y_im, n, X, Y, Z, T, sparse != 0, S, R, C, rs, wide != 0};
    return by_pair<Launch>(pair, a, dirs, static_cast<cudaStream_t>(stream));
}

// The registers, local bytes, threads a block and resident blocks an SM of
// the kernel of K4a (stream 0) or K4b (stream 1) at this shape, pair, form,
// column count and tile (out[4]).
int sbt_stencil_schedule_attrs(int stream, int ki, int kd, int bi, int bd, int pair,
                               int sparse, int n, int X, int S, int R, int C, int rs,
                               int* out) {
    const SchedArgs a{stream != 0, ki, kd, bi, bd, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr, nullptr, nullptr, n, X, 1, 1, 1,
                      sparse != 0, S, R, C, rs, false};
    return by_pair<Attrs>(pair, a, out);
}

}  // extern "C"
