// K1's runtime-shape route for Hopper (sm_90a): the SoA stencil matvec at
// any (KI, KD, BI, BD) with KI*KD*BI*BD <= 256, given at run time.
//
// Replaces the Pallas TPU kernel superbblas_tpu/ops/stencil_pallas.py
// stencil_matvec_soa (_kernel, _matvec_body) at every shape but those of
// K1's own kernels (stencil_tiled.cu: (4, 4, 3, 3), (1, 1, 3, 3);
// stencil_site.cu and stencil_soa.cu: (1, 1, 12, 12)).  It computes the sum
// of stencil_soa.cuh over a periodic 4-D lattice, in split complex,
//   y[n, a*BI+i, s] = sum_d sum_j B_d[i, j](s) sum_b K_d[a, b] x[n, b*BD+j, s+o_d]
// with blocks [ndir, BI*BD, X, Y, Z, T] of the storage type ST, fields x
// [n, KD*BD, ...] and y [n, KI*BI, ...] of the field type FT, kron factors
// [ndir, KI, KD] in the sum's type (nullptr: K_d = 1), at the five pairs of
// kPair, any ndir <= kMaxDirs with its one-hot offsets, packed parity (the
// parity-select X shift of stencil_soa.cu), any n >= 1.
//
// Bits.  A (site, column)'s sums are rt_zterm and rt_acc of
// stencil_soa.cuh, the runtime-shape arithmetic the X-inside and
// X-streaming schedules share (rt_direction): z[a][j] over b ascending,
// the output over d, then j, four fma_a a complex product.  So this route gives the schedules' bits at every
// shape, the tiled route's where no direction of its spin plan factors, and
// the block-streaming kernel's at (1, 1, 12, 12).
//
// What bounds it on the H100: bytes at the wide shapes (at (1, 1, 16, 16)
// the blocks are 90% of them: 2 KB a site a direction at f32 against 128 B
// of x a column), bytes and issue at the narrow ones.  The kernel it
// replaces ran one thread per (site, output, column): x passed the caches
// KI*BI times a direction, each z was formed BI times, the links were read
// once a column, and every index was 64-bit (13-20x its bound).  This design:
//  * a block owns a tile of S consecutive sites (flat index, T fastest) and
//    a group of C columns that share them; for each direction it stages the
//    tile's BI*BD block planes (re and im) in shared memory once for all
//    its columns and outputs, and each (site, column)'s F = KD*BD
//    neighbour features once, not once per output;
//  * a thread owns up to R outputs (R = 1-4, 8 or 16, compile time) of one
//    site for two columns, within one row a of K_d: G = KI * ceil(BI / R)
//    threads share a (site, column pair) (where that passes 32, R
//    consecutive outputs across rows, G = ceil(KI*BI / R)); each block
//    entry it reads from shared memory serves both columns (one column a
//    thread ran 5-40% slower); it forms z[a][j] once a column for each row
//    its outputs touch and keeps its sums in registers across the
//    directions, so (1, 1, 16, 16) and (2, 2, 8, 8) need no register array
//    of 256; its loop over j has no branch (the slots past its outputs sum
//    a copy of the last row and are not stored; KD of 1 to 4 unrolled at
//    compile time), so the loads of a j hoist ahead of its FMAs: the
//    branches of the first form ran the wide shapes 1.5-1.7x slower;
//  * the grid is persistent; a block walks its items (tile, column group,
//    D directions) through a ring of 2-8 stages filled with cp.async, so
//    that the copies of the next stages are in flight while one is summed
//    (the narrow shapes do little work a direction: a stage holds several
//    directions, and the ring is deep, or they wait on each copy's
//    latency):
//    16-byte copies (copy16) where a stage's row of sites is 16-byte
//    aligned in device memory (the blocks, and x at every hop of a tile
//    inside one T row: a T hop stages the tile's own row and one halo
//    site, read one site off), element copies (copy_elem) elsewhere: the
//    halo, the X hops under packed parity (the slot is chosen site by site)
//    and ragged lattices;
//  * coordinates are 32-bit with divisors fixed at launch (FastDiv):
//    ops/stencil.py raises ValueError above 2^31 values a column's field
//    or a direction's blocks (check_32bit);
//  * a warp's threads share their outputs' rows and read the same block
//    entries (a broadcast); where a warp spans several columns their
//    features lie in other banks;
//  * ops/stencil.py rt_tile picks S, C, R, D and the stages: the ring
//    fits a block's shared memory, up to 256 threads a block, 512 (site,
//    column) sums an SM where the shape allows; f64 (there to be right)
//    runs one block an SM.
//
// Plain C interface (loaded with ctypes); a call returns the cudaError_t
// of its launch.

#include <type_traits>

#include "kernel_common.cuh"
#include "stencil_soa.cuh"

namespace {

__host__ __device__ constexpr int log2_of(int v) { return v > 1 ? 1 + log2_of(v / 2) : 0; }

// The design, as its bring-up sweep chose it (PERF.md section 6): most
// threads a block, and the launch bound's blocks an SM at the f32-summed
// pairs (one at f64).  The tile, the directions a stage holds and the
// ring's depth are the host picker's (ops/stencil.py rt_tile), arguments
// of the call.
constexpr int kThreads = 256;
constexpr int kMaxStages = 8;
constexpr int kRowThreads = 32;   // most threads a (site, column) of the rowwise split
// columns a thread sums, each block entry it reads from shared memory
// serving both (one column a thread ran 5-40% slower, PERF.md section 6)
constexpr int kCols = 2;

template <typename ST, typename FT> constexpr int kMinBlocks =
    sizeof(acc_t<ST, FT>) == 8 ? 1 : 2;

// The launch: shape, tile and shared-memory layout; every index the kernel
// decodes is below 2^31 (sbt_stencil_soa_rt checks).
struct RtGrid {
    int V, units;              // sites; items (tile, column group) of the launch
    int X, ZT, YZT;            // X extent; strides of Y and X
    int KI, KD, BI, BD;        // the shape
    int F, KO, NE;             // KD*BD inputs, KI*BI outputs, BI*BD block entries
    int S, sbits, C, G;        // sites a tile (2^sbits), columns a group, threads a (site, column)
    int rowwise, nchunk;       // a thread's outputs in one row of K_d, ceil(BI / R) threads a row
    int ngroup;                // column groups
    int D, nsteps, stages;     // directions a stage, stages a unit, stages of the ring
    int xrs, xcs;              // elements from one x row (a feature of a column) to the next, and
                               // from one column to the next, in a stage
    int kron_bytes, dir_bytes, x_off;   // shared memory: kron; a direction's slot, its x part
    int wide_b, wide_x;        // 16-byte copies of the blocks; of x where a row allows
    FastDiv T, Z, Y, F_div, BI_div, BD_div, ngroup_div, nsteps_div;
};

// site s = ((x * Y + y) * Z + z) * T + t -> its coordinates
struct Coords {
    int x, y, z, t;
    __device__ __forceinline__ Coords(const RtGrid& g, int s) {
        const int zt = (int)g.T.div(s), yzt = (int)g.Z.div(zt);
        t = s - zt * (int)g.T.d;
        z = zt - yzt * (int)g.Z.d;
        x = (int)g.Y.div(yzt);
        y = yzt - x * (int)g.Y.d;
    }
};

// flat index of the neighbour of site s in direction d on the torus, in 32
// bits (stencil_soa.cuh neighbour(): with a packed parity an X step moves
// only on the sites whose image parity asks for it)
__device__ __forceinline__ int neighbour32(const RtGrid& g, const Dirs& dirs, int d, int s,
                                           const Coords& c) {
    const int ax = dirs.axis[d], sg = dirs.sign[d];
    bool move = sg != 0;
    if (move && ax == 0 && dirs.packed >= 0) {
        const bool odd = ((dirs.packed + c.y + c.z + c.t) & 1) != 0;
        move = sg > 0 ? odd : !odd;
    }
    if (!move) return s;
    const int co = ax == 0 ? c.x : ax == 1 ? c.y : ax == 2 ? c.z : c.t;
    const int L = ax == 0 ? g.X : ax == 1 ? (int)g.Y.d : ax == 2 ? (int)g.Z.d : (int)g.T.d;
    const int st = ax == 0 ? g.YZT : ax == 1 ? g.ZT : ax == 2 ? (int)g.T.d : 1;
    if (sg > 0) return s + (co == L - 1 ? -(L - 1) * st : st);
    return s + (co == 0 ? (L - 1) * st : -st);
}

// the row of block entry e = i*BD + j of part ``part`` (re, im) in a stage:
// j*BI + i, so that the entries B_d[i, j] a thread sums for one j are S
// elements apart
__device__ __forceinline__ int b_row(const RtGrid& g, int part, int e) {
    const int i = (int)g.BD_div.div(e);
    return part * g.NE + (e - i * g.BD) * g.BI + i;
}

// wait until at most n (0 <= n <= kMaxStages - 2) committed groups of this
// thread are in flight
__device__ __forceinline__ void copy_wait_upto(int n) {
    switch (n) {
        case 0: copy_wait<0>(); break;
        case 1: copy_wait<1>(); break;
        case 2: copy_wait<2>(); break;
        case 3: copy_wait<3>(); break;
        case 4: copy_wait<4>(); break;
        case 5: copy_wait<5>(); break;
        default: copy_wait<6>(); break;
    }
}

// direction d's operands of the unit whose tile starts at site s0 and whose
// columns start at c0 into one slot of a stage, by all threads of the
// block: the tile's block planes [re|im][j][i][site] and its columns'
// neighbour features [re|im][column (xcs apart)][j][b (xrs apart)][site]
// (feature b*BD + j), so that the compute walks j with fixed strides;
// sites at or past V and columns at or past n are left unwritten
template <typename ST, typename FT>
__device__ __forceinline__ void copy_dir(unsigned char* slot, const RtGrid& g, const Dirs& dirs,
                                         const Coords& c0s, const ST* __restrict__ b_re,
                                         const ST* __restrict__ b_im,
                                         const FT* __restrict__ x_re,
                                         const FT* __restrict__ x_im, int n, int s0, int c0,
                                         int d, int tid, int nthreads) {
    const int V = g.V, S = g.S;
    ST* sb = reinterpret_cast<ST*>(slot);
    const ST* bre = b_re + (int64_t)d * g.NE * V + s0;
    const ST* bim = b_im + (int64_t)d * g.NE * V + s0;
    if (g.wide_b) {
        constexpr int kVec = 16 / sizeof(ST);
        const int cbits = g.sbits - log2_of(kVec);   // chunks of a row: 2^cbits
        for (int q = tid; q < (2 * g.NE) << cbits; q += nthreads) {
            const int row = q >> cbits, c = (q & ((1 << cbits) - 1)) * kVec;
            const int part = row >= g.NE, e = row - part * g.NE;
            if (s0 + c < V)   // V is a multiple of kVec: whole copies
                copy16(sb + b_row(g, part, e) * S + c, (part ? bim : bre) + e * V + c);
        }
    } else {
        for (int q = tid; q < 2 * g.NE * S; q += nthreads) {
            const int row = q >> g.sbits, c = q & (S - 1);
            const int part = row >= g.NE, e = row - part * g.NE;
            if (s0 + c < V)
                copy_elem(sb + b_row(g, part, e) * S + c, (part ? bim : bre) + e * V + c);
        }
    }

    // a row of x: a pad of kVec slots (its last the left halo), the S sites
    // from slot kVec on, the right halo in the next row's first slot
    constexpr int kVec = 16 / sizeof(FT);
    FT* sx = reinterpret_cast<FT*>(slot + g.x_off) + kVec;
    const int rows = g.C * g.F;   // rows of one part
    const int ax = dirs.axis[d];
    // a tile inside one T row shifted along X, Y or Z (or not at all) is a
    // row of consecutive sites; a T hop reads the tile's own row one site
    // off, with one halo site (thop); an X hop under packed parity picks
    // the slot site by site
    const bool row_tile = g.wide_x && c0s.t + S <= (int)g.T.d && s0 + S <= V;
    const bool thop = row_tile && ax == 3;
    bool wide = row_tile && (ax == 3 || !(ax == 0 && dirs.packed >= 0));
    int nb0 = s0;
    if (wide && !thop) {
        nb0 = neighbour32(g, dirs, d, s0, c0s);
        wide = nb0 % kVec == 0;
    }
    // row (part, column, feature) of the stage's x: its place and its source
    auto row_of = [&](int row, FT** dst, const FT** src) {
        const int part = row >= rows;
        const int cf = row - part * rows;
        const int col = (int)g.F_div.div(cf), f = cf - col * g.F;
        const int b = (int)g.BD_div.div(f), j = f - b * g.BD;   // x[b*BD + j] at row j*KD + b
        *dst = sx + (part * g.C + col) * g.xcs + (j * g.KD + b) * g.xrs;
        *src = (part ? x_im : x_re) + ((int64_t)(c0 + col) * g.F + f) * V;
        return c0 + col < n;
    };
    if (wide) {
        const int cbits = g.sbits - log2_of(kVec);
        for (int q = tid; q < (2 * rows) << cbits; q += nthreads) {
            const int c = (q & ((1 << cbits) - 1)) * kVec;
            FT* dst;
            const FT* src;
            if (row_of(q >> cbits, &dst, &src)) copy16(dst + c, src + nb0 + c);
        }
        if (thop) {
            // the halo site of each row: s0 - 1 or s0 + S, wrapped in T
            const int T = (int)g.T.d;
            const int h = dirs.sign[d] > 0 ? S : -1;
            const int nbh = dirs.sign[d] > 0 ? (c0s.t + S == T ? s0 + S - T : s0 + S)
                                             : (c0s.t == 0 ? s0 + T - 1 : s0 - 1);
            for (int row = tid; row < 2 * rows; row += nthreads) {
                FT* dst;
                const FT* src;
                if (row_of(row, &dst, &src)) copy_elem(dst + h, src + nbh);
            }
        }
    } else {
        const int lane = tid & (S - 1), s = s0 + lane;
        if (s < V) {
            const int nb = neighbour32(g, dirs, d, s, Coords(g, s));
            for (int row = tid >> g.sbits; row < 2 * rows; row += nthreads >> g.sbits) {
                FT* dst;
                const FT* src;
                if (row_of(row, &dst, &src)) copy_elem(dst + lane, src + nb);
            }
        }
    }
}

// One direction's sums of a rowwise thread: for j ascending, z[a][j] of
// each of its kCols columns (the row a of K_d in registers, KDc = KD of 1
// to 4 unrolled at compile time, 0 for any KD from shared memory), then
// its R colour rows of B_d (boff: their offsets, slots past the thread's
// outputs on a copy of the last); pb, px: B_d and x at j = 0, xc: each
// column's x, xim and bim: the imaginary parts', bj and xj: the strides of j.
template <int KDc, int R, int kCols, typename ST, typename FT, typename A>
__device__ __forceinline__ void row_direction(const RtGrid& g, const A* kra, const A* kia,
                                              const ST* pb, const FT* px,
                                              const int (&xc)[kCols], const int (&boff)[R],
                                              int xim, int bim, int bj, int xj,
                                              A (&acc_re)[kCols][R], A (&acc_im)[kCols][R]) {
    constexpr int kKc = KDc > 0 ? KDc : 1;
    A kc_r[kKc], kc_i[kKc];
#pragma unroll
    for (int b = 0; b < kKc; ++b) {
        kc_r[b] = kra[b];
        kc_i[b] = kia[b];
    }
#pragma unroll 2
    for (int j = 0; j < g.BD; ++j, pb += bj, px += xj) {
        A zr[kCols], zi[kCols];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
            const FT* pc = px + xc[cc];
            zr[cc] = zi[cc] = A(0);
            if constexpr (KDc > 0) {
#pragma unroll
                for (int b = 0; b < KDc; ++b)
                    rt_zterm(kc_r[b], kc_i[b], A(to_f(pc[b * g.xrs])),
                             A(to_f(pc[b * g.xrs + xim])), zr[cc], zi[cc]);
            } else {
                for (int b = 0; b < g.KD; ++b)
                    rt_zterm(kra[b], kia[b], A(to_f(pc[b * g.xrs])),
                             A(to_f(pc[b * g.xrs + xim])), zr[cc], zi[cc]);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const A br = to_f(pb[boff[r]]), bi = to_f(pb[boff[r] + bim]);
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc)
                rt_acc(br, bi, zr[cc], zi[cc], acc_re[cc][r], acc_im[cc][r]);
        }
    }
}

template <typename ST, typename FT, int R>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<ST, FT>)) stencil_rt_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im,
    const acc_t<ST, FT>* __restrict__ k_re, const acc_t<ST, FT>* __restrict__ k_im,
    const FT* __restrict__ x_re, const FT* __restrict__ x_im, FT* __restrict__ y_re,
    FT* __restrict__ y_im, int n, const __grid_constant__ RtGrid g,
    const __grid_constant__ Dirs dirs) {
    using A = acc_t<ST, FT>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    A* skron = reinterpret_cast<A*>(smem_raw);   // [re|im][ndir][KI][KD]
    unsigned char* ring = smem_raw + g.kron_bytes;
    const int stage_bytes = g.D * g.dir_bytes;

    const int ndir = dirs.ndir;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int KK = g.KI * g.KD, nk = ndir * KK;
    stage_kron(skron, k_re, k_im, nk);   // read after the first item's barrier

    // this thread's share of a unit: site lane, kCols columns c, c + 1, ...
    // of the group (the columns of a group fastest, so that a warp's threads
    // read the same block entries), and the outputs [o0, o0 + nr): R of one
    // row a of K_d (rowwise), or R consecutive ones across rows where the
    // rows are too many for a thread each
    const int S = g.S, lane = tid & (S - 1);
    const int rest = tid >> g.sbits;
    const int cg = (g.C + kCols - 1) / kCols;   // column sets of a group
    const int gq = rest / cg;
    const int c = (rest - gq * cg) * kCols;
    const int arow = g.rowwise ? gq / g.nchunk : 0;
    const int o0 = g.rowwise ? arow * g.BI + (gq - arow * g.nchunk) * R : gq * R;
    const int nr = min(R, g.rowwise ? (arow + 1) * g.BI - o0 : g.KO - o0);

    const int mine = g.units > (int)blockIdx.x
                         ? (g.units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const int items = mine * g.nsteps;   // item: (unit, its step of D directions)
    auto issue = [&](int k) {
        if (k < items) {
            const int j = (int)g.nsteps_div.div(k);
            const int u = (int)blockIdx.x + j * (int)gridDim.x;
            const int tile = (int)g.ngroup_div.div(u);
            const int s0 = tile << g.sbits, c0 = (u - tile * g.ngroup) * g.C;
            const Coords c0s(g, s0);
            const int d0 = (k - j * g.nsteps) * g.D;
            const int dn = min(g.D, ndir - d0);
            unsigned char* stage = ring + (k % g.stages) * stage_bytes;
            for (int q = 0; q < dn; ++q)
                copy_dir(stage + q * g.dir_bytes, g, dirs, c0s, b_re, b_im, x_re, x_im, n, s0,
                         c0, d0 + q, tid, nthreads);
        }
        copy_commit();
    };
    for (int k = 0; k < g.stages - 1; ++k) issue(k);

    A acc_re[kCols][R], acc_im[kCols][R];
    int s = 0, col = 0, step = g.nsteps - 1, ncol = 0;   // columns of the set that exist
    bool live = false, thop = false;
#pragma unroll 1
    for (int k = 0; k < items; ++k) {
        if (++step == g.nsteps) {
            step = 0;
            const int u = (int)blockIdx.x + (int)g.nsteps_div.div(k) * (int)gridDim.x;
            const int tile = (int)g.ngroup_div.div(u);
            s = (tile << g.sbits) + lane;
            col = (u - tile * g.ngroup) * g.C + c;
            ncol = min(min(kCols, n - col), g.C - c);
            live = s < g.V && ncol > 0 && nr > 0;
            // copy_dir's thop: the T hops read the tile's own row
            const int s0 = tile << g.sbits, t0 = s0 - (int)g.T.div(s0) * (int)g.T.d;
            thop = g.wide_x && t0 + S <= (int)g.T.d && s0 + S <= g.V;
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
                for (int r = 0; r < R; ++r) acc_re[cc][r] = acc_im[cc][r] = A(0);
        }
        copy_wait_upto(g.stages - 2);
        __syncthreads();
        issue(k + g.stages - 1);   // into the stage item k - 1 used: every thread is past it
        if (live) {
            const unsigned char* stage = ring + (k % g.stages) * stage_bytes;
            const int d0 = step * g.D, dn = min(g.D, ndir - d0);
            for (int q = 0; q < dn; ++q) {
                const unsigned char* slot = stage + q * g.dir_bytes;
                const ST* bs = reinterpret_cast<const ST*>(slot) + lane;
                const int d = d0 + q;
                const int toff = thop && dirs.axis[d] == 3 ? dirs.sign[d] : 0;
                // column cc's x (a missing column reads the first's)
                const FT* xr = reinterpret_cast<const FT*>(slot + g.x_off) + c * g.xcs +
                               16 / (int)sizeof(FT) + lane + toff;
                int xc[kCols];
#pragma unroll
                for (int cc = 0; cc < kCols; ++cc) xc[cc] = cc < ncol ? cc * g.xcs : 0;
                const A* kr = skron + (d0 + q) * KK;
                const A* ki = skron + nk + (d0 + q) * KK;
                const int xim = g.C * g.xcs, bim = g.NE * S;
                const int xj = g.KD * g.xrs, bj = g.BI * S;   // strides of j
                if (g.rowwise) {
                    const A* kra = kr + arow * g.KD;
                    const A* kia = ki + arow * g.KD;
                    const ST* pb = bs + (o0 - arow * g.BI) * S;
                    // slots past nr sum a copy of the last row and are not
                    // stored: no branch in the loop (its loads hoist)
                    int boff[R];
#pragma unroll
                    for (int r = 0; r < R; ++r) boff[r] = min(r, nr - 1) * S;
                    auto rows = [&](auto kd) {
                        row_direction<decltype(kd)::value>(g, kra, kia, pb, xr, xc, boff, xim,
                                                           bim, bj, xj, acc_re, acc_im);
                    };
                    switch (g.KD) {
                        case 1: rows(std::integral_constant<int, 1>{}); break;
                        case 2: rows(std::integral_constant<int, 2>{}); break;
                        case 3: rows(std::integral_constant<int, 3>{}); break;
                        case 4: rows(std::integral_constant<int, 4>{}); break;
                        default: rows(std::integral_constant<int, 0>{}); break;
                    }
                    continue;
                }
                // the rows a of K_d the outputs touch, each with its outputs
                // [r_lo, r_lo + cnt) of this thread and their first colour
                // row i_lo
                for (int r_lo = 0; r_lo < nr;) {
                    const int a = (int)g.BI_div.div(o0 + r_lo);
                    const int i_lo = o0 + r_lo - a * g.BI;
                    const int cnt = min(nr - r_lo, g.BI - i_lo);
                    const ST* pb = bs + (i_lo - r_lo) * S;
                    const FT* px = xr;
                    for (int j = 0; j < g.BD; ++j, pb += bj, px += xj) {
                        A zr[kCols], zi[kCols];
#pragma unroll
                        for (int cc = 0; cc < kCols; ++cc) {
                            const FT* pc = px + xc[cc];
                            zr[cc] = zi[cc] = A(0);
                            for (int b = 0; b < g.KD; ++b)
                                rt_zterm(kr[a * g.KD + b], ki[a * g.KD + b],
                                         A(to_f(pc[b * g.xrs])), A(to_f(pc[b * g.xrs + xim])),
                                         zr[cc], zi[cc]);
                        }
#pragma unroll
                        for (int r = 0; r < R; ++r)
                            if (r >= r_lo && r < r_lo + cnt) {
                                const A br = to_f(pb[r * S]), bi = to_f(pb[r * S + bim]);
#pragma unroll
                                for (int cc = 0; cc < kCols; ++cc)
                                    rt_acc(br, bi, zr[cc], zi[cc], acc_re[cc][r],
                                           acc_im[cc][r]);
                            }
                    }
                    r_lo += cnt;
                }
            }
            if (step == g.nsteps - 1) {
#pragma unroll
                for (int cc = 0; cc < kCols; ++cc) {
                    if (cc >= ncol) continue;
                    const int64_t out = ((int64_t)(col + cc) * g.KO + o0) * g.V + s;
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        if (r < nr) {
                            store_f(y_re + out + (int64_t)r * g.V, acc_re[cc][r]);
                            store_f(y_im + out + (int64_t)r * g.V, acc_im[cc][r]);
                        }
                    }
                }
            }
        }
    }
    copy_wait<0>();
}

constexpr int kMaxDevices = 64;
constexpr int kOccSlots = 16;

// the kernel of one (pair, R): its per-device set-up (the ring's
// shared-memory attribute, the SM count) and resident blocks an SM by
// (threads, shared memory), kept so that a launch makes no query of its own
template <typename ST, typename FT, int R>
struct Rt {
    struct Occ {
        int threads = 0, smem = 0, per_sm = 0;
    };
    struct Dev {
        int sms = 0;
        Occ occ[kOccSlots];
        int next = 0;
    };

    static cudaError_t slots(int threads, int smem, int* sms, int* per_sm) {
        static Dev cache[kMaxDevices];
        int dev;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        Dev local;
        Dev& c = dev < kMaxDevices ? cache[dev] : local;
        if (c.sms == 0) {
            int optin;
            if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                              dev)) != cudaSuccess ||
                (err = cudaFuncSetAttribute(stencil_rt_kernel<ST, FT, R>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            optin)) != cudaSuccess ||
                (err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev)) !=
                    cudaSuccess)
                return err;
        }
        *sms = c.sms;
        for (const Occ& o : c.occ)
            if (o.threads == threads && o.smem == smem) {
                *per_sm = o.per_sm;
                return cudaSuccess;
            }
        Occ o{threads, smem, 0};
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &o.per_sm, stencil_rt_kernel<ST, FT, R>, threads, smem)) != cudaSuccess)
            return err;
        if (o.per_sm < 1) return cudaErrorInvalidConfiguration;
        c.occ[c.next] = o;
        c.next = (c.next + 1) % kOccSlots;
        *per_sm = o.per_sm;
        return cudaSuccess;
    }

    static cudaError_t run(const Operands& a, const Dirs& dirs, const RtGrid& g, int threads,
                           int smem, cudaStream_t stream) {
        int sms, per_sm;
        const cudaError_t err = slots(threads, smem, &sms, &per_sm);
        if (err != cudaSuccess) return err;
        const int64_t all = (int64_t)per_sm * sms;
        using A = acc_t<ST, FT>;
        stencil_rt_kernel<ST, FT, R><<<(unsigned)(g.units < all ? g.units : all), threads, smem,
                                       stream>>>(
            static_cast<const ST*>(a.b_re), static_cast<const ST*>(a.b_im),
            static_cast<const A*>(a.k_re), static_cast<const A*>(a.k_im),
            static_cast<const FT*>(a.x_re), static_cast<const FT*>(a.x_im),
            static_cast<FT*>(a.y_re), static_cast<FT*>(a.y_im), a.n, g, dirs);
        return cudaGetLastError();
    }

    // registers, local bytes, threads a block, resident blocks an SM
    static cudaError_t attrs(int threads, int smem, int* out) {
        int sms;
        cudaError_t err = slots(threads, smem, &sms, &out[3]);
        cudaFuncAttributes attr;
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, stencil_rt_kernel<ST, FT, R>);
        if (err != cudaSuccess) return err;
        out[0] = attr.numRegs;
        out[1] = (int)attr.localSizeBytes;
        out[2] = threads;
        return cudaSuccess;
    }
};

// f(Rt<ST, FT, R>{}) for the kPair ``pair`` and R in {1, 2, 3, 4, 8, 16}
template <typename F>
cudaError_t by_pair(int pair, int R, F&& f) {
    auto at = [&](auto st, auto ft) -> cudaError_t {
        using ST = decltype(st);
        using FT = decltype(ft);
        switch (R) {
            case 1: return f(Rt<ST, FT, 1>{});
            case 2: return f(Rt<ST, FT, 2>{});
            case 3: return f(Rt<ST, FT, 3>{});
            case 4: return f(Rt<ST, FT, 4>{});
            case 8: return f(Rt<ST, FT, 8>{});
            case 16: return f(Rt<ST, FT, 16>{});
            default: return cudaErrorInvalidValue;
        }
    };
    switch (pair) {
        case kF32F32: return at(float{}, float{});
        case kBf16F32: return at(__nv_bfloat16{}, float{});
        case kBf16Bf16: return at(__nv_bfloat16{}, __nv_bfloat16{});
        case kF32Bf16: return at(float{}, __nv_bfloat16{});
        case kF64F64: return at(double{}, double{});
        default: return cudaErrorInvalidValue;
    }
}

constexpr int elem_of(int pair, bool field) {
    return pair == kF64F64 ? 8
           : field ? (pair == kBf16Bf16 || pair == kF32Bf16 ? 2 : 4)
                   : (pair == kBf16F32 || pair == kBf16Bf16 ? 2 : 4);
}

constexpr int64_t round16(int64_t b) { return (b + 15) / 16 * 16; }

// The tile and shared memory of a launch (ops/stencil.py rt_smem): the
// kron factors, then ``stages`` stages of D direction slots of [blocks |
// x]; x's rows S + 16 bytes apart (the halo sites of a T hop), its columns
// where S < 32 padded to S sites past a multiple of 128 bytes (the columns
// a warp reads fall in other banks); false where the tile is outside the
// kernel's rules.
bool layout(int pair, int ki, int kd, int bi, int bd, int ndir, int S, int C, int R, int D,
            int stages, RtGrid* g, int* threads, int* smem) {
    if (S < 8 || S > 1024 || (S & (S - 1)) || C < 1 || R < 1 || R > 16 || (R > 4 && R % 8) ||
        D < 1 || D > ndir || stages < 2 || stages > kMaxStages)
        return false;
    const int st = elem_of(pair, false), ft = elem_of(pair, true);
    const int acc = pair == kF64F64 ? 8 : 4;
    // a thread's outputs in one row of K_d while the rows' threads are at
    // most kRowThreads a (site, column)
    g->nchunk = (bi + R - 1) / R;
    g->rowwise = ki * g->nchunk <= kRowThreads;
    g->G = g->rowwise ? ki * g->nchunk : (ki * bi + R - 1) / R;
    const int vec = 16 / ft;
    g->xrs = S + vec;
    g->xcs = kd * bd * g->xrs;
    if (S < 32 && (S / kCols) % vec == 0) {
        // the column sets of a warp S sites apart in the 128 bytes of the banks
        const int m = 128 / ft / kCols;
        g->xcs += ((S / kCols - g->xcs) % m + m) % m;
    }
    const int64_t kron = round16(2LL * ndir * ki * kd * acc);
    const int64_t x_off = round16(2LL * bi * bd * S * st);
    const int64_t dir = x_off + round16((2LL * C * g->xcs + vec) * ft);
    const int64_t all = kron + (int64_t)stages * D * dir;
    const int64_t nthreads = (int64_t)S * ((C + kCols - 1) / kCols) * g->G;
    if (nthreads > kThreads || all > INT32_MAX) return false;
    g->kron_bytes = (int)kron, g->x_off = (int)x_off, g->dir_bytes = (int)dir;
    g->D = D, g->stages = stages, g->nsteps = (ndir + D - 1) / D;
    *threads = (int)nthreads;
    *smem = (int)all;
    return true;
}

}  // namespace

extern "C" {

// K1's runtime-shape route: any shape with ki*kd*bi*bd <= 256 and any n >= 1,
// at the tile ops/stencil.py rt_tile picks: S sites, C columns, R outputs
// and two columns a thread (S * ceil(C / 2) * G threads, at most
// kThreads), D directions a stage, a ring of ``stages`` (2 to 8); every value of
// a column's field and of a direction's blocks below 2^31; pair: the kPair;
// offsets: host [ndir, 4]; packed_parity 0, 1 or -1 (none).
int sbt_stencil_soa_rt(int ki, int kd, int bi, int bd, int pair, const void* b_re,
                       const void* b_im, const void* k_re, const void* k_im, const void* x_re,
                       const void* x_im, void* y_re, void* y_im, int n, int X, int Y, int Z,
                       int T, int ndir, const int* offsets, int packed_parity, int S, int C, int R,
                       int D, int stages, void* stream) {
    if (ki < 1 || kd < 1 || bi < 1 || bd < 1 || ki * kd * bi * bd > 256 || n < 1 || X < 1 ||
        Y < 1 || Z < 1 || T < 1)
        return cudaErrorInvalidValue;
    Dirs dirs{};
    cudaError_t err = parse_dirs(ndir, offsets, packed_parity, &dirs);
    if (err != cudaSuccess) return err;
    RtGrid g{};
    int threads, smem;
    if (!layout(pair, ki, kd, bi, bd, ndir, S, C, R, D, stages, &g, &threads, &smem))
        return cudaErrorInvalidValue;
    const int64_t V = (int64_t)X * Y * Z * T;
    const int F = kd * bd, KO = ki * bi, NE = bi * bd;
    const int64_t ntile = (V + S - 1) / S, ngroup = (n + C - 1) / C;
    const int64_t per_site = F > KO ? (F > NE ? F : NE) : (KO > NE ? KO : NE);
    if (V * per_site >= INT32_MAX || ntile * ngroup * g.nsteps >= INT32_MAX)
        return cudaErrorInvalidValue;
    g.V = (int)V;
    g.X = X, g.ZT = Z * T, g.YZT = Y * Z * T;
    g.units = (int)(ntile * ngroup);
    g.KI = ki, g.KD = kd, g.BI = bi, g.BD = bd, g.F = F, g.KO = KO, g.NE = NE;
    g.S = S, g.C = C, g.ngroup = (int)ngroup;
    while ((1 << g.sbits) < S) ++g.sbits;
    const int st = elem_of(pair, false), ft = elem_of(pair, true);
    auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    g.wide_b = (V * st) % 16 == 0 && (S * st) % 16 == 0 && aligned(b_re) && aligned(b_im);
    g.wide_x = (V * ft) % 16 == 0 && (S * ft) % 16 == 0 && aligned(x_re) && aligned(x_im);
    g.T = FastDiv(T), g.Z = FastDiv(Z), g.Y = FastDiv(Y), g.F_div = FastDiv(F);
    g.BI_div = FastDiv(bi), g.BD_div = FastDiv(bd), g.ngroup_div = FastDiv(g.ngroup), g.nsteps_div = FastDiv(g.nsteps);
    const Operands a{b_re, b_im, k_re, k_im, x_re, x_im, y_re, y_im, n, X, Y, Z, T};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return by_pair(pair, R, [&](auto rt) {
        return decltype(rt)::run(a, dirs, g, threads, smem, s);
    });
}

// The registers, local bytes, threads a block and resident blocks an SM
// (out[4]) of the runtime-shape route at a tile of rt_tile (as the call).
int sbt_stencil_soa_rt_attrs(int ki, int kd, int bi, int bd, int pair, int ndir, int S, int C,
                             int R, int D, int stages, int* out) {
    RtGrid g{};
    int threads, smem;
    if (ndir < 1 || ndir > kMaxDirs ||
        !layout(pair, ki, kd, bi, bd, ndir, S, C, R, D, stages, &g, &threads, &smem))
        return cudaErrorInvalidValue;
    return by_pair(pair, R, [&](auto rt) { return decltype(rt)::attrs(threads, smem, out); });
}

}  // extern "C"
