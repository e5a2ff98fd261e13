// Variants of the stencil kernel K1's tiled route (csrc/stencil_tiled.cu)
// for tools/k1_ablation.py, which builds this file with -DSBT_K1_VARIANT
// (and any of the package's SBT_K1_* macros) into its own library; the
// package does not build or call it.  Each variant computes K1's function
// with the same sums in the same order, so it gives K1's bits (but 5-7):
//
//   1  the X-walk kernel: a block owns a tile of 32 sites at one y for its
//      columns and walks X with a ring of four slots of the tile's T lines
//      of x in shared memory (cp.async), the plane's links staged once for
//      all its columns; +-Y and +-Z from device memory (L2);
//   2  the links of the block's sites staged in shared memory (cp.async,
//      16 bytes), one barrier, x as K1 reads it;
//   3  the sparse form loading direction d + 1's terms before d's sums;
//   4  2 and 3 together;
//   5-7  diagnostics that compute another function, to time what the
//      neighbours' x (5: every direction reads x at the site itself),
//      the links (6: direction 0's links for every direction) or both (7)
//      cost; tools/k1_ablation.py neither checks nor reports them as K1.
//
// Their direction loops unroll by SBT_K1_UNROLL_W at both shapes.
//
// Plain C interface: sbt_stencil_tiled and sbt_stencil_tiled_attrs with
// the package's arguments, running the variant.

#define sbt_stencil_tiled sbt_stencil_tiled_package
#define sbt_stencil_tiled_attrs sbt_stencil_tiled_attrs_package
#include "../superbblas_tpu_torch/csrc/stencil_tiled.cu"
#undef sbt_stencil_tiled
#undef sbt_stencil_tiled_attrs

#ifndef SBT_K1_VARIANT
#define SBT_K1_VARIANT 1
#endif

namespace {

// cp.async of 16 bytes into shared memory; !valid fills zeros (src-size
// 0, src not read)
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ constexpr size_t align16(size_t v) { return (v + 15) / 16 * 16; }

template <int KI, int KD, int BI, int BD, bool kSparse, bool kLinks, bool kPipe, typename ST,
          typename FT, int kDiag = 0>
__global__ void __launch_bounds__(256, kMinBlocks<KI, acc_t<ST, FT>>) stencil_tiled_kernel_v(
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
    // kLinks: the links of the block's sites, every direction, into shared memory
    // ([re, im][ndir][NB][sites]) by all its threads, then one barrier
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const ST* lsm = reinterpret_cast<const ST*>(smem_raw);
    if constexpr (kLinks) {
        ST* dst = reinterpret_cast<ST*>(smem_raw);
        constexpr int PL = 16 / sizeof(ST);
        const int sites = blockDim.x, planes = 2 * hops.ndir * NB;
        const int tid = threadIdx.y * blockDim.x + threadIdx.x;
        const int nthr = blockDim.x * blockDim.y;
        const int t0 = tt * g.bt, z0 = tz * g.bz, pbase = cx * g.sX + cy * g.sY;
        if (g.bt % PL == 0 && g.T % PL == 0) {
            const int kl = g.bt / PL;
            for (int i = tid; i < planes * g.bz * kl; i += nthr) {
                const int k = i % kl, q = i / kl, r = q % g.bz, pl = q / g.bz;
                const int t = t0 + k * PL, z = z0 + r;
                const bool ok = t < g.T && z < g.Z;
                const ST* src = pl < hops.ndir * NB ? b_re : b_im;
                src += ok ? (int64_t)(pl % (hops.ndir * NB)) * V + (pbase + z * g.T + t) : 0;
                copy16(dst + pl * sites + r * g.bt + k * PL, src, ok);
            }
        } else {
            for (int i = tid; i < planes * sites; i += nthr) {
                const int site = i % sites, pl = i / sites;
                const int t = t0 + site % g.bt, z = z0 + site / g.bt;
                const ST* src = pl < hops.ndir * NB ? b_re : b_im;
                dst[pl * sites + site] = t < g.T && z < g.Z
                    ? src[(int64_t)(pl % (hops.ndir * NB)) * V + (pbase + z * g.T + t)]
                    : ST(0.0f);
            }
        }
        copy_commit();
        copy_wait_all();
        __syncthreads();
    }
    if (ct >= g.T || cz >= g.Z || col0 >= g.n) return;
    const int ncols = g.n - col0 < CT ? g.n - col0 : CT;

    if constexpr (!kLinks &&
                  (SBT_K1_PREFETCH == 2 || (SBT_K1_PREFETCH == 1 && KI != 1))) {
        // every direction's links of the site into L2 first, shared out
        // among the block's column groups: the loads of each direction then
        // wait on L2 rather than on device memory
        for (int d = threadIdx.y; d < hops.ndir; d += blockDim.y)
            for (int ij = 0; ij < NB; ++ij) {
                prefetch_l2(b_re + (int64_t)d * NB * V + (s + ij * V));
                prefetch_l2(b_im + (int64_t)d * NB * V + (s + ij * V));
            }
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
        if constexpr ((kDiag & 1) != 0) return nb;   // diagnostic: x of the site itself
        const int ax = hops.axis[d];
        if (ax >= 0 && !(ax == 0 && hops.packed >= 0 && odd != (hops.step[d] > 0))) {
            const int c = ax == 0 ? cx : ax == 1 ? cy : ax == 2 ? cz : ct;
            nb += c == hops.edge[d] ? hops.wrap[d] : hops.step[d];
        }
        return nb;
    };
    // the colour block B_d(s), from the direction's base in 64 bits (or
    // from shared memory)
    auto links = [&](int d, A (&br)[NB], A (&bi)[NB]) {
        if constexpr ((kDiag & 2) != 0) d = 0;   // diagnostic: direction 0's links throughout
        if constexpr (kLinks) {
        const ST* lr = lsm + d * NB * blockDim.x + threadIdx.x;
        const ST* li = lr + hops.ndir * NB * blockDim.x;
#pragma unroll
        for (int ij = 0; ij < NB; ++ij) {
            br[ij] = to_f(lr[ij * blockDim.x]);
            bi[ij] = to_f(li[ij * blockDim.x]);
        }
        } else {
        const ST* bdr = b_re + (int64_t)d * NB * V + s;
        const ST* bdi = b_im + (int64_t)d * NB * V + s;
#pragma unroll
        for (int ij = 0; ij < NB; ++ij) {
            br[ij] = load_link(bdr + ij * V);
            bi[ij] = load_link(bdi + ij * V);
        }
        }
    };
    if constexpr (kPipe && kSparse && CT == 1) {
        // direction d + 1's terms are loaded before direction d's sums
        const FT* xcr = x_re + (int64_t)col0 * F * V;
        const FT* xci = x_im + (int64_t)col0 * F * V;
        A ar[kS][BD], ai[kS][BD], cr[kS][BD], ci[kS][BD], br[NB], bi[NB];
        sparse_terms<BD, false>(plan, xcr + nb_of(0), xci + nb_of(0), V, ar, ai);
#pragma unroll 1
        for (int d = 0; d < hops.ndir; d += 2) {
            const bool two = d + 1 < hops.ndir;
            if (two) sparse_terms<BD, false>(plan + d + 1, xcr + nb_of(d + 1),
                                             xci + nb_of(d + 1), V, cr, ci);
            links(d, br, bi);
            sparse_apply<BI, BD>(plan + d, ar, ai, br, bi, acc_re[0], acc_im[0]);
            if (two) {
                if (d + 2 < hops.ndir)
                    sparse_terms<BD, false>(plan + d + 2, xcr + nb_of(d + 2),
                                            xci + nb_of(d + 2), V, ar, ai);
                links(d + 1, br, bi);
                sparse_apply<BI, BD>(plan + d + 1, cr, ci, br, bi, acc_re[0], acc_im[0]);
            }
        }
    } else {
        SBT_UNROLL(SBT_K1_UNROLL_W)
        for (int d = 0; d < hops.ndir; ++d) {
            const int nb = nb_of(d);
            A br[NB], bi[NB];
            links(d, br, bi);
#pragma unroll
            for (int c = 0; c < CT; ++c) {
                if (c >= ncols) break;
                const FT* xr = x_re + (int64_t)(col0 + c) * F * V + nb;   // the column's base
                const FT* xi = x_im + (int64_t)(col0 + c) * F * V + nb;
                direction<KI, BI, BD, kSparse, false>(plan, d, xr, xi, V, br, bi, acc_re[c],
                                                      acc_im[c]);
            }
        }
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

// The variant that stages x and the links in shared memory (SBT_K1_VARIANT 1):
// a block owns a tile of 32 sites (bt T sites x bz Z rows) at one y for
// ``cols`` columns and walks W planes of X.  A ring of four slots holds
// the tile's T lines of x at x - 1, x, x + 1 (and x + 2 in flight), each
// with P sites of T halo a side (P values = 16 bytes), so the centre and
// the +-X and +-T neighbours come from shared memory; +-Y and +-Z come from
// device memory (L2).  The links of the plane are staged once for all the
// block's columns, in two buffers.  Copies are cp.async of 16 bytes where
// T and bt are multiples of P (zero-filled past the lattice), else element
// copies; one barrier a plane.
struct StageTile {
    int n, X, Y, Z, T;
    int bt, bz;     // the tile: bt T sites x bz Z rows, bt * bz = 32
    int ncb, nz;    // column blocks (blockIdx.x = cb + ncb * T tile); Z tiles
                    // (blockIdx.y = Z tile + nz * y)
    int W;          // X planes a block walks (from W * blockIdx.z)
    int lt;         // a staged T line: bt + 2 P values
    int cols;       // columns a block holds
    int xal, bal;   // 16-byte copies of x lines, of links (else element copies)
    int sY, sX;     // site strides of Y and X
};


template <int KI, int KD, int BI, int BD, bool kSparse, typename ST, typename FT>
__global__ void __launch_bounds__(256, 1) stencil_staged_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im,
    const PlanDir<acc_t<ST, FT>>* __restrict__ plan, const FT* __restrict__ x_re,
    const FT* __restrict__ x_im, FT* __restrict__ y_re, FT* __restrict__ y_im,
    const __grid_constant__ StageTile g, const __grid_constant__ Hops hops) {
    using A = acc_t<ST, FT>;
    static_assert(KI == KD && (KI == 1 || KI == kS), "the tiled kernel's spin shapes");
    constexpr int F = KD * BD, KO = KI * BI, NB = BI * BD, CT = kCols<KI>;
    constexpr int P = 16 / sizeof(FT), PL = 16 / sizeof(ST);
    constexpr int S = 32;   // sites a tile
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int line = g.bz * g.lt;                  // one feature of a staged plane
    const int slot_len = g.cols * 2 * F * line;    // a ring slot: [cols][re, im][F][bz][lt]
    const int lbuf = 2 * hops.ndir * NB * S;       // a links buffer: [re, im][ndir][NB][S]
    FT* ring = reinterpret_cast<FT*>(smem_raw);
    ST* lnk = reinterpret_cast<ST*>(smem_raw + align16(sizeof(FT) * 4 * slot_len));

    const int cb = blockIdx.x % g.ncb, tt = blockIdx.x / g.ncb;
    const int tz = blockIdx.y % g.nz, cy = blockIdx.y / g.nz;
    const int x0 = blockIdx.z * g.W;
    const int x1 = x0 + g.W < g.X ? x0 + g.W : g.X;
    const int t0 = tt * g.bt, z0 = tz * g.bz;
    const int ts = threadIdx.x, tl = ts % g.bt, rz = ts / g.bt;
    const int ct = t0 + tl, cz = z0 + rz;
    const int cl0 = threadIdx.y * CT;              // the thread's first column in the block
    const int col0 = cb * g.cols + cl0;
    const bool live = ct < g.T && cz < g.Z && col0 < g.n;
    const int ncols = g.n - col0 < CT ? g.n - col0 : CT;
    const int V = g.X * g.sX;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthr = blockDim.x * blockDim.y;
    const int ypart = cy * g.sY;

    // the tile's T lines of x at plane p into ring slot sl
    auto stage_x = [&](int sl, int p) {
        FT* dst = ring + sl * slot_len;
        const int pbase = p * g.sX + ypart;
        if (g.xal) {
            const int kl = g.lt / P;
            const int total = g.cols * 2 * F * g.bz * kl;
            for (int i = tid; i < total; i += nthr) {
                const int k = i % kl, q = i / kl;   // q = (c * 2F + part * F + f) * bz + r
                const int r = q % g.bz, cpf = q / g.bz;
                const int c = cpf / (2 * F), pf = cpf % (2 * F);
                const int col = cb * g.cols + c, z = z0 + r;
                int t = t0 - P + k * P;
                t = t < 0 ? t + g.T : t >= g.T ? t - g.T : t;
                const bool ok = col < g.n && z < g.Z;
                const FT* src = pf < F ? x_re : x_im;
                src += ok ? (int64_t)(col * F + pf % F) * V + (pbase + z * g.T + t) : 0;
                copy16(dst + q * g.lt + k * P, src, ok);
            }
        } else {
            const int total = g.cols * 2 * F * g.bz * g.lt;
            for (int i = tid; i < total; i += nthr) {
                const int w = i % g.lt, q = i / g.lt;
                const int r = q % g.bz, cpf = q / g.bz;
                const int c = cpf / (2 * F), pf = cpf % (2 * F);
                const int col = cb * g.cols + c, z = z0 + r;
                int t = t0 - P + w;
                while (t < 0) t += g.T;
                while (t >= g.T) t -= g.T;
                const FT* src = pf < F ? x_re : x_im;
                dst[q * g.lt + w] = col < g.n && z < g.Z
                    ? src[(int64_t)(col * F + pf % F) * V + (pbase + z * g.T + t)] : FT(0.0f);
            }
        }
    };
    // the tile's links at plane p into buffer lb
    auto stage_links = [&](int lb, int p) {
        ST* dst = lnk + lb * lbuf;
        const int pbase = p * g.sX + ypart;
        const int planes = 2 * hops.ndir * NB;
        if (g.bal) {
            const int kl = g.bt / PL;
            const int total = planes * g.bz * kl;
            for (int i = tid; i < total; i += nthr) {
                const int k = i % kl, q = i / kl;   // q = plane * bz + r
                const int r = q % g.bz, pl = q / g.bz;
                const int t = t0 + k * PL, z = z0 + r;
                const bool ok = t < g.T && z < g.Z;
                const int dij = pl % (hops.ndir * NB);
                const ST* src = pl < hops.ndir * NB ? b_re : b_im;
                src += ok ? (int64_t)dij * V + (pbase + z * g.T + t) : 0;
                copy16(dst + pl * S + r * g.bt + k * PL, src, ok);
            }
        } else {
            const int total = planes * S;
            for (int i = tid; i < total; i += nthr) {
                const int site = i % S, pl = i / S;
                const int t = t0 + site % g.bt, z = z0 + site / g.bt;
                const int dij = pl % (hops.ndir * NB);
                const ST* src = pl < hops.ndir * NB ? b_re : b_im;
                dst[pl * S + site] = t < g.T && z < g.Z
                    ? src[(int64_t)dij * V + (pbase + z * g.T + t)] : ST(0.0f);
            }
        }
    };
    // planes x0 - 1 .. x1 take slots (p - x0 + 1) mod 4
    auto slot_of = [&](int p) { return (p - x0 + 1) & 3; };
    auto wrap_x = [&](int p) { return p < 0 ? p + g.X : p >= g.X ? p - g.X : p; };

    stage_x(slot_of(x0 - 1), wrap_x(x0 - 1));
    stage_x(slot_of(x0), x0);
    stage_x(slot_of(x0 + 1), wrap_x(x0 + 1));
    stage_links(0, x0);
    copy_commit();

    const bool odd = ((hops.packed + cy + cz + ct) & 1) != 0;
    for (int cx = x0; cx < x1; ++cx) {
        // plane cx + 1 and the links of cx have landed, and every thread is
        // past plane cx - 1: its slot and links buffer take the next copies
        copy_wait_all();
        __syncthreads();
        if (cx + 1 < x1) {
            stage_x(slot_of(cx + 2), wrap_x(cx + 2));
            stage_links((cx + 1 - x0) & 1, cx + 1);
        }
        copy_commit();
        if (!live) continue;

        const int s = cx * g.sX + ypart + cz * g.T + ct;
        const ST* lr = lnk + ((cx - x0) & 1) * lbuf + ts;
        A acc_re[CT][KO], acc_im[CT][KO];
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
            for (int o = 0; o < KO; ++o) acc_re[c][o] = acc_im[c][o] = A(0);
        SBT_UNROLL(SBT_K1_UNROLL_W)
        for (int d = 0; d < hops.ndir; ++d) {
            const int ax = hops.axis[d];
            A br[NB], bi[NB];
#pragma unroll
            for (int ij = 0; ij < NB; ++ij) {
                br[ij] = to_f(lr[(d * NB + ij) * S]);
                bi[ij] = to_f(lr[((hops.ndir + d) * NB + ij) * S]);
            }
            if (ax == 1 || ax == 2) {
                const int c = ax == 1 ? cy : cz;
                const int nb = s + (c == hops.edge[d] ? hops.wrap[d] : hops.step[d]);
#pragma unroll
                for (int c2 = 0; c2 < CT; ++c2) {
                    if (c2 >= ncols) break;
                    const FT* xr = x_re + (int64_t)(col0 + c2) * F * V + nb;
                    const FT* xi = x_im + (int64_t)(col0 + c2) * F * V + nb;
                    direction<KI, BI, BD, kSparse, false>(plan, d, xr, xi, V, br, bi,
                                                          acc_re[c2], acc_im[c2]);
                }
            } else {
                int sl = slot_of(cx), w = P + tl;
                if (ax == 3) {
                    w += hops.step[d] > 0 ? 1 : -1;
                } else if (ax == 0 && (hops.packed < 0 || odd == (hops.step[d] > 0))) {
                    sl = slot_of(hops.step[d] > 0 ? cx + 1 : cx - 1);
                }
                const FT* xs = ring + sl * slot_len + rz * g.lt + w;
#pragma unroll
                for (int c2 = 0; c2 < CT; ++c2) {
                    if (c2 >= ncols) break;
                    const FT* xr = xs + (cl0 + c2) * 2 * F * line;
                    direction<KI, BI, BD, kSparse, true>(plan, d, xr, xr + F * line, line, br,
                                                         bi, acc_re[c2], acc_im[c2]);
                }
            }
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
}

// the staged variant's launch: column groups cut until the ring and the
// links buffers fit the shared memory a block may have, the X walk cut
// into chunks for two blocks an SM; false where no tile fits or the grid
// cannot hold the lattice
template <int KI, int KD, int BI, int BD, typename ST, typename FT>
bool staging(int n, int X, int Y, int Z, int T, int ndir, dim3* grid, dim3* block,
             StageTile* g, size_t* smem) {
    if (n < 1 || X < 1 || Y < 1 || Z < 1 || T < 1) return false;
    if ((int64_t)X * Y * Z * T * kPlanes<KI, KD, BI, BD> > INT32_MAX) return false;
    constexpr int F = KD * BD, NB = BI * BD, CT = kCols<KI>;
    constexpr int P = 16 / sizeof(FT), PL = 16 / sizeof(ST);
    const int groups = (n + CT - 1) / CT;
    const int bt = tile_t(T), bz = 32 / bt, lt = bt + 2 * P;
    int cg = groups < SBT_K1_COL_GROUPS ? groups : SBT_K1_COL_GROUPS;
    auto bytes = [&](int c) {
        return align16(sizeof(FT) * 4 * (size_t)c * CT * 2 * F * bz * lt)
            + sizeof(ST) * 2 * 2 * (size_t)ndir * NB * 32;
    };
    while (cg > 1 && bytes(cg) > 232448) --cg;
    if (bytes(cg) > 232448) return false;
    const int ncb = (groups + cg - 1) / cg, nt = (T + bt - 1) / bt, nz = (Z + bz - 1) / bz;
    const int64_t base = (int64_t)ncb * nt * nz * Y;
    int chunks = (int)((264 + base - 1) / base);
    if (chunks > X) chunks = X;
    const int W = (X + chunks - 1) / chunks;
    chunks = (X + W - 1) / W;
    if ((int64_t)nz * Y > 65535 || (int64_t)ncb * nt > INT32_MAX) return false;
    *grid = dim3((unsigned)(ncb * nt), (unsigned)(nz * Y), (unsigned)chunks);
    *block = dim3(32u, (unsigned)cg);
    *g = StageTile{n, X, Y, Z, T, bt, bz, ncb, nz, W, lt, cg * CT,
                   T % P == 0 && bt % P == 0, T % PL == 0 && bt % PL == 0, Z * T, Y * Z * T};
    *smem = bytes(cg);
    return true;
}

template <int KI, int KD, int BI, int BD, typename ST, typename FT, bool kSparse>
auto variant_kernel() {
    if constexpr (SBT_K1_VARIANT == 1)
        return stencil_staged_kernel<KI, KD, BI, BD, kSparse, ST, FT>;
    else if constexpr (SBT_K1_VARIANT >= 5)
        return stencil_tiled_kernel_v<KI, KD, BI, BD, kSparse, false, false, ST, FT,
                                      SBT_K1_VARIANT - 4>;
    else
        return stencil_tiled_kernel_v<KI, KD, BI, BD, kSparse, SBT_K1_VARIANT != 3,
                                      SBT_K1_VARIANT != 2, ST, FT>;
}

// the variant's kernel, grid, block, shared bytes and arguments of a
// launch; false where no tiling takes the lattice
template <int KI, int KD, int BI, int BD, typename ST, typename FT>
struct Variant {
    template <typename Run>
    static cudaError_t with(const TiledArgs& a, const Dirs& dirs, Run&& run) {
        dim3 grid, block;
        size_t smem;
        Hops h;
        const bool sparse = KI != 1 && a.sparse;
        if constexpr (SBT_K1_VARIANT == 1) {
            StageTile g;
            if (!staging<KI, KD, BI, BD, ST, FT>(a.n, a.X, a.Y, a.Z, a.T, dirs.ndir, &grid,
                                                 &block, &g, &smem))
                return cudaErrorInvalidValue;
            h = hops_of(dirs, Tile{a.n, a.X, a.Y, a.Z, a.T, 1, g.bt, g.bz, g.ncb, g.nz, g.sY,
                                   g.sX});
            return sparse ? run(variant_kernel<KI, KD, BI, BD, ST, FT, true>(), grid, block,
                                smem, g, h)
                          : run(variant_kernel<KI, KD, BI, BD, ST, FT, false>(), grid, block,
                                smem, g, h);
        } else {
            Tile g;
            // at most 128 sites a block where the links are staged: nine
            // directions' links of 128 sites fit in f64 (K1's tiling else)
            constexpr bool staged = SBT_K1_VARIANT == 2 || SBT_K1_VARIANT == 4;
            if (!tiling<KI, KD, BI, BD>(a.n, a.X, a.Y, a.Z, a.T, a.yc, &grid, &block, &g,
                                        staged ? 128 : 256))
                return cudaErrorInvalidValue;
            smem = staged ? sizeof(ST) * 2 * dirs.ndir * BI * BD * block.x : 0;
            if (smem > 232448) return cudaErrorInvalidValue;
            h = hops_of(dirs, g);
            return sparse ? run(variant_kernel<KI, KD, BI, BD, ST, FT, true>(), grid, block,
                                smem, g, h)
                          : run(variant_kernel<KI, KD, BI, BD, ST, FT, false>(), grid, block,
                                smem, g, h);
        }
    }
};

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
struct LaunchVariant {
    static cudaError_t run(const TiledArgs& a, const Dirs& dirs, cudaStream_t stream) {
        using A = acc_t<ST, FT>;
        return Variant<KI, KD, BI, BD, ST, FT>::with(
            a, dirs, [&](auto kernel, dim3 grid, dim3 block, size_t smem, auto g, Hops h) {
                if (smem > 48 * 1024) {
                    const cudaError_t err = cudaFuncSetAttribute(
                        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
                    if (err != cudaSuccess) return err;
                }
                kernel<<<grid, block, smem, stream>>>(
                    static_cast<const ST*>(a.b_re), static_cast<const ST*>(a.b_im),
                    static_cast<const PlanDir<A>*>(a.plan), static_cast<const FT*>(a.x_re),
                    static_cast<const FT*>(a.x_im), static_cast<FT*>(a.y_re),
                    static_cast<FT*>(a.y_im), g, h);
                return cudaGetLastError();
            });
    }
};

template <int KI, int KD, int BI, int BD, typename ST, typename FT>
struct AttrsVariant {
    static cudaError_t run(const TiledArgs& a, int* out) {
        Dirs dirs{};
        dirs.ndir = 9;
        dirs.packed = -1;
        for (int d = 0; d < 9; ++d) dirs.axis[d] = -1;
        return Variant<KI, KD, BI, BD, ST, FT>::with(
            a, dirs, [&](auto kernel, dim3, dim3 block, size_t smem, auto, Hops) {
                cudaError_t err;
                if (smem > 48 * 1024) {
                    err = cudaFuncSetAttribute(
                        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
                    if (err != cudaSuccess) return err;
                }
                cudaFuncAttributes attr;
                err = cudaFuncGetAttributes(&attr, kernel);
                if (err != cudaSuccess) return err;
                const int threads = (int)(block.x * block.y);
                int blocks = 0;
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                                    smem);
                out[0] = attr.numRegs;
                out[1] = (int)attr.localSizeBytes;
                out[2] = threads;
                out[3] = blocks;
                return err;
            });
    }
};

}  // namespace

extern "C" {

// sbt_stencil_tiled's arguments and result, running the variant
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
    return dispatch<LaunchVariant, true>(ki, kd, bi, bd, pair, a, dirs,
                                         static_cast<cudaStream_t>(stream));
}

// sbt_stencil_tiled_attrs's arguments and result, for the variant
int sbt_stencil_tiled_attrs(int ki, int kd, int bi, int bd, int pair, int sparse, int n,
                            int X, int Y, int Z, int T, int yc, int* out) {
    const TiledArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      n, X, Y, Z, T, yc, sparse != 0};
    return dispatch<AttrsVariant, true>(ki, kd, bi, bd, pair, a, out);
}

}  // extern "C"
