// K1 at the clover term's shape (1, 1, 12, 12) for Hopper (sm_90a): the
// block-streaming kernel.
//
// Replaces the Pallas TPU kernel superbblas_tpu/ops/stencil_pallas.py
// stencil_matvec_soa (_kernel, _matvec_body) at this shape.  It computes,
// over a periodic 4-D lattice in split complex,
//   y[n, i, s] = sum_d sum_j B_d[i, j](s) K_d x[n, j, s + o_d]
// with 12 x 12 blocks [ndir, 144, X, Y, Z, T] of the storage type ST,
// fields x, y [n, 12, X, Y, Z, T] of the field type FT, a scalar kron
// factor K_d a direction (nullptr: 1), sums in f32, for the four f32-summed
// pairs of stencil_soa.cuh kPair (f32/f32, bf16/f32, bf16/bf16, f32/bf16:
// bf16 converted on load, rounded on store), any ndir <= kMaxDirs with its
// one-hot offsets, packed parity, any n >= 1 and any volume.  f64/f64 stays
// on the templated kernel of stencil_soa.cu, which is there to be right,
// not fast.
//
// What bounds it on the H100: bytes.  A site's blocks are 144 complex
// entries a direction (1152 B at f32), read by every column; x and y are
// 96 B a column each.  The clover solve's term, 24^3x48 x 8 columns at
// f32, moves 1.78 GB (0.532 ms at 3.35 TB/s) against 8 x 576 FMAs a site
// (0.10 ms).  The templated kernel it replaces ran one thread a (site,
// column) and loaded the block entries once a column, leaving their reuse
// to L1, and had few loads in flight.  This design:
//  * a block owns a tile of kSites = 32 consecutive sites (flat index, T
//    fastest) and up to kMaxGroups x kCols columns; it streams each
//    direction's 288 block planes of the tile (re and im) into shared
//    memory once, and every column of every warp reads them from there:
//    each block entry crosses device memory once for all the columns;
//  * the copies are 16-byte cp.async (kWide) where V x elem is a multiple
//    of 16 bytes and the block pointers are 16-byte aligned, else element
//    copies through registers (the same kernel, template argument kWide
//    false, for ragged volumes; ops/stencil.py k1_route picks the form);
//  * the grid is persistent, one block an SM slot; each block walks its
//    items (tile, column pass, direction) with a ring of kStages = 2
//    stages (36 KB each at f32: three blocks of 128 threads an SM), so
//    the next item's copies are in flight while this one is summed; a
//    third stage, or fewer warps with more stages, measured no faster
//    (PERF.md section 6); above 8 columns a block makes column
//    passes over a tile, the later ones reading its blocks from L2;
//  * the items are decoded in 32 bits with divisors fixed at launch
//    (FastDiv: volumes below 2^31 sites);
//  * a thread takes one site and kCols = 2 columns: each block entry read
//    from shared memory serves two columns; it holds their 12 complex x
//    values and 12 complex sums in registers; x is read at the neighbour
//    site from device memory, 32 consecutive sites a warp, before the
//    barrier of the item, so the loads are in flight while it waits;
//  * the sums keep site_matvec's order (d, then j ascending, the four
//    FMAs of a complex product in its order): the kernel gives the bits
//    of the runtime-shape route (stencil_soa.cu) at this shape.
//
// Plain C interface (loaded with ctypes); a call returns the cudaError_t
// of its launch.

#include "kernel_common.cuh"
#include "stencil_soa.cuh"

namespace {

constexpr int kSites = 32;      // sites of a tile: one warp, T-fastest flat index
constexpr int kEntries = 144;   // entries of a 12 x 12 block
constexpr int kFeat = 12;       // features of a site and column
constexpr int kCols = 2;        // columns a thread
// the design, as its bring-up sweep chose it (PERF.md section 6): column
// groups (warps) a block at most, stages of the ring, and three blocks an
// SM in the launch bounds
constexpr int kMaxGroups = 4;   // column groups a block (threadIdx.y)
constexpr int kStages = 2;      // the ring of stages

constexpr int kStageElems = 2 * kEntries * kSites;   // a stage: [re|im][entry][site]

template <typename ST>
constexpr size_t ring_bytes() { return kStages * kStageElems * sizeof(ST); }

// direction d's block planes of the sites [s0, s0 + kSites) into one stage,
// by all threads of the block; sites at or past V are left unwritten
template <typename ST, bool kWide>
__device__ __forceinline__ void copy_stage(ST* stage, const ST* __restrict__ b_re,
                                           const ST* __restrict__ b_im, int d, int64_t s0,
                                           int64_t V, int tid, int nthreads) {
    const int64_t base = (int64_t)d * kEntries * V + s0;
    if constexpr (kWide) {
        constexpr int kPer = 16 / sizeof(ST);        // elements a copy
        constexpr int kChunks = kSites / kPer;       // copies a plane row
        for (int q = tid; q < 2 * kEntries * kChunks; q += nthreads) {
            const int row = q / kChunks;             // part * kEntries + entry
            const int c = q - row * kChunks;
            const int part = row >= kEntries;
            const int e = row - part * kEntries;
            if (s0 + c * kPer < V)   // V is a multiple of kPer: whole copies
                copy16(stage + row * kSites + c * kPer,
                       (part ? b_im : b_re) + base + (int64_t)e * V + c * kPer);
        }
    } else {
        for (int q = tid; q < 2 * kEntries * kSites; q += nthreads) {
            const int row = q / kSites;
            const int c = q - row * kSites;
            const int part = row >= kEntries;
            const int e = row - part * kEntries;
            if (s0 + c < V) stage[q] = (part ? b_im : b_re)[base + (int64_t)e * V + c];
        }
    }
}

// the launch's fixed divisors: every index the kernel decodes is below 2^31
// (sbt_stencil_site checks items = units x ndir)
struct SiteGrid {
    int V, npass, units;
    FastDiv T, Z, Y, ndir, npass_div;
};

template <typename ST, typename FT, bool kWide>
__global__ void __launch_bounds__(kSites * kMaxGroups, 3) stencil_site_kernel(
    const ST* __restrict__ b_re, const ST* __restrict__ b_im, const float* __restrict__ k_re,
    const float* __restrict__ k_im, const FT* __restrict__ x_re, const FT* __restrict__ x_im,
    FT* __restrict__ y_re, FT* __restrict__ y_im, int n, int X, int Y, int Z, int T,
    const __grid_constant__ SiteGrid g, const __grid_constant__ Dirs dirs) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    ST* ring = reinterpret_cast<ST*>(smem_raw);
    __shared__ float skron[2 * kMaxDirs];

    const int ndir = dirs.ndir;
    const int lane = threadIdx.x;   // the site in the tile
    const int tid = threadIdx.y * kSites + lane;
    const int nthreads = kSites * blockDim.y;
    if (tid < ndir) {
        skron[tid] = k_re ? k_re[tid] : 1.f;
        skron[kMaxDirs + tid] = k_im ? k_im[tid] : 0.f;
    }   // read after the first item's barrier

    const int64_t V = g.V;
    // the block's units (tile, column pass) are blockIdx.x + j gridDim.x;
    // item k is unit j = k / ndir, direction k % ndir
    const int mine = g.units > (int)blockIdx.x
                         ? (g.units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const int items = mine * ndir;

    auto issue = [&](int k) {
        if (k < items) {
            const int j = (int)g.ndir.div(k);
            const int u = blockIdx.x + j * gridDim.x;
            copy_stage<ST, kWide>(ring + (k % kStages) * kStageElems, b_re, b_im,
                                  k - j * ndir, (int64_t)g.npass_div.div(u) * kSites, V, tid,
                                  nthreads);
        }
        if constexpr (kWide) copy_commit();
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) issue(k);

    float acc_re[kCols][kFeat], acc_im[kCols][kFeat];
    int s = 0, cx = 0, cy = 0, cz = 0, ct = 0, col0 = 0, d = ndir - 1;
    bool live = false;
#pragma unroll 1
    for (int k = 0; k < items; ++k) {
        if (++d == ndir) {
            d = 0;
            const int u = blockIdx.x + (int)g.ndir.div(k) * gridDim.x;
            const int tile = (int)g.npass_div.div(u);
            s = tile * kSites + lane;
            col0 = ((u - tile * g.npass) * (int)blockDim.y + (int)threadIdx.y) * kCols;
            live = s < g.V && col0 < n;
            const int zt = (int)g.T.div(s), yzt = (int)g.Z.div(zt);
            ct = s - zt * T;
            cz = zt - yzt * Z;
            cx = (int)g.Y.div(yzt);
            cy = yzt - cx * Y;
#pragma unroll
            for (int c = 0; c < kCols; ++c)
#pragma unroll
                for (int i = 0; i < kFeat; ++i) acc_re[c][i] = acc_im[c][i] = 0.f;
        }
        // x at the neighbour, in flight across the barrier
        float z_re[kCols][kFeat], z_im[kCols][kFeat];
        if (live) {
            const int64_t nb = neighbour(dirs, d, s, cx, cy, cz, ct, X, Y, Z, T);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                const int col = col0 + c < n ? col0 + c : col0;   // a spare column reads a live one
                const FT* xr = x_re + (int64_t)col * kFeat * V + nb;
                const FT* xi = x_im + (int64_t)col * kFeat * V + nb;
#pragma unroll
                for (int j = 0; j < kFeat; ++j) {
                    z_re[c][j] = load_f(xr + j * V);
                    z_im[c][j] = load_f(xi + j * V);
                }
            }
        }
        if constexpr (kWide) copy_wait<kStages - 2>();
        __syncthreads();
        issue(k + kStages - 1);   // into the stage item k - 1 used: every thread is past it
        if (live) {
            // spin factor first: z = K_d x, as site_matvec (KD = 1)
            const float cr = skron[d], cim = skron[kMaxDirs + d];
#pragma unroll
            for (int c = 0; c < kCols; ++c)
#pragma unroll
                for (int j = 0; j < kFeat; ++j) {
                    const float vr = z_re[c][j], vi = z_im[c][j];
                    float zr = 0.f, zi = 0.f;
                    zr = fmaf(cr, vr, zr);
                    zr = fmaf(-cim, vi, zr);
                    zi = fmaf(cr, vi, zi);
                    zi = fmaf(cim, vr, zi);
                    z_re[c][j] = zr;
                    z_im[c][j] = zi;
                }
            // then the block: acc[i] += B_d[i, j] z[j], j ascending
            const ST* st = ring + (k % kStages) * kStageElems + lane;
#pragma unroll
            for (int i = 0; i < kFeat; ++i) {
#pragma unroll
                for (int j = 0; j < kFeat; ++j) {
                    const float br = to_f(st[(i * kFeat + j) * kSites]);
                    const float bim = to_f(st[(kEntries + i * kFeat + j) * kSites]);
#pragma unroll
                    for (int c = 0; c < kCols; ++c) {
                        float& ar = acc_re[c][i];
                        float& ai = acc_im[c][i];
                        ar = fmaf(br, z_re[c][j], ar);
                        ar = fmaf(-bim, z_im[c][j], ar);
                        ai = fmaf(br, z_im[c][j], ai);
                        ai = fmaf(bim, z_re[c][j], ai);
                    }
                }
            }
            if (d == ndir - 1) {
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                    if (col0 + c >= n) continue;
                    FT* yr = y_re + (int64_t)(col0 + c) * kFeat * V + s;
                    FT* yi = y_im + (int64_t)(col0 + c) * kFeat * V + s;
#pragma unroll
                    for (int i = 0; i < kFeat; ++i) {
                        store_f(yr + i * V, acc_re[c][i]);
                        store_f(yi + i * V, acc_im[c][i]);
                    }
                }
            }
        }
    }
    if constexpr (kWide) copy_wait<0>();
}

// threads a block (kSites x groups) and column passes of n columns
inline void groups_of(int n, int* groups, int* npass) {
    const int want = (n + kCols - 1) / kCols;
    *groups = want < kMaxGroups ? want : kMaxGroups;
    *npass = (n + *groups * kCols - 1) / (*groups * kCols);
}

constexpr int kMaxDevices = 64;

template <typename ST, typename FT, bool kWide>
struct Site {
    // per device: SMs and resident blocks an SM at each group count, set at
    // the first launch (with the ring's shared-memory attribute), so a launch
    // makes no query of its own
    struct Slots {
        int sms = 0;
        int per_sm[kMaxGroups + 1] = {};
    };

    static cudaError_t slots(int groups, int* sms, int* per_sm) {
        static Slots cache[kMaxDevices];
        int dev;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        Slots local;
        Slots& c = dev < kMaxDevices ? cache[dev] : local;
        if (c.sms == 0) {
            if ((err = cudaFuncSetAttribute(stencil_site_kernel<ST, FT, kWide>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)ring_bytes<ST>())) != cudaSuccess ||
                (err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev)) !=
                    cudaSuccess)
                return err;
        }
        if (c.per_sm[groups] == 0 &&
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &c.per_sm[groups], stencil_site_kernel<ST, FT, kWide>, kSites * groups,
                 ring_bytes<ST>())) != cudaSuccess)
            return err;
        *sms = c.sms;
        *per_sm = c.per_sm[groups];
        return *per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
    }

    static cudaError_t run(const Operands& a, const Dirs& dirs, cudaStream_t stream) {
        int groups, npass, sms, per_sm;
        groups_of(a.n, &groups, &npass);
        cudaError_t err = slots(groups, &sms, &per_sm);
        if (err != cudaSuccess) return err;
        const int64_t V = (int64_t)a.X * a.Y * a.Z * a.T;
        const int64_t units = (V + kSites - 1) / kSites * npass;
        if (V >= INT32_MAX || units * dirs.ndir >= INT32_MAX) return cudaErrorInvalidValue;
        const SiteGrid g{(int)V, npass, (int)units, FastDiv(a.T), FastDiv(a.Z), FastDiv(a.Y),
                         FastDiv(dirs.ndir), FastDiv(npass)};
        const int64_t slots_all = (int64_t)per_sm * sms;
        stencil_site_kernel<ST, FT, kWide>
            <<<(unsigned)(units < slots_all ? units : slots_all), dim3(kSites, groups),
               ring_bytes<ST>(), stream>>>(
                static_cast<const ST*>(a.b_re), static_cast<const ST*>(a.b_im),
                static_cast<const float*>(a.k_re), static_cast<const float*>(a.k_im),
                static_cast<const FT*>(a.x_re), static_cast<const FT*>(a.x_im),
                static_cast<FT*>(a.y_re), static_cast<FT*>(a.y_im), a.n, a.X, a.Y, a.Z, a.T, g,
                dirs);
        return cudaGetLastError();
    }

    // registers, local bytes, threads a block, resident blocks an SM at n columns
    static cudaError_t attrs(int n, int* out) {
        int groups, npass, sms;
        groups_of(n, &groups, &npass);
        cudaError_t err = slots(groups, &sms, &out[3]);
        if (err != cudaSuccess) return err;
        cudaFuncAttributes attr;
        if ((err = cudaFuncGetAttributes(&attr, stencil_site_kernel<ST, FT, kWide>)) !=
            cudaSuccess)
            return err;
        out[0] = attr.numRegs;
        out[1] = (int)attr.localSizeBytes;
        out[2] = kSites * groups;
        return cudaSuccess;
    }
};

// Site<ST, FT, kWide> of the kPair ``pair`` (the four f32-summed pairs)
template <bool kWide, typename F>
cudaError_t by_pair(int pair, F&& f) {
    switch (pair) {
        case kF32F32: return f(Site<float, float, kWide>{});
        case kBf16F32: return f(Site<__nv_bfloat16, float, kWide>{});
        case kBf16Bf16: return f(Site<__nv_bfloat16, __nv_bfloat16, kWide>{});
        case kF32Bf16: return f(Site<float, __nv_bfloat16, kWide>{});
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// K1's block-streaming route: (ki, kd, bi, bd) = (1, 1, 12, 12) at the
// f32-summed pairs (kPair 0-3); kron [ndir, 1, 1] f32 or nullptr; wide: 1
// for the 16-byte copies (V x elem a multiple of 16, block pointers
// 16-byte aligned), 0 for element copies.
int sbt_stencil_site(int ki, int kd, int bi, int bd, int pair, const void* b_re,
                     const void* b_im, const void* k_re, const void* k_im, const void* x_re,
                     const void* x_im, void* y_re, void* y_im, int n, int X, int Y, int Z,
                     int T, int ndir, const int* offsets, int packed_parity, int wide,
                     void* stream) {
    if (ki != 1 || kd != 1 || bi != kFeat || bd != kFeat || n < 1) return cudaErrorInvalidValue;
    if (wide) {
        const int64_t V = (int64_t)X * Y * Z * T;
        const size_t elem = (pair == kBf16F32 || pair == kBf16Bf16) ? 2 : 4;
        if ((V * (int64_t)elem) % 16 || reinterpret_cast<uintptr_t>(b_re) % 16 ||
            reinterpret_cast<uintptr_t>(b_im) % 16)
            return cudaErrorMisalignedAddress;
    }
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, packed_parity, &dirs);
    if (err != cudaSuccess) return err;
    const Operands a{b_re, b_im, k_re, k_im, x_re, x_im, y_re, y_im, n, X, Y, Z, T};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto run = [&](auto site) { return decltype(site)::run(a, dirs, st); };
    return wide ? by_pair<true>(pair, run) : by_pair<false>(pair, run);
}

// The registers, local bytes, threads a block and resident blocks an SM of
// the block-streaming kernel at n columns (out[4]).
int sbt_stencil_site_attrs(int pair, int wide, int n, int* out) {
    if (n < 1) return cudaErrorInvalidValue;
    auto attrs = [&](auto site) { return decltype(site)::attrs(n, out); };
    return wide ? by_pair<true>(pair, attrs) : by_pair<false>(pair, attrs);
}

}  // extern "C"
