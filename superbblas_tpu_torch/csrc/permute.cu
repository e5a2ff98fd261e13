// 4-D tiled transpose for Hopper (sm_90a): the label-permute fast path.
//
// Replaces the Pallas TPU kernel superbblas_tpu/ops/permute_pallas.py:66
// pallas_permute (_kern :57), which ops/copy.py's _permute_to reaches for
// every eligible 4-D transpose.  For in [X, Y, Z, T] of any 4-byte type,
// moved as raw 32-bit words (so the result is bit-exact):
//   perm (3,1,2,0): out[t, y, z, x] = in[x, y, z, t]
//   perm (3,2,1,0): out[t, z, y, x] = in[x, y, z, t]
// The output is contiguous; the input is read through its four strides.
//
// What bounds it on the H100: bytes.  It does no arithmetic and must read
// the tensor once and write it once: at [128, 64, 64, 128] f32 (268.4 MB)
// that is 536.9 MB, 0.160 ms at 3.35 TB/s.
//
// Two routes of one function (ops/permute.py permute_route picks one).
//
// The 16-byte route (permute_4d_ring_kernel at K2Point), where T's stride
// is 1, X, T and the other strides are multiples of 4 words and both
// pointers are 16-byte aligned.  The word route moved one 4 KB tile a block with 4-byte
// accesses, and each block loaded, waited at a barrier, stored and
// exited, so its loads and stores never overlapped (0.33-0.35 ms at the
// shape above).  This one:
//  * a persistent grid (blocks an SM slot) walks items (y, z plane, X
//    tile, T tile) of 64 X rows x 128 T words (32 KB); a block's items
//    stream through a ring of kVecStages = 3 stages in shared memory, so
//    the loads of the next two items are in flight while this one is
//    stored (two blocks of 256 threads an SM); the tile's shape and the
//    ring were chosen by its bring-up sweep (PERF.md section 6);
//  * loads are 16-byte cp.async along T (a warp reads one 512-byte row),
//    stores 16-byte words along X (a warp writes four 128-byte rows);
//  * the stage holds the tile as read, row x, its 32 four-word chunks
//    swizzled (chunk c at c ^ ((x / 4) % 8)): the cp.async writes of 8
//    threads and the four-word column reads of a warp (8 X chunks x 4 T)
//    each fall in 32 distinct banks, with no padding;
//  * the ragged edges of X and T are masked by whole 16-byte words.
//
// The word route (permute_4d_kernel) takes every other view: the input's
// strides are arguments, so a box sliced out of a larger tensor (a view)
// is read in place with no extra pass.  Each block takes a 32x32 tile of
// the (X, T) plane of one (y, z), since a direct element copy would read
// or write with a stride of X or of T words and waste most of every
// 32-byte sector it touches:
//  * it reads rows along T, 32 consecutive words per warp (coalesced where
//    T's stride is 1), into a [32][33] shared array: the pad puts the 32
//    words of a tile column in 32 different banks;
//  * it writes rows along X, 32 consecutive words per warp, coalesced,
//    into the output plane of the same (y, z), y and z swapped for
//    (3,2,1,0);
//  * it masks the ragged edges of X and T.
//
// E3, the tile sweep (sbt_permute_4d_tiled).  Replaces the Pallas TPU
// probe experiments/permute_pallas.py (its pl.pallas_call :68, kern :60),
// which sweeps the (YB, ZB) planes a TPU block moves: can an explicit tiled
// transpose beat the framework's own?  The same function, on the 16-byte
// views the vec route takes (others are refused), at this card's design
// points (ops/permute.py TILES):
//  * the 16-byte ring family: K2's 16-byte kernel (permute_4d_ring_kernel)
//    templated on the tile (EX X rows x ET T words), the ring's stages and
//    the threads a block; K2's own point is (64, 128, 3, 256);
//  * the TMA point (permute_4d_tma_kernel): one producer thread issues
//    cp.async.bulk.tensor loads of an (X, T) tile of EX rows x 32 words
//    (one 128-byte swizzle row a row) into a ring whose stages complete on
//    mbarriers; each consumer warp owns a fixed share of the stages, reads
//    a tile's 16-byte chunks (the hardware's 128-byte swizzle puts the
//    chunks of eight rows in distinct banks), transposes them four lanes
//    at a time with shuffles and writes 16-byte words along X.  The tensor
//    map is built on the host for each call (cuTensorMapEncodeTiled, reached
//    through cudaGetDriverEntryPoint, so the library needs no libcuda);
//    its rules (a 16-byte-aligned base, strides in whole 16 bytes) are the
//    16-byte route's.  Out-of-range rows and words are zero-filled by the
//    copy and masked at the store.
// Bound, as K2: bytes (at 64^4 f32, 134 MB moved, 0.040 ms at 3.35 TB/s).
// Every point runs a persistent grid (blocks an SM slot) over the items
// of its tile, ragged X and T masked by whole 16-byte words.
//
// Plain C interface (loaded with ctypes); the call returns the
// cudaError_t of its launch.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace {

constexpr int kTile = 32;  // tile edge, in words
constexpr int kRows = 8;   // threadIdx.y extent: each thread moves kTile/kRows words
constexpr int64_t kMaxGridYZ = 65535;
// The 16-byte route's design, as its bring-up sweep chose it (PERF.md
// section 6): a tile of kVecEX X rows x kVecET T words (multiples of 32), a ring
// of kVecStages tiles, kVecThreads threads a block.
constexpr int kVecEX = 64, kVecET = 128;
constexpr int kVecThreads = 256;
constexpr int kVecStages = 3;

// the items of the 16-byte forms: (y, z) plane slowest, then the X tile,
// then the T tile; fewer than 2^31 (vec_grid checks)
struct VecGrid {
    int64_t X, Y, Z, T, sx, sy, sz;
    int items;
    FastDiv tiles, ntt, Zd;   // X tiles x T tiles of a plane; T tiles; Z
};

// item -> its plane (y, z) and the first x and t of its EX x ET tile
struct VecItem {
    int64_t y, z, x0, t0;

    __device__ __forceinline__ VecItem(const VecGrid& g, int item, int EX, int ET) {
        const int yz = (int)g.tiles.div(item);
        const int rest = item - yz * (int)g.tiles.d;
        const int xt = (int)g.ntt.div(rest);
        y = g.Zd.div(yz);
        z = yz - y * g.Z;
        x0 = (int64_t)xt * EX;
        t0 = (int64_t)(rest - xt * (int)g.ntt.d) * ET;
    }
};

// The 16-byte ring: K2's 16-byte route at (kVecEX, kVecET, kVecStages,
// kVecThreads) and the ring family of the tile sweep at other tiles.
template <int EX, int ET, int STAGES, int THREADS>
__global__ void __launch_bounds__(THREADS)
permute_4d_ring_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                       const __grid_constant__ VecGrid g, int mid_swap) {
    static_assert(EX % 32 == 0 && ET % 32 == 0 && STAGES >= 2, "ring tile");
    constexpr int kChunks = ET / 4;          // 16-byte words of a tile row
    constexpr int kStageWords = EX * ET;
    extern __shared__ __align__(16) uint4 ring[];   // [STAGES][x][chunk]
    const int tid = threadIdx.x;
    const int mine = g.items > (int)blockIdx.x
                         ? (g.items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const int64_t YZ = g.Y * g.Z;

    auto issue = [&](int k) {
        if (k < mine) {
            const VecItem it(g, blockIdx.x + k * gridDim.x, EX, ET);
            const uint32_t* src = in + it.y * g.sy + it.z * g.sz + it.t0;
            uint4* st = ring + (k % STAGES) * (kStageWords / 4);
#pragma unroll
            for (int q = tid; q < kStageWords / 4; q += THREADS) {
                const int r = q / kChunks, c = q % kChunks;
                if (it.x0 + r < g.X && it.t0 + 4 * c < g.T)
                    copy16(st + r * kChunks + (c ^ ((r >> 2) & 7)),
                           src + (it.x0 + r) * g.sx + 4 * c);
            }
        }
        copy_commit();
    };
#pragma unroll
    for (int k = 0; k < STAGES - 1; ++k) issue(k);

#pragma unroll 1
    for (int k = 0; k < mine; ++k) {
        copy_wait<STAGES - 2>();
        __syncthreads();
        issue(k + STAGES - 1);   // into the stage item k - 1 used: every thread is past it
        const VecItem it(g, blockIdx.x + k * gridDim.x, EX, ET);
        const int64_t x0 = it.x0, t0 = it.t0;
        const int64_t plane = mid_swap ? it.z * g.Y + it.y : it.y * g.Z + it.z;
        const uint32_t* st =
            reinterpret_cast<const uint32_t*>(ring + (k % STAGES) * (kStageWords / 4));
        // a warp: 8 X chunks (lane / 4) x 4 T words (lane % 4) of one T chunk
#pragma unroll
        for (int q = tid; q < kStageWords / 4; q += THREADS) {
            const int lane = q & 31, wq = q >> 5;
            const int w = lane & 3;
            const int xc = wq % (EX / 32) * 8 + (lane >> 2);   // X chunk
            const int tc = wq / (EX / 32);                     // T chunk
            const int t = 4 * tc + w;
            if (x0 + 4 * xc >= g.X || t0 + t >= g.T) continue;
            const int phys = (tc ^ (xc & 7)) * 4 + w;    // rows 4 xc .. 4 xc + 3 share (x / 4)
            uint4 v;
            v.x = st[(4 * xc + 0) * ET + phys];
            v.y = st[(4 * xc + 1) * ET + phys];
            v.z = st[(4 * xc + 2) * ET + phys];
            v.w = st[(4 * xc + 3) * ET + phys];
            *reinterpret_cast<uint4*>(out + ((t0 + t) * YZ + plane) * g.X + x0 + 4 * xc) = v;
        }
    }
    copy_wait<0>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity ``parity`` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

constexpr int kTmaET = 32;   // T words of a TMA tile row: one 128-byte swizzle row

// The TMA point: warp 0's lane 0 loads the items' (X, T) tiles (EX rows of
// kTmaET words, 128-byte swizzle) into a ring of STAGES stages; consumer
// warp w takes the items k with k % CONSUMERS == w, so that a stage always
// has one consumer (STAGES % CONSUMERS == 0) and its barriers never run
// two phases apart.
template <int EX, int STAGES, int CONSUMERS>
__global__ void __launch_bounds__(32 * (CONSUMERS + 1))
permute_4d_tma_kernel(const __grid_constant__ CUtensorMap tmap, uint32_t* __restrict__ out,
                      const __grid_constant__ VecGrid g, int mid_swap) {
    static_assert(EX % 32 == 0 && EX <= 256 && STAGES % CONSUMERS == 0, "TMA tile");
    constexpr int kStageWords = EX * kTmaET;
    extern __shared__ unsigned char tma_raw[];
    // the 128-byte swizzle repeats every 1024 bytes: stages 1024-byte aligned
    uint32_t* ring = reinterpret_cast<uint32_t*>(
        (reinterpret_cast<uintptr_t>(tma_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * kStageWords);
    uint64_t* empty = full + STAGES;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int mine = g.items > (int)blockIdx.x
                         ? (g.items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 0) {
        if (lane == 0) {
            const uint64_t map = reinterpret_cast<uint64_t>(&tmap);
            for (int k = 0; k < mine; ++k) {
                const int s = k % STAGES;
                if (k >= STAGES) mbar_wait(&empty[s], ((k / STAGES) - 1) & 1);
                const VecItem it(g, blockIdx.x + k * gridDim.x, EX, kTmaET);
                mbar_expect_tx(&full[s], kStageWords * 4);
                asm volatile(
                    "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
                    " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
                    ::"r"(smem_u32(ring + s * kStageWords)), "l"(map), "r"((int)it.t0),
                    "r"((int)it.z), "r"((int)it.y), "r"((int)it.x0), "r"(smem_u32(&full[s]))
                    : "memory");
            }
        }
        return;
    }
    const int64_t YZ = g.Y * g.Z;
    const int k4 = lane & 3;   // a lane's row within its group of four; later its T word
    for (int k = warp - 1; k < mine; k += CONSUMERS) {
        const int s = k % STAGES;
        mbar_wait(&full[s], (k / STAGES) & 1);
        const VecItem it(g, blockIdx.x + k * gridDim.x, EX, kTmaET);
        const int64_t plane = mid_swap ? it.z * g.Y + it.y : it.y * g.Z + it.z;
        const uint32_t* st = ring + s * kStageWords;
#pragma unroll 2
        for (int q = 0; q < EX / 32 * (kTmaET / 4); ++q) {
            const int xb = q / (kTmaET / 4), tc = q % (kTmaET / 4);
            // lane (xc, k4) reads row 32 xb + 4 xc + k4, T chunk tc (swizzled)
            const int row = 32 * xb + lane;
            const uint4 v = *reinterpret_cast<const uint4*>(st + row * kTmaET +
                                                            ((tc ^ (row & 7)) * 4));
            const uint32_t in[4] = {v.x, v.y, v.z, v.w};
            // 4 x 4 transpose in each group of four lanes: lane k4 gets T word
            // k4 of the group's four rows
            uint32_t o[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int src = k4 ^ r;   // the word this lane sends, the row it receives
                const uint32_t send =
                    src == 0 ? in[0] : src == 1 ? in[1] : src == 2 ? in[2] : in[3];
                const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    if (i == src) o[i] = got;
            }
            const int64_t x = it.x0 + 32 * xb + 4 * (lane >> 2), t = it.t0 + 4 * tc + k4;
            if (x < g.X && t < g.T)
                *reinterpret_cast<uint4*>(out + (t * YZ + plane) * g.X + x) =
                    make_uint4(o[0], o[1], o[2], o[3]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
    }
}

__global__ void __launch_bounds__(kTile * kRows)
permute_4d_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int64_t X, int64_t Y, int64_t Z, int64_t T, int64_t sx,
                  int64_t sy, int64_t sz, int64_t st, int mid_swap) {
    __shared__ uint32_t tile[kTile][kTile + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
    const int64_t YZ = Y * Z;
    for (int64_t x0 = static_cast<int64_t>(blockIdx.y) * kTile; x0 < X;
         x0 += static_cast<int64_t>(gridDim.y) * kTile) {
        for (int64_t yz = blockIdx.z; yz < YZ; yz += gridDim.z) {
            const int64_t y = yz / Z, z = yz - y * Z;
            const uint32_t* src = in + y * sy + z * sz;
            const int64_t t = t0 + tx;
            for (int r = ty; r < kTile; r += kRows) {
                const int64_t x = x0 + r;
                if (x < X && t < T) tile[r][tx] = src[x * sx + t * st];
            }
            __syncthreads();
            // out is [T, A, B, X] with (A, B) = (Y, Z), or (Z, Y) when swapped
            const int64_t plane = mid_swap ? z * Y + y : y * Z + z;
            const int64_t x = x0 + tx;
            for (int r = ty; r < kTile; r += kRows) {
                const int64_t tw = t0 + r;
                if (x < X && tw < T) out[(tw * YZ + plane) * X + x] = tile[tx][r];
            }
            __syncthreads();
        }
    }
}

constexpr int kMaxDevices = 64;

// a design point of the 16-byte forms: its kernel, threads a block, shared
// memory and tile (EX X rows x ET T words)
template <int EX, int ET, int STAGES, int THREADS>
struct RingPoint {
    static constexpr int kEX = EX, kET = ET, kThreads = THREADS;
    static constexpr size_t kSmem = (size_t)STAGES * EX * ET * sizeof(uint32_t);
    static auto kernel() { return permute_4d_ring_kernel<EX, ET, STAGES, THREADS>; }
};
template <int EX, int STAGES, int CONSUMERS>
struct TmaPoint {
    static constexpr int kEX = EX, kET = kTmaET, kThreads = 32 * (CONSUMERS + 1);
    // the ring, 1024-byte aligned inside the block's window, then its barriers
    static constexpr size_t kSmem =
        1024 + (size_t)STAGES * EX * kTmaET * sizeof(uint32_t) + 2 * STAGES * sizeof(uint64_t);
    static auto kernel() { return permute_4d_tma_kernel<EX, STAGES, CONSUMERS>; }
};
using K2Point = RingPoint<kVecEX, kVecET, kVecStages, kVecThreads>;

// the SMs of the current device and a point's resident blocks an SM, set at
// its first launch on a device (with its shared-memory attribute), so a
// launch makes no query of its own
template <typename P>
cudaError_t slots(int* sms, int* per_sm) {
    static int cache[kMaxDevices][2];
    int dev, local[2] = {0, 0};
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    int* c = dev < kMaxDevices ? cache[dev] : local;
    if (c[0] == 0) {
        if ((err = cudaFuncSetAttribute(P::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(P::kSmem))) != cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c[1], P::kernel(), P::kThreads,
                                                                 P::kSmem)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&c[0], cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess)
            return err;
    }
    *sms = c[0];
    *per_sm = c[1];
    return c[1] < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// whether the 16-byte forms take the view: T's stride 1, X, T and the
// other strides whole 16-byte words (the strides of axes of extent 1
// aside), both pointers 16-byte aligned
bool vec_view(int64_t X, int64_t Y, int64_t Z, int64_t T, int64_t sx, int64_t sy, int64_t sz,
              int64_t st, const void* in, const void* out) {
    return !((T > 1 && st != 1) || X % 4 || T % 4 || (X > 1 && sx % 4) || (Y > 1 && sy % 4) ||
             (Z > 1 && sz % 4) || reinterpret_cast<uintptr_t>(in) % 16 ||
             reinterpret_cast<uintptr_t>(out) % 16);
}

// the items of a point's tiles over the view: (y, z) plane slowest, then the
// X tile, then the T tile; false where they reach 2^31
template <typename P>
bool vec_grid(int64_t X, int64_t Y, int64_t Z, int64_t T, int64_t sx, int64_t sy, int64_t sz,
              VecGrid* g) {
    const int64_t ntx = (X + P::kEX - 1) / P::kEX, ntt = (T + P::kET - 1) / P::kET;
    const int64_t items = Y * Z * ntx * ntt;
    if (items >= INT32_MAX) return false;
    *g = VecGrid{X, Y, Z, T, X > 1 ? sx : 0, Y > 1 ? sy : 0, Z > 1 ? sz : 0,
                 static_cast<int>(items), FastDiv(static_cast<uint32_t>(ntx * ntt)),
                 FastDiv(static_cast<uint32_t>(ntt)), FastDiv(static_cast<uint32_t>(Z))};
    return true;
}

template <typename P>
cudaError_t launch_ring(int mid_swap, int64_t X, int64_t Y, int64_t Z, int64_t T, int64_t sx,
                        int64_t sy, int64_t sz, const void* in, void* out, cudaStream_t stream) {
    int sms, per_sm;
    const cudaError_t err = slots<P>(&sms, &per_sm);
    if (err != cudaSuccess) return err;
    VecGrid g;
    if (!vec_grid<P>(X, Y, Z, T, sx, sy, sz, &g)) return cudaErrorInvalidValue;
    const int64_t all = static_cast<int64_t>(per_sm) * sms;
    const auto kernel = P::kernel();
    kernel<<<static_cast<unsigned>(g.items < all ? g.items : all), P::kThreads, P::kSmem,
             stream>>>(static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), g,
                       mid_swap);
    return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no libcuda
// at link time); nullptr where the driver has none
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
                cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

template <typename P>
cudaError_t launch_tma(int mid_swap, int64_t X, int64_t Y, int64_t Z, int64_t T, int64_t sx,
                       int64_t sy, int64_t sz, const void* in, void* out, cudaStream_t stream) {
    if (X >= INT32_MAX || Y >= INT32_MAX || Z >= INT32_MAX || T >= INT32_MAX)
        return cudaErrorInvalidValue;   // the copy's coordinates are 32-bit
    int sms, per_sm;
    cudaError_t err = slots<P>(&sms, &per_sm);
    if (err != cudaSuccess) return err;
    VecGrid g;
    if (!vec_grid<P>(X, Y, Z, T, sx, sy, sz, &g)) return cudaErrorInvalidValue;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    // [X, Y, Z, T] innermost first; an axis of extent 1 takes the stride a
    // packed tensor would have (the map wants whole 16 bytes everywhere)
    const cuuint64_t bz = (Z > 1 ? sz : T) * 4, by = (Y > 1 ? sy * 4 : bz * Z);
    const cuuint64_t dims[4] = {(cuuint64_t)T, (cuuint64_t)Z, (cuuint64_t)Y, (cuuint64_t)X};
    const cuuint64_t strides[3] = {bz, by, (cuuint64_t)sx * 4};
    const cuuint32_t box[4] = {(cuuint32_t)P::kET, 1, 1, (cuuint32_t)P::kEX};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    CUtensorMap map;
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, const_cast<void*>(in), dims, strides, box,
               ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    const int64_t all = static_cast<int64_t>(per_sm) * sms;
    const auto kernel = P::kernel();
    kernel<<<static_cast<unsigned>(g.items < all ? g.items : all), P::kThreads, P::kSmem,
             stream>>>(map, static_cast<uint32_t*>(out), g, mid_swap);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements (words), as torch's Tensor.stride() gives them.
int sbt_permute_4d(int mid_swap, int64_t X, int64_t Y, int64_t Z, int64_t T,
                   int64_t sx, int64_t sy, int64_t sz, int64_t st,
                   const void* in, void* out, void* stream) {
    if (X < 1 || Y < 1 || Z < 1 || T < 1) return cudaErrorInvalidValue;
    const int64_t gx = (T + kTile - 1) / kTile;
    if (gx > INT32_MAX) return cudaErrorInvalidValue;
    const int64_t gy = (X + kTile - 1) / kTile;
    const dim3 grid(static_cast<unsigned>(gx),
                    static_cast<unsigned>(gy < kMaxGridYZ ? gy : kMaxGridYZ),
                    static_cast<unsigned>(Y * Z < kMaxGridYZ ? Y * Z : kMaxGridYZ));
    permute_4d_kernel<<<grid, dim3(kTile, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), X, Y, Z, T,
        sx, sy, sz, st, mid_swap);
    return static_cast<int>(cudaGetLastError());
}

// The 16-byte route: the same transpose where st == 1, X, T, sx, sy and
// sz are multiples of 4 (the strides of axes of extent 1 aside) and both
// pointers are 16-byte aligned; else cudaErrorMisalignedAddress.
int sbt_permute_4d_vec(int mid_swap, int64_t X, int64_t Y, int64_t Z, int64_t T, int64_t sx,
                       int64_t sy, int64_t sz, int64_t st, const void* in, void* out,
                       void* stream) {
    if (X < 1 || Y < 1 || Z < 1 || T < 1) return cudaErrorInvalidValue;
    if (!vec_view(X, Y, Z, T, sx, sy, sz, st, in, out)) return cudaErrorMisalignedAddress;
    return static_cast<int>(launch_ring<K2Point>(mid_swap, X, Y, Z, T, sx, sy, sz, in, out,
                                                 static_cast<cudaStream_t>(stream)));
}

// The 16-byte route's registers, local bytes, threads a block and resident
// blocks an SM (out[4]).
int sbt_permute_4d_vec_attrs(int* out) {
    int sms;
    cudaError_t err = slots<K2Point>(&sms, &out[3]);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, K2Point::kernel());
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = K2Point::kThreads;
    return 0;
}

// The tile sweep at one design point of ops/permute.py TILES: form 0, the
// 16-byte ring (tile ex x et words, stages, threads a block), form 1, the
// TMA kernel (ex rows of 32 words, stages, 32 x (consumer warps + 1)
// threads); the views of sbt_permute_4d_vec, else
// cudaErrorMisalignedAddress; a point not built, cudaErrorInvalidValue.
int sbt_permute_4d_tiled(int form, int ex, int et, int stages, int threads, int mid_swap,
                         int64_t X, int64_t Y, int64_t Z, int64_t T, int64_t sx, int64_t sy,
                         int64_t sz, int64_t st, const void* in, void* out, void* stream) {
    if (X < 1 || Y < 1 || Z < 1 || T < 1) return cudaErrorInvalidValue;
    if (!vec_view(X, Y, Z, T, sx, sy, sz, st, in, out)) return cudaErrorMisalignedAddress;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SBT_RING(EX, ET, ST, TH)                                                          \
    if (form == 0 && ex == EX && et == ET && stages == ST && threads == TH)               \
        return static_cast<int>(launch_ring<RingPoint<EX, ET, ST, TH>>(                   \
            mid_swap, X, Y, Z, T, sx, sy, sz, in, out, s))
    SBT_RING(64, 128, 3, 256);   // K2's own
    SBT_RING(64, 256, 3, 256);
    SBT_RING(32, 256, 4, 256);
    SBT_RING(64, 128, 4, 256);
    SBT_RING(32, 128, 4, 128);
    SBT_RING(128, 128, 2, 512);
    SBT_RING(64, 64, 4, 256);
#undef SBT_RING
#define SBT_TMA(EX, ST, CW)                                                               \
    if (form == 1 && ex == EX && et == kTmaET && stages == ST && threads == 32 * (CW + 1)) \
        return static_cast<int>(                                                          \
            launch_tma<TmaPoint<EX, ST, CW>>(mid_swap, X, Y, Z, T, sx, sy, sz, in, out, s))
    SBT_TMA(64, 8, 4);
    SBT_TMA(128, 8, 4);
#undef SBT_TMA
    return cudaErrorInvalidValue;
}

}  // extern "C"
