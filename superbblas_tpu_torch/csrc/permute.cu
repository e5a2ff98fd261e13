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
// The 16-byte route (permute_4d_vec_kernel), where T's stride is 1, X, T
// and the other strides are multiples of 4 words and both pointers are
// 16-byte aligned.  The word route moved one 4 KB tile a block with 4-byte
// accesses, and each block loaded, waited at a barrier, stored and
// exited, so its loads and stores never overlapped (0.33-0.35 ms at the
// shape above).  This one:
//  * a persistent grid (blocks an SM slot) walks items (y, z plane, X
//    tile, T tile) of 64 X rows x 128 T words (32 KB); a block's items
//    stream through a ring of kVecStages = 3 stages in shared memory, so
//    the loads of the next two items are in flight while this one is
//    stored (two blocks of 256 threads an SM); the tile's shape and the
//    ring were chosen by tools/kernel_variants.py (PERF.md);
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
// which sweeps the (YB, ZB) planes a TPU block moves.  The same function,
// templated on the tile edge E (an E x E tile of the (X, T) plane), the
// rows R of threads (E x R threads, each moving E / R words a plane) and
// the number P of (y, z) planes a block moves, P tiles in shared memory at
// once: more words in flight a block for larger E and P.  (32, 8, 1) is
// K2's own tile.  Bound, as K2: bytes (at 64^4 f32, 134 MB moved, 0.040
// ms at 3.35 TB/s).  The grid is the caller's (ops/permute.py
// tiled_grid); grid-stride loops cover X and the planes beyond it.
//
// Plain C interface (loaded with ctypes); the call returns the
// cudaError_t of its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace {

constexpr int kTile = 32;  // tile edge, in words
constexpr int kRows = 8;   // threadIdx.y extent: each thread moves kTile/kRows words
constexpr int64_t kMaxGridYZ = 65535;
// The 16-byte route's design, set by -D in tools/kernel_variants.py: a
// tile of SBT_K2_EX X rows x SBT_K2_ET T words (multiples of 32), a ring of
// SBT_K2_STAGES tiles, SBT_K2_THREADS threads a block.
#ifndef SBT_K2_EX
#define SBT_K2_EX 64
#endif
#ifndef SBT_K2_ET
#define SBT_K2_ET 128
#endif
#ifndef SBT_K2_STAGES
#define SBT_K2_STAGES 3
#endif
#ifndef SBT_K2_THREADS
#define SBT_K2_THREADS 256
#endif
constexpr int kVecEX = SBT_K2_EX, kVecET = SBT_K2_ET;
constexpr int kVecChunks = kVecET / 4;   // 16-byte words of a tile row
constexpr int kVecThreads = SBT_K2_THREADS;
constexpr int kVecStages = SBT_K2_STAGES;
constexpr int kVecStageWords = kVecEX * kVecET;
static_assert(kVecEX % 32 == 0 && kVecET % 32 == 0 && kVecStages >= 2, "K2 tile");

// the items of the 16-byte route: (y, z) plane slowest, then the X tile,
// then the T tile; fewer than 2^31 (sbt_permute_4d_vec checks)
struct VecGrid {
    int64_t X, Y, Z, T, sx, sy, sz;
    int items;
    FastDiv tiles, ntt, Zd;   // X tiles x T tiles of a plane; T tiles; Z
};

// item -> its plane (y, z) and the tile's first x and t
struct VecItem {
    int64_t y, z, x0, t0;

    __device__ __forceinline__ VecItem(const VecGrid& g, int item) {
        const int yz = (int)g.tiles.div(item);
        const int rest = item - yz * (int)g.tiles.d;
        const int xt = (int)g.ntt.div(rest);
        y = g.Zd.div(yz);
        z = yz - y * g.Z;
        x0 = (int64_t)xt * kVecEX;
        t0 = (int64_t)(rest - xt * (int)g.ntt.d) * kVecET;
    }
};

__global__ void __launch_bounds__(kVecThreads)
permute_4d_vec_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                      const __grid_constant__ VecGrid g, int mid_swap) {
    extern __shared__ __align__(16) uint4 ring[];   // [kVecStages][x][chunk]
    const int tid = threadIdx.x;
    const int mine = g.items > (int)blockIdx.x
                         ? (g.items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const int64_t YZ = g.Y * g.Z;

    auto issue = [&](int k) {
        if (k < mine) {
            const VecItem it(g, blockIdx.x + k * gridDim.x);
            const uint32_t* src = in + it.y * g.sy + it.z * g.sz + it.t0;
            uint4* st = ring + (k % kVecStages) * (kVecStageWords / 4);
#pragma unroll
            for (int q = tid; q < kVecStageWords / 4; q += kVecThreads) {
                const int r = q / kVecChunks, c = q % kVecChunks;
                if (it.x0 + r < g.X && it.t0 + 4 * c < g.T)
                    copy16(st + r * kVecChunks + (c ^ ((r >> 2) & 7)),
                           src + (it.x0 + r) * g.sx + 4 * c);
            }
        }
        copy_commit();
    };
#pragma unroll
    for (int k = 0; k < kVecStages - 1; ++k) issue(k);

#pragma unroll 1
    for (int k = 0; k < mine; ++k) {
        copy_wait<kVecStages - 2>();
        __syncthreads();
        issue(k + kVecStages - 1);   // into the stage item k - 1 used: every thread is past it
        const VecItem it(g, blockIdx.x + k * gridDim.x);
        const int64_t x0 = it.x0, t0 = it.t0;
        const int64_t plane = mid_swap ? it.z * g.Y + it.y : it.y * g.Z + it.z;
        const uint32_t* st =
            reinterpret_cast<const uint32_t*>(ring + (k % kVecStages) * (kVecStageWords / 4));
        // a warp: 8 X chunks (lane / 4) x 4 T words (lane % 4) of one T chunk
#pragma unroll
        for (int q = tid; q < kVecStageWords / 4; q += kVecThreads) {
            const int lane = q & 31, wq = q >> 5;
            const int w = lane & 3;
            const int xc = wq % (kVecEX / 32) * 8 + (lane >> 2);   // X chunk
            const int tc = wq / (kVecEX / 32);                     // T chunk
            const int t = 4 * tc + w;
            if (x0 + 4 * xc >= g.X || t0 + t >= g.T) continue;
            const int phys = (tc ^ (xc & 7)) * 4 + w;    // rows 4 xc .. 4 xc + 3 share (x / 4)
            uint4 v;
            v.x = st[(4 * xc + 0) * kVecET + phys];
            v.y = st[(4 * xc + 1) * kVecET + phys];
            v.z = st[(4 * xc + 2) * kVecET + phys];
            v.w = st[(4 * xc + 3) * kVecET + phys];
            *reinterpret_cast<uint4*>(out + ((t0 + t) * YZ + plane) * g.X + x0 + 4 * xc) = v;
        }
    }
    copy_wait<0>();
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

template <int E, int R, int P>
__global__ void __launch_bounds__(E * R)
permute_4d_tiled_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                        int64_t X, int64_t Y, int64_t Z, int64_t T, int64_t sx, int64_t sy,
                        int64_t sz, int64_t st, int mid_swap) {
    __shared__ uint32_t tile[P][E][E + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int64_t t0 = static_cast<int64_t>(blockIdx.x) * E;
    const int64_t YZ = Y * Z;
    for (int64_t x0 = static_cast<int64_t>(blockIdx.y) * E; x0 < X;
         x0 += static_cast<int64_t>(gridDim.y) * E) {
        for (int64_t g = static_cast<int64_t>(blockIdx.z) * P; g < YZ;
             g += static_cast<int64_t>(gridDim.z) * P) {
            const int np = YZ - g < P ? static_cast<int>(YZ - g) : P;
            for (int p = 0; p < np; ++p) {
                const int64_t y = (g + p) / Z, z = (g + p) - y * Z;
                const uint32_t* src = in + y * sy + z * sz;
                const int64_t t = t0 + tx;
                for (int r = ty; r < E; r += R) {
                    const int64_t x = x0 + r;
                    if (x < X && t < T) tile[p][r][tx] = src[x * sx + t * st];
                }
            }
            __syncthreads();
            for (int p = 0; p < np; ++p) {
                const int64_t y = (g + p) / Z, z = (g + p) - y * Z;
                const int64_t plane = mid_swap ? z * Y + y : y * Z + z;
                const int64_t x = x0 + tx;
                for (int r = ty; r < E; r += R) {
                    const int64_t tw = t0 + r;
                    if (x < X && tw < T) out[(tw * YZ + plane) * X + x] = tile[p][tx][r];
                }
            }
            __syncthreads();
        }
    }
}

constexpr size_t kVecSmem = kVecStages * kVecStageWords * sizeof(uint32_t);
constexpr int kMaxDevices = 64;

// the SMs of the current device and the 16-byte route's resident blocks an
// SM, set at the first launch on a device (with the ring's shared-memory
// attribute), so a launch makes no query of its own
cudaError_t vec_slots(int* sms, int* per_sm) {
    static int cache[kMaxDevices][2];
    int dev, local[2] = {0, 0};
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    int* c = dev < kMaxDevices ? cache[dev] : local;
    if (c[0] == 0) {
        if ((err = cudaFuncSetAttribute(permute_4d_vec_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(kVecSmem))) != cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &c[1], permute_4d_vec_kernel, kVecThreads, kVecSmem)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(&c[0], cudaDevAttrMultiProcessorCount, dev)) !=
                cudaSuccess)
            return err;
    }
    *sms = c[0];
    *per_sm = c[1];
    return c[1] < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <int E, int R, int P>
cudaError_t launch_tiled(const dim3& grid, int mid_swap, int64_t X, int64_t Y, int64_t Z,
                         int64_t T, int64_t sx, int64_t sy, int64_t sz, int64_t st,
                         const void* in, void* out, cudaStream_t stream) {
    permute_4d_tiled_kernel<E, R, P><<<grid, dim3(E, R), 0, stream>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), X, Y, Z, T, sx, sy,
        sz, st, mid_swap);
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
    if ((T > 1 && st != 1) || X % 4 || T % 4 || (X > 1 && sx % 4) || (Y > 1 && sy % 4) ||
        (Z > 1 && sz % 4) || reinterpret_cast<uintptr_t>(in) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16)
        return cudaErrorMisalignedAddress;
    int sms, per_sm;
    const cudaError_t err = vec_slots(&sms, &per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t ntx = (X + kVecEX - 1) / kVecEX, ntt = (T + kVecET - 1) / kVecET;
    const int64_t items = Y * Z * ntx * ntt;
    if (items >= INT32_MAX) return cudaErrorInvalidValue;
    const VecGrid g{X, Y, Z, T, X > 1 ? sx : 0, Y > 1 ? sy : 0, Z > 1 ? sz : 0,
                    static_cast<int>(items), FastDiv(static_cast<uint32_t>(ntx * ntt)),
                    FastDiv(static_cast<uint32_t>(ntt)), FastDiv(static_cast<uint32_t>(Z))};
    const int64_t slots = static_cast<int64_t>(per_sm) * sms;
    permute_4d_vec_kernel<<<static_cast<unsigned>(items < slots ? items : slots),
                            kVecThreads, kVecSmem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), g, mid_swap);
    return static_cast<int>(cudaGetLastError());
}

// The 16-byte route's registers, local bytes, threads a block and resident
// blocks an SM (out[4]).
int sbt_permute_4d_vec_attrs(int* out) {
    int sms;
    cudaError_t err = vec_slots(&sms, &out[3]);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, permute_4d_vec_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = kVecThreads;
    return 0;
}

// The tile sweep: tile (edge, rows, planes) one of the instantiations
// below, on the grid (gx, gy, gz) the caller computed.
int sbt_permute_4d_tiled(int edge, int rows, int planes, int mid_swap, int64_t X, int64_t Y,
                         int64_t Z, int64_t T, int64_t sx, int64_t sy, int64_t sz,
                         int64_t st, int64_t gx, int64_t gy, int64_t gz, const void* in,
                         void* out, void* stream) {
    if (X < 1 || Y < 1 || Z < 1 || T < 1 || gx < 1 || gx > INT32_MAX || gy < 1 ||
        gy > kMaxGridYZ || gz < 1 || gz > kMaxGridYZ || gx * edge < T)
        return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                    static_cast<unsigned>(gz));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SBT_TILE(E, R, P)                                                                 \
    if (edge == E && rows == R && planes == P)                                            \
        return static_cast<int>(                                                          \
            launch_tiled<E, R, P>(grid, mid_swap, X, Y, Z, T, sx, sy, sz, st, in, out, s))
    SBT_TILE(32, 8, 1);
    SBT_TILE(32, 8, 2);
    SBT_TILE(32, 8, 4);
    SBT_TILE(32, 16, 1);
    SBT_TILE(64, 8, 1);
    SBT_TILE(64, 16, 2);
#undef SBT_TILE
    return cudaErrorInvalidValue;
}

}  // extern "C"
