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
// What the design does about it: the minor axis changes (T in, X out), so
// a direct element copy reads or writes with a stride of X or of T words
// and wastes most of every 32-byte sector it touches.  Instead each block
// takes a 32x32 tile of the (X, T) plane of one (y, z):
//  * it reads rows along T, 32 consecutive words per warp (coalesced where
//    T's stride is 1), into a [32][33] shared array: the pad puts the 32
//    words of a tile column in 32 different banks;
//  * it writes rows along X, 32 consecutive words per warp, coalesced,
//    into the output plane of the same (y, z), y and z swapped for
//    (3,2,1,0);
//  * it masks the ragged edges of X and T.
// The input's strides are arguments, so a box sliced out of a larger
// tensor (a view) is read in place with no extra pass.  TMA and wider
// vector accesses are left to a later redesign.
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

namespace {

constexpr int kTile = 32;  // tile edge, in words
constexpr int kRows = 8;   // threadIdx.y extent: each thread moves kTile/kRows words
constexpr int64_t kMaxGridYZ = 65535;

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
