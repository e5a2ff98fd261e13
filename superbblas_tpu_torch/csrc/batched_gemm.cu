// Batched small GEMM for Hopper (sm_90a): y[v] = b[v] @ x[v],
// b [V, I, J], x [V, J, N], y [V, I, N], all contiguous, f32 or f64.
//
// Replaces two TPU kernels that compute this function:
//  * K3, superbblas_tpu/ops/batched_gemm_pallas.py:99 batched_small_gemm
//    (_batched_small_gemm_padded :78, _kernel :58): I, J <= 64, S sites
//    packed block-diagonally into one 128x128 MXU tile;
//  * E1, experiments/bgemm_rowpack_probe.py:32 rowpack (kernel :16): the
//    large-J coarse shape [4096, 32, 288] x [4096, 288, 32], 4 sites x 32
//    rows packed into a [128, 4*288] block-diagonal tile.
// The block-diagonal packing fills the TPU's matrix unit; the card has no
// such unit to fill with f32, so it is not carried over.  Both run one
// templated kernel, gemm_kernel below, at the tiles ops/batched_gemm.py
// picks: K3 (sbt_batched_gemm_small) walks several whole sites a block,
// E1 (sbt_batched_gemm_rowpack) streams chunks of J.
//
// What bounds them on the H100: bytes, at the multigrid coarse operator's
// shapes.  At [4096, 32, 288] x [4096, 288, 32] f32 the function reads b
// and x once and writes y once, 318.8 MB, 0.0952 ms at 3.35 TB/s; its 2.42
// GFLOP take 0.0361 ms at 67 TFLOP/s (the f32 CUDA cores).  At [8192, 32,
// 32] x [8192, 32, 128], 302 MB, 0.0901 ms (0.032 ms of FLOPs).  So the
// products stay on the CUDA cores in f32 (or f64) fused multiply-adds:
// TF32 tensor-core products would lose the digits Precision.HIGHEST keeps,
// and 3xTF32 would buy FLOPs, which are not what binds.
//
// The design, against what held the first versions back:
//  1. Register tiles.  A thread owns RR x CC outputs (4x4, or 2x2 / 4x2 on
//     the narrow tiles, 1x4 on the short one).  b is staged [IT rows][JW + pad] and x [JW][NT +
//     pad] in shared memory, as they lie in device memory; a thread reads
//     four k values of each of its RR rows of b with one 16-byte load
//     (LDS.128; two k values in f64) and CC columns of x with one 8- or
//     16-byte load, then does 4 x RR x CC fused multiply-adds: at 4x4, 8
//     shared loads per 64 FMAs, against one load per FMA before.  Row pads
//     of 16 bytes keep the rows of one load instruction in distinct banks.
//  2. Asynchronous 16-byte staging.  cp.async.cg (16 bytes, L2 only)
//     fills a ring of STAGES (3 in f32, 2 in f64) buffers: the loads of
//     step t + STAGES - 1 are in flight while step t computes.  A step is
//     one chunk of JW values of J of one site; the ring runs over the
//     block's sites and chunks in one sequence, so E1 rings chunks of J
//     and K3, whose J fits one chunk, rings whole sites.  Rows whose bytes
//     are not 16-byte multiples (N = 1, 3, 5; J = 27, 33) or misaligned
//     pointers take 4-byte (8 in f64) cp.async.ca in the same loop.  Past
//     the edges (I, J, N ragged) the copies fill zeros (src-size 0), so
//     the inner loop runs unmasked.  TMA was not taken: a tile is a few KB
//     of two small 2-D boxes a step, and cp.async already keeps every byte
//     of a step in flight with no register traffic; what TMA would save is
//     the address arithmetic of 8-32 copies a thread a step.
//  3. Compile-time tiles.  (IT, NT, RR, CC, JC, KS, blocks an SM for the
//     register allocation) are template constants (six instantiations
//     a dtype, SBT_GEMM_TILES below); every extent a copy or the inner
//     loop divides by is a power of two (static_assert), so staging and
//     compute carry shifts and masks, no runtime / or %.
//  4. Split J where V is small.  Where V times the tiles of a site gives
//     fewer than MIN_BLOCKS (264, two an SM) blocks, or the tile is narrow
//     (4x8, 16x8: too few outputs for a block), the block's KS groups of
//     warps take KS slices of each step's JW = KS * JC values of J and add
//     their partial sums in shared memory in the fixed order 0, 1, ..,
//     KS - 1: the result is the same bits from run to run.  Each output
//     is a sum of J rounded products in some fixed order, so its error
//     stays within J * 2^-24 * sum |b| |x| in f32.
//  5. Any I and N.  Row tiles go on grid.y and column tiles on grid.z, each
//     at most 65535.  Past that a second instantiation of the kernel walks
//     its row and column tiles in strides of the grid; up to there the
//     one-tile kernel runs, without the loop's registers.
// Host cost is the wrapper's: its tile choice is cached per (V, I, J, N),
// and the shared-memory opt-in is made once a device and instantiation.
//
// Plain C interface (loaded with ctypes); each call returns the
// cudaError_t of its launch.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// 16 bytes of T, and its values to and from registers
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
__device__ __forceinline__ void unpack(const float4& q, float* e) {
    e[0] = q.x;
    e[1] = q.y;
    e[2] = q.z;
    e[3] = q.w;
}
__device__ __forceinline__ void unpack(const double2& q, double* e) {
    e[0] = q.x;
    e[1] = q.y;
}
__device__ __forceinline__ float4 pack(const float* e) {
    return make_float4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ double2 pack(const double* e) { return make_double2(e[0], e[1]); }

// cp.async of BYTES (16: .cg; 4 or 8: .ca); !valid fills zeros (src-size
// 0, src not read).  The "memory" clobbers keep shared-memory reads from
// moving across the copies and the waits.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? BYTES : 0;
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                     "r"(n) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                     "n"(BYTES), "r"(n) : "memory");
}
__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest N committed groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }
__host__ __device__ constexpr bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// A tile: IT rows x NT columns of one site's y a block, RR x CC a thread,
// J in steps of JW = KS * JC values, group g of KS taking slice g; MINB
// blocks an SM asked of the register allocation (__launch_bounds__).
template <int IT_, int NT_, int RR_, int CC_, int JC_, int KS_, int MINB_>
struct Tile {
    static constexpr int IT = IT_, NT = NT_, RR = RR_, CC = CC_, JC = JC_, KS = KS_;
    static constexpr int MINB = MINB_;
    static constexpr int JW = JC * KS;
    static constexpr int COLS = NT / CC;             // threads across a row of the tile
    static constexpr int TG = (IT / RR) * COLS;      // threads of a group
    static constexpr int THREADS = TG * KS;
    static_assert(IT % RR == 0 && NT % CC == 0, "a thread's outputs tile the block's");
    static_assert(pow2(COLS) && pow2(TG) && pow2(KS) && pow2(NT) && pow2(JW),
                  "the kernel shifts and masks by these extents");
    static_assert(THREADS <= 1024, "too many threads a block");
};

// Shared memory of tile C in type T: STAGES ring buffers of b [IT][BP]
// and x [JW][XP], then the split-J partial sums [KS - 1][RR * CC][TG].
template <typename T, typename C>
struct Layout {
    static constexpr int VK = 16 / sizeof(T);        // values in 16 bytes
    static constexpr int STAGES = sizeof(T) == 4 ? 3 : 2;
    static constexpr int BP = C::JW + VK;
    static constexpr int XP = C::NT + VK;
    static constexpr int STAGE = C::IT * BP + C::JW * XP;
    static constexpr int RED = (C::KS - 1) * C::IT * C::NT;
    static constexpr size_t BYTES = (static_cast<size_t>(STAGES) * STAGE + RED) * sizeof(T);
    static_assert(C::JC % VK == 0, "a chunk of J is whole 16-byte loads");
    static_assert(BYTES <= 232448, "the tile needs more than the H100's 227 KB a block");
};

// CC values of a row of x in shared memory: 8- or 16-byte loads
template <typename T, int CC>
__device__ __forceinline__ void load_cols(const T* p, T (&v)[CC]) {
    if constexpr ((CC * sizeof(T)) % 16 == 0) {
        using V = typename Vec16<T>::type;
        constexpr int VK = 16 / sizeof(T);
#pragma unroll
        for (int w = 0; w < CC / VK; ++w) unpack(reinterpret_cast<const V*>(p)[w], v + w * VK);
    } else if constexpr (CC * sizeof(T) == 8 && sizeof(T) == 4) {
        const float2 q = *reinterpret_cast<const float2*>(p);
        v[0] = q.x;
        v[1] = q.y;
    } else {
#pragma unroll
        for (int c = 0; c < CC; ++c) v[c] = p[c];
    }
}

// Copies of one step into a ring buffer, by all threads of the block:
// rows i0.. of b's chunk k0.. of site v, and rows k0.. of x's columns n0..
// (zeros past the edges).  vb / vx: the rows are 16-byte aligned.
template <typename T, typename C>
__device__ __forceinline__ void stage_step(T* bs, T* xs, const T* __restrict__ b,
                                           const T* __restrict__ x, int64_t v, int I, int J,
                                           int N, int i0, int k0, int n0, bool vb, bool vx) {
    using L = Layout<T, C>;
    constexpr int VK = L::VK;
    const int tid = threadIdx.x;
    const T* bv = b + v * I * J;
    const T* xv = x + v * J * N;
    if (vb) {
        constexpr int PER_ROW = C::JW / VK, LG = log2i(PER_ROW);
#pragma unroll
        for (int e = tid; e < C::IT * PER_ROW; e += C::THREADS) {
            const int r = e >> LG, c = (e & (PER_ROW - 1)) * VK;
            const bool ok = i0 + r < I && k0 + c < J;
            copy_async<16>(bs + r * L::BP + c, ok ? bv + (int64_t)(i0 + r) * J + k0 + c : b, ok);
        }
    } else {
        constexpr int LG = log2i(C::JW);
#pragma unroll 4
        for (int e = tid; e < C::IT * C::JW; e += C::THREADS) {
            const int r = e >> LG, c = e & (C::JW - 1);
            const bool ok = i0 + r < I && k0 + c < J;
            copy_async<sizeof(T)>(bs + r * L::BP + c,
                                  ok ? bv + (int64_t)(i0 + r) * J + k0 + c : b, ok);
        }
    }
    if (vx) {
        constexpr int PER_ROW = C::NT / VK, LG = log2i(PER_ROW);
#pragma unroll
        for (int e = tid; e < C::JW * PER_ROW; e += C::THREADS) {
            const int r = e >> LG, c = (e & (PER_ROW - 1)) * VK;
            const bool ok = k0 + r < J && n0 + c < N;
            copy_async<16>(xs + r * L::XP + c, ok ? xv + (int64_t)(k0 + r) * N + n0 + c : x, ok);
        }
    } else {
        constexpr int LG = log2i(C::NT);
#pragma unroll 4
        for (int e = tid; e < C::JW * C::NT; e += C::THREADS) {
            const int r = e >> LG, c = e & (C::NT - 1);
            const bool ok = k0 + r < J && n0 + c < N;
            copy_async<sizeof(T)>(xs + r * L::XP + c,
                                  ok ? xv + (int64_t)(k0 + r) * N + n0 + c : x, ok);
        }
    }
}

// one y tile: sites v0 .. v0 + SB - 1 (fewer at the end of V), rows i0
// .., columns n0 ..
template <typename T, typename C>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ b, const T* __restrict__ x,
                                          T* __restrict__ y, int64_t V, int I, int J, int N,
                                          int SB, int i0, int n0, bool vb, bool vx, bool vy) {
    using L = Layout<T, C>;
    constexpr int VK = L::VK, RR = C::RR, CC = C::CC, STAGES = L::STAGES;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* ring = reinterpret_cast<T*>(smem_raw);
    T* red = ring + STAGES * L::STAGE;

    const int tid = threadIdx.x;
    const int g = tid / C::TG;                 // J slice of this thread (powers of two)
    const int tg = tid & (C::TG - 1);
    const int cg = tg & (C::COLS - 1), rg = tg / C::COLS;
    const int64_t v0 = static_cast<int64_t>(blockIdx.x) * SB;
    const int ns = static_cast<int>(V - v0 < SB ? V - v0 : SB);
    const int nchunk = (J + C::JW - 1) / C::JW;   // once a block
    const int total = ns * nchunk;

    // load cursor: site ls, chunk lc of the next step to stage
    int ls = 0, lc = 0;
    auto issue = [&](int buf) {
        if (ls < ns) {
            T* bs = ring + buf * L::STAGE;
            stage_step<T, C>(bs, bs + C::IT * L::BP, b, x, v0 + ls, I, J, N, i0, lc * C::JW,
                             n0, vb, vx);
            if (++lc == nchunk) {
                lc = 0;
                ++ls;
            }
        }
        copy_commit();   // possibly empty: every thread commits one group a step
    };
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) issue(p);

    T acc[RR][CC];
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
        for (int c = 0; c < CC; ++c) acc[r][c] = T(0);

    int cbuf = 0, lbuf = STAGES - 1, cs = 0, cc = 0;
    for (int t = 0; t < total; ++t) {
        copy_wait<STAGES - 2>();   // this thread's copies of step t have landed
        __syncthreads();           // everyone's have; step t - 1's buffer is free
        issue(lbuf);
        lbuf = lbuf + 1 == STAGES ? 0 : lbuf + 1;

        const T* bs = ring + cbuf * L::STAGE + (rg * RR) * L::BP + g * C::JC;
        const T* xs = ring + cbuf * L::STAGE + C::IT * L::BP + (g * C::JC) * L::XP + cg * CC;
        cbuf = cbuf + 1 == STAGES ? 0 : cbuf + 1;
#pragma unroll
        for (int kk = 0; kk < C::JC; kk += VK) {
            T bv[RR][VK];
#pragma unroll
            for (int r = 0; r < RR; ++r)
                unpack(*reinterpret_cast<const typename Vec16<T>::type*>(bs + r * L::BP + kk),
                       bv[r]);
#pragma unroll
            for (int u = 0; u < VK; ++u) {
                T xv[CC];
                load_cols<T, CC>(xs + (kk + u) * L::XP, xv);
#pragma unroll
                for (int r = 0; r < RR; ++r)
#pragma unroll
                    for (int c = 0; c < CC; ++c) acc[r][c] = fma_t(bv[r][u], xv[c], acc[r][c]);
            }
        }

        if (++cc < nchunk) continue;
        // the site's last chunk: add the J slices in order 0 .. KS-1, store
        const int64_t v = v0 + cs;
        cc = 0;
        ++cs;
        if constexpr (C::KS > 1) {
            if (g > 0) {
                T* mine = red + ((g - 1) * RR * CC) * C::TG + tg;
#pragma unroll
                for (int r = 0; r < RR; ++r)
#pragma unroll
                    for (int c = 0; c < CC; ++c) mine[(r * CC + c) * C::TG] = acc[r][c];
            }
            __syncthreads();
            if (g == 0) {
                for (int h = 1; h < C::KS; ++h) {
                    const T* part = red + ((h - 1) * RR * CC) * C::TG + tg;
#pragma unroll
                    for (int r = 0; r < RR; ++r)
#pragma unroll
                        for (int c = 0; c < CC; ++c) acc[r][c] += part[(r * CC + c) * C::TG];
                }
            }
        }
        if (g == 0) {
            const int n = n0 + cg * CC;
#pragma unroll
            for (int r = 0; r < RR; ++r) {
                const int i = i0 + rg * RR + r;
                if (i >= I) continue;
                T* yr = y + (v * I + i) * N + n;
                if constexpr ((CC * sizeof(T)) % 16 == 0) {
                    if (vy && n + CC <= N) {
                        using V = typename Vec16<T>::type;
#pragma unroll
                        for (int w = 0; w < CC / VK; ++w)
                            reinterpret_cast<V*>(yr)[w] = pack(acc[r] + w * VK);
                        continue;
                    }
                }
#pragma unroll
                for (int c = 0; c < CC; ++c)
                    if (n + c < N) yr[c] = acc[r][c];
            }
        }
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int c = 0; c < CC; ++c) acc[r][c] = T(0);
    }
    copy_wait<0>();
}

// y tiles of sites v0 .. v0 + SB - 1 (fewer at the end of V): with kWalk
// false the one tile of rows blockIdx.y * IT .., columns blockIdx.z * NT
// ..; with kWalk, rows by * IT .., columns bz * NT .. for by =
// blockIdx.y, blockIdx.y + gridDim.y, .. below gy and bz likewise below
// gz, so a grid of at most 65535 on y and z walks any I and N.  The walk
// is its own instantiation: the loop's registers stay out of the
// one-tile kernel every smaller shape runs.
template <typename T, typename C, bool kWalk>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
gemm_kernel(const T* __restrict__ b, const T* __restrict__ x, T* __restrict__ y, int64_t V,
            int I, int J, int N, int SB, int gy, int gz, bool vb, bool vx, bool vy) {
    if constexpr (!kWalk) {
        gemm_tile<T, C>(b, x, y, V, I, J, N, SB, blockIdx.y * C::IT, blockIdx.z * C::NT, vb,
                        vx, vy);
    } else {
        for (int by = blockIdx.y; by < gy; by += gridDim.y)
            for (int bz = blockIdx.z; bz < gz; bz += gridDim.z) {
                gemm_tile<T, C>(b, x, y, V, I, J, N, SB, by * C::IT, bz * C::NT, vb, vx, vy);
                __syncthreads();   // the ring and partial sums are free for the next tile
            }
    }
}

// The tiles, by number.  This table is their only copy: ops/batched_gemm.py
// reads it from this file (CONFIGS) to pick one per shape.
//   X(number, IT, NT, RR, CC, JC, KS, MINB)
//  0 wide:   32 x 128, 4x4 a thread, J in 32s, 256 threads, 3 blocks an
//            SM asked of the registers (K3's main shape)
//  1 square: 32 x 32,  4x4, J in 64s, 64 threads (E1's main shape)
//  2 square, split J 4 ways: J in 4 x 32, 256 threads (few blocks)
//  3 narrow: 4 x 8, 2x2, J split 8 ways in 8s, 64 threads (I <= 4, N <= 8)
//  4 tall:   16 x 8, 4x2, J split 4 ways in 16s, 64 threads (I <= 16, N <= 8)
//  5 short:  4 x 32, 1x4, J in 4s, one warp, 32 blocks an SM (I <= 4, J <= 8,
//            N > 8: the kron gather's colour stage [V, 3, 3] @ [V, 3, 32],
//            which would leave most rows and values of J of a wider tile
//            idle)
#define SBT_GEMM_TILES(X)         \
    X(0, 32, 128, 4, 4, 32, 1, 3) \
    X(1, 32, 32, 4, 4, 64, 1, 1)  \
    X(2, 32, 32, 4, 4, 32, 4, 1)  \
    X(3, 4, 8, 2, 2, 8, 8, 1)     \
    X(4, 16, 8, 4, 2, 16, 4, 1)   \
    X(5, 4, 32, 1, 4, 4, 1, 32)

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Tiles over the 48 KB default of shared memory need an opt-in, which
// holds for the current device only: made once a device (the first
// kMaxDevices), and on every launch on any other.
constexpr int kMaxDevices = 64;

template <typename T, typename C, bool kWalk>
cudaError_t opt_in() {
    constexpr size_t BYTES = Layout<T, C>::BYTES;
    if constexpr (BYTES <= 48 * 1024) {
        return cudaSuccess;
    } else {
        static std::atomic<bool> done[kMaxDevices];
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        const bool known = dev < kMaxDevices;
        if (known && done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
        err = cudaFuncSetAttribute(gemm_kernel<T, C, kWalk>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(BYTES));
        if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_relaxed);
        return err;
    }
}

template <typename T, typename C, bool kWalk>
int launch_grid(dim3 grid, int64_t V, int I, int J, int N, int SB, int gy, int gz,
                const void* b, const void* x, void* y, cudaStream_t stream) {
    using L = Layout<T, C>;
    const cudaError_t opt = opt_in<T, C, kWalk>();
    if (opt != cudaSuccess) return static_cast<int>(opt);
    const bool vb = J % L::VK == 0 && aligned16(b);
    const bool vx = N % L::VK == 0 && aligned16(x);
    const bool vy = N % C::CC == 0 && aligned16(y);
    gemm_kernel<T, C, kWalk><<<grid, C::THREADS, L::BYTES, stream>>>(
        static_cast<const T*>(b), static_cast<const T*>(x), static_cast<T*>(y), V, I, J, N, SB,
        gy, gz, vb, vx, vy);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C>
int launch(int64_t V, int I, int J, int N, int SB, const void* b, const void* x, void* y,
           cudaStream_t stream) {
    const int64_t gx = (V + SB - 1) / SB;
    const int gy = (I + C::IT - 1) / C::IT, gz = (N + C::NT - 1) / C::NT;
    if (gx > 0x7fffffff) return cudaErrorInvalidConfiguration;
    constexpr int kMaxYZ = 65535;
    if (gy <= kMaxYZ && gz <= kMaxYZ)
        return launch_grid<T, C, false>(dim3(static_cast<unsigned>(gx), gy, gz), V, I, J, N,
                                        SB, gy, gz, b, x, y, stream);
    const dim3 grid(static_cast<unsigned>(gx), gy < kMaxYZ ? gy : kMaxYZ,
                    gz < kMaxYZ ? gz : kMaxYZ);
    return launch_grid<T, C, true>(grid, V, I, J, N, SB, gy, gz, b, x, y, stream);
}

template <typename T>
int run(int cfg, int64_t V, int I, int J, int N, int SB, const void* b, const void* x, void* y,
        cudaStream_t st) {
    switch (cfg) {
#define SBT_GEMM_CASE(n, IT, NT, RR, CC, JC, KS, MINB) \
    case n: return launch<T, Tile<IT, NT, RR, CC, JC, KS, MINB>>(V, I, J, N, SB, b, x, y, st);
        SBT_GEMM_TILES(SBT_GEMM_CASE)
#undef SBT_GEMM_CASE
        default: return cudaErrorInvalidValue;
    }
}

int run_any(int f64, int cfg, int64_t V, int I, int J, int N, int SB, const void* b,
            const void* x, void* y, void* stream) {
    if (V < 1 || I < 1 || J < 1 || N < 1 || SB < 1) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return f64 ? run<double>(cfg, V, I, J, N, SB, b, x, y, st)
               : run<float>(cfg, V, I, J, N, SB, b, x, y, st);
}

}  // namespace

extern "C" {

// K3: I, J <= 64; f64 selects double; cfg, sites as ops/batched_gemm.py
// small_tile picks them (sites: the sites a block walks).
int sbt_batched_gemm_small(int f64, int64_t V, int I, int J, int N, int cfg, int sites,
                           const void* b, const void* x, void* y, void* stream) {
    if (I > 64 || J > 64) return cudaErrorInvalidValue;
    return run_any(f64, cfg, V, I, J, N, sites, b, x, y, stream);
}

// E1: any shape; cfg, sites as ops/batched_gemm.py rowpack_tile picks them.
int sbt_batched_gemm_rowpack(int f64, int64_t V, int I, int J, int N, int cfg, int sites,
                             const void* b, const void* x, void* y, void* stream) {
    return run_any(f64, cfg, V, I, J, N, sites, b, x, y, stream);
}

}  // extern "C"
