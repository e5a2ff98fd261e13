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
// such unit to fill with f32, so it is not carried over.  Both kernels
// here run f32 (or f64) fused multiply-adds on the CUDA cores and sum each
// output over j in ascending order: TF32 tensor-core products would lose
// the digits that Precision.HIGHEST keeps (3xTF32 is redesign work).
//
// What bounds them on the H100: bytes, at the coarse operator's shapes.
// At [4096, 32, 288] x [4096, 288, 32] f32 the function reads b and x once
// and writes y once, 318.8 MB, 0.0952 ms at 3.35 TB/s; its 2.42 GFLOP take
// 0.0361 ms at 67 TFLOP/s.  At [8192, 32, 32] x [8192, 32, 128], 302 MB,
// 0.0902 ms (0.032 ms of FLOPs).
//
// What the designs do about it: every element of b and x is read from
// device memory once (coalesced, consecutive threads on consecutive
// addresses) into shared memory, and every output is written once.  Each
// thread owns one column c of RR = 4, 8 or 16 consecutive rows of one
// site, accumulated in registers: one shared load of x[j][c] feeds RR
// fused multiply-adds, and the RR loads of b are broadcasts (the lanes of
// a warp share rows and differ in c; b's rows are padded to an odd length
// so that distinct rows fall in distinct banks).
//  * K3 (sbt_batched_gemm_small): a block holds the whole b[v] of S sites
//    and a [J, NT] tile of their x[v] (NT <= 128 columns), one barrier,
//    then one pass over J.
//  * E1 (sbt_batched_gemm_rowpack): a block owns up to 128 rows (IT <= 32
//    rows of each of S sites: 4 sites x 32 rows at the probe's shape, up
//    to 32 sites x 4 rows at I = 4) and NT <= 32 columns, and streams J
//    through shared memory in chunks of JC <= 32.
// Both wrappers pack fewer sites into a block where V is small, so that a
// launch keeps two blocks an SM: a block's loads are serial rounds of
// memory latency, and a few blocks of many sites leave the card waiting.
// Ragged V, I, J and N are masked (E1 pads a chunk with zeros in shared
// memory but sums only over the real j).  The kernels are bound by
// shared-memory issue (about one load per fused multiply-add) before the
// bytes bound; register tiles of several columns a thread, cp.async
// double buffers and 3xTF32 tensor-core products are left to a later
// redesign.
//
// Plain C interface (loaded with ctypes); each call returns the
// cudaError_t of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// The work item of thread tid: column c of the RR rows g*RR .. g*RR+RR-1
// of site s, items ordered (s, g, c), c fastest; G row groups a site.
struct Item {
    int s, g, c;
    bool active;
};

__device__ __forceinline__ Item item_of(int tid, int S, int G, int NT) {
    Item it;
    it.active = tid < S * G * NT;
    const int w = it.active ? tid : 0;
    it.c = w % NT;
    it.g = (w / NT) % G;
    it.s = w / (NT * G);
    return it;
}

// acc[r] += sum over jj < jn of b_rows[r][jj] * x_col[jj * NT]: one shared
// load of x feeds RR fused multiply-adds, in ascending jj.
template <typename T, int RR>
__device__ __forceinline__ void accumulate(T (&acc)[RR], const T* __restrict__ bs,
                                           const int (&boff)[RR], const T* __restrict__ xs,
                                           int jn, int NT) {
    for (int jj = 0; jj < jn; ++jj) {
        const T xv = xs[jj * NT];
#pragma unroll
        for (int r = 0; r < RR; ++r) acc[r] = fma_t(bs[boff[r] + jj], xv, acc[r]);
    }
}

template <typename T, int RR>
__global__ void __launch_bounds__(kThreads)
small_kernel(const T* __restrict__ b, const T* __restrict__ x, T* __restrict__ y,
             int64_t V, int I, int J, int N, int S, int NT) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int JP = J | 1;
    T* bs = reinterpret_cast<T*>(smem_raw);          // [S][I][JP]
    T* xs = bs + static_cast<int64_t>(S) * I * JP;   // [S][J][NT]
    const int tid = threadIdx.x;
    const int64_t v0 = static_cast<int64_t>(blockIdx.x) * S;
    const int ns = static_cast<int>(V - v0 < S ? V - v0 : S);
    const int n0 = blockIdx.y * NT;
    const int nc = N - n0 < NT ? N - n0 : NT;

    const T* bg = b + v0 * I * J;
    const int IJ = I * J;
    for (int e = tid; e < ns * IJ; e += kThreads) {
        const int s = e / IJ, r = e - s * IJ;
        const int i = r / J, j = r - i * J;
        bs[(s * I + i) * JP + j] = bg[e];
    }
    const T* xg = x + v0 * J * N + n0;
    for (int e = tid; e < ns * J * NT; e += kThreads) {
        const int sj = e / NT, c = e - sj * NT;   // sj = s * J + j
        xs[e] = c < nc ? xg[static_cast<int64_t>(sj) * N + c] : T(0);
    }
    __syncthreads();

    const int G = (I + RR - 1) / RR;
    const Item it = item_of(tid, S, G, NT);
    int boff[RR];
    T acc[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
        const int i = it.g * RR + r;
        boff[r] = (it.s * I + (i < I ? i : I - 1)) * JP;   // rows past I: read, never written
        acc[r] = T(0);
    }
    accumulate<T, RR>(acc, bs, boff, xs + it.s * J * NT + it.c, J, NT);
    if (!it.active || it.s >= ns || it.c >= nc) return;
#pragma unroll
    for (int r = 0; r < RR; ++r) {
        const int i = it.g * RR + r;
        if (i < I) y[((v0 + it.s) * I + i) * N + n0 + it.c] = acc[r];
    }
}

template <typename T, int RR>
__global__ void __launch_bounds__(kThreads)
rowpack_kernel(const T* __restrict__ b, const T* __restrict__ x, T* __restrict__ y,
               int64_t V, int I, int J, int N, int S, int IT, int NT, int JC) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int JCP = JC | 1;
    T* bs = reinterpret_cast<T*>(smem_raw);   // [S][IT][JCP]
    T* xs = bs + S * IT * JCP;                // [S][JC][NT]
    const int tid = threadIdx.x;
    const int64_t v0 = static_cast<int64_t>(blockIdx.x) * S;
    const int ns = static_cast<int>(V - v0 < S ? V - v0 : S);
    const int i0 = blockIdx.y * IT;
    const int ni = I - i0 < IT ? I - i0 : IT;
    const int n0 = blockIdx.z * NT;
    const int nc = N - n0 < NT ? N - n0 : NT;

    const int G = (IT + RR - 1) / RR;
    const Item it = item_of(tid, S, G, NT);
    int boff[RR];
    T acc[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
        const int i = it.g * RR + r;
        boff[r] = (it.s * IT + (i < IT ? i : IT - 1)) * JCP;
        acc[r] = T(0);
    }
    const T* xcol = xs + it.s * JC * NT + it.c;
    for (int j0 = 0; j0 < J; j0 += JC) {
        const int jc = J - j0 < JC ? J - j0 : JC;
        for (int e = tid; e < S * IT * JC; e += kThreads) {
            const int si = e / JC, jj = e - si * JC;
            const int s = si / IT, i = si - s * IT;
            bs[si * JCP + jj] = (s < ns && i < ni && jj < jc)
                ? b[((v0 + s) * I + i0 + i) * J + j0 + jj] : T(0);
        }
        for (int e = tid; e < S * JC * NT; e += kThreads) {
            const int sj = e / NT, c = e - sj * NT;
            const int s = sj / JC, jj = sj - s * JC;
            xs[e] = (s < ns && jj < jc && c < nc)
                ? x[((v0 + s) * J + j0 + jj) * N + n0 + c] : T(0);
        }
        __syncthreads();
        accumulate<T, RR>(acc, bs, boff, xcol, jc, NT);
        __syncthreads();
    }
    if (!it.active || it.s >= ns || it.c >= nc) return;
#pragma unroll
    for (int r = 0; r < RR; ++r) {
        const int i = it.g * RR + r;
        if (i < ni) y[((v0 + it.s) * I + i0 + i) * N + n0 + it.c] = acc[r];
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

template <typename T, int RR>
int launch_small(int64_t V, int I, int J, int N, int S, int NT, const void* b,
                 const void* x, void* y, cudaStream_t stream) {
    const size_t smem = (static_cast<size_t>(S) * I * (J | 1) +
                         static_cast<size_t>(S) * J * NT) * sizeof(T);
    cudaError_t err = allow_smem(small_kernel<T, RR>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((V + S - 1) / S),
                    static_cast<unsigned>((N + NT - 1) / NT));
    small_kernel<T, RR><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(b), static_cast<const T*>(x), static_cast<T*>(y),
        V, I, J, N, S, NT);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int RR>
int launch_rowpack(int64_t V, int I, int J, int N, int S, int IT, int NT, int JC,
                   const void* b, const void* x, void* y, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(S) * (IT * (JC | 1) + JC * NT) * sizeof(T);
    cudaError_t err = allow_smem(rowpack_kernel<T, RR>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((V + S - 1) / S),
                    static_cast<unsigned>((I + IT - 1) / IT),
                    static_cast<unsigned>((N + NT - 1) / NT));
    rowpack_kernel<T, RR><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(b), static_cast<const T*>(x), static_cast<T*>(y),
        V, I, J, N, S, IT, NT, JC);
    return static_cast<int>(cudaGetLastError());
}

// Every (s, g, c) item of a block must have a thread.
bool items_fit(int S, int rows, int RR, int NT) {
    return static_cast<int64_t>(S) * ((rows + RR - 1) / RR) * NT <= kThreads;
}

}  // namespace

extern "C" {

// K3: f64 selects double; (S, NT, RR) as ops/batched_gemm.py small_tile
// picks them (RR = 4, 8 or 16 rows a thread).
int sbt_batched_gemm_small(int f64, int64_t V, int I, int J, int N, int S, int NT, int RR,
                           const void* b, const void* x, void* y, void* stream) {
    if (V < 1 || I < 1 || J < 1 || N < 1 || S < 1 || NT < 1 || !items_fit(S, I, RR, NT))
        return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SBT_SMALL(T, R) launch_small<T, R>(V, I, J, N, S, NT, b, x, y, st)
    switch (RR) {
        case 4: return f64 ? SBT_SMALL(double, 4) : SBT_SMALL(float, 4);
        case 8: return f64 ? SBT_SMALL(double, 8) : SBT_SMALL(float, 8);
        case 16: return f64 ? SBT_SMALL(double, 16) : SBT_SMALL(float, 16);
        default: return cudaErrorInvalidValue;
    }
#undef SBT_SMALL
}

// E1: (S, IT, NT, JC, RR) as ops/batched_gemm.py rowpack_tile picks them.
int sbt_batched_gemm_rowpack(int f64, int64_t V, int I, int J, int N, int S, int IT,
                             int NT, int JC, int RR, const void* b, const void* x, void* y,
                             void* stream) {
    if (V < 1 || I < 1 || J < 1 || N < 1 || S < 1 || IT < 1 || NT < 1 || JC < 1 ||
        !items_fit(S, IT, RR, NT))
        return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SBT_ROWPACK(T, R) launch_rowpack<T, R>(V, I, J, N, S, IT, NT, JC, b, x, y, st)
    switch (RR) {
        case 4: return f64 ? SBT_ROWPACK(double, 4) : SBT_ROWPACK(float, 4);
        case 8: return f64 ? SBT_ROWPACK(double, 8) : SBT_ROWPACK(float, 8);
        case 16: return f64 ? SBT_ROWPACK(double, 16) : SBT_ROWPACK(float, 16);
        default: return cudaErrorInvalidValue;
    }
#undef SBT_ROWPACK
}

}  // extern "C"
