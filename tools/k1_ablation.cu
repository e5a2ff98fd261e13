// The PR 1 design of the stencil kernel K1 at the Wilson and staggered
// shapes, for tools/k1_ablation.py: stencil_soa.cu's templated kernel
// (one thread a site and column, 64-bit coordinates, the spin factors
// as runtime values on all KD slots, blocks in flat site order) launched
// at (4, 4, 3, 3) and (1, 1, 3, 3), where the package's K1 now runs the
// tiled kernel of stencil_tiled.cu.  Built by the tool into its own
// library; the package does not build or call it.

#include "../superbblas_tpu_torch/csrc/stencil_soa.cu"

extern "C" {

// sbt_stencil_soa's arguments, at (4, 4, 3, 3) or (1, 1, 3, 3)
int sbt_k1_pr1(int ki, int kd, int bi, int bd, int pair, const void* b_re, const void* b_im,
               const void* k_re, const void* k_im, const void* x_re, const void* x_im,
               void* y_re, void* y_im, int n, int X, int Y, int Z, int T, int ndir,
               const int* offsets, int packed_parity, void* stream) {
    Dirs dirs{};
    const cudaError_t err = parse_dirs(ndir, offsets, packed_parity, &dirs);
    if (err != cudaSuccess) return err;
    const Operands a{b_re, b_im, k_re, k_im, x_re, x_im, y_re, y_im, n, X, Y, Z, T};
    return dispatch<LaunchK1, true>(ki, kd, bi, bd, pair, a, dirs,
                                    static_cast<cudaStream_t>(stream));
}

// registers and local bytes a thread of the PR 1 kernel at (ki, kd, 3, 3),
// f32/f32, and its resident blocks an SM at 256 threads (out[3])
int sbt_k1_pr1_attrs(int ki, int* out) {
    cudaFuncAttributes attr;
    const void* fn = ki == 4
        ? (const void*)stencil_soa_kernel<4, 4, 3, 3, float, float>
        : (const void*)stencil_soa_kernel<1, 1, 3, 3, float, float>;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 256,
                                                        2 * sizeof(float) * 9 * ki * ki);
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = blocks;
    return err;
}

}  // extern "C"
