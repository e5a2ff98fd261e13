// The per-site plan math of the SoA stencil kernels that run the kron's
// spin plan: K1's tiled route (stencil_tiled.cu) and the X-inside and
// X-streaming schedules (stencil_schedules.cu) at the Wilson (4, 4, 3, 3)
// and staggered (1, 1, 3, 3) shapes.
//
// The plan is ops/stencil.py kernel_plan: the TPU kernel's _factor_kron
// (superbblas_tpu/ops/stencil_pallas.py), one PlanDir a direction, built
// once per kron tensor and read by every thread with uniform loads:
//  * a factored direction K_d = R_d P_d of rank 2 (every Wilson hop at
//    r = 1) projects x onto two half-spinor slots with P_d, multiplies
//    them by the 3x3 colour block (18 complex FMAs, not 36), and adds R_d
//    times the result to the four output slots;
//  * a direct direction multiplies K_d's rows into x and the colour block
//    into those, in site_matvec's order of sums (stencil_soa.cuh), so where
//    no direction factors the kernels give the runtime route's bits.
// direction() is one direction of one column; its caller loads the colour
// block B_d(s) and hands it the neighbour's x as two pointers (re, im) and
// the stride between features, with kSh true where they point into shared
// memory (the schedules' staged lines and planes) and false where they
// point into device memory (K1, and the schedules' other neighbours).  The
// same inputs give the same bits in every kernel that calls it.

#pragma once

#include "stencil_soa.cuh"

namespace {

constexpr int kS = 4;   // spin slots a plan record holds (KI, KD <= 4)

// one direction of the plan, as ops/stencil.py _plan_dtype lays it out
template <typename A> struct PlanDir {
    int mode;     // 0: direct, 1: factored
    int rank;     // factored: rows of P_d (1 or 2)
    int slots;    // sparse form: x slot of term k in bits 4k..4k+3
    int rslots;   // sparse form: slot of g that R row a takes, bits 4a..4a+3
    A k[2][kS][kS];   // (re, im) of K_d (direct) or of P_d in rows < rank
    A r[2][kS][2];    // (re, im) of R_d (factored)
    A t[2][kS];       // sparse form: coefficient of term k (1 for 2c in a factored one)
    A q[2][kS];       // sparse form: coefficient of R row a
};
static_assert(sizeof(PlanDir<float>) == 272, "ops/stencil.py PLAN_DIR_BYTES");
static_assert(sizeof(PlanDir<double>) == 528, "ops/stencil.py PLAN_DIR_BYTES");

// a launch's directions as site steps on the lattice (X, Y, Z, T), T
// fastest: for direction d the coordinate whose step wraps and the flat
// offsets of the step and of the wrapped step
struct Hops {
    int ndir;
    int packed;             // checkerboard parity of packed operands; -1: none
    int axis[kMaxDirs];     // 0..3 for X, Y, Z, T; -1 for the centre
    int edge[kMaxDirs];     // the coordinate along axis whose step wraps
    int step[kMaxDirs];     // flat-site offset of the step
    int wrap[kMaxDirs];     // flat-site offset of the wrapped step
};

// the lattice's site strides fit in 32 bits (the kernels take lattices
// under 2^31 values a column's field)
inline Hops make_hops(const Dirs& dirs, int X, int Y, int Z, int T) {
    Hops h{};
    h.ndir = dirs.ndir;
    h.packed = dirs.packed;
    for (int d = 0; d < dirs.ndir; ++d) {
        const int ax = dirs.sign[d] == 0 ? -1 : dirs.axis[d], sg = dirs.sign[d];
        h.axis[d] = ax;
        if (ax < 0) continue;
        const int L = ax == 0 ? X : ax == 1 ? Y : ax == 2 ? Z : T;
        const int st = ax == 0 ? Y * Z * T : ax == 1 ? Z * T : ax == 2 ? T : 1;
        h.edge[d] = sg > 0 ? L - 1 : 0;
        h.step[d] = sg * st;
        h.wrap[d] = -sg * (L - 1) * st;
    }
    return h;
}

// a line of device memory into L2, with no register and no wait
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// four consecutive plan values (16-byte aligned) in one or two loads
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// acc[a*BI+i] += sum_j B[i, j] z[a][j] for rows a < NA, in site_matvec's
// order (one chain a sum over d, then j)
template <int NA, int BI, int BD, typename A>
__device__ __forceinline__ void colour_into(const A (&br)[BI * BD], const A (&bi)[BI * BD],
                                            const A (&zr)[NA][BD], const A (&zi)[NA][BD],
                                            A (&acc_re)[NA * BI], A (&acc_im)[NA * BI]) {
#pragma unroll
    for (int i = 0; i < BI; ++i) {
#pragma unroll
        for (int j = 0; j < BD; ++j) {
#pragma unroll
            for (int a = 0; a < NA; ++a) {
                A& ar = acc_re[a * BI + i];
                A& ai = acc_im[a * BI + i];
                ar = fma_a(br[i * BD + j], zr[a][j], ar);
                ar = fma_a(-bi[i * BD + j], zi[a][j], ar);
                ai = fma_a(br[i * BD + j], zi[a][j], ai);
                ai = fma_a(bi[i * BD + j], zr[a][j], ai);
            }
        }
    }
}

// g[c][i] = sum_j B[i, j] h[c][j] for c < 2 (a chain from zero)
template <int BI, int BD, typename A>
__device__ __forceinline__ void colour_half(const A (&br)[BI * BD], const A (&bi)[BI * BD],
                                            const A (&hr)[2][BD], const A (&hi)[2][BD],
                                            A (&gr)[2][BI], A (&gi)[2][BI]) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int i = 0; i < BI; ++i) {
            A r = A(0), m = A(0);
#pragma unroll
            for (int j = 0; j < BD; ++j) {
                r = fma_a(br[i * BD + j], hr[c][j], r);
                r = fma_a(-bi[i * BD + j], hi[c][j], r);
                m = fma_a(br[i * BD + j], hi[c][j], m);
                m = fma_a(bi[i * BD + j], hr[c][j], m);
            }
            gr[c][i] = r;
            gi[c][i] = m;
        }
    }
}

// (zr, zi) = sum over the terms of (cr + i ci) (vr + i vi), a chain from zero
template <typename A>
__device__ __forceinline__ void cmac(A cr, A ci, A vr, A vi, A& zr, A& zi) {
    zr = fma_a(cr, vr, zr);
    zr = fma_a(-ci, vi, zr);
    zi = fma_a(cr, vi, zi);
    zi = fma_a(ci, vr, zi);
}

// the sparse form's four terms of x of one direction of one column, read
// at the plan's slots (xp: the column's x at the neighbour site)
template <int BD, bool kSh, typename FT, typename A>
__device__ __forceinline__ void sparse_terms(const PlanDir<A>* __restrict__ p, const FT* xr,
                                             const FT* xi, int V, A (&vr)[kS][BD],
                                             A (&vi)[kS][BD]) {
    const int slots = __ldg(&p->slots);
#pragma unroll
    for (int k = 0; k < kS; ++k) {
        const int off = ((slots >> (4 * k)) & 15) * BD * V;
#pragma unroll
        for (int j = 0; j < BD; ++j) {
            vr[k][j] = load_x<kSh>(xr + (off + j * V));
            vi[k][j] = load_x<kSh>(xi + (off + j * V));
        }
    }
}

// the sparse form's sums of one direction of one column at (4, 4, 3, 3)
// on its terms v
template <int BI, int BD, typename A>
__device__ __forceinline__ void sparse_apply(const PlanDir<A>* __restrict__ p,
                                             const A (&vr)[kS][BD], const A (&vi)[kS][BD],
                                             const A (&br)[BI * BD], const A (&bi)[BI * BD],
                                             A (&acc_re)[kS * BI], A (&acc_im)[kS * BI]) {
    const int4 head = __ldg(reinterpret_cast<const int4*>(p));   // mode, rank, slots, rslots
    const int mode = head.x;
    A tr[kS], ti[kS];
    load4(p->t[0], tr);
    load4(p->t[1], ti);
    if (mode == 0) {
        // direct, one entry a row: z[a] = t_a x[slot a]
        A zr[kS][BD], zi[kS][BD];
#pragma unroll
        for (int a = 0; a < kS; ++a) {
#pragma unroll
            for (int j = 0; j < BD; ++j) {
                zr[a][j] = zi[a][j] = A(0);
                cmac(tr[a], ti[a], vr[a][j], vi[a][j], zr[a][j], zi[a][j]);
            }
        }
        colour_into<kS, BI, BD>(br, bi, zr, zi, acc_re, acc_im);
        return;
    }
    // factored: h[c] = x[slot 2c] + t_2c+1 x[slot 2c+1] (P's rows scaled to
    // a first coefficient of 1), the colour block on the two slots, then
    // acc[a] += q_a g[rslot a] (q scaled back)
    const int rslots = head.w;
    A hr[2][BD], hi[2][BD];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int j = 0; j < BD; ++j) {
            hr[c][j] = vr[2 * c][j];
            hi[c][j] = vi[2 * c][j];
            cmac(tr[2 * c + 1], ti[2 * c + 1], vr[2 * c + 1][j], vi[2 * c + 1][j], hr[c][j],
                 hi[c][j]);
        }
    }
    A gr[2][BI], gi[2][BI];
    colour_half<BI, BD>(br, bi, hr, hi, gr, gi);
    A qr[kS], qi[kS];
    load4(p->q[0], qr);
    load4(p->q[1], qi);
#pragma unroll
    for (int a = 0; a < kS; ++a) {
        const bool second = ((rslots >> (4 * a)) & 15) != 0;
#pragma unroll
        for (int i = 0; i < BI; ++i)
            cmac(qr[a], qi[a], second ? gr[1][i] : gr[0][i], second ? gi[1][i] : gi[0][i],
                 acc_re[a * BI + i], acc_im[a * BI + i]);
    }
}

// one direction of one column at (4, 4, 3, 3), sparse form
template <int BI, int BD, bool kSh, typename FT, typename A>
__device__ __forceinline__ void direction_sparse(const PlanDir<A>* __restrict__ p,
                                                 const FT* xr, const FT* xi, int V,
                                                 const A (&br)[BI * BD],
                                                 const A (&bi)[BI * BD],
                                                 A (&acc_re)[kS * BI],
                                                 A (&acc_im)[kS * BI]) {
    A vr[kS][BD], vi[kS][BD];
    sparse_terms<BD, kSh>(p, xr, xi, V, vr, vi);
    sparse_apply<BI, BD>(p, vr, vi, br, bi, acc_re, acc_im);
}

// one direction of one column at (4, 4, 3, 3), dense form: K_d, or P_d and
// R_d, whole (every kron)
template <int BI, int BD, bool kSh, typename FT, typename A>
__device__ __forceinline__ void direction_dense(const PlanDir<A>* __restrict__ p,
                                                const FT* xr, const FT* xi, int V,
                                                const A (&br)[BI * BD],
                                                const A (&bi)[BI * BD],
                                                A (&acc_re)[kS * BI], A (&acc_im)[kS * BI]) {
    const int mode = __ldg(&p->mode);
    A vr[kS][BD], vi[kS][BD];
#pragma unroll
    for (int b = 0; b < kS; ++b) {
#pragma unroll
        for (int j = 0; j < BD; ++j) {
            vr[b][j] = load_x<kSh>(xr + (b * BD + j) * V);
            vi[b][j] = load_x<kSh>(xi + (b * BD + j) * V);
        }
    }
    if (mode == 0) {
        // direct: z[a][j] = sum_b K_d[a, b] x[b*BD + j], site_matvec's order
        A zr[kS][BD], zi[kS][BD];
#pragma unroll
        for (int a = 0; a < kS; ++a) {
#pragma unroll
            for (int j = 0; j < BD; ++j) {
                zr[a][j] = zi[a][j] = A(0);
#pragma unroll
                for (int b = 0; b < kS; ++b)
                    cmac(__ldg(&p->k[0][a][b]), __ldg(&p->k[1][a][b]), vr[b][j], vi[b][j],
                         zr[a][j], zi[a][j]);
            }
        }
        colour_into<kS, BI, BD>(br, bi, zr, zi, acc_re, acc_im);
        return;
    }
    // factored: h[c] = P_d[c, :] x (rows of P past the rank are zero)
    A hr[2][BD], hi[2][BD];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int j = 0; j < BD; ++j) {
            hr[c][j] = hi[c][j] = A(0);
#pragma unroll
            for (int b = 0; b < kS; ++b)
                cmac(__ldg(&p->k[0][c][b]), __ldg(&p->k[1][c][b]), vr[b][j], vi[b][j],
                     hr[c][j], hi[c][j]);
        }
    }
    A gr[2][BI], gi[2][BI];
    colour_half<BI, BD>(br, bi, hr, hi, gr, gi);
#pragma unroll
    for (int a = 0; a < kS; ++a) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const A qr = __ldg(&p->r[0][a][c]), qi = __ldg(&p->r[1][a][c]);
#pragma unroll
            for (int i = 0; i < BI; ++i)
                cmac(qr, qi, gr[c][i], gi[c][i], acc_re[a * BI + i], acc_im[a * BI + i]);
        }
    }
}

// one direction of one column at (1, 1, 3, 3): z = K_d x (K_d = 1 without
// a kron), as site_matvec sums it, then the colour block
template <int BI, int BD, bool kSh, typename FT, typename A>
__device__ __forceinline__ void direction_one(const PlanDir<A>* __restrict__ p, const FT* xr,
                                              const FT* xi, int V, const A (&br)[BI * BD],
                                              const A (&bi)[BI * BD], A (&acc_re)[BI],
                                              A (&acc_im)[BI]) {
    A zr[1][BD], zi[1][BD];
#pragma unroll
    for (int j = 0; j < BD; ++j) {
        const A vr = load_x<kSh>(xr + j * V), vi = load_x<kSh>(xi + j * V);
        if (p == nullptr) {
            zr[0][j] = vr;
            zi[0][j] = vi;
        } else {
            zr[0][j] = zi[0][j] = A(0);
            cmac(__ldg(&p->k[0][0][0]), __ldg(&p->k[1][0][0]), vr, vi, zr[0][j], zi[0][j]);
        }
    }
    colour_into<1, BI, BD>(br, bi, zr, zi, acc_re, acc_im);
}

// one direction of one column in the form the shape and the plan take (x
// at xr, xi with feature stride V; kSh: in shared memory)
template <int KI, int BI, int BD, bool kSparse, bool kSh, typename FT, typename A>
__device__ __forceinline__ void direction(const PlanDir<A>* __restrict__ plan, int d,
                                          const FT* xr, const FT* xi, int V,
                                          const A (&br)[BI * BD], const A (&bi)[BI * BD],
                                          A (&acc_re)[KI * BI], A (&acc_im)[KI * BI]) {
    if constexpr (KI == 1)
        direction_one<BI, BD, kSh>(plan == nullptr ? nullptr : plan + d, xr, xi, V, br, bi,
                                   acc_re, acc_im);
    else if constexpr (kSparse)
        direction_sparse<BI, BD, kSh>(plan + d, xr, xi, V, br, bi, acc_re, acc_im);
    else
        direction_dense<BI, BD, kSh>(plan + d, xr, xi, V, br, bi, acc_re, acc_im);
}

}  // namespace
