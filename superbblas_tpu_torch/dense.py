"""Batched dense linear algebra: cholesky / trsm / gesm / inversion
(counterpart of ``superbblas_tpu/dense.py``).

Re-design of the reference's dense layer (``include/superbblas/dense.h``
in eromero-vlc/superbblas): label-driven batched factorizations where
``orows``/``ocols`` name the matrix axes and every other label is batch
(dense.h:1008-1160 public API; e.g. cholesky on "xyztscSC" with rows "sc"
and cols "SC" factorizes a 12x12 matrix per lattice site).  The reference
reorders data so each matrix is rank-local and calls LAPACK/cusolver
batched kernels (dense.h:504-569); here ``torch.linalg`` (LAPACK on the
CPU, cuSOLVER/cuBLAS batched on the card) runs on the operands' device,
as the JAX package runs its own linalg, outside any kernel of its own.

Sharded operands (DTensors, or CArrays of them): batch labels may be
sharded and matrix labels not (superbblas_tpu/dense.py states this
contract).  The ops run on each rank's local shards and return a DTensor
with the batch labels sharded as the operands had them; a sharded matrix
label, or two operands sharding one label differently, raises.

Split-complex support: the interleaved real embedding

    phi(a + ib) = [[a, -b], [b, a]]   (per element, 2x2 blocks)

is a *-homomorphism with phi(A^H) = phi(A)^T, and the complex Cholesky
factor's diagonal is real, so phi(L) is genuinely lower-triangular: by
uniqueness, chol(phi(A)) = phi(chol(A)), and the same argument covers
triangular and general solves.  Complex factorizations therefore run as
real ones at 2x the dimension, exactly as in the JAX package, so that
both round the same way.
"""

from __future__ import annotations

import torch

from . import cplx
from .labels import check_order, volume
from .ops.copy import _is_static, local_permute
from .utils.tracker import tracked as _tracked

__all__ = ["cholesky", "trsm", "gesm", "inversion"]


def _dtensor(t):
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    a = t.re if cplx.is_carray(t) else t
    return mod is not None and isinstance(a, mod.DTensor)


def _on_shards(call, operands, matrix: str, out_order: str):
    """Run ``call`` on the local shards of ``operands`` ((value, labels)
    pairs) and wrap its result (labels ``out_order``) as a DTensor whose
    batch labels are sharded as the operands shard them."""
    from .parallel._local import label_axes, local, wrap_labels

    axes, mesh, dims = {}, None, {}
    for v, o in operands:
        a = v.re if cplx.is_carray(v) else v
        dims.update({c: int(d) for c, d in zip(o, a.shape)})
        if not _dtensor(v):
            continue
        mesh = a.device_mesh if mesh is None else mesh
        for c, nm in label_axes(v, o).items():
            if c in matrix:
                raise ValueError(f"matrix label {c!r} is sharded over mesh axis {nm!r}: "
                                 "dense ops take sharded batch labels only")
            if axes.setdefault(c, nm) != nm:
                raise ValueError(f"label {c!r} is sharded over {axes[c]!r} and {nm!r}")
    for v, o in operands:
        if _dtensor(v):
            have = label_axes(v, o)
            miss = [c for c, nm in axes.items() if c in o and have.get(c) != nm]
            if miss:
                raise ValueError(f"labels {miss} are sharded on one operand only")
    out = call(*[local(v) for v, _ in operands])
    return wrap_labels(out, mesh, out_order, axes, tuple(dims[c] for c in out_order))


# ---------------------------------------------------------------------------
# interleaved real embedding
# ---------------------------------------------------------------------------


def embed_real(c: cplx.CArray) -> torch.Tensor:
    """[..., n, m] split-complex -> [..., 2n, 2m] interleaved real."""
    re, im = c.re, c.im
    *batch, n, m = re.shape
    # block[..., i, p, j, q] = re*I2[p,q] + im*J[p,q],  J = [[0,-1],[1,0]]
    eye2 = torch.tensor([[1.0, 0.0], [0.0, 1.0]], dtype=re.dtype, device=re.device)
    jmat = torch.tensor([[0.0, -1.0], [1.0, 0.0]], dtype=re.dtype, device=re.device)
    blocks = re[..., :, None, :, None] * eye2[:, None, :] \
        + im[..., :, None, :, None] * jmat[:, None, :]
    return blocks.reshape(*batch, 2 * n, 2 * m)


def extract_embedded(m2: torch.Tensor) -> cplx.CArray:
    """Inverse of embed_real."""
    return cplx.CArray(m2[..., ::2, ::2].contiguous(), m2[..., 1::2, ::2].contiguous())


# ---------------------------------------------------------------------------
# label plumbing
# ---------------------------------------------------------------------------


def _matrix_view(v, o: str, orows: str, ocols: str):
    """Permute/flatten to [batch..., R, C]; return (mat, restore_fn)."""
    check_order(o)
    for c in orows + ocols:
        if c not in o:
            raise ValueError(f"matrix label {c!r} not in order {o!r}")
    batch = "".join(c for c in o if c not in orows and c not in ocols)
    canon = batch + orows + ocols
    vm = local_permute(v, o, canon)
    shape = vm.shape
    nb = len(batch)
    bshape = shape[:nb]
    rshape = shape[nb:nb + len(orows)]
    cshape = shape[nb + len(orows):]
    R, C = volume(rshape), volume(cshape)
    if cplx.is_carray(vm):
        vm = cplx.cmap(lambda a: a.reshape(bshape + (R, C)), vm)
    else:
        vm = vm.reshape(bshape + (R, C))

    def restore(mat):
        if cplx.is_carray(mat):
            out = cplx.cmap(lambda a: a.reshape(bshape + rshape + cshape), mat)
        else:
            out = mat.reshape(bshape + rshape + cshape)
        return local_permute(out, canon, o)

    return vm, restore


def _hermitian_transpose(mat):
    if cplx.is_carray(mat):
        return cplx.conj(cplx.cmap(lambda a: a.transpose(-1, -2), mat))
    mat = mat.transpose(-1, -2)
    return mat.conj_physical() if mat.is_complex() else mat


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------


@_tracked("cholesky")
def cholesky(v, o: str, orows: str, ocols: str):
    """Batched Cholesky factorization (public cholesky, dense.h:1020/1161).

    Factorizes the Hermitian positive-definite matrix formed by
    (orows x ocols) per batch point and returns the *upper* triangular
    factor U with A = U^H U (the reference documents returning the upper
    triangular matrix).
    """
    if _dtensor(v):
        return _on_shards(lambda lv: cholesky(lv, o, orows, ocols), [(v, o)],
                          orows + ocols, o)
    mat, restore = _matrix_view(v, o, orows, ocols)
    if cplx.is_carray(mat):
        l2 = torch.linalg.cholesky(embed_real(mat))
        low = extract_embedded(l2)
    else:
        low = torch.linalg.cholesky(mat)
    return restore(_hermitian_transpose(low))


@_tracked("trsm")
def trsm(alpha, c, oc: str, orows: str, ocols: str, x, ox: str, oy: str):
    """Batched triangular solve (public trsm, dense.h:1055).

    ``c`` is an upper-triangular factor (as returned by :func:`cholesky`)
    with matrix labels (orows x ocols).  ``x`` shares the row labels; the
    result carries the column labels instead:

        sum_cols C[rows, cols] y[cols, ...] = alpha x[rows, ...]

    i.e. y = alpha * C^{-1} x contracted by label.
    """
    if _dtensor(c) or _dtensor(x):
        return _on_shards(lambda lc, lx: trsm(alpha, lc, oc, orows, ocols, lx, ox, oy),
                          [(c, oc), (x, ox)], orows + ocols, oy)
    cm, _ = _matrix_view(c, oc, orows, ocols)
    # x: batch labels of c that appear in ox stay batch; the row labels are
    # contracted; remaining x labels are the rhs columns.
    batch = "".join(ch for ch in oc if ch not in orows and ch not in ocols)
    xcols = "".join(ch for ch in ox if ch not in orows and ch not in batch)
    canon_x = "".join(ch for ch in batch if ch in ox) + orows + xcols
    xm = local_permute(x, ox, canon_x)
    nb = len([ch for ch in batch if ch in ox])
    bshape = xm.shape[:nb]
    rshape = xm.shape[nb:nb + len(orows)]
    nshape = xm.shape[nb + len(orows):]
    R, N = volume(rshape), volume(nshape)
    xm = (cplx.cmap(lambda a: a.reshape(bshape + (R, N)), xm)
          if cplx.is_carray(xm) else xm.reshape(bshape + (R, N)))

    if cplx.is_carray(cm) or cplx.is_carray(xm):
        cm = cm if cplx.is_carray(cm) else cplx.CArray(cm, torch.zeros_like(cm))
        xm = xm if cplx.is_carray(xm) else cplx.CArray(xm, torch.zeros_like(xm))
        c2 = embed_real(cm)                      # scalar-upper-triangular
        # embed the rhs by interleaving its rows: x2[2r] = re, x2[2r+1] = im
        x2 = torch.stack([xm.re, xm.im], dim=-2).reshape(
            *xm.re.shape[:-2], 2 * R, N)
        y2 = torch.linalg.solve_triangular(c2, x2, upper=True)
        ym = cplx.CArray(
            y2.reshape(*xm.re.shape[:-2], R, 2, N)[..., 0, :],
            y2.reshape(*xm.re.shape[:-2], R, 2, N)[..., 1, :],
        )
    else:
        ym = torch.linalg.solve_triangular(cm, xm, upper=True)
    if not (_is_static(alpha) and alpha == 1):
        ym = cplx.scale(alpha, ym)

    # rebuild with cols labels in place of rows labels
    canon_y = "".join(ch for ch in batch if ch in ox) + ocols + xcols
    cshape = tuple(c.shape[oc.index(ch)] for ch in ocols)
    out = (cplx.cmap(lambda a: a.reshape(bshape + cshape + nshape), ym)
           if cplx.is_carray(ym) else ym.reshape(bshape + cshape + nshape))
    return local_permute(out, canon_y, oy)


@_tracked("gesm")
def gesm(alpha, a, oa: str, orows: str, ocols: str, x, ox: str, oy: str):
    """Batched general solve (public gesm, dense.h:1099): y with
    A[rows, cols] y[cols, ...] = alpha x[rows, ...] via LU."""
    if _dtensor(a) or _dtensor(x):
        return _on_shards(lambda la, lx: gesm(alpha, la, oa, orows, ocols, lx, ox, oy),
                          [(a, oa), (x, ox)], orows + ocols, oy)
    am, _ = _matrix_view(a, oa, orows, ocols)
    batch = "".join(ch for ch in oa if ch not in orows and ch not in ocols)
    xcols = "".join(ch for ch in ox if ch not in orows and ch not in batch)
    canon_x = "".join(ch for ch in batch if ch in ox) + orows + xcols
    xm = local_permute(x, ox, canon_x)
    nb = len([ch for ch in batch if ch in ox])
    bshape = xm.shape[:nb]
    rshape = xm.shape[nb:nb + len(orows)]
    nshape = xm.shape[nb + len(orows):]
    R, N = volume(rshape), volume(nshape)
    xm = (cplx.cmap(lambda v: v.reshape(bshape + (R, N)), xm)
          if cplx.is_carray(xm) else xm.reshape(bshape + (R, N)))

    if cplx.is_carray(am) or cplx.is_carray(xm):
        am = am if cplx.is_carray(am) else cplx.CArray(am, torch.zeros_like(am))
        xm = xm if cplx.is_carray(xm) else cplx.CArray(xm, torch.zeros_like(xm))
        a2 = embed_real(am)
        x2 = torch.stack([xm.re, xm.im], dim=-2).reshape(
            *xm.re.shape[:-2], 2 * R, N)
        y2 = torch.linalg.solve(a2, x2)
        ym = cplx.CArray(
            y2.reshape(*xm.re.shape[:-2], R, 2, N)[..., 0, :],
            y2.reshape(*xm.re.shape[:-2], R, 2, N)[..., 1, :],
        )
    else:
        ym = torch.linalg.solve(am, xm)
    if not (_is_static(alpha) and alpha == 1):
        ym = cplx.scale(alpha, ym)

    canon_y = "".join(ch for ch in batch if ch in ox) + ocols + xcols
    cshape = tuple(a.shape[oa.index(ch)] for ch in ocols)
    out = (cplx.cmap(lambda v: v.reshape(bshape + cshape + nshape), ym)
           if cplx.is_carray(ym) else ym.reshape(bshape + cshape + nshape))
    return local_permute(out, canon_y, oy)


@_tracked("inversion")
def inversion(v, o: str, orows: str, ocols: str):
    """Batched matrix inversion (public inversion, dense.h:1134)."""
    if _dtensor(v):
        return _on_shards(lambda lv: inversion(lv, o, orows, ocols), [(v, o)],
                          orows + ocols, o)
    mat, restore = _matrix_view(v, o, orows, ocols)
    if cplx.is_carray(mat):
        inv2 = torch.linalg.inv(embed_real(mat))
        return restore(extract_embedded(inv2))
    return restore(torch.linalg.inv(mat))
