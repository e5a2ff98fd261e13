"""Wilson-Dirac lattice operator and its normal-equation CG solve
(counterpart of ``superbblas_tpu/models/wilson.py``).

    D x (s) = (m + 4 r) x(s)
              - 1/2 sum_mu [ (r - gamma_mu) (x) U_mu(s)      x(s + mu)
                           + (r + gamma_mu) (x) U_mu(s-mu)^H x(s - mu) ]

is built as a Kronecker-factored stencil operator: spin factors shared
across sites, per-site colour links, in the SoA layout (the stencil
kernel's) or the AoS one (label order, applied through ``bsr_krylov``;
the default, as in the JAX package).  Links and gammas are made on the
host in numpy, with the same code as the JAX package; the blocks are
formed from them on the operator's device with the same exact
operations, so one seed gives bit-identical operators in both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import cplx
from ..bsr import (BSROperator, apply_stencil_soa, bsr_cast_storage, bsr_from_stencil,
                   bsr_krylov)
from ..cplx import CArray
from ..labels import volume
from ..ops._guard import is_sharded
from ..ops.stencil import derive_kron

__all__ = ["gamma_matrices", "random_su3_links", "wilson_offsets", "wilson_operator",
           "apply_wilson", "adjoint_operator", "apply_wilson_dagger",
           "cg_step", "cg_solve", "twisted_mass_operator"]

NS = 4  # spin components
NC = 3  # colours


def _seed_from_key(key) -> int:
    """numpy seed of a model constructor's ``key``: 0 for None, else the
    integer (JAX PRNG keys are the JAX package's alone)."""
    return 0 if key is None else int(key)


def gamma_matrices() -> np.ndarray:
    """Euclidean gamma matrices (DeGrand-Rossi basis), numpy [4, 4, 4]."""
    g = np.zeros((4, NS, NS), dtype=np.complex128)
    g[0] = [[0, 0, 0, 1j], [0, 0, 1j, 0], [0, -1j, 0, 0], [-1j, 0, 0, 0]]
    g[1] = [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]
    g[2] = [[0, 0, 1j, 0], [0, 0, 0, -1j], [-1j, 0, 0, 0], [0, 1j, 0, 0]]
    g[3] = [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]]
    return g


def gamma5() -> np.ndarray:
    """gamma5 = g0 g1 g2 g3, diag(1, 1, -1, -1) in this (chiral) basis."""
    g = gamma_matrices()
    return g[0] @ g[1] @ g[2] @ g[3]


def random_su3_links(rng: np.random.Generator, lat_dims) -> np.ndarray:
    """Random unitary gauge links U[mu, *lat, 3, 3] (host-side QR of a
    Gaussian; U(3) rather than SU(3), fine for benchmarks)."""
    shape = (len(lat_dims),) + tuple(lat_dims) + (NC, NC)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    q, r = np.linalg.qr(a)
    d = np.einsum("...ii->...i", r)
    q = q * (d / np.abs(d)).conj()[..., None, :]
    return q


def links_tensor(links, device) -> torch.Tensor:
    """numpy links [nd, *lat, 3, 3] (or a tensor of them) as a complex128
    tensor on ``device``:
    the operators' blocks are formed there, with the JAX package's exact
    operations (copies, rolls, conjugates, multiples by +-1/2), so they
    equal its host numpy blocks bit for bit."""
    if isinstance(links, torch.Tensor):
        return links.to(device=device, dtype=torch.complex128)
    return torch.as_tensor(np.asarray(links), dtype=torch.complex128, device=device)


def link_dagger_behind(U: torch.Tensor, mu: int) -> torch.Tensor:
    """U_mu(s - mu)^H: the link field shifted by +mu, conjugate-transposed."""
    return torch.roll(U[mu], 1, dims=mu).transpose(-1, -2).conj()


def real_parts(blocks: torch.Tensor, dtype) -> CArray:
    """Split-complex parts of complex128 ``blocks`` in ``dtype``'s part
    precision (complex64 -> float32, complex128 -> float64)."""
    part_dt = torch.float32 if dtype == torch.complex64 else torch.float64
    return CArray(blocks.real.to(part_dt), blocks.imag.to(part_dt))


def wilson_offsets(nd: int = 4):
    """The Wilson stencil's offsets: the centre, then +mu and -mu for
    each axis mu."""
    return [(0,) * nd] + [tuple(s if a == mu else 0 for a in range(nd))
                          for mu in range(nd) for s in (1, -1)]


def wilson_operator(
    lat_dims: Tuple[int, ...],
    mass: float = 0.1,
    r: float = 1.0,
    key: Optional[int] = None,
    dtype=torch.complex64,
    links: Optional[np.ndarray] = None,
    layout: str = "aos",
    storage_dtype=None,
    device="cuda",
) -> BSROperator:
    """Build the Wilson operator as a split-complex Kron-BSR stencil.

    ``key`` seeds numpy's generator for the links (None: 0).  ``dtype``
    picks precision: complex64 -> float32 parts, complex128 -> float64.
    ``layout="aos"`` (the default, as in the JAX package) takes [*lat, NS,
    NC, ncols] fields through ``bsr_krylov``; ``layout="soa"`` runs the
    stencil kernel on SoA operands [ncols, 12, *lat] (the hot path).
    ``storage_dtype=torch.bfloat16`` stores the link blocks in bf16; the
    spin factors keep ``dtype``'s precision.  The operator is built on
    ``device``: the card unless the caller names the CPU."""
    nd = len(lat_dims)
    rng = np.random.default_rng(_seed_from_key(key))
    if links is None:
        links = random_su3_links(rng, lat_dims)  # [mu, *lat, c, c] complex128
    g = gamma_matrices()
    eye_s = np.eye(NS, dtype=np.complex128)
    U = links_tensor(links, device)
    eye_c = torch.eye(NC, dtype=torch.complex128, device=U.device).expand(
        tuple(lat_dims) + (NC, NC))

    offsets = wilson_offsets(nd)
    spin_factors = [(mass + r * nd) * eye_s]
    color_blocks = [eye_c]
    for mu in range(nd):
        spin_factors.append(-0.5 * (r * eye_s - g[mu]))
        color_blocks.append(U[mu])
        spin_factors.append(-0.5 * (r * eye_s + g[mu]))
        # U_mu(s - mu)^H : shift the link field then conjugate-transpose
        color_blocks.append(link_dagger_behind(U, mu))
    del U

    part_dt = np.float32 if dtype == torch.complex64 else np.float64
    kron = np.stack(spin_factors, axis=0)
    lat_labels = "xyzt"[:nd]
    op = bsr_from_stencil(
        lat_labels + "Sc", lat_labels + "SC",
        lat_dims, {"c": NC}, {"C": NC},
        offsets,
        real_parts(torch.stack(color_blocks, dim=nd), dtype),
        kron=CArray(kron.real.astype(part_dt), kron.imag.astype(part_dt)),
        kron_i={"S": NS}, kron_d={"S": NS},
        layout=layout, device=device,
    )
    if storage_dtype is not None:
        op = bsr_cast_storage(op, storage_dtype)
    return op


def apply_wilson(op: BSROperator, x):
    """y = D x.  SoA operators take [ncols, NS*NC, *lat] CArrays; AoS
    operators take [*lat, NS, NC, ncols] (CArray or complex)."""
    if op.mode == "stencil_soa":
        return apply_stencil_soa(op, x)
    return bsr_krylov(1.0, op, x, "xyzt"[:len(op.dim_d)] + "SCn")


def adjoint_operator(op: BSROperator) -> BSROperator:
    """The conjugate-transposed stencil operator: direction k's adjoint
    has offset -o_k and block A_k(s - o_k)^H.  Built anew on every call;
    callers that apply it repeatedly keep the result.  Sharded blocks
    (DTensors) stay sharded: a roll along a sharded lattice axis moves
    only the rolled edge between neighbouring ranks
    (``parallel.halo.roll_local``)."""
    bi, bd = volume(op.bi), volume(op.bd)
    nd = len(op.dim_d)
    lat = tuple(op.dim_i)
    roll, wrap = torch.roll, None
    if is_sharded(op.blocks_re):
        from ..parallel._local import from_local, local
        from ..parallel.halo import roll_local

        d = op.blocks_re
        mesh = d.device_mesh
        names = {p.dim: nm for nm, p in zip(mesh.mesh_dim_names, d.placements)
                 if p.is_shard()}

        def roll(a, shift, dims):
            return roll_local(a, shift, dims, names.get(dims), mesh)

        def wrap(a, like):
            return from_local(a, like)

    def adj_soa(a):
        ndir, FB = a.shape[0], a.shape[1]
        shp = tuple(a.shape[2:])
        a = a.reshape((ndir, bi, bd) + shp).transpose(1, 2)   # transpose block
        rows = []
        for k in range(ndir):
            blk = a[k]
            for ax, off in enumerate(op.offsets[k]):
                if off % lat[ax] != 0:
                    blk = roll(blk, off, 2 + ax)
            rows.append(blk)
        return torch.stack(rows, 0).reshape((ndir, FB) + shp)

    def adj_aos(a):
        a = a.transpose(-1, -2)                               # transpose block
        rows = []
        for k in range(op.ndir):
            blk = a[(slice(None),) * nd + (k,)]
            for ax, off in enumerate(op.offsets[k]):
                if off % lat[ax] != 0:
                    blk = roll(blk, off, ax)
            rows.append(blk)
        return torch.stack(rows, dim=nd)

    adj = adj_soa if op.mode == "stencil_soa" else adj_aos
    if wrap is not None:
        adj0 = adj

        def adj(a):
            return wrap(adj0(local(a).contiguous()), a)

    blocks = adj(op.blocks_re) if op.blocks_im is None else \
        CArray(adj(op.blocks_re), -adj(op.blocks_im))
    kron = op.kron
    if kron is not None:
        kron = kron.transpose(-1, -2).contiguous() if not cplx.is_carray(kron) else \
            CArray(kron.re.transpose(-1, -2).contiguous(),
                   -kron.im.transpose(-1, -2).contiguous())
        derive_kron(op.kron, kron, lambda re, im: (re.transpose(0, 2, 1).copy(),
                                                   -im.transpose(0, 2, 1)))
    return op.replace(blocks=blocks, kron=kron,
                      offsets=tuple(tuple(-o for o in off) for off in op.offsets))


def apply_wilson_dagger(op: BSROperator, x: CArray) -> CArray:
    """y = D^H x."""
    return apply_wilson(adjoint_operator(op), x)


def _inner(a, b):
    """Re <a, b> = sum(a.re*b.re + a.im*b.im), or sum(conj(a) b).real for
    plain tensors, as a 0-dim tensor on the operands' device."""
    if cplx.is_carray(a):
        return cplx.inner_real(a, b)
    return torch.sum(torch.conj(a) * b).real


def _zeros_like(x):
    return cplx.cmap(torch.zeros_like, x) if cplx.is_carray(x) else torch.zeros_like(x)


def _axpy(alpha, x, y):
    """y + alpha * x for a real 0-dim tensor alpha; CArrays or plain
    tensors."""
    if cplx.is_carray(x):
        return CArray(y.re + alpha * x.re, y.im + alpha * x.im)
    return y + alpha.to(x.dtype) * x


def cg_step(op: BSROperator, state, op_h: Optional[BSROperator] = None):
    """One CG-on-normal-equations iteration: two stencil matvecs, axpys
    and inner products.  ``op_h`` is the adjoint (built when None).  The
    scalars stay 0-dim tensors on the device."""
    x, rr, p, rs = state
    if op_h is None:
        op_h = adjoint_operator(op)
    ap = apply_wilson(op_h, apply_wilson(op, p))
    alpha = rs / torch.clamp_min(cplx.inner_real(p, ap), 1e-30)
    x = _axpy(alpha, p, x)
    rr = _axpy(-alpha, ap, rr)
    rs_new = cplx.inner_real(rr, rr)
    beta = rs_new / torch.clamp_min(rs, 1e-30)
    p = _axpy(beta, p, rr)
    return (x, rr, p, rs_new)


def cg_solve(op: BSROperator, b: CArray, n_iters: int = 10, tol: float = 0.0):
    """Conjugate gradient on the normal equations D^H D x = D^H b, from
    x = 0, for ``n_iters`` iterations.  Returns (x, |r|^2).  Makes
    1 + 2 * n_iters stencil matvecs.  ``tol`` is accepted and unused, as
    in the JAX package: the iteration count is fixed."""
    op_h = adjoint_operator(op)
    rhs = apply_wilson(op_h, b)
    state = (cplx.cmap(torch.zeros_like, b), rhs, rhs, cplx.inner_real(rhs, rhs))
    for _ in range(n_iters):
        state = cg_step(op, state, op_h)
    return state[0], state[3]


def twisted_mass_operator(
    lat_dims: Tuple[int, ...],
    mass: float = 0.1,
    mu: float = 0.05,
    r: float = 1.0,
    key: Optional[int] = None,
    dtype=torch.complex64,
    links: Optional[np.ndarray] = None,
    layout: str = "aos",
    device="cuda",
) -> BSROperator:
    """Twisted-mass Wilson operator D_tm = D_W + i mu gamma5 (x) 1.

    The twist is site-local and spin-diagonal, so it is added to the
    centre direction's spin factor (index 0): the operator stays one
    Kron-BSR stencil and runs the Wilson kernel with a complex centre
    factor.  The spin factors are a new tensor; ``op``'s are not edited.
    Same arguments as :func:`wilson_operator` (``layout="aos"`` by
    default, as in the JAX package)."""
    if len(lat_dims) != 4:
        raise ValueError("the gamma5 twist is defined on a 4D lattice")
    op = wilson_operator(lat_dims, mass=mass, r=r, key=key, dtype=dtype, links=links,
                         layout=layout, device=device)
    tw = 1j * mu * gamma5()
    kron = op.kron
    re, im = kron.re.clone(), kron.im.clone()
    re[0] += torch.as_tensor(tw.real, dtype=re.dtype, device=re.device)
    im[0] += torch.as_tensor(tw.imag, dtype=im.dtype, device=im.device)

    def twist(hre, him):
        """the same sums on the host, in the parts' dtype"""
        hre, him = hre.copy(), him.copy()
        hre[0] += tw.real.astype(hre.dtype)
        him[0] += tw.imag.astype(him.dtype)
        return hre, him

    derive_kron(kron, CArray(re, im), twist)
    return op.replace(kron=CArray(re, im))
