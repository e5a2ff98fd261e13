"""Domain-wall fermions, Shamir and Moebius (counterpart of
``superbblas_tpu/models/domain_wall.py``).

Shamir domain-wall fermions extend the Wilson operator with a fifth
dimension of extent Ls whose chiral-projector couplings carry the quark
mass at the walls:

    (D_dw psi)_s = (5 - M5) psi_s + D_W-hopping psi_s
                   - P_- psi_{s+1} - P_+ psi_{s-1}

with P_+- = (1 +- gamma5)/2 and the s5 wrap links scaled by -m_f.
Moebius (Brower-Neff-Orginos) generalises it to
D_M = (b5 D_W + 1) delta_ss' + (c5 D_W - 1) Lambda_ss'.

Two layouts:

* SoA (:class:`DomainWallSoAOperator`, ``layout="soa"``, the hot path):
  the 4-D hopping does not depend on s, so Ls
  folds into the stencil kernel's columns (fields [ncols, Ls, 12, *lat]
  reshaped to [ncols*Ls, 12, *lat], K1 at (4, 4, 3, 3)); the s5 terms are
  elementwise, the projectors being diagonal in the chiral basis
  (gamma5 = diag(1, 1, -1, -1)): one pass over the field each
  (``ops/dw_s5.py``, a CUDA kernel on the card).
* AoS (the default, as in the JAX package): a 5-D stencil on (s, x, y,
  z, t) with full 12x12 blocks, Shamir
  with 11 offsets (one batched product of J = 132: E1), Moebius with 27,
  16 of them corners (J = 324: E1).

The defining symmetry Gamma5 R5 D R5 Gamma5 = D^H (R5 reflects s -> Ls-1-s)
holds for Shamir; the two projector orderings of Moebius are its adjoint
partners.  The blocks are made on the host in numpy, with the JAX
package's code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import cplx
from ..bsr import BSROperator, apply_stencil_soa, bsr_from_stencil, bsr_krylov
from ..cplx import CArray
from ..labels import volume
from ..ops import dw_s5 as S5
from ..ops._guard import is_sharded
from ..utils import tracker
from .wilson import NC, NS, _seed_from_key, gamma5, gamma_matrices, random_su3_links, \
    wilson_operator

__all__ = ["domain_wall_operator", "apply_domain_wall", "mobius_operator",
           "DomainWallSoAOperator"]


@dataclass(frozen=True)
class DomainWallSoAOperator:
    """Domain-wall operator in the SoA layout.

    ``wilson`` is the 4-D SoA Wilson stencil (Shamir: mass 1 - M5;
    Moebius: bare mass -M5), applied with s folded into the columns;
    ``pp_diag``/``pm_diag`` [12] are the per-channel weights of the
    diagonal chiral projectors P+ and P-.  ``mobius=False`` is the Shamir
    apply; ``mobius=True`` evaluates D_M psi = D_W(b5 psi + c5 H psi) + psi
    - H psi (``projector_side="right"``) or D_M psi = b5 u + psi + H(c5 u -
    psi), u = D_W psi ("left"), with H psi|_s = P_- psi_{s+1} + P_+
    psi_{s-1} (walls x -m_f): one Wilson kernel call for any (b5, c5).  The
    two sides are Gamma5-R5 adjoint partners: D_right^H = (Gamma5 R5)
    D_left (Gamma5 R5).  ``apply_domain_wall`` takes x as a CArray [ncols,
    Ls, 12, X, Y, Z, T]."""

    wilson: BSROperator
    Ls: int
    m_f: float
    pp_diag: torch.Tensor
    pm_diag: torch.Tensor
    b5: float = 1.0
    c5: float = 0.0
    mobius: bool = False
    projector_side: str = "right"

    @property
    def dim_d(self):
        return (self.Ls,) + tuple(self.wilson.dim_d)

    def flops_per_matvec(self, ncols: int, complex_dtype: bool = True) -> int:
        """The JAX package's model: the Wilson matvec on ncols*Ls columns,
        two projector applications, and for Moebius about 10 real flops an
        element for its field combinations."""
        f = self.wilson.flops_per_matvec(ncols * self.Ls, complex_dtype)
        mul = 8 if complex_dtype else 2
        v4 = volume(self.wilson.dim_d)
        f += 2 * mul * v4 * self.Ls * NC * NS * NS * ncols
        if self.mobius:
            f += 10 * v4 * self.Ls * NC * NS * ncols
        return f


def _chiral_proj_diag(P: np.ndarray, part_dt, device) -> torch.Tensor:
    """Per-channel weights [NS*NC] of a diagonal real chiral projector, as
    the SoA layout needs (gamma5 is diagonal in the chiral basis)."""
    if not (np.allclose(P, np.diag(np.diag(P))) and np.allclose(np.imag(P), 0)):
        raise NotImplementedError(
            "SoA domain-wall requires a gamma basis with diagonal real chiral "
            "projectors (g5 diagonal)")
    return torch.tensor(np.repeat(np.diag(P).real, NC).astype(part_dt), device=device)


def _wilson_hop_blocks(links: np.ndarray, r: float, g) -> list:
    """Per-direction 4-D Wilson hopping blocks [((sign, mu), [*lat, 12,
    12]), ...], shared by the 5-D builders."""
    lat_dims = links.shape[1:-2]
    out = []
    for mu in range(4):
        sp = -0.5 * (r * np.eye(NS) - g[mu])
        out.append(((1, mu), np.einsum(
            "st,...cd->...sctd", sp, links[mu]).reshape(tuple(lat_dims) + (12, 12))))
        sp = -0.5 * (r * np.eye(NS) + g[mu])
        shifted = np.roll(links[mu], 1, axis=mu)
        out.append(((-1, mu), np.einsum(
            "st,...cd->...sctd", sp,
            np.swapaxes(shifted, -1, -2).conj()).reshape(tuple(lat_dims) + (12, 12))))
    return out


def _projectors():
    g5 = gamma5()
    return (np.eye(NS) + g5) / 2.0, (np.eye(NS) - g5) / 2.0


def _part_dtype(dtype):
    return np.float32 if dtype == torch.complex64 else np.float64


def _aos_operator(lat5, offsets, blocks, part_dt, device) -> BSROperator:
    vals = np.stack([np.broadcast_to(b, lat5 + (12, 12)) for b in blocks], axis=5)
    return bsr_from_stencil(
        "sxyztSc", "sxyztSC", lat5, {"S": NS, "c": NC}, {"S": NS, "C": NC}, offsets,
        CArray(vals.real.astype(part_dt), vals.imag.astype(part_dt)),
        layout="aos", device=device)


def domain_wall_operator(
    lat_dims: Tuple[int, ...],
    Ls: int = 8,
    M5: float = 1.8,
    m_f: float = 0.05,
    r: float = 1.0,
    key: Optional[int] = None,
    dtype=torch.complex128,
    links: Optional[np.ndarray] = None,
    layout: str = "aos",
    device="cuda",
):
    """Build the Shamir D_dw on the 5-D lattice (s5, x, y, z, t).

    ``layout="soa"`` returns a :class:`DomainWallSoAOperator`;
    ``layout="aos"`` (the default, as in the JAX package) a 5-D stencil
    with labels "sxyztSc" / "sxyztSC", the (S, c) pair one dense 12x12
    block, taking fields [Ls, *lat, NS, NC, ncols].  ``links`` are
    numpy (None: random from ``key``).  Built on ``device``: the card
    unless the caller names the CPU."""
    if len(lat_dims) != 4:
        raise ValueError("domain-wall fermions extend a 4D lattice")
    if layout not in ("soa", "aos"):
        raise ValueError(f"layout={layout!r}: 'soa' or 'aos'")
    rng = np.random.default_rng(_seed_from_key(key))
    if links is None:
        links = random_su3_links(rng, lat_dims)
    Pp, Pm = _projectors()
    part_np = _part_dtype(dtype)
    if layout == "soa":
        w = wilson_operator(lat_dims, mass=1.0 - M5, r=r, dtype=dtype, links=links,
                            layout="soa", device=device)
        return DomainWallSoAOperator(wilson=w, Ls=Ls, m_f=float(m_f),
                                     pp_diag=_chiral_proj_diag(Pp, part_np, device),
                                     pm_diag=_chiral_proj_diag(Pm, part_np, device))
    eyeC = np.eye(NC)
    lat5 = (Ls,) + tuple(lat_dims)
    offsets = [(0, 0, 0, 0, 0)]
    blocks = [np.kron((4.0 * r + 1.0 - M5) * np.eye(NS), eyeC)]
    # 4-D Wilson hopping (s5-independent; links broadcast over s5)
    for (s4, mu), blk in _wilson_hop_blocks(links, r, gamma_matrices()):
        off = [0] * 5
        off[1 + mu] = s4
        offsets.append(tuple(off))
        blocks.append(np.broadcast_to(blk, lat5 + (12, 12)))
    # s5 hopping with mass walls
    bp = np.broadcast_to(np.kron(-Pm, eyeC), lat5 + (12, 12)).copy()
    bp[Ls - 1] = np.kron(m_f * Pm, eyeC)          # wrap s=Ls-1 -> 0
    offsets.append((1, 0, 0, 0, 0))
    blocks.append(bp)
    bm = np.broadcast_to(np.kron(-Pp, eyeC), lat5 + (12, 12)).copy()
    bm[0] = np.kron(m_f * Pp, eyeC)               # wrap s=0 -> Ls-1
    offsets.append((-1, 0, 0, 0, 0))
    blocks.append(bm)
    return _aos_operator(lat5, offsets, blocks, part_np, device)


def mobius_operator(
    lat_dims: Tuple[int, ...],
    Ls: int = 8,
    M5: float = 1.8,
    m_f: float = 0.05,
    b5: float = 1.5,
    c5: float = 0.5,
    r: float = 1.0,
    key: Optional[int] = None,
    dtype=torch.complex128,
    links: Optional[np.ndarray] = None,
    layout: str = "aos",
    projector_side: str = "right",
    device="cuda",
):
    """Moebius domain-wall fermions (Brower-Neff-Orginos):

        D_M = (b5 D_W + 1) delta_ss' + (c5 D_W - 1) Lambda_ss',

    D_W at bare mass -M5, Lambda psi|_s = P_- psi_{s+1} + P_+ psi_{s-1}
    with the s wrap scaled by -m_f; Shamir is b5 = 1, c5 = 0.
    ``projector_side``: "right" applies (c5 D_W - 1) after the projection
    (the form above), "left" builds Lambda (c5 D_W - 1); they are
    Gamma5-R5 adjoint partners.  ``layout="soa"`` needs one Wilson kernel
    call an apply plus elementwise terms; ``layout="aos"`` (the default,
    as in the JAX package) is the 5-D stencil with 27 offsets
    (centre, 8 spatial, 2 axial, 16 corners (s +-1, mu +-1) from c5 D_W
    Lambda; the corners are skipped at c5 = 0)."""
    if projector_side not in ("right", "left"):
        raise ValueError("projector_side must be 'right' or 'left'")
    if len(lat_dims) != 4:
        raise ValueError("domain-wall fermions extend a 4D lattice")
    if layout not in ("soa", "aos"):
        raise ValueError(f"layout={layout!r}: 'soa' or 'aos'")
    rng = np.random.default_rng(_seed_from_key(key))
    if links is None:
        links = random_su3_links(rng, lat_dims)
    Pp, Pm = _projectors()
    part_np = _part_dtype(dtype)
    if layout == "soa":
        w = wilson_operator(lat_dims, mass=-M5, r=r, dtype=dtype, links=links,
                            layout="soa", device=device)
        return DomainWallSoAOperator(wilson=w, Ls=Ls, m_f=float(m_f),
                                     pp_diag=_chiral_proj_diag(Pp, part_np, device),
                                     pm_diag=_chiral_proj_diag(Pm, part_np, device),
                                     b5=float(b5), c5=float(c5), mobius=True,
                                     projector_side=projector_side)

    lat5 = (Ls,) + tuple(lat_dims)
    diag_w = 4.0 * r - M5                       # D_W diagonal (bare -M5)
    hops = _wilson_hop_blocks(links, r, gamma_matrices())
    eyeC = np.eye(NC)
    PmC, PpC = np.kron(Pm, eyeC), np.kron(Pp, eyeC)
    # axial wall factors: +1 in the bulk, -m_f across the s wrap
    lam_p = np.ones(Ls)
    lam_p[Ls - 1] = -m_f
    lam_m = np.ones(Ls)
    lam_m[0] = -m_f
    ones4 = (1,) * 4

    offsets = [(0, 0, 0, 0, 0)]
    blocks = [(b5 * diag_w + 1.0) * np.eye(12)]
    for (s4, mu), blk in hops:                  # spatial: b5 * hop
        off = [0] * 5
        off[1 + mu] = s4
        offsets.append(tuple(off))
        blocks.append(np.broadcast_to(b5 * blk, lat5 + (12, 12)))
    # axial: (c5 * diag_w - 1) * lambda_s * P -+
    for soff, lam, PC in ((1, lam_p, PmC), (-1, lam_m, PpC)):
        offsets.append((soff, 0, 0, 0, 0))
        blocks.append(np.einsum("s,ij->sij", lam * (c5 * diag_w - 1.0), PC)
                      .reshape((Ls,) + ones4 + (12, 12)))
    # corners: c5 * lambda_s * (hop_mu @ P) for "right" (project, then
    # hop) vs (P @ hop_mu) for "left" (hop, then project); all zero at
    # c5 == 0 (Shamir): the 16 offsets are skipped
    for soff, lam, PC in (() if c5 == 0 else ((1, lam_p, PmC), (-1, lam_m, PpC))):
        for (s4, mu), blk in hops:
            off = [0] * 5
            off[0] = soff
            off[1 + mu] = s4
            offsets.append(tuple(off))
            if projector_side == "right":
                corner = c5 * np.einsum("...ij,jk->...ik", blk, PC)
            else:
                corner = c5 * np.einsum("ij,...jk->...ik", PC, blk)
            blocks.append(np.einsum("s,...ij->s...ij", lam, corner))
    return _aos_operator(lat5, offsets, blocks, part_np, device)


@tracker.spanned("apply_domain_wall")
def apply_domain_wall(op, x):
    """y = D_dw x (each call an ``apply_domain_wall`` span of the tracker).

    AoS operators (BSROperator): x [Ls, *lat, NS, NC, ncols] (CArray or
    complex), one ``bsr_krylov`` at lattice rank 5.  SoA operators
    (DomainWallSoAOperator): x a CArray [ncols, Ls, 12, X, Y, Z, T]; the
    hopping runs the stencil kernel with s folded into the columns, the s5
    projector terms, with the mass walls at the s wrap, one pass of
    ``ops/dw_s5.py`` before K1 and one after (Moebius right), or one after
    (Moebius left, Shamir)."""
    if not isinstance(op, DomainWallSoAOperator):
        return bsr_krylov(1.0, op, x, "sxyztSCn")
    if is_sharded(x):
        return _apply_dw_sharded(op, x)
    return _apply_dw_soa(op, x, lambda v: _w5(op, v))


def _w5(op, v, wrap=None, unwrap=None):
    """The 4-d hopping of every s-slice of v [n, Ls, 12, *lat]: one SoA
    apply with s folded into the columns (``wrap``/``unwrap`` carry the
    folded field to and from the sharded apply)."""
    nl, Ls = v.re.shape[0], v.re.shape[1]
    f = cplx.cmap(lambda a: a.reshape((nl * Ls,) + tuple(a.shape[2:])), v)
    y = apply_stencil_soa(op.wilson, f if wrap is None else wrap(f))
    y = y if unwrap is None else unwrap(y)
    return cplx.cmap(lambda a: a.reshape((nl, Ls) + tuple(a.shape[1:])), y)


def _apply_dw_sharded(op, x):
    """The SoA apply on a sharded field [n, Ls, 12, *lat] (DTensors,
    sharded on columns and lattice axes): the s5 terms on the local
    shards, the hopping through the sharded SoA apply with s folded into
    the columns.  A sharded Ls or spin axis raises: the s5 terms act
    along both."""
    from ..parallel._local import from_local, local, mesh_axes, wrap_labels

    lat = "xyzt"[:x.re.ndim - 3]
    mesh, lab = mesh_axes(x, "nsf" + lat)
    if "s" in lab or "f" in lab:
        raise ValueError("apply_domain_wall: a sharded Ls or spin axis; the s5 terms act "
                         "along them (shard the columns and lattice axes)")
    folded = (x.re.shape[0] * op.Ls,) + tuple(x.re.shape[2:])

    def W5(v):
        return _w5(op, v, lambda f: wrap_labels(f, mesh, "nf" + lat, lab, folded), local)

    return from_local(_apply_dw_soa(op, local(x), W5), x)


def _apply_dw_soa(op, x, W5):
    """The SoA apply on x [n, Ls, 12, *lat] with the hopping ``W5`` of
    [n, Ls, 12, *lat] fields; the s5 terms are ``ops/dw_s5.py``'s passes
    (its kernel on the card, its plain version on the CPU)."""
    if x.re.shape[1] != op.Ls:
        raise ValueError(f"field has {x.re.shape[1]} s-slices, the operator Ls = {op.Ls}")
    wp, wm = op.pm_diag, op.pp_diag             # weights of x_{s+1}, x_{s-1}
    # Moebius: H psi|_s = P_- psi_{s+1} + P_+ psi_{s-1}, x -m_f across the s
    # wrap; Shamir: y_s -= P_- psi_{s+1} + P_+ psi_{s-1}, x -m_f across it
    bulk, wall = (1.0, -op.m_f) if op.mobius else (-1.0, op.m_f)

    def s5(kind, y=None):
        return S5.dw_s5(kind, x, y, wp, wm, bulk, wall, op.b5, op.c5)

    if not op.mobius:
        return s5("shamir", W5(x))
    if op.projector_side == "right":         # D_M x = D_W(b5 x + c5 H x) + x - H x
        return s5("right_post", W5(s5("right_pre")))
    return s5("left", W5(x))                 # D_M x = b5 u + x + H(c5 u - x), u = D_W x
