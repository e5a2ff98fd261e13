"""Even-odd preconditioned Wilson-clover solves through the port's public
entries (``models.clover_eo``: openQCD's ``Dwhat``, the Schur complement
A_ee - H_eo A_oo^-1 H_oe on the even sites).

The operator is ``wilson_clover_operator(layout="soa")`` on the
benchmark's links, as the clover cells build it, packed once by
``clover_eo_operator`` (the hopping term onto each parity, A_ee, and
A_oo^-1 inverted in complex128 and cast), the unpacked operator then
dropped.  The timed call is ``eo_solve_clover_soa``: the source prepared
on the even sites, CGNE on the Schur system to the traffic's tolerance
(on the Schur system's normal residual), the odd sites reconstructed.
Fields are split complex [n, 12, X, Y, Z, T] in and out; one card.

A Schur apply is two K1 launches on the tiled route with
``packed_parity`` (8 directions over V/2 sites) and two on the
block-streaming route (the 12x12 site blocks over V/2 sites).
"""

from __future__ import annotations

import torch

from superbblas_tpu_torch.models.clover import wilson_clover_operator
from superbblas_tpu_torch.models.clover_eo import clover_eo_operator, eo_solve_clover_soa

from _base import K1_FILES, Solves
from counts import k1 as k1_counts
from counts import k1_packed

#: the port's span around each Schur apply (``apply_span_ms.schur`` reads it)
SPAN = "apply_schur"


def lead(cfg: dict, nrhs: int) -> tuple:
    """Field axes before X."""
    return (nrhs, 12)


class Action(Solves):
    """Solved by ``eo_solve_clover_soa``."""

    def __init__(self, cfg: dict, links: torch.Tensor, ranks, spans):
        if ranks.world != 1:
            raise ValueError("the clover even-odd cell runs on one card")
        op = wilson_clover_operator(ranks.lat, links=links, mass=cfg["mass"], c_sw=cfg["c_sw"],
                                    r=cfg.get("r", 1.0), dtype=torch.complex64, layout="soa",
                                    device=ranks.device)
        self.eo = clover_eo_operator(op)
        del op

    def solve(self, b, tol: float, maxiter: int):
        return eo_solve_clover_soa(self.eo, b, tol=tol, maxiter=maxiter)

    def work(self, sites: int, nrhs: int) -> dict:
        """Both routes' launches on the V/2 sites of one parity, which
        ``k1_roofline.tiled`` and ``k1_roofline.site16`` read in this cell."""
        half = sites // 2
        ki, kd, bi, bd = k1_packed.SHAPE
        return {"k1.tiled": {"bytes": k1_counts.k1_bytes(ki, kd, bi, bd, k1_packed.NDIR, half,
                                                         nrhs),
                             "flops": k1_packed.k1_packed_flops(half, nrhs),
                             "file": K1_FILES["tiled"]},
                "k1.site16": {"bytes": k1_counts.k1_bytes(1, 1, 12, 12, 1, half, nrhs),
                              "flops": k1_counts.k1_flops(1, 1, 12, 12, 1, half, nrhs),
                              "file": K1_FILES["site16"]}}
