"""Wilson-clover solves through the port's public entries.

A is ``models.clover.apply_clover`` on the operator that
``wilson_clover_operator(layout="soa")`` builds from the benchmark's
links; A^H = g5 A g5 (the operator is g5-Hermitian).  Fields are split
complex [n, 12, X, Y, Z, T].  On several ranks each builds its X slab
with one halo plane a side, keeps the interior and hands the port
DTensors sharded on X: blocks and fields go through the ordinary entry
points to the sharded stencil.
"""

from __future__ import annotations

import torch

from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models.clover import CloverOperator, apply_clover, \
    wilson_clover_operator

from _base import Solves
from shard import lmap

#: the span around each call into the port's apply
SPAN = "apply_clover"


def lead(cfg: dict, nrhs: int) -> tuple:
    """Field axes before X."""
    return (nrhs, 12)


def crop(ranks, blocks: CArray) -> CArray:
    """Blocks [ndir, B, xl + 2, ...] of a slab built with its halo planes:
    the interior, sharded on X."""
    parts = tuple(a[:, :, 1:ranks.xl + 1] for a in blocks)
    return ranks.wrap(parts, axis=2)


class Action(Solves):
    """Solved by CGNE (``_base.Solves``)."""

    K1 = {"tiled": (4, 4, 3, 3, 9, 1), "site16": (1, 1, 12, 12, 1, 1)}

    def __init__(self, cfg: dict, links: torch.Tensor, ranks, spans):
        kw = dict(mass=cfg["mass"], c_sw=cfg["c_sw"], r=cfg.get("r", 1.0),
                  dtype=torch.complex64, layout="soa", device=ranks.device)
        if ranks.world == 1:
            op = wilson_clover_operator(ranks.lat, links=links, **kw)
        else:
            ext = wilson_clover_operator((ranks.xl + 2,) + ranks.rest, links=links, **kw)
            hop = ext.hop.replace(blocks=crop(ranks, ext.hop.blocks), dim=ranks.lat)
            term = ext.clover.replace(blocks=crop(ranks, ext.clover.blocks), dim=ranks.lat)
            op = CloverOperator(hop=hop, clover=term, c_sw=ext.c_sw)
            del ext, hop, term
        self.op, self.spans = op, spans
        self.signs = torch.tensor((1.0,) * 6 + (-1.0,) * 6, device=ranks.device).reshape(
            1, 12, 1, 1, 1, 1)

    def g5(self, v: CArray) -> CArray:
        return CArray(*(lmap(lambda a: a * self.signs, p) for p in v))

    def A(self, v: CArray) -> CArray:
        return self.spans(SPAN, apply_clover, self.op, v)

    def Ah(self, v: CArray) -> CArray:
        return self.g5(self.A(self.g5(v)))
