"""Moebius domain-wall solves through the port's public entries.

A is ``models.domain_wall.apply_domain_wall`` on the right-projector
operator of ``mobius_operator(dtype=complex64, layout="soa")``, and
A^H = (g5 R5) D_left (g5 R5), R5 reflecting s -> Ls-1-s: the two
projector orderings are adjoint partners.  Fields are split complex
[n, Ls, 12, X, Y, Z, T]; the port folds Ls into K1's columns.  On several
ranks each builds its X slab with one halo plane a side and hands the
port DTensors sharded on X.
"""

from __future__ import annotations

import dataclasses

import torch

from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models.domain_wall import apply_domain_wall, mobius_operator

from _base import Solves
from shard import lmap

SPAN = "apply_domain_wall"


def lead(cfg: dict, nrhs: int) -> tuple:
    return (nrhs, int(cfg["Ls"]), 12)


class Action(Solves):
    """Solved by CGNE (``_base.Solves``); K1 takes Ls columns a right-hand
    side."""

    def __init__(self, cfg: dict, links: torch.Tensor, ranks, spans):
        self.K1 = {"tiled": (4, 4, 3, 3, 9, int(cfg["Ls"]))}
        kw = dict(Ls=int(cfg["Ls"]), M5=cfg["M5"], m_f=cfg["m_f"], b5=cfg["b5"], c5=cfg["c5"],
                  r=cfg.get("r", 1.0), links=links, dtype=torch.complex64, layout="soa",
                  device=ranks.device)
        ops = []
        for side in ("right", "left"):
            if ranks.world == 1:
                op = mobius_operator(ranks.lat, projector_side=side, **kw)
            else:
                ext = mobius_operator((ranks.xl + 2,) + ranks.rest, projector_side=side, **kw)
                parts = tuple(a[:, :, 1:ranks.xl + 1] for a in ext.wilson.blocks)
                w = ext.wilson.replace(blocks=ranks.wrap(parts, axis=2), dim=ranks.lat)
                op = dataclasses.replace(ext, wilson=w)
                del ext, parts, w
            ops.append(op)
        self.right, self.left = ops
        self.spans = spans
        self.signs = torch.tensor((1.0,) * 6 + (-1.0,) * 6, device=ranks.device).reshape(
            1, 1, 12, 1, 1, 1, 1)

    def r5g5(self, v: CArray) -> CArray:
        return CArray(*(lmap(lambda a: a.flip(1) * self.signs, p) for p in v))

    def A(self, v: CArray) -> CArray:
        return self.spans(SPAN, apply_domain_wall, self.right, v)

    def Ah(self, v: CArray) -> CArray:
        return self.r5g5(self.spans(SPAN, apply_domain_wall, self.left, self.r5g5(v)))
