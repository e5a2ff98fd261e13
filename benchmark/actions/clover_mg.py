"""Wilson-clover solves by two-level aggregation multigrid through the
port's public entries (``models.multigrid``: ``clover_mg_setup``,
``mg_solve_clover``).

The operator is ``wilson_clover_operator(layout="soa")`` on the
benchmark's links, as the clover cells build it.  The multigrid set-up
runs here, in ``__init__``, so it counts in ``setup_s`` and never in the
window: test vectors made near-null by inverse iterations, split by
chirality and block-orthonormalised on the configuration's aggregates,
and the Galerkin coarse operator probed into a coarse BSR operator on
the card.  The timed call is ``mg_solve_clover``: FGCR on the unsquared D,
right-preconditioned by the multigrid cycle, to the traffic's tolerance
on |D x - b| / |b|.  Fields are split complex [n, 12, X, Y, Z, T]; one
card.

The kernels a solve runs: K1 at one column (the smoother's and FGCR's
applies of D: the tiled route and the clover term's site16), and the
coarse applies (the batched-GEMM kernels of ``csrc/batched_gemm.cu``),
whose work ``counts/coarse.py`` freezes.
"""

from __future__ import annotations

import math

import torch

from superbblas_tpu_torch.models.clover import wilson_clover_operator
from superbblas_tpu_torch.models.multigrid import clover_mg_setup, mg_solve_clover
from superbblas_tpu_torch.ops.batched_gemm import batched_gemm_rowpack, batched_small_gemm

import gen
from _base import Solves
from counts import coarse as coarse_counts

#: the port's span around each coarse apply (``coarse_roofline`` reads it)
SPAN = "coarse.apply"


def lead(cfg: dict, nrhs: int) -> tuple:
    """Field axes before X."""
    return (nrhs, 12)


def coarse_shape(cfg: dict, sites: int) -> tuple:
    """(coarse sites, N_c, offsets) of the configuration's coarse operator
    on ``sites`` fine sites: an offset a direction each way where the
    coarse extent exceeds 2, one where it is 2, and the site itself."""
    mg = cfg["multigrid"]
    clat = [d // b for d, b in zip(cfg["lattice"], mg["block"])]
    ndir = 1 + sum(2 if c > 2 else (1 if c == 2 else 0) for c in clat)
    return sites // math.prod(mg["block"]), 2 * int(mg["test_vectors"]), ndir


class Action(Solves):
    """Solved by ``mg_solve_clover``."""

    K1 = {"tiled": (4, 4, 3, 3, 9, 1), "site16": (1, 1, 12, 12, 1, 1)}

    def __init__(self, cfg: dict, links: torch.Tensor, ranks, spans):
        if ranks.world != 1:
            raise ValueError("the clover multigrid cell runs on one card")
        # The harness reads each answer through ``shard.local``, whose first
        # call imports ``torch.distributed.tensor`` (seconds on the card's
        # host).  The CGNE actions' warm-up imports it (``solvers.cg`` checks
        # its operands for DTensors); this solve never does, so the import
        # is made here, in the set-up, and not after the window's first solve.
        import torch.distributed.tensor  # noqa: F401
        op = wilson_clover_operator(ranks.lat, links=links, mass=cfg["mass"], c_sw=cfg["c_sw"],
                                    r=cfg.get("r", 1.0), dtype=torch.complex64, layout="soa",
                                    device=ranks.device)
        mg = cfg["multigrid"]
        # the test vectors' generator from the run's links, so from --seed
        key = gen.subseed("multigrid", float(links[0, 0, 0, 0, 0, 0, 0].real))
        self.cfg = cfg
        self.mg = clover_mg_setup(
            op, block=tuple(mg["block"]), nvec=int(mg["test_vectors"]), key=key,
            setup_rounds=int(mg["setup_rounds"]), setup_steps=int(mg["setup_steps"]),
            refine_rounds=int(mg["refine_rounds"]), smooth_steps=int(mg["smooth_steps"]),
            coarse_steps=int(mg["coarse_steps"]))

    def solve(self, b, tol: float, maxiter: int):
        return mg_solve_clover(self.mg, b, tol=tol, maxiter=maxiter,
                               restart=int(self.cfg["multigrid"]["fgcr_restart"]))

    def work(self, sites: int, nrhs: int) -> dict:
        """K1's routes at one column and one coarse apply (``counts/coarse.py``
        at the configuration's coarse shape)."""
        out = super().work(sites, nrhs)
        vc, nc, ndir = coarse_shape(self.cfg, sites)
        out[SPAN] = {"bytes": coarse_counts.coarse_bytes(vc, nc, ndir, nrhs),
                     "flops": coarse_counts.coarse_flops(vc, nc, ndir, nrhs),
                     "file": "batched_gemm.cu"}
        return out

    def launches(self) -> dict:
        """K1's launches by route, and the batched-GEMM launches of the
        coarse applies (E1 and K3; three Gauss products an apply)."""
        out = super().launches()
        out[SPAN] = batched_gemm_rowpack.launches + batched_small_gemm.launches
        return out
