"""What an action does unless it says otherwise.

An action (``actions/<action>.py``) is a class ``Action(cfg, links,
ranks, spans)`` that owns the cell's timed call and the work its kernels
must do:

* ``solve(b, tol, maxiter) -> (x, residual, iterations)``: one timed
  call on one source; here CGNE (``solvers.cgne`` over the action's A
  and A^H) to the traffic's tolerance;
* ``work(sites, nrhs) -> {kernel: {"bytes", "flops", "file"}}``: what one
  launch of each kernel must move and compute on a rank's ``sites`` at
  ``nrhs`` right-hand sides, by the frozen counts under ``counts/``, and
  the ``csrc/`` file its device code comes from; here K1's routes from
  the action's ``K1`` shapes;
* ``launches() -> {kernel: count}``: the port's launch counters under the
  same names, read before and after the traced solves to confirm which
  kernels ran; here K1's ``by_route``.

A cell whose timed call is another entry of the port, or whose kernels
are others, overrides these in its own action file; the harness and the
readers take whatever names it gives.
"""

from __future__ import annotations

from superbblas_tpu_torch import solvers
from superbblas_tpu_torch.ops.stencil import stencil_matvec_soa

from counts import k1 as k1_counts

#: the ``csrc/`` file of each K1 route
K1_FILES = {"tiled": "stencil_tiled.cu", "site16": "stencil_site.cu",
            "site": "stencil_site.cu"}


class Solves:
    #: K1's launches an apply: route -> (KI, KD, BI, BD, directions, columns a rhs)
    K1: dict = {}

    def solve(self, b, tol: float, maxiter: int):
        return solvers.cgne(self.A, self.Ah, b, tol=tol, maxiter=maxiter)

    def work(self, sites: int, nrhs: int) -> dict:
        out = {}
        for route, (ki, kd, bi, bd, nd, cols) in self.K1.items():
            n = nrhs * cols
            out[f"k1.{route}"] = {"bytes": k1_counts.k1_bytes(ki, kd, bi, bd, nd, sites, n),
                                  "flops": k1_counts.k1_flops(ki, kd, bi, bd, nd, sites, n),
                                  "file": K1_FILES[route]}
        return out

    def launches(self) -> dict:
        return {f"k1.{route}": n for route, n in stencil_matvec_soa.by_route.items()}
