"""Coarse GCR iterations a multigrid cycle over the traced solves: the
port's ``mg.coarse_iterations`` counter over its ``mg.cycles`` counter
(``models.multigrid``; mean over ranks).  None where the program keeps no
such counters."""

from _program import per_rank


def read(t: dict):
    def one(_r, p):
        cycles = p["counters"].get("mg.cycles")
        iters = p["counters"].get("mg.coarse_iterations")
        return iters / cycles if cycles and iters is not None else None

    return per_rank(t, one)
