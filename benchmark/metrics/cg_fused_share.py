"""Share of the traced solves' Krylov iterations that ran on CG's fused
kernels (``ops/cg_update.py``): the port's ``solver.fused_iterations``
counter over its ``solver.iterations``, in % (mean over ranks).  None
where the program keeps no such counter."""

from _program import iterations, per_rank


def read(t: dict):
    def one(_r, p):
        n = iterations(p)
        fused = p["counters"].get("solver.fused_iterations")
        return 100.0 * fused / n if n and fused is not None else None

    return per_rank(t, one)
