"""Device-to-host reads a Krylov iteration: the port's ``host_reads``
counter (``tracker.to_host``: the convergence read of ``solvers._above``
and any device read of a kron for K1's spin plan) over its
``solver.iterations`` in the traced solves; CG reads iters + 1 times a
solve (mean over ranks)."""

from _program import iterations, per_rank


def read(t: dict):
    def one(_r, p):
        n = iterations(p)
        return p["counters"].get("host_reads", 0) / n if n else None

    return per_rank(t, one)
