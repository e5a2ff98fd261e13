"""PyTorch's kernels launched a Krylov iteration: the kernels of the rank's
traced device events built neither from the port's ``csrc/`` nor by NCCL
(the elementwise and reduction passes of ``cplx.py``, ``solvers.py`` and
``models/``) that start inside a solve, over the port's
``solver.iterations`` counter (mean over ranks).  A solve runs on the
device from its ``solver.cg`` span's start to the later of the span's host
end and its device end (the span's events); the benchmark's own kernels
between solves (its sources) lie outside."""

from _device import csrc_names, is_named, is_nccl
from _program import iterations, named, per_rank


def read(t: dict):
    names = csrc_names(t)

    def one(r, p):
        n = iterations(p)
        solves = [(s[3], max(s[4], s[3] + 1e3 * (s[5] or 0.0)))
                  for s in named(p, "solver.cg")]
        k = sum(1 for name, start, _d, kind in r["device"]
                if kind == "kernel" and not is_nccl(name) and not is_named(name, names)
                and any(a <= start <= b for a, b in solves))
        return k / n if n and k else None

    return per_rank(t, one)
