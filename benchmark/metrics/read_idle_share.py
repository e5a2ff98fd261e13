"""Share of the traced window in which the device sat idle waiting for the
solver's host read of its convergence test: the idle gaps between device
activities (``profiling.union``) whose start lies inside a ``solver.read``
span of ``solvers._above``, over the window (mean over ranks)."""

import bisect

from _program import named, per_rank, union


def read(t: dict):
    def one(r, p):
        reads = sorted((s[3], s[4]) for s in named(p, "solver.read"))
        w0, w1 = r["window"]
        if not reads or w1 <= w0:
            return None
        starts = [s for s, _e in reads]
        idle, prev = 0.0, w0
        for s, e in union(r["device"], r["window"]) + [[w1, w1]]:
            k = bisect.bisect_right(starts, prev) - 1
            if s > prev and k >= 0 and reads[k][1] >= prev:
                idle += s - prev
            prev = max(prev, e)
        return 100.0 * idle / (w1 - w0)

    return per_rank(t, one)
