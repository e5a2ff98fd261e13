"""Krylov iterations a solve: the mean of what ``solvers.cgne`` returned
over every solve of the traced run's window (a count the program returns)."""


def read(t: dict):
    iters = t.get("solver_iters") or []
    return sum(iters) / len(iters) if iters else None
