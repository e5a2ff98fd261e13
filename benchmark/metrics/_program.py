"""Shared arithmetic of the readers that take the port's own record: the
spans and counters ``superbblas_tpu_torch.utils.tracker`` keeps while a
profile runs, so over the traced solves.  A record is
``{"spans": [[id, parent, name, t0_us, t1_us, device_ms or None], ...],
"counters": {name: count}}``, its host times on the device trace's clock.

The records come from ``t["program"]`` (one a rank, in rank order beside
``t["ranks"]``) where the trace holds them; else, on one rank, from the
tracker of this process, which ran the traced solves: the first reader
takes the record (``tracker.stop``) and leaves it in ``t`` for the others.
A cell on several cards reads its ranks in other processes, and a program
without the record (no ``tracker.stop``) gives none: the readers give
None there."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from profiling import union  # noqa: E402,F401


def records(t: dict) -> list:
    """The ranks' records, [] where there are none to read."""
    if "program" not in t:
        rec = None
        if len(t.get("ranks") or []) == 1:
            from superbblas_tpu_torch.utils import tracker

            if hasattr(tracker, "stop"):
                rec = tracker.stop()
        t["program"] = [rec] if rec and rec["spans"] else []
    return t["program"] or []


def per_rank(t: dict, fn):
    """The mean over ranks of ``fn(rank trace, rank record)``, None where
    any rank has no record or ``fn`` finds nothing to read there."""
    recs, ranks = records(t), t.get("ranks") or []
    if not recs or len(recs) != len(ranks) or any(p is None for p in recs):
        return None
    vals = [fn(r, p) for r, p in zip(ranks, recs)]
    if any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def named(p: dict, name: str) -> list:
    return [s for s in p["spans"] if s[2] == name]


def device_ms(spans: list):
    """The spans' device ms, None where any span has none (a CPU run)."""
    ms = [s[5] for s in spans]
    return None if not ms or any(v is None for v in ms) else ms


def iterations(p: dict):
    return p["counters"].get("solver.iterations") or None
