"""Shared arithmetic of the readers that take the device trace."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from counts.k1 import bound_s  # noqa: E402
from profiling import busy_us, is_named, is_nccl  # noqa: E402,F401


def csrc_names(t: dict) -> list:
    return [n for names in t["kernel_files"].values() for n in names]


def per_rank(t: dict, fn):
    """The mean over ranks of ``fn(rank trace)``, None where any rank has
    nothing to read."""
    vals = [fn(r) for r in t.get("ranks") or []]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def kernel_time(r: dict, keep) -> float:
    return sum(d for name, _s, d, kind in r["device"] if kind == "kernel" and keep(name))


def roofline(t: dict, kernel: str):
    """100 x the frozen bound of one launch of ``kernel`` (the work the
    action gives for it: bytes, operations and its ``csrc/`` file) over
    the mean device time of a launch of that file's kernels; None where
    the action gives no work for it or none ran."""
    work = t.get("work", {}).get(kernel)
    if work is None or not t.get("launches", {}).get(kernel):
        return None
    names = t["kernel_files"].get(work["file"]) or []
    bound_us = 1e6 * bound_s(work["bytes"], work["flops"], t["peaks"])

    def one(r):
        durs = [d for name, _s, d, kind in r["device"]
                if kind == "kernel" and is_named(name, names)]
        return 100.0 * bound_us / (sum(durs) / len(durs)) if durs else None

    return per_rank(t, one)
