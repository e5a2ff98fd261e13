"""One apply of the multigrid's coarse operator as a share of its
roofline: the action's frozen work of an apply (``counts/coarse.py``:
the blocks read once, x read once, y written once) at the data sheet's
rates, over the mean device time of the port's ``coarse.apply`` spans
(``models.coarse.apply_coarse``: CUDA events at entry and exit) in the
traced solves, in % (mean over ranks).  It reads the same work whatever
kernels implement the apply.  None where the action gives no such work or
the program keeps no such span."""

from _device import bound_s
from _program import device_ms, named, per_rank


def read(t: dict):
    work = t.get("work", {}).get("coarse.apply")
    if work is None:
        return None
    bound_ms = 1e3 * bound_s(work["bytes"], work["flops"], t["peaks"])

    def one(_r, p):
        ms = device_ms(named(p, "coarse.apply"))
        return 100.0 * bound_ms * len(ms) / sum(ms) if ms else None

    return per_rank(t, one)
