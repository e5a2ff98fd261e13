"""Share of the traced window spent in the multigrid's coarse solves: the
device time of the port's ``mg.coarse`` spans (CUDA events on the current
stream at the coarse GCR's entry and exit, ``models.multigrid``) over the
traced window, in % (mean over ranks).  A span's device time holds the
device's idle gaps inside it (the coarse GCR waits on the host's
launches and its convergence reads), so the share is taken of the window,
where it stays one.  None where the program keeps no such span or the
run has no device times (a CPU run)."""

from _program import device_ms, named, per_rank


def read(t: dict):
    def one(r, p):
        ms = device_ms(named(p, "mg.coarse"))
        w0, w1 = r["window"]
        return 100.0 * 1e3 * sum(ms) / (w1 - w0) if ms and w1 > w0 else None

    return per_rank(t, one)
