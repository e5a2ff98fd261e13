"""Host microseconds of a call of K1's wrapper
(``ops.stencil.stencil_matvec_soa``, from entry to return: checks, spin
plan lookup, the ctypes launch): the mean of its ``k1`` spans in the
traced solves (mean over ranks)."""

from _program import named, per_rank


def read(t: dict):
    def one(_r, p):
        us = [s[4] - s[3] for s in named(p, "k1")]
        return sum(us) / len(us) if us else None

    return per_rank(t, one)
