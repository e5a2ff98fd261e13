"""Mean device ms of a call of ``models.clover_eo.apply_schur`` (two packed
hopping launches, two site-block launches and a subtraction on the half
lattice): its ``apply_schur`` spans inside the program (CUDA events on the
current stream at entry and exit) in the traced solves (mean over ranks)."""

from _program import device_ms, named, per_rank


def read(t: dict):
    def one(_r, p):
        ms = device_ms(named(p, "apply_schur"))
        return sum(ms) / len(ms) if ms else None

    return per_rank(t, one)
