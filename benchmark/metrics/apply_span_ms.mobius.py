"""Mean device ms of a call of ``models.domain_wall.apply_domain_wall``:
its ``apply_domain_wall`` spans inside the program (CUDA events on the
current stream at entry and exit) in the traced solves (mean over ranks)."""

from _program import device_ms, named, per_rank


def read(t: dict):
    def one(_r, p):
        ms = device_ms(named(p, "apply_domain_wall"))
        return sum(ms) / len(ms) if ms else None

    return per_rank(t, one)
