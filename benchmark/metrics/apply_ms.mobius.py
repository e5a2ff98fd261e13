"""Mean ms of a call of ``models.domain_wall.apply_domain_wall`` from the
benchmark's A and A^H: CUDA events around each call in the traced solves."""


def read(t: dict):
    ms = t.get("spans", {}).get("apply_domain_wall") or []
    return sum(ms) / len(ms) if ms else None
