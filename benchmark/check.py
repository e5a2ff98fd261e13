"""Whether the timed solves are right: the plain reference's residuals of
the answers the window produced.

Once the window has closed and the port's state is freed, the reference
(``reference/<action>.py``, plain PyTorch in complex128, nothing of the
port) builds its own operator from links made again from the seed, makes
each checked solve's right-hand sides again, and computes for the
solution x that the port returned

    res        = |D x - b| / |b|
    normal_res = |D^H (D x - b)| / |D^H b|

over the whole lattice (sums over ranks), one column at a time so that
it fits.  A rank holds its X slab with one halo plane a side, from its
neighbours (or wrapped, on one card).  The numbers compared are the
largest of each over the checked solves, each against its limit in the
cell's workload file.
"""

from __future__ import annotations

import math

import torch

import gen

def residuals(ref, x: torch.Tensor, b: torch.Tensor, ranks, axis: int):
    """Rank-local sums (|r|^2, |b|^2, |D^H r|^2, |D^H b|^2) of complex128
    slabs x, b [*lead, xl, *rest] (lead[0] = 1)."""
    def interior(t):
        return t.narrow(axis, 1, ranks.xl)

    r = interior(ref.apply(ranks.extend(x, axis))) - b
    ahr = interior(ref.adjoint(ranks.extend(r, axis)))
    ahb = interior(ref.adjoint(ranks.extend(b, axis)))
    return [float(torch.vdot(t.reshape(-1), t.reshape(-1)).real) for t in (r, b, ahr, ahb)]


def numbers(mod, cfg: dict, seed: int, kept, lead, ranks) -> dict:
    """{"res": [...], "normal_res": [...]} of each checked solve, in the
    order of ``kept`` ([(solve index, (re, im) host tensors)]), by the
    reference module ``mod`` (``reference/<action>.py``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    links = gen.links(seed, ranks.planes_ext, ranks.rest, ranks.device)
    ref = mod.Operator(links, cfg, dtype=torch.complex128)
    del links
    axis = len(lead)
    out = {"res": [], "normal_res": []}
    for index, (re, im) in kept:
        bre, bim = gen.source(seed, index, lead, ranks.planes, ranks.rest, ranks.device)
        sums = torch.zeros(4, dtype=torch.float64, device=ranks.device)
        for c in range(re.shape[0]):
            x = torch.complex(re[c:c + 1].to(ranks.device, torch.float64),
                              im[c:c + 1].to(ranks.device, torch.float64))
            b = torch.complex(bre[c:c + 1].double(), bim[c:c + 1].double())
            sums += torch.tensor(residuals(ref, x, b, ranks, axis), dtype=torch.float64,
                                 device=ranks.device)
            del x, b
        sums = ranks.all_sum(sums).tolist()
        ok = all(math.isfinite(v) for v in sums) and sums[1] > 0 and sums[3] > 0
        out["res"].append(math.sqrt(sums[0] / sums[1]) if ok else math.inf)
        out["normal_res"].append(math.sqrt(sums[2] / sums[3]) if ok else math.inf)
    del ref
    return out


def compare(found: dict, limits: dict) -> dict:
    """{name: {"value": the largest reading, "limit": its limit}}."""
    return {name: {"value": max(found[name]) if found[name] else math.inf,
                   "limit": limits[name]} for name in limits}


def passed(compared: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in compared.values())
