"""Plain PyTorch even-odd preconditioned Wilson-clover operator, the check
of the clover even-odd cell.  It imports nothing of the port.

``Operator`` is the full clover operator of ``clover.py``: the check
judges the reconstructed full solution against D itself.  ``schur``
gives the Schur complement on the even sites (openQCD's ``Dwhat``)

    Dhat = A_ee - H_eo A_oo^-1 H_oe,    A = (m + 4 r) + clover term,

built from checkerboard masks on the unpacked lattice: H is the Wilson
hopping term (``ref_wilson.WilsonHop`` with its diagonal m + 4 r set to
zero), A the site blocks of ``clover.py`` plus the diagonal, and A_oo^-1
applied by ``torch.linalg.solve`` on each odd site's 12x12 block in
complex128.  Fields are complex [n, 12, *lat]; the parity of a site is
(x + y + z + t) % 2.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from ref_wilson import WilsonHop, exact


def _sibling(name: str):
    """``<name>.py`` of this folder, loaded by its path (a plain ``import``
    could find another folder's module of the same name first)."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


Operator = _sibling("clover").Operator


def parity(lat, device) -> torch.Tensor:
    """(x + y + z + t) % 2 of every site, flattened in the lattice's order."""
    coords = torch.meshgrid(*[torch.arange(d, device=device) for d in lat], indexing="ij")
    return (sum(coords) % 2).reshape(-1)


def schur(links: torch.Tensor, cfg: dict, dtype=torch.complex128, q=exact):
    """Dhat over ``links`` [4, *lat, 3, 3] (complex128): a function of v
    [n, 12, *lat] that gives Dhat v on the even sites and zero on the odd
    ones (v's odd sites are not read).  Products run in ``dtype``, each
    operand rounded by ``q``; A_oo^-1 is a complex128 solve."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = float(cfg.get("r", 1.0))
    lat = tuple(links.shape[1:5])
    hop = WilsonHop(links, -4.0 * r, r, dtype, q)
    eye = torch.eye(12, dtype=torch.complex128, device=links.device)
    A = Operator(links, cfg).C.reshape(12, 12, -1).permute(2, 0, 1) \
        + (float(cfg["mass"]) + 4.0 * r) * eye
    p = parity(lat, links.device)
    even, odd = p == 0, p == 1
    A_ee, A_oo = q(A[even].to(dtype)), A[odd]
    del A

    def H(v: torch.Tensor) -> torch.Tensor:
        n = v.shape[0]
        return hop.apply(v.reshape((n, 4, 3) + lat)).reshape(n, 12, -1)

    def apply(v: torch.Tensor) -> torch.Tensor:
        n = v.shape[0]
        v = v.to(dtype).reshape(n, 12, -1)
        t = torch.linalg.solve(A_oo, H(v)[:, :, odd].permute(2, 1, 0).to(torch.complex128))
        w = torch.zeros_like(v)
        w[:, :, odd] = t.permute(2, 1, 0).to(dtype)
        y = torch.zeros_like(v)
        y[:, :, even] = torch.einsum("sij,njs->nis", A_ee, q(v[:, :, even])) - H(w)[:, :, even]
        return y.reshape((n, 12) + lat)

    return apply
