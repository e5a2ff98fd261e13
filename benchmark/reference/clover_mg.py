"""Plain PyTorch check of the clover multigrid cell.  It imports nothing
of the port.

``Operator`` is the full clover operator of ``clover.py`` at the
configuration's mass: the check judges the answer against D itself,
whatever preconditioner produced it.  ``galerkin`` forms the Galerkin
coarse matrix P^H D P densely from a given P at small sizes, for the
CPU tests of the port's probed coarse operator.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch


def _sibling(name: str):
    """``<name>.py`` of this folder, loaded by its path (a plain ``import``
    could find another folder's module of the same name first)."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


Operator = _sibling("clover").Operator


def galerkin(links: torch.Tensor, cfg: dict, P: torch.Tensor) -> torch.Tensor:
    """A_c[i, j] = <P_i, D P_j> in complex128, [M, M], for the M coarse
    basis vectors P [M, 12, *lat] (complex) given as fine fields, D the
    clover operator over ``links`` [4, *lat, 3, 3] at ``cfg``'s mass."""
    P = P.to(torch.complex128)
    M = P.shape[0]
    DP = Operator(links, cfg, dtype=torch.complex128).apply(P)
    return P.conj().reshape(M, -1) @ DP.reshape(M, -1).T
