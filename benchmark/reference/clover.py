"""Plain PyTorch Wilson-clover operator, the check of the clover cells.

    D = D_W - (c_sw / 2) sum_{mu<nu} sigma_{mu nu} (x) F_{mu nu}(s)

sigma_{mu nu} = (i/2)[g_mu, g_nu]; F = (Q - Q^H) / (8 i), Q the sum of the
four plaquette leaves in the mu-nu plane around s (the standard clover
leaf).  D is g5-Hermitian, so D^H = g5 D g5.  Fields [n, 12, *lat]
complex (12 = spin x colour, spin major); the blocks are formed here from
the links, in complex128, then cast to the field type.
"""

from __future__ import annotations

import torch

from ref_wilson import WilsonHop, exact, gamma5_signs, gammas, real_dtype, shift


def field_strength(U: torch.Tensor, mu: int, nu: int) -> torch.Tensor:
    """F_{mu nu}(s) [*lat, 3, 3] from links U [4, *lat, 3, 3]."""
    def dag(m):
        return m.transpose(-1, -2).conj()

    def at(m, *steps):
        """m(s + sum of steps), each step (axis, +-1)"""
        for ax, k in steps:
            m = shift(m, ax, k)
        return m

    Um, Un = U[mu], U[nu]
    q = Um @ at(Un, (mu, 1)) @ dag(at(Um, (nu, 1))) @ dag(Un)
    q = q + Un @ dag(at(Um, (mu, -1), (nu, 1))) @ dag(at(Un, (mu, -1))) @ at(Um, (mu, -1))
    q = q + (dag(at(Um, (mu, -1))) @ dag(at(Un, (mu, -1), (nu, -1)))
             @ at(Um, (mu, -1), (nu, -1)) @ at(Un, (nu, -1)))
    q = q + dag(at(Un, (nu, -1))) @ at(Um, (nu, -1)) @ at(Un, (mu, 1), (nu, -1)) @ dag(Um)
    return (q - dag(q)) / 8j


class Operator:
    """The clover operator over ``links`` [4, *lat, 3, 3] (complex128)."""

    def __init__(self, links: torch.Tensor, cfg: dict, dtype=torch.complex128, q=exact):
        self.dtype, self.q = dtype, q
        self.hop = WilsonHop(links, cfg["mass"], cfg.get("r", 1.0), dtype, q)
        g = gammas(links.device)
        lat = tuple(links.shape[1:5])
        # C[(s, a), (t, b), site] = -(c_sw / 2) sum sigma[s, t] F[site, a, b], filled in place
        C = torch.zeros((4, 3, 4, 3) + lat, dtype=torch.complex128, device=links.device)
        for mu in range(4):
            for nu in range(mu + 1, 4):
                sigma = (0.5j * (g[mu] @ g[nu] - g[nu] @ g[mu])).cpu()
                F = field_strength(links, mu, nu).movedim((-2, -1), (0, 1))
                for s in range(4):
                    for t in range(4):
                        if complex(sigma[s, t]) != 0:
                            C[s, :, t] += (-cfg["c_sw"] / 2.0) * complex(sigma[s, t]) * F
                del F
        self.C = q(C.reshape((12, 12) + lat).to(dtype))
        del C
        self.g5 = gamma5_signs(links.device, real_dtype(dtype))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """D x for x [n, 12, *lat]."""
        n, lat = x.shape[0], tuple(x.shape[2:])
        x = x.to(self.dtype)
        y = self.hop.apply(x.reshape((n, 4, 3) + lat)).reshape(x.shape)
        xq = self.q(x)
        for j in range(12):
            y = y + self.C[:, j] * xq[:, j:j + 1]
        return y

    def adjoint(self, x: torch.Tensor) -> torch.Tensor:
        """D^H x = g5 D g5 x."""
        return self._g5(self.apply(self._g5(x)))

    def _g5(self, x):
        n, lat = x.shape[0], tuple(x.shape[2:])
        return (x.reshape((n, 4, 3) + lat) * self.g5).reshape(x.shape)
