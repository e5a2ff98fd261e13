"""Plain PyTorch Moebius domain-wall operator, the check of the Moebius
cells (Brower-Neff-Orginos, in the port's projector ordering "right"):

    D psi = D_W (b5 psi + c5 H psi) + psi - H psi,
    H psi|_s = P_- psi_{s+1} + P_+ psi_{s-1},

D_W the Wilson operator at bare mass -M5, P_+- = (1 +- g5) / 2, and the
two terms that wrap around the fifth dimension (s = Ls-1 -> 0 and
s = 0 -> Ls-1) scaled by -m_f.  Its adjoint is worked out directly:

    D^H = (b5 + c5 H^H) D_W^H + 1 - H^H,   D_W^H = g5 D_W g5,
    H^H phi|_s = P_- c+_{s-1} phi_{s-1} + P_+ c-_{s+1} phi_{s+1},

c+_s (c-_s) the factor of H's s+1 (s-1) term at s.  Fields [n, Ls, 12,
*lat] complex.
"""

from __future__ import annotations

import torch

from ref_wilson import WilsonHop, exact, gamma5_signs, real_dtype


class Operator:
    def __init__(self, links: torch.Tensor, cfg: dict, dtype=torch.complex128, q=exact):
        self.dtype, self.q = dtype, q
        self.Ls = int(cfg["Ls"])
        self.b5, self.c5, self.m_f = float(cfg["b5"]), float(cfg["c5"]), float(cfg["m_f"])
        self.hop = WilsonHop(links, -float(cfg["M5"]), cfg.get("r", 1.0), dtype, q)
        dev, rt = links.device, real_dtype(dtype)
        self.g5 = gamma5_signs(dev, rt)                                 # [4, 1, ...]
        # chiral projectors on the 12 features (spin major)
        g5f = self.g5.reshape(4).repeat_interleave(3)
        self.pp = ((1 + g5f) / 2).reshape(1, 1, 12, 1, 1, 1, 1)
        self.pm = ((1 - g5f) / 2).reshape(1, 1, 12, 1, 1, 1, 1)
        cp = torch.ones(self.Ls, dtype=rt, device=dev)
        cp[self.Ls - 1] = -self.m_f
        cm = torch.ones(self.Ls, dtype=rt, device=dev)
        cm[0] = -self.m_f
        self.cp = cp.reshape(1, self.Ls, 1, 1, 1, 1, 1)
        self.cm = cm.reshape(1, self.Ls, 1, 1, 1, 1, 1)

    def _H(self, x):
        return (self.pm * self.cp * torch.roll(x, -1, dims=1)
                + self.pp * self.cm * torch.roll(x, 1, dims=1))

    def _Hh(self, x):
        return (self.pm * torch.roll(self.cp * x, 1, dims=1)
                + self.pp * torch.roll(self.cm * x, -1, dims=1))

    def _dw(self, x, dagger=False):
        n, Ls, lat = x.shape[0], x.shape[1], tuple(x.shape[3:])
        v = x.reshape((n * Ls, 4, 3) + lat)
        if dagger:
            v = self.hop.apply(v * self.g5) * self.g5
        else:
            v = self.hop.apply(v)
        return v.reshape(x.shape)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """D x for x [n, Ls, 12, *lat]."""
        x = x.to(self.dtype)
        Hx = self._H(x)
        return self._dw(self.b5 * x + self.c5 * Hx) + x - Hx

    def adjoint(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        u = self._dw(x, dagger=True)
        return self.b5 * u + self.c5 * self._Hh(u) + x - self._Hh(x)
