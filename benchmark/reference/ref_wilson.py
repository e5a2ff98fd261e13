"""Plain PyTorch Wilson hopping, the base of the clover and Moebius
references.  It imports nothing of the port and nothing the port made:
it takes the links the benchmark made and forms every block itself.

    D_W x(s) = (m + 4 r) x(s)
               - 1/2 sum_mu [ (r - g_mu) U_mu(s) x(s + mu)
                            + (r + g_mu) U_mu(s - mu)^H x(s - mu) ]

Gamma matrices in the DeGrand-Rossi (chiral) basis, g5 = g0 g1 g2 g3 =
diag(1, 1, -1, -1).  Fields are complex [n, 4, 3, X, Y, Z, T] (spin
major, the port's SoA feature order); links U[mu, X, Y, Z, T, a, b].
Boundaries are periodic in the arrays given: a caller that holds a slab
passes it with one halo plane on each side of X and keeps the interior.

``q`` rounds each operand of a product (the identity for the reference;
TF32 rounding for the control), so the reference and its control are
one code.
"""

from __future__ import annotations

import torch


def gammas(device) -> torch.Tensor:
    """[4, 4, 4] complex128: g_x, g_y, g_z, g_t (DeGrand-Rossi)."""
    j = 1j
    g = torch.tensor([
        [[0, 0, 0, j], [0, 0, j, 0], [0, -j, 0, 0], [-j, 0, 0, 0]],
        [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]],
        [[0, 0, j, 0], [0, 0, 0, -j], [-j, 0, 0, 0], [0, j, 0, 0]],
        [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]],
    ], dtype=torch.complex128, device=device)
    return g


def real_dtype(dtype):
    return torch.float32 if dtype == torch.complex64 else torch.float64


def gamma5_signs(device, dtype) -> torch.Tensor:
    """g5's diagonal, [4, 1, 1, 1, 1, 1] to broadcast over [n, 4, 3, *lat]."""
    g = gammas(device)
    g5 = g[0] @ g[1] @ g[2] @ g[3]
    return torch.diagonal(g5).real.to(dtype).reshape(4, 1, 1, 1, 1, 1)


def shift(a: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """a(s) -> a(s + k along axis)."""
    return torch.roll(a, -k, dims=axis)


def exact(t):
    return t


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 stored mantissa bits, nearest even), as a
    tensor core rounds a float32 operand; complex parts each."""
    if t.is_complex():
        return torch.complex(tf32(t.real.contiguous()), tf32(t.imag.contiguous()))
    b = t.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def colour(Ut: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[n, s, a, site] = sum_b U[site, a, b] x[n, s, b, site]; Ut [a, b, *lat]."""
    return sum(Ut[:, b] * x[:, :, b:b + 1] for b in range(3))


def spin(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[n, s] = sum_t P[s, t] x[n, t] for a 4x4 spin matrix whose entries
    are 0, +-1/2, +-i/2 (exact in any precision used here)."""
    out = None
    for s in range(4):
        row = None
        for t in range(4):
            c = complex(P[s, t])
            if c == 0:
                continue
            term = x[:, t] * c
            row = term if row is None else row + term
        out = [row] if out is None else out + [row]
    return torch.stack(out, dim=1)


class WilsonHop:
    """D_W over ``links`` [4, *lat, 3, 3] at ``mass`` and ``r``, applied to
    fields of ``dtype`` (links cast to it once)."""

    def __init__(self, links: torch.Tensor, mass: float, r: float = 1.0,
                 dtype=torch.complex128, q=exact):
        self.dtype, self.q = dtype, q
        self.mass, self.r = float(mass), float(r)
        g = gammas(links.device)
        eye = torch.eye(4, dtype=torch.complex128, device=links.device)
        self.fwd = [(-0.5 * (r * eye - g[mu])).cpu() for mu in range(4)]
        self.bwd = [(-0.5 * (r * eye + g[mu])).cpu() for mu in range(4)]
        # U_mu(s) and U_mu(s - mu)^H as [mu, a, b, *lat], formed and rounded once
        self.U = q(links.to(dtype).movedim((-2, -1), (1, 2)).contiguous())
        self.Ub = q(torch.stack([shift(links[mu], mu, -1).transpose(-1, -2).conj()
                                 for mu in range(4)]).to(dtype).movedim((-2, -1), (1, 2))
                    .contiguous())

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """D_W x for x [n, 4, 3, *lat] of ``dtype``."""
        x = self.q(x)
        y = (self.mass + 4.0 * self.r) * x
        for mu in range(4):
            ax = 3 + mu
            y = y + spin(self.fwd[mu], colour(self.U[mu], shift(x, ax, 1)))
            y = y + spin(self.bwd[mu], colour(self.Ub[mu], shift(x, ax, -1)))
        return y
