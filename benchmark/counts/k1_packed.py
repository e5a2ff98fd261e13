"""Frozen work counts of K1's packed route: the Wilson hopping term
between checkerboard packings (``packed_parity``), eight directions over
the V/2 sites of one parity, the centre direction dropped.

Bytes are ``counts/k1.py``'s ``k1_bytes`` at ``ndir`` = 8 over the half
lattice.  The operations are those of the port's spin plan for the packed
Wilson kron (``factor_kron`` on the eight hops r -+ gamma_mu, each of rank
2 at r = 1), counted once on the CPU and kept as a number, as
``counts/k1.py`` keeps 3072 for the nine directions: a direction projects
x onto two spin slots (4 nonzero entries x 3 colours), multiplies the two
half spinors by the 3x3 link (2 x 9) and spreads them onto four spin
rows (4 x 3), 42 complex multiply-adds; eight directions, 336; 8 real
operations a complex multiply-add, 2688 a site and column (3072 less the
centre's 48 x 8).
"""

from __future__ import annotations

#: operations a site and column of the packed hopping term, 8 directions
FLOPS_PER_SITE_COL = 2688
#: the launch's shape (KI, KD, BI, BD) and directions
SHAPE, NDIR = (4, 4, 3, 3), 8


def k1_packed_flops(V_half: int, ncols: int) -> int:
    return FLOPS_PER_SITE_COL * V_half * ncols
