"""Frozen work counts of the stencil kernel K1, from shapes alone.

A launch at block shape (KI, KD, BI, BD) over ``ndir`` directions, V
sites and ``ncols`` columns needs at least: the blocks read once (real
and imaginary planes), x read once and y written once.  Whatever route
computes it, the same count applies, so a kernel that reads a byte twice
shows as a lower share of its roofline.

The operations are those of the port's spin plan for the Wilson kron
(``factor_kron``: one direct centre direction, eight directions projected
onto two spin slots), counted once here on the CPU and kept as a number
so that a later change of the plan cannot move the yardstick: 3072 real
operations a site and column (8 a complex multiply-add).  The clover
term (1, 1, 12, 12) is one dense 12x12 complex product a site and
column: 8 x 144 = 1152.
"""

from __future__ import annotations

#: operations a site and column, by (KI, KD, BI, BD, ndir)
FLOPS_PER_SITE_COL = {(4, 4, 3, 3, 9): 3072, (1, 1, 12, 12, 1): 1152}


def k1_bytes(ki, kd, bi, bd, ndir, V, ncols, block_bytes=4, field_bytes=4) -> int:
    """Bytes a launch must move: blocks [ndir, BI*BD, V], x [ncols, KD*BD,
    V] and y [ncols, KI*BI, V], split complex (two planes each)."""
    blocks = 2 * ndir * bi * bd * V * block_bytes
    x = 2 * ncols * kd * bd * V * field_bytes
    y = 2 * ncols * ki * bi * V * field_bytes
    return blocks + x + y


def k1_flops(ki, kd, bi, bd, ndir, V, ncols) -> int:
    return FLOPS_PER_SITE_COL[(ki, kd, bi, bd, ndir)] * V * ncols


def bound_s(nbytes: int, flops: int, peaks: dict) -> float:
    """The least time the card could take: the larger of the bytes at the
    data sheet's bandwidth and the operations at its float32 rate."""
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["f32_flops_per_s"])
