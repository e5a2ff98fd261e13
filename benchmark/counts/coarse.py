"""Frozen work counts of one apply of a coarse (multigrid) operator, from
shapes alone.

A coarse operator couples each coarse site to ``ndir`` sites (itself and
its nearest neighbours) through dense N_c x N_c complex blocks.  One
apply to ``ncols`` columns needs at least: the blocks read once (real
and imaginary float32 planes), x read once and y written once.  Whatever
computes it (the batched-GEMM kernels behind ``bsr.py``'s gather apply
today, three Gauss products a part), the same count applies, so an apply
that reads the blocks more than once shows as a lower share of its
roofline.  The operations: one complex multiply-add (8 real operations)
a block entry and column.
"""

from __future__ import annotations


def coarse_bytes(sites: int, nc: int, ndir: int, ncols: int = 1, block_bytes: int = 4,
                 field_bytes: int = 4) -> int:
    """Bytes an apply must move: blocks [sites, ndir, nc, nc], x and y
    [sites, nc, ncols], split complex (two planes each)."""
    blocks = 2 * ndir * nc * nc * sites * block_bytes
    x = 2 * nc * sites * ncols * field_bytes
    y = 2 * nc * sites * ncols * field_bytes
    return blocks + x + y


def coarse_flops(sites: int, nc: int, ndir: int, ncols: int = 1) -> int:
    return 8 * ndir * nc * nc * sites * ncols
