"""superbblas_tpu_torch.ops.permute against superbblas_tpu's Pallas tiled
transpose, run in interpret mode on the CPU, and the tile sweep E3's plain
version and tile arithmetic against np.transpose (the CUDA kernels' own
tests are in test_torch_cuda.py).  Permutes are exact: results are
compared bit for bit."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superbblas_tpu.ops.permute_pallas import pallas_permute
from superbblas_tpu_torch.ops import permute as P

SHAPES = [(16, 8, 8, 32), (16, 4, 8, 32), (8, 16, 24, 128)]
PERMS = [(3, 2, 1, 0), (3, 1, 2, 0)]


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("perm", PERMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_permute(shape, perm):
    x = rand(shape)
    want = np.asarray(pallas_permute(jnp.asarray(x), perm, interpret=True))
    before = P.permute_4d.launches
    for fn in (P.permute_4d_reference, P.maybe_permute, P.permute_4d):
        got = fn(torch.from_numpy(x), perm)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    assert P.permute_4d.launches == before   # the CPU runs the plain version


@pytest.mark.parametrize("perm", PERMS)
def test_strided_view_matches_pallas_permute(perm):
    """A box sliced out of a larger tensor (a view, as ``_extract_box``
    gives it) permutes like the materialised box."""
    x = rand((20, 9, 10, 40), seed=1)
    view = torch.from_numpy(x)[2:18, 1:9, 3:7, 5:37]
    assert not view.is_contiguous()
    want = np.asarray(pallas_permute(jnp.asarray(x[2:18, 1:9, 3:7, 5:37]), perm,
                                     interpret=True))
    np.testing.assert_array_equal(P.maybe_permute(view, perm).numpy(), want)


@pytest.mark.parametrize("shape,perm,dtype,eligible", [
    ((16, 8, 8), (2, 1, 0), torch.float32, False),           # rank
    ((16, 8, 8, 32), (0, 1, 2, 3), torch.float32, False),    # perm
    ((16, 8, 8, 32), (2, 1, 3, 0), torch.float32, False),    # perm
    ((16, 8, 8, 32), (3, 2, 1, 0), torch.float64, False),    # 8-byte data
    ((16, 8, 8, 32), (3, 2, 1, 0), torch.bfloat16, False),   # 2-byte data
    ((1, 8, 8, 32), (3, 2, 1, 0), torch.float32, False),     # X = 1
    ((16, 8, 8, 1), (3, 1, 2, 0), torch.float32, False),     # T = 1
    ((16, 0, 8, 32), (3, 2, 1, 0), torch.float32, False),    # empty
    ((16, 8, 8, 32), (3, 2, 1, 0), torch.float32, True),
    ((16, 8, 8, 32), (3, 1, 2, 0), torch.int32, True),
    ((16, 9, 8, 32), (3, 2, 1, 0), torch.float32, True),     # TPU: Y % 8 != 0
    ((4096, 8, 8, 4096), (3, 2, 1, 0), torch.float32, True),  # TPU: VMEM
    ((2, 1, 1, 2), (3, 1, 2, 0), torch.float32, True),
])
def test_eligibility(shape, perm, dtype, eligible):
    assert P.permute_eligible(shape, perm, dtype) is eligible


@pytest.mark.parametrize("shape,perm", [((3, 4, 5), (2, 0, 1)), ((1, 8, 8, 32), (3, 2, 1, 0)),
                                        ((2, 3, 4, 5, 6), (4, 3, 2, 1, 0))])
def test_other_cases_use_torch_permute(shape, perm):
    x = torch.from_numpy(rand(shape, seed=2))
    got = P.maybe_permute(x, perm)
    assert got.is_contiguous() and torch.equal(got, x.permute(perm))


def test_kernel_wrapper_raises_off_the_cpu_without_a_kernel():
    x = torch.empty((16, 8, 8, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        P.permute_4d(x, (3, 2, 1, 0))


def tiled_walk(x, perm, point, grid):
    """The tile sweep's copy, block by block, as csrc/permute.cu's 16-byte
    forms walk it: a persistent grid of ``grid`` blocks, block b taking the
    items b, b + grid, ... of ``sweep_items`` ((y, z) plane slowest, then
    the X tile, then the T tile), each item's EX x ET tile copied with a
    slice; the ragged X and T tiles end in whole 16-byte words."""
    perm = tuple(int(p) for p in perm)
    X, Y, Z, T = x.shape
    _, EX, ET, _, _ = point
    items, ntx, ntt = P.sweep_items(tuple(x.shape), point)
    out = torch.empty(tuple(x.shape[p] for p in perm), dtype=x.dtype)
    flat = out.view(T, Y * Z, X)
    for b in range(grid):
        for item in range(b, items, grid):
            yz, rest = divmod(item, ntx * ntt)
            xt, tt = divmod(rest, ntt)
            y, z = divmod(yz, Z)
            x0, t0 = xt * EX, tt * ET
            x1, t1 = min(x0 + EX, X), min(t0 + ET, T)
            assert (x1 - x0) % 4 == 0 and (t1 - t0) % 4 == 0   # whole 16-byte words
            plane = z * Y + y if P.SUPPORTED[perm] else yz
            flat[t0:t1, plane, x0:x1] = x[x0:x1, y, z, t0:t1].T
    return out


@pytest.mark.parametrize("grid", [264, 3])
@pytest.mark.parametrize("tile", P.TILES)
@pytest.mark.parametrize("perm", PERMS)
def test_tile_sweep_walk_matches_numpy(perm, tile, grid):
    """The tile sweep's blocks, as each design point walks them on a
    persistent grid (two blocks an SM of an H100, more than the items; and
    3 blocks, each walking many items), with ragged X and T tiles, copy
    exactly np.transpose; the wrapper's CPU path is the plain version."""
    x = rand((72, 3, 5, 44), seed=3)
    assert P.sweep_takes(x.shape, torch.from_numpy(x).stride(), 0)
    want = np.transpose(x, perm)
    got = tiled_walk(torch.from_numpy(x), perm, tile, grid)
    np.testing.assert_array_equal(got.numpy(), want)
    before = P.permute_4d_tiled.launches
    np.testing.assert_array_equal(P.permute_4d_tiled(torch.from_numpy(x), perm, tile).numpy(),
                                  want)
    assert P.permute_4d_tiled.launches == before


def test_tile_sweep_refusals():
    x = torch.zeros((16, 8, 8, 32))
    with pytest.raises(ValueError, match="not one of"):
        P.permute_4d_tiled(x, (3, 2, 1, 0), (32, 8, 1))
    with pytest.raises(ValueError, match="no kernel for device"):
        P.permute_4d_tiled(x.to("meta"), (3, 2, 1, 0), P.TILES[0])
    # permute_4d's 16-byte design point is one of the sweep, and so is a TMA one
    assert P.K2_POINT in P.TILES and P.K2_POINT[0] == "ring"
    assert any(point[0] == "tma" for point in P.TILES)


@pytest.mark.parametrize("shape,strides,ptrs,takes", [
    ((16, 8, 8, 32), (2048, 256, 32, 1), (0, 0), True),
    ((72, 3, 5, 44), (660, 220, 44, 1), (16, 4096), True),
    ((16, 1, 8, 32), (256, 7, 32, 1), (0, 0), True),        # extent 1: its stride aside
    ((18, 8, 8, 32), (2048, 256, 32, 1), (0, 0), False),     # X % 4
    ((16, 8, 8, 30), (1920, 240, 30, 1), (0, 0), False),     # T % 4
    ((16, 8, 8, 32), (2048, 256, 32, 2), (0, 0), False),     # T's stride
    ((16, 8, 8, 32), (2050, 256, 32, 1), (0, 0), False),     # X's stride
    ((16, 8, 8, 32), (2048, 256, 32, 1), (4, 0), False),     # input pointer
    ((16, 8, 8, 32), (2048, 256, 32, 1), (0, 8), False),     # output pointer
])
def test_tile_sweep_takes_16_byte_views(shape, strides, ptrs, takes):
    """The views the sweep's 16-byte forms take are those of permute_4d's
    16-byte route."""
    assert P.sweep_takes(shape, strides, *ptrs) is takes
    assert (P.permute_route(shape, strides, *ptrs) == "vec16") is takes
