"""The frozen byte and operation counts of K1 against hand-computed
values."""

import pytest

from counts.k1 import bound_s, k1_bytes, k1_flops

PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 6.7e13}


@pytest.mark.parametrize("shape, ndir, per_site, per_col", [
    # blocks 9 directions x 9 complex f32 = 648 B; x and y 12 complex f32 = 96 B each
    ((4, 4, 3, 3), 9, 648, 192),
    # one 12x12 complex f32 block = 1152 B; x and y 96 B each
    ((1, 1, 12, 12), 1, 1152, 192),
])
@pytest.mark.parametrize("V, ncols", [(1, 1), (2 ** 21, 1), (2 ** 21, 12), (65536, 12)])
def test_bytes(shape, ndir, per_site, per_col, V, ncols):
    assert k1_bytes(*shape, ndir, V, ncols) == V * (per_site + per_col * ncols)


def test_operations_and_bound():
    V = 32 * 32 * 32 * 64
    assert k1_flops(4, 4, 3, 3, 9, V, 1) == 3072 * V
    assert k1_flops(1, 1, 12, 12, 1, V, 12) == 8 * 144 * V * 12
    # cls-d200 at 1 rhs: both launches bound by bytes
    tiled = bound_s(k1_bytes(4, 4, 3, 3, 9, V, 1), k1_flops(4, 4, 3, 3, 9, V, 1), PEAKS)
    site = bound_s(k1_bytes(1, 1, 12, 12, 1, V, 1), k1_flops(1, 1, 12, 12, 1, V, 1), PEAKS)
    assert tiled == pytest.approx(840 * V / 3.35e12)
    assert site == pytest.approx(1344 * V / 3.35e12)
    assert bound_s(100, 10 ** 9, PEAKS) == pytest.approx(1e9 / 6.7e13)

