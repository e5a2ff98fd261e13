"""superbblas_tpu_torch.ops.reduce against superbblas_tpu.ops.reduce on
the same numpy inputs: label_sum (sums in another order: f64 tolerance),
select and scal (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, both, crand_np
from superbblas_tpu.ops import reduce as J
from superbblas_tpu_torch.ops import reduce as T

SHAPE = (3, 4, 5, 6)


@pytest.mark.parametrize("carray", [False, True])
@pytest.mark.parametrize("o1", ["tzyx", "xz", "t", "", "xyzt"])
def test_label_sum_matches_jax(o1, carray):
    parts = crand_np(SHAPE, 0)
    if carray:
        jx, tx = both(parts)
    else:
        jx, tx = jnp.asarray(parts[0]), torch.from_numpy(parts[0])
    got, want = T.label_sum(tx, "xyzt", o1), J.label_sum(jx, "xyzt", o1)
    assert tuple(got.shape) == tuple(want.shape)
    assert_parity(got, want, np.float64)


def test_label_sum_rejects_new_labels():
    x = np.zeros((2, 3))
    for mod, conv in ((T, torch.from_numpy), (J, jnp.asarray)):
        with pytest.raises(ValueError, match="not in"):
            mod.label_sum(conv(x), "ab", "aw")


@pytest.mark.parametrize("carray", [False, True])
def test_select_matches_jax(carray):
    parts = crand_np(SHAPE, 1)
    mask = np.random.default_rng(2).random(SHAPE) < 0.4
    if carray:
        jx, tx = both(parts)
    else:
        jx, tx = jnp.asarray(parts[0]), torch.from_numpy(parts[0])
    got, want = T.select(tx, mask), J.select(jx, mask)
    assert tuple(got.shape) == (int(mask.sum()),)
    for g, w in zip(got if carray else (got,), want if carray else (want,)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("alpha", [-0.75, 0.5 - 1.25j])
@pytest.mark.parametrize("carray", [False, True])
def test_scal_matches_jax(alpha, carray):
    parts = crand_np(SHAPE, 3)
    if carray:
        jx, tx = both(parts)
    else:
        jx, tx = jnp.asarray(parts[0]), torch.from_numpy(parts[0])
    got, want = T.scal(alpha, tx), J.scal(alpha, jx)
    if not carray and isinstance(alpha, complex):
        got, want = (got.real, got.imag), (jnp.real(want), jnp.imag(want))
    assert_parity(got, want, np.float64)
