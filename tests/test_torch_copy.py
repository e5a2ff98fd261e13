"""superbblas_tpu_torch.ops.copy against superbblas_tpu.ops.copy: the
cases of test_copy.py, run through both packages on the same numpy
inputs.  A copy moves, scales and adds elements with the same operations
in both, so results are compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superbblas_tpu import cplx as JC
from superbblas_tpu import local_copy as j_copy
from superbblas_tpu import local_permute as j_permute
from superbblas_tpu.utils.testing import numpy_copy_reference
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch import local_copy as t_copy
from superbblas_tpu_torch import local_permute as t_permute


def rand(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.complexfloating):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def split(a):
    """A numpy array as the port's operand: a tensor, or a CArray when
    complex."""
    if np.iscomplexobj(a):
        return TC.from_complex(a)
    return torch.from_numpy(a.copy())


def as_np(out):
    if isinstance(out, TC.CArray):
        return out.re.numpy() + 1j * out.im.numpy()
    if isinstance(out, JC.CArray):
        return np.asarray(out.re) + 1j * np.asarray(out.im)
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def both_copy(alpha, x, o0, y, o1, **kw):
    """(port result, JAX result) of the same copy as numpy arrays; the
    port's result is checked for the type JAX gives."""
    got = t_copy(alpha, split(x), o0, split(y), o1, **kw)
    want = j_copy(alpha, jnp.asarray(x), o0, jnp.asarray(y), o1, **kw)
    g, w = as_np(got), as_np(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    return g, w


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_full_permute(dtype):
    x = rand((3, 4, 5), dtype)
    y = np.zeros((5, 3, 4), dtype=dtype)
    np.testing.assert_array_equal(*both_copy(1, x, "abc", y, "cab"))


def test_permute_helper():
    x = rand((3, 4), np.float64)
    np.testing.assert_array_equal(t_permute(torch.from_numpy(x), "ab", "ba").numpy(),
                                  np.asarray(j_permute(jnp.asarray(x), "ab", "ba")))


def test_permute_carray_with_dtype():
    x = rand((2, 3, 4, 5), np.float64, seed=20), rand((2, 3, 4, 5), np.float64, seed=21)
    got = t_permute(TC.CArray(*map(torch.from_numpy, x)), "xyzt", "tzyx",
                    dtype=torch.float32)
    want = j_permute(JC.CArray(*map(jnp.asarray, x)), "xyzt", "tzyx", dtype=jnp.float32)
    assert got.re.dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("copy_add", ["copy", "add"])
@pytest.mark.parametrize("alpha", [1.0, 0.0, -2.5])
def test_box_copy_no_wrap(copy_add, alpha):
    x = rand((6, 8), np.float64, seed=1)
    y = rand((8, 10), np.float64, seed=2)
    np.testing.assert_array_equal(*both_copy(
        alpha, x, "ab", y, "ba", from0=(1, 2), size0=(4, 5), from1=(2, 3),
        copy_add=copy_add))


@pytest.mark.parametrize("copy_add", ["copy", "add"])
@pytest.mark.parametrize("where", ["source", "dest", "both"])
def test_box_copy_wrap(copy_add, where):
    x = rand((6, 8), np.float64, seed=3)
    y = rand((6, 8), np.float64, seed=4)
    from0 = (0, 0) if where == "dest" else (4, 6)
    from1 = (0, 0) if where == "source" else (4, 6)
    np.testing.assert_array_equal(*both_copy(
        1.0, x, "ab", y, "ab", from0=from0, size0=(4, 5), from1=from1,
        copy_add=copy_add))


def test_rank_change_drop_and_add_labels():
    x = rand((1, 4, 5), np.float64, seed=7)
    y = rand((5, 3, 4), np.float64, seed=8)
    np.testing.assert_array_equal(*both_copy(
        1.0, x, "zab", y, "bwa", from0=(0, 0, 0), size0=(1, 4, 5), from1=(0, 1, 0)))


def test_precision_convert():
    x = rand((4, 4), np.float32, seed=9)
    y = np.zeros((4, 4), dtype=np.float64)
    g, w = both_copy(1.0, x, "ab", y, "ab")
    assert g.dtype == np.float64
    np.testing.assert_array_equal(g, w)


def test_alpha_zero_zeroes_box():
    y = rand((4, 4), np.float64, seed=10)
    x = rand((4, 4), np.float64, seed=11)
    g, w = both_copy(0.0, x, "ab", y, "ab", from0=(0, 0), size0=(2, 2), from1=(1, 1))
    np.testing.assert_array_equal(g, w)
    assert (g[1:3, 1:3] == 0).all()


def checkerboard(shape, parity=0):
    return np.add.reduce(np.indices(shape)) % 2 == parity


@pytest.mark.parametrize("case", ["pairing", "different_positions", "add_scaled",
                                  "compact_checkerboard"])
def test_masked_copy(case):
    x = rand((4, 4), np.float64, seed=12)
    y = np.zeros((4, 4), dtype=np.float64)
    alpha, copy_add = 1.0, "copy"
    if case == "pairing":
        m0 = m1 = checkerboard((4, 4))
    elif case == "different_positions":
        x = np.arange(16, dtype=np.float64).reshape(4, 4)
        m0 = np.zeros((4, 4), dtype=bool); m0[0, :] = True
        m1 = np.zeros((4, 4), dtype=bool); m1[1, :] = True
    elif case == "add_scaled":
        y = rand((4, 4), np.float64, seed=15)
        m0, m1, alpha, copy_add = checkerboard((4, 4)), checkerboard((4, 4), 1), -2.5, "add"
    else:
        # even sites of x, packed into the first half (a < 2) of y
        x = rand((4, 4, 2, 6), np.float64, seed=16)
        y = np.zeros((4, 4, 2, 6), dtype=np.float64)
        m0, m1 = checkerboard(x.shape), np.indices(y.shape)[0] < 2
    g, w = both_copy(alpha, x, "abcd"[:x.ndim], y, "abcd"[:y.ndim], mask0=m0,
                     mask1=m1, copy_add=copy_add)
    np.testing.assert_array_equal(g, w)
    if case == "compact_checkerboard":
        np.testing.assert_array_equal(g[:2].reshape(-1), x[m0])
        assert (g[2:] == 0).all()


def test_masked_copy_incompatible_raises():
    x = rand((4, 4), np.float64, seed=13)
    y = np.zeros((4, 4), dtype=np.float64)
    m0 = np.zeros((4, 4), dtype=bool); m0[0, 0] = True
    m1 = np.zeros((4, 4), dtype=bool); m1[0, 0] = True; m1[1, 1] = True
    for fn, conv in ((t_copy, torch.from_numpy), (j_copy, jnp.asarray)):
        with pytest.raises(ValueError, match="incompatible"):
            fn(1.0, conv(x), "ab", conv(y), "ab", mask0=m0, mask1=m1)


@pytest.mark.parametrize("alpha", [1.5 - 0.5j, np.complex128(-0.25 + 2j)])
def test_complex_scale(alpha):
    """A complex alpha mixes the parts: the port scales the CArray as the
    JAX package scales its own CArray (the same products and sums)."""
    x = rand((3, 3), np.complex128, seed=14)
    y = rand((3, 3), np.complex128, seed=17)
    got = t_copy(alpha, TC.from_complex(x), "ab", TC.from_complex(y), "ab",
                 from0=(1, 0), size0=(2, 3), from1=(2, 0), copy_add="add")
    want = j_copy(alpha, JC.from_complex(x), "ab", JC.from_complex(y), "ab",
                  from0=(1, 0), size0=(2, 3), from1=(2, 0), copy_add="add")
    np.testing.assert_array_equal(as_np(got), as_np(want))
    np.testing.assert_allclose(as_np(got), numpy_copy_reference(
        alpha, x, "ab", y, "ab", (1, 0), (2, 3), (2, 0), "add"), rtol=1e-14)


def _fuzz_cases():
    """The seeded sweep of test_copy.py's fuzz: wrapped source and
    destination boxes, label permutations, copy/add, alpha variants."""
    rng = np.random.default_rng(77)
    cases = []
    for _ in range(25):
        nd = int(rng.integers(1, 4))
        labels = "abc"[:nd]
        dim0 = tuple(int(rng.integers(2, 7)) for _ in range(nd))
        perm = list(rng.permutation(nd))
        o0 = labels
        o1 = "".join(labels[i] for i in perm)
        dim1 = tuple(int(rng.integers(2, 7)) for _ in range(nd))
        size0 = tuple(int(rng.integers(1, min(dim0[i], dim1[o1.index(o0[i])]) + 1))
                      for i in range(nd))
        from0 = tuple(int(rng.integers(0, d)) for d in dim0)
        from1 = tuple(int(rng.integers(0, d)) for d in dim1)
        copy_add = ["copy", "add"][int(rng.integers(0, 2))]
        alpha = [1.0, 2.5, -1.0][int(rng.integers(0, 3))]
        cases.append((alpha, rng.standard_normal(dim0), o0, rng.standard_normal(dim1),
                      o1, dict(from0=from0, size0=size0, from1=from1, copy_add=copy_add)))
    return cases


FUZZ = _fuzz_cases()


@pytest.mark.parametrize("case", range(len(FUZZ)))
def test_fuzz_wrapped_box_copies(case):
    alpha, x, o0, y, o1, kw = FUZZ[case]
    g, w = both_copy(alpha, x, o0, y, o1, **kw)
    np.testing.assert_array_equal(g, w, err_msg=f"case {case}: {o0}->{o1} {kw}")
    np.testing.assert_array_equal(g, numpy_copy_reference(alpha, x, o0, y, o1, **kw))


@pytest.mark.parametrize("case", ["full_copy", "full_add", "box", "wrapped_box",
                                  "zero_box", "masked", "carray"])
def test_never_modifies_y(case):
    """The copy is functional: the caller's y keeps its values, and the
    result shares memory with neither y nor x."""
    x = torch.from_numpy(rand((4, 6), np.float64, seed=30))
    y = torch.from_numpy(rand((4, 6), np.float64, seed=31))
    kw = {"full_copy": {}, "full_add": dict(copy_add="add"),
          "box": dict(from0=(1, 1), size0=(2, 3), from1=(0, 2)),
          "wrapped_box": dict(from0=(3, 4), size0=(2, 3), from1=(3, 5), copy_add="add"),
          "zero_box": dict(from0=(0, 0), size0=(2, 2), from1=(1, 1)),
          "masked": dict(mask0=checkerboard((4, 6)), mask1=checkerboard((4, 6), 1)),
          "carray": dict(from0=(1, 1), size0=(2, 3), from1=(2, 4))}[case]
    alpha = 0.0 if case == "zero_box" else 1.0
    if case == "carray":
        x, y = TC.CArray(x, 2 * x), TC.CArray(y, 3 * y)

    def parts(a):
        return list(a) if isinstance(a, TC.CArray) else [a]

    before = [p.clone() for p in parts(y) + parts(x)]
    out = t_copy(alpha, x, "ab", y, "ab", **kw)
    for b, now in zip(before, parts(y) + parts(x)):
        assert torch.equal(b, now)
    for o in parts(out):
        for a in parts(y) + parts(x):
            assert o.untyped_storage().data_ptr() != a.untyped_storage().data_ptr()
