"""superbblas_tpu_torch.native against superbblas_tpu.native: the port's
own build of the plan engine gives the JAX package's rows for
``intersect_all`` and ``fragment_plan``, lives under the port's
``_build/`` and not next to either package's source, and every entry
returns None without a toolchain."""

from pathlib import Path

import numpy as np
import pytest

from _torch_parity import jax_native_lib
from superbblas_tpu import native as JN
from superbblas_tpu import parallel as par
from superbblas_tpu_torch import native as TN

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def both_libs():
    if TN.get_lib() is None or jax_native_lib() is None:
        pytest.skip("native toolchain unavailable")
    return True


def boxes_arr(part):
    return np.asarray([[b[0], b[1]] for b in part.boxes])


def test_library_lives_under_build(both_libs):
    path = Path(TN.get_lib()._name).resolve()
    assert path == TN.library_path().resolve()
    assert path.parent.parent == (ROOT / "superbblas_tpu_torch" / "_build").resolve()
    assert not (ROOT / "superbblas_tpu_torch" / "native" / "libsbtplan.so").exists()
    assert (ROOT / "superbblas_tpu_torch" / "native" / "plan_engine.cpp").read_bytes() == \
        (ROOT / "superbblas_tpu" / "native" / "plan_engine.cpp").read_bytes()


@pytest.mark.parametrize("copy_add", ["copy", "add"])
@pytest.mark.parametrize("case", range(3))
def test_fragment_plan_matches_jax(both_libs, copy_add, case):
    dim = ((8, 6), (12, 5), (9, 7))[case]
    src = par.basic_partitioning("xy", dim, ((4, 2), (8, 1), (3, 1))[case])
    dst = par.basic_partitioning("xy", dim, ((2, 2), (2, 4), (1, 7))[case], nprocs=8,
                                 ext_power=(1, 0))
    got = TN.fragment_plan(boxes_arr(src), boxes_arr(dst), dim, copy_add)
    want = JN.fragment_plan(boxes_arr(src), boxes_arr(dst), dim, copy_add)
    assert got is not None and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_intersect_all_matches_jax(both_libs, seed):
    """Random (wrapped) box lists on a 2-D or 3-D torus: the same rows."""
    rng = np.random.default_rng(seed)
    nd = 2 + seed % 2
    dim = tuple(int(v) for v in rng.integers(4, 10, nd))

    def boxes(n):
        return np.asarray([[[int(rng.integers(0, d)) for d in dim],
                            [int(rng.integers(1, d + 1)) for d in dim]] for _ in range(n)])

    a, b = boxes(3), boxes(7)
    got, want = TN.intersect_all(a, b, dim), JN.intersect_all(a, b, dim)
    assert got is not None and len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_no_toolchain_gives_none(monkeypatch, tmp_path):
    """Without g++ the loader returns None, and so does every entry: the
    caller takes its Python sweep."""
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_tried", False)
    monkeypatch.setattr(TN, "BUILD", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert TN.get_lib() is None
    assert TN.intersect_all([[[0], [2]]], [[[1], [2]]], (4,)) is None
    assert TN.fragment_plan([[[0], [4]]], [[[0], [4]]], (4,)) is None
