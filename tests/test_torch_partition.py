"""superbblas_tpu_torch.parallel.partition against superbblas_tpu's (host
code, compared in-process): the 2-3 factorisation, the process grids,
``basic_partitioning`` in all its modes, the box algebra, ``make_hole``
and the partition predicates, on the cases of tests/test_partition.py
and seeded fuzz.  The redistribution plans over both plan engines (the
native one and the Python box algebra) are compared too."""

from itertools import product

import numpy as np
import pytest

from _torch_parity import jax_native_lib
from superbblas_tpu.parallel import partition as JP
from superbblas_tpu_torch.parallel import partition as TP


def _same(t, j):
    assert t.dim == j.dim and t.boxes == j.boxes and t.ncomponents == j.ncomponents


@pytest.mark.parametrize("n", list(range(1, 60)) + [96, 128, 200, 1000])
def test_factors23_matches_jax(n):
    t, j = TP.Factors23(n), JP.Factors23(n)
    assert (t.two, t.three, t.value) == (j.two, j.three, j.value)
    assert repr(t) == repr(j)


PROCS_CASES = [("xyzt", (8, 8, 8, 8), "tzyx", 4), ("xyzt", (1, 8, 1, 8), "xyzt", 4),
               ("xy", (16, 2), "xy", 8), ("xyz", (12, 6, 5), "zyx", 6),
               ("xyzt", (32, 32, 32, 64), "xy", 4), ("xyzt", (4, 4, 4, 4), "t", 3),
               ("xy", (7, 5), "xy", 1), ("xyzt", (6, 6, 6, 6), "xyzt", 12)]


@pytest.mark.parametrize("case", PROCS_CASES)
def test_partitioning_distributed_procs_matches_jax(case):
    assert TP.partitioning_distributed_procs(*case) == JP.partitioning_distributed_procs(*case)


BP_CASES = [
    (("xy", (8, 4), (2, 2)), {}),
    (("x", (10,), (4,)), {}),
    (("xy", (4, 4), (2, 2)), {"dist_labels": "yx"}),
    (("x", (8,), (2,)), {"ext_power": (1,)}),
    (("x", (4,), (2,)), {"ext_power": (2,)}),
    (("xy", (4, 4), (1, 1)), {"nprocs": 4, "replicate": True}),
    (("x", (2,), (1,)), {"nprocs": 4}),
    (("xyzt", (8, 8, 8, 8), None), {"nprocs": 4, "dist_labels": "tz"}),
    (("xyz", (9, 6, 4), (3, 2, 1)), {"ext_power": (1, 1, 0)}),
    (("xy", (8, 6), (2, 1)), {"ncomponents": 2}),
    (("xyzt", (32, 32, 32, 64), (4, 1, 1, 1)), {}),
    (("xy", (10, 6), (3, 1)), {"nprocs": 4}),
]


@pytest.mark.parametrize("case", range(len(BP_CASES)))
def test_basic_partitioning_matches_jax(case):
    args, kw = BP_CASES[case]
    t, j = TP.basic_partitioning(*args, **kw), JP.basic_partitioning(*args, **kw)
    _same(t, j)
    assert t.nprocs == j.nprocs and len(t) == len(j)
    assert t.grid_shape() == j.grid_shape()
    assert t.is_replicated() == j.is_replicated()
    assert t.has_full_support() == j.has_full_support()
    assert t.are_there_repetitions() == j.are_there_repetitions()
    for r in range(t.nprocs):
        assert t.box(r) == j.box(r)


def test_basic_partitioning_errors_match_jax():
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="give procs or nprocs"):
            mod.basic_partitioning("xy", (4, 4))
        with pytest.raises(ValueError, match="exceeds nprocs"):
            mod.basic_partitioning("xy", (4, 4), (2, 2), nprocs=2)
    with pytest.raises(ValueError, match="positive"):
        TP.Factors23(0)


def _fuzz_boxes(seed, count):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        nd = int(rng.integers(1, 4))
        dim = tuple(int(rng.integers(1, 8)) for _ in range(nd))
        box = (tuple(int(rng.integers(0, d)) for d in dim),
               tuple(int(rng.integers(1, d + 1)) for d in dim))
        hole = (tuple(int(rng.integers(0, d)) for d in dim),
                tuple(int(rng.integers(1, d + 1)) for d in dim))
        out.append((dim, box, hole))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_box_algebra_matches_jax(seed):
    for dim, box, hole in _fuzz_boxes(seed, 80):
        assert TP.box_minus(*box, *hole, dim) == JP.box_minus(*box, *hole, dim)
        for a in range(len(dim)):
            args = (box[0][a], box[1][a], hole[0][a], hole[1][a], dim[a])
            assert TP.interval_split(*args) == JP.interval_split(*args)
            assert TP.subtract_interval(*args) == JP.subtract_interval(*args)


def test_subtract_interval_reference_cases():
    assert TP.subtract_interval(0, 8, 2, 3, 8) == [(0, 2), (5, 3)]
    assert TP.subtract_interval(0, 4, 4, 4, 8) == [(0, 4)]
    assert TP.subtract_interval(0, 4, 0, 8, 8) == []
    assert TP.subtract_interval(0, 8, 6, 4, 8) == [(2, 4)]


@pytest.mark.parametrize("case", [((8, 8), (2, 2), (3, 3), (2, 2)),
                                  ((4, 4), (2, 2), (0, 0), (1, 1)),
                                  ((8, 6), (4, 1), (6, 4), (4, 4)),
                                  ((6,), (3,), (5,), (3,))])
def test_make_hole_matches_jax(case):
    dim, procs, hf, hs = case
    order = "xyzt"[:len(dim)]
    t = TP.make_hole(TP.basic_partitioning(order, dim, procs), hf, hs)
    j = JP.make_hole(JP.basic_partitioning(order, dim, procs), hf, hs)
    _same(t, j)
    assert t.has_full_support() == j.has_full_support()
    assert t.are_there_repetitions() == j.are_there_repetitions()


def test_split_into_components_matches_jax():
    for dim, procs, nc in (((8, 6), (2, 1), 2), ((9, 9), (3, 1), 3), ((4, 4), (1, 1), 4)):
        t = TP.split_into_components(TP.basic_partitioning("xy", dim, procs), "xy", None, nc)
        j = JP.split_into_components(JP.basic_partitioning("xy", dim, procs), "xy", None, nc)
        _same(t, j)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_plans_on_both_engines_match_jax(engine, monkeypatch):
    """Copy and add plans of random toroidal partitions from both of the
    port's plan engines equal the JAX package's (whose native engine is
    its own build of the same source)."""
    from superbblas_tpu.parallel.redistribute import RedistributionPlan as JPlan
    from superbblas_tpu_torch import native
    from superbblas_tpu_torch.parallel.redistribute import RedistributionPlan as TPlan

    from superbblas_tpu import native as jnative

    if engine == "python":
        monkeypatch.setattr(native, "fragment_plan", lambda *a, **k: None)
        monkeypatch.setattr(jnative, "fragment_plan", lambda *a, **k: None)
    elif native.get_lib() is None or jax_native_lib() is None:
        pytest.skip("no C++ toolchain to build the native plan engine")
    rng = np.random.default_rng(321)
    for case in range(25):
        nd = int(rng.integers(1, 4))
        dim = tuple(int(rng.integers(1, 8)) for _ in range(nd))
        n = int(rng.integers(1, 6))
        mode = ["copy", "add"][int(rng.integers(0, 2))]
        boxes = [tuple((tuple(int(rng.integers(0, d)) for d in dim),
                        tuple(int(rng.integers(1, d + 1)) for d in dim)) for _ in range(n))
                 for _ in range(2)]
        tp = TPlan(TP.Partition(dim=dim, boxes=boxes[0]),
                   TP.Partition(dim=dim, boxes=boxes[1]), mode)
        jp = JPlan(JP.Partition(dim=dim, boxes=boxes[0]),
                   JP.Partition(dim=dim, boxes=boxes[1]), mode)
        assert tp.pair_pieces.keys() == jp.pair_pieces.keys(), case
        for k in tp.pair_pieces:
            np.testing.assert_array_equal(tp.pair_pieces[k], jp.pair_pieces[k])
        for i, j in product(range(n), range(n)):
            for a, b in zip(tp.pair_elem_indices(i, j), jp.pair_elem_indices(i, j)):
                np.testing.assert_array_equal(a, b)
