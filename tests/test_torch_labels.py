"""superbblas_tpu_torch.labels against superbblas_tpu.labels: every helper
and ContractionPlan, on the same arguments, results and errors alike."""

import inspect

import numpy as np
import pytest

from superbblas_tpu import labels as J
from superbblas_tpu_torch import labels as T

CASES = [
    ("check_order", ("abc",)),
    ("check_order", ("aba",)),
    ("check_order", (3,)),
    ("check_coor", ((1, 2), "ab")),
    ("check_coor", ((1,), "ab", "from0")),
    ("find_permutation", ("abc", "cab")),
    ("find_permutation", ("abc", "xbz")),
    ("reorder_coor", ((10, 20, 30), (2, 0, 1))),
    ("reorder_coor", ((10, 20), (1, -1, 0), 1)),
    ("volume", ((2, 3, 4),)),
    ("volume", ((),)),
    ("normalize_coor", ((-1, 5, 4), (4, 4, 4))),
    ("normalize_coor", ((3, 2), (0, 2))),
    ("check_isomorphic", ("ab", (1, 3), (2, 3), "b", (3,))),
    ("check_isomorphic", ("ab", (2, 3), (2, 3), "b", (3,))),
    ("check_isomorphic", ("ab", (2, 5), (2, 5), "ba", (4, 2))),
    ("check_isomorphic", ("a", (3,), (2,), "a", (4,))),
    ("split_interval", (1, 3, 8)),
    ("split_interval", (6, 4, 8)),
    ("split_interval", (-3, 2, 8)),
    ("split_interval", (0, 0, 8)),
    ("split_interval", (0, 9, 8)),
    ("split_box", ((6, 3), (4, 2), (8, 8))),
    ("split_box", ((7, 7, 0), (3, 3, 2), (8, 8, 2))),
    ("intersect_interval", (0, 4, 2, 4, 8)),
    ("intersect_interval", (0, 4, 4, 4, 8)),
    ("intersect_interval", (6, 4, 0, 4, 8)),
    ("intersect_interval", (3, 8, 5, 8, 8)),
    ("intersect_interval", (6, 5, 1, 7, 8)),
    ("intersect_interval", (0, 0, 1, 2, 8)),
    ("intersect_interval", (0, 2, 1, 2, 0)),
    ("_unwrap", (6, 4, 8)),
    ("intersect_box", ((0, 0), (4, 4), (2, 2), (4, 4), (8, 8))),
    ("intersect_box", ((6, 1), (4, 3), (0, 7), (3, 3), (8, 8))),
    ("translate_coor", ((3, 4), "xy", (1, 1), "yx", (0, 0))),
    ("translate_coor", ((3, 4), "xy", (1, 1), "yzx", (5, 6, 7), 9)),
]


def run(mod, name, args):
    """(kind, value): the result, or the error's type and message."""
    try:
        out = getattr(mod, name)(*args)
    except (TypeError, ValueError) as e:
        return type(e).__name__, str(e)
    return "ok", list(out) if inspect.isgenerator(out) else out


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}-{i}" for i, (n, _) in
                                                  enumerate(CASES)])
def test_helper_matches_jax(name, args):
    assert run(T, name, args) == run(J, name, args)


PLANS = [
    ("tab", (5, 3, 4), "tac", (5, 3, 6), "tbc", (5, 4, 6)),
    ("kSxyzt", (4, 3, 2, 2, 2, 2), "lSxyzt", (5, 3, 2, 2, 2, 2), "kl", (4, 5)),
    ("kSxyzt", (4, 3, 2, 2, 2, 2), "km", (4, 6), "mSxyzt", (6, 3, 2, 2, 2, 2)),
    ("ab", (2, 3), "ab", (2, 3), "", ()),
    ("a", (2,), "b", (3,), "ba", (3, 2)),
    ("ab", (2, 3), "bc", (3, 4), "a", (2,)),           # unmatched: c
    ("ab", (2, 3), "bc", (3, 4), "acx", (2, 4, 5)),    # unmatched: x
    ("ab", (2, 3), "bc", (4, 4), "ac", (2, 4)),        # extent mismatch A
    ("tab", (5, 3, 4), "tac", (5, 3, 6), "tbc", (6, 4, 6)),   # mismatch T/r
    ("tab", (5, 3, 4), "tac", (5, 3, 6), "tbc", (5, 4, 7)),   # mismatch C/r
    ("aa", (2, 2), "a", (2,), "", ()),                 # repeated label
]


def plan_summary(mod, args):
    try:
        p = mod.ContractionPlan(*args)
    except ValueError as e:
        return "ValueError", str(e)
    return ("ok", p.o0, p.o1, p.o_r, p.T, p.A, p.B, p.C, p.volT, p.volA, p.volB,
            p.volC, p.dot_general_dims(), p.dot_general_out_order(), p.flops(),
            p.flops(complex_dtype=True))


@pytest.mark.parametrize("args", PLANS, ids=[f"plan-{i}" for i in range(len(PLANS))])
def test_contraction_plan_matches_jax(args):
    assert plan_summary(T, args) == plan_summary(J, args)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_boxes_match_jax(seed):
    """Random N-D toroidal boxes, both of which may wrap: split_box,
    intersect_box and normalize_coor give what the JAX module gives."""
    rng = np.random.default_rng(900 + seed)
    for _ in range(25):
        nd = int(rng.integers(1, 4))
        dim = tuple(int(rng.integers(1, 8)) for _ in range(nd))
        fa = tuple(int(rng.integers(-8, 8)) for _ in dim)
        sa = tuple(int(rng.integers(0, d + 1)) for d in dim)
        fb = tuple(int(rng.integers(0, d)) for d in dim)
        sb = tuple(int(rng.integers(0, d + 1)) for d in dim)
        for name, args in (("split_box", (fa, sa, dim)),
                           ("intersect_box", (fa, sa, fb, sb, dim)),
                           ("normalize_coor", (fa, dim))):
            assert run(T, name, args) == run(J, name, args), (name, args)
