"""superbblas_tpu_torch's utilities against the JAX package's: the
tracker (paths, the disabled no-op, the report's columns, flops under the
nested path, the decorated ops), the memory keys and the leak check, the
caches' report and clear, the numpy oracles and consistency checks, and
``flags`` (parsing, errors, ``clear_cache``, SBT_MATMUL_PRECISION)."""

import gc
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superbblas_tpu import flags as JF
from superbblas_tpu.utils import testing as JT
from superbblas_tpu.utils import tracker as JTR
from superbblas_tpu_torch import flags as TF
from superbblas_tpu_torch.utils import testing as TT
from superbblas_tpu_torch.utils import tracker as TR


@pytest.fixture
def env(monkeypatch):
    """Sets SBT_* variables for both packages; re-reads them after."""
    def setenv(name, value):
        monkeypatch.setenv(name, value)
        TF.clear_cache()
        JF.clear_cache()
    yield setenv
    monkeypatch.undo()
    TF.clear_cache()
    JF.clear_cache()
    TR.reset_timings()


def test_tracker_paths_and_report():
    TR.reset_timings()
    with TR.track("outer", flops=100, force=True):
        with TR.track("inner", flops=50, memops=10, force=True,
                      sync_on=torch.ones(3)):
            torch.ones((4, 4)).sum()
    t = TR.get_timings()
    assert set(t) == {"outer", "outer/inner"}
    assert t["outer/inner"]["flops"] == 50 and t["outer/inner"]["memops"] == 10
    assert t["outer"]["calls"] == 1 and t["outer"]["seconds"] >= t["outer/inner"]["seconds"]
    rep = TR.report_timings()
    JTR.reset_timings()
    with JTR.track("outer", flops=100, force=True):
        pass
    # the same header and columns as the JAX package's report
    assert rep.splitlines()[:2] == JTR.report_timings().splitlines()[:2]
    assert "outer/inner" in rep and "GFLOPS" in rep
    out = io.StringIO()
    assert TR.report_timings(out) == out.getvalue().rstrip("\n")
    TR.reset_timings()
    JTR.reset_timings()


def test_tracker_disabled_is_noop(env):
    env("SBT_TRACK_TIME", "0")
    TR.reset_timings()
    with TR.track("nope"):
        pass

    @TR.tracked("leaf")
    def leaf(a):
        return a + 1

    assert leaf(1) == 2
    assert TR.get_timings() == {}
    assert TF.wrapper_state() == (False, False)


def test_tracked_nested_flops_under_path(env):
    env("SBT_TRACK_TIME", "1")
    TR.reset_timings()

    @TR.tracked("leaf", flops_fn=lambda out, *a, **k: 42.0,
                memops_fn=lambda out, *a, **k: 8.0)
    def leaf():
        return torch.ones(())

    with TR.track("outer"):
        leaf()
    t = TR.get_timings()
    assert t["outer/leaf"]["flops"] == 42.0 and t["outer/leaf"]["memops"] == 8.0
    assert "leaf" not in t


def test_tracked_ops_record_as_jax(env):
    """With SBT_TRACK_TIME=1 the decorated ops record under the JAX
    package's names with its flop attribution: bsr_krylov (the AoS
    Wilson operator), apply_stencil_soa (flops and bytes of the SoA
    one), local_contraction and the dense ops."""
    from superbblas_tpu import bsr as JB
    from superbblas_tpu.models import wilson as JW
    from superbblas_tpu_torch import bsr as TB
    from superbblas_tpu_torch import dense as TD
    from superbblas_tpu_torch.models import wilson as TW
    from superbblas_tpu_torch.ops import contract

    env("SBT_TRACK_TIME", "1")
    lat = (2, 2, 2, 4)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(lat + (4, 3, 2))
    results = []
    for W, B, TRK, arr in ((TW, TB, TR, torch.from_numpy), (JW, JB, JTR, jnp.asarray)):
        kw = {"device": "cpu"} if W is TW else {}
        TRK.reset_timings()
        op = W.wilson_operator(lat, mass=0.3, key=0, dtype=np.complex128 if W is JW
                               else torch.complex128, **kw)
        B.bsr_krylov(1.0, op, arr(x), "xyztSCn")
        results.append(TRK.get_timings()["bsr_krylov"])
    assert results[0]["calls"] == 1 and results[0]["flops"] == results[1]["flops"] > 0

    op = TW.wilson_operator(lat, mass=0.3, key=0, layout="soa", dtype=torch.complex64,
                            device="cpu")
    xs = TW.CArray(torch.ones((2, 12) + lat), torch.zeros((2, 12) + lat))
    TR.reset_timings()
    TB.apply_stencil_soa(op, xs)
    contract.local_contraction(1.0, torch.ones(3, 4), "ij", False, torch.ones(4, 5), "jk",
                               False, 0.0, None, "ik")
    a = torch.eye(3, dtype=torch.float64).expand(2, 3, 3) * 2
    TD.inversion(TD.cholesky(a, "krc", "r", "c"), "krc", "r", "c")
    TD.gesm(1.0, a, "krc", "r", "c", torch.ones(2, 3, 1, dtype=torch.float64), "krn", "kcn")
    t = TR.get_timings()
    assert t["apply_stencil_soa"]["flops"] == op.flops_per_matvec(2, True)
    assert t["apply_stencil_soa"]["memops"] == op.memops_per_matvec(2, 8)
    for name in ("local_contraction", "cholesky", "inversion", "gesm"):
        assert t[name]["calls"] == 1, name
    assert "apply_stencil_soa" in TR.report_timings()


def test_memory_report_and_leak_check():
    held = torch.ones(1024)
    usage = TR.report_memory_usage()
    assert "live_array_bytes" in usage and usage["live_array_bytes"] >= held.nbytes
    gc.collect()          # the baseline without garbage a later collection frees
    base = TR.memory_snapshot()
    tmp = torch.ones((1024, 1024))
    with pytest.raises(RuntimeError, match="memory leak"):
        TR.check_for_memory_leaks(base)
    del tmp
    TR.check_for_memory_leaks(base)


def test_cache_report_and_clear():
    from superbblas_tpu_torch.ops import batched_gemm, stencil
    from superbblas_tpu_torch.utils import clear_caches, report_cache_usage

    batched_gemm.small_tile(64, 4, 4, 8)
    stencil._PLANS["key"] = stencil._Plan()
    stencil._PLANS["key"].table = torch.zeros(16, dtype=torch.uint8)
    out = io.StringIO()
    stats = report_cache_usage(out)
    assert stats["spin_plans"]["entries"] >= 1 and stats["spin_plans"]["bytes"] >= 16
    assert stats["gemm_tiles"]["entries"] >= 1
    assert stats["allocator"]["budget_bytes"] == int(TF.get_cache_gb() * (1 << 30))
    assert "spin plans" in out.getvalue()
    clear_caches()
    stats = report_cache_usage(io.StringIO())
    assert stats["spin_plans"]["entries"] == 0 and stats["gemm_tiles"]["entries"] == 0


@pytest.mark.parametrize("case", [
    ((4, 4), "ab", (4, 4), "ba", (0, 0), (2, 2), (1, 1), "copy"),
    ((3, 5), "ab", (5, 2, 3), "bca", (2, 1), (3, 4), (3, 1, 2), "add"),
    ((4, 3, 2), "abc", (3, 4), "ba", (1, 0, 1), (3, 3, 1), (2, 1), "copy"),
])
def test_testing_oracles_match_jax(case):
    shape0, o0, shape1, o1, from0, size0, from1, copy_add = case
    TT.verify_copy(*case)
    x = np.arange(1, int(np.prod(shape0)) + 1, dtype=np.float64).reshape(shape0)
    y = -np.arange(1, int(np.prod(shape1)) + 1, dtype=np.float64).reshape(shape1)
    np.testing.assert_array_equal(
        TT.numpy_copy_reference(2.0, x, o0, y, o1, from0, size0, from1, copy_add),
        JT.numpy_copy_reference(2.0, x, o0, y, o1, from0, size0, from1, copy_add))
    a, b = np.ones((2, 3)), np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(
        TT.numpy_contraction_reference(1.5, a, "ij", True, b, "jk", False, 0.5, np.ones((2, 4)),
                                       "ik"),
        JT.numpy_contraction_reference(1.5, a, "ij", True, b, "jk", False, 0.5,
                                       np.ones((2, 4)), "ik"))


def test_consistency_checks():
    TT.check_consistency(o0="abc", size0=(1, 2))
    with pytest.raises(ValueError, match="repeated"):
        TT.check_consistency(o0="aa")
    with pytest.raises(ValueError, match="negative"):
        TT.check_consistency(size1=(1, -2))
    TT.check_collective_consistency("tag", ("one process",))   # no group: returns


@pytest.mark.parametrize("name,value,getter,want", [
    ("SBT_LOG", "2", "get_log_level", 2),
    ("SBT_LOG", "", "get_log_level", 0),
    ("SBT_TRACK_TIME", "1", "get_track_time", True),
    ("SBT_TRACK_TIME", "", "get_track_time", False),
    ("SBT_CACHEGB", "0.5", "get_cache_gb", 0.5),
    ("SBT_CACHEGB", "", "get_cache_gb", 1.0),
    ("SBT_MATMUL_PRECISION", "HIGH", "get_matmul_precision", "high"),
    ("SBT_MATMUL_PRECISION", "Default", "get_matmul_precision", "default"),
    ("SBT_MATMUL_PRECISION", "", "get_matmul_precision", "highest"),
])
def test_flags_parse_as_jax(env, name, value, getter, want):
    env(name, value)
    assert getattr(TF, getter)() == getattr(JF, getter)() == want


@pytest.mark.parametrize("name,value,getter", [
    ("SBT_LOG", "x", "get_log_level"),
    ("SBT_CACHEGB", "big", "get_cache_gb"),
    ("SBT_LOG", "1.5", "get_log_level"),
    ("SBT_TRACK_TIME", "yes", "get_track_time"),
    ("SBT_MATMUL_PRECISION", "bf16", "get_matmul_precision"),
])
def test_flags_errors_as_jax(env, name, value, getter):
    env(name, value)
    for F in (TF, JF):
        with pytest.raises(ValueError) as err:
            getattr(F, getter)()
        assert name in str(err.value)


def test_flags_clear_cache_rereads(monkeypatch):
    monkeypatch.setenv("SBT_TRACK_TIME", "1")
    TF.clear_cache()
    assert TF.get_track_time() and TF.wrapper_state() == (False, True)
    monkeypatch.setenv("SBT_TRACK_TIME", "0")
    assert TF.get_track_time()                      # cached until cleared
    TF.clear_cache()
    assert not TF.get_track_time() and TF.wrapper_state() == (False, False)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_matmul_precision_values(env, precision):
    """Each SBT_MATMUL_PRECISION value is accepted by local_contraction;
    "highest" (the default) and "high" (no TF32 on the CPU) keep the f64
    and f32 parity with JAX, "default" rounds f32 operands to bf16 (its
    result equals the product of the rounded operands), and f64 is the
    same at every value."""
    from superbblas_tpu.ops.contract import local_contraction as jlc
    from superbblas_tpu_torch import cplx as TC
    from superbblas_tpu_torch.ops.contract import local_contraction as tlc

    from _torch_parity import assert_parity

    env("SBT_MATMUL_PRECISION", precision)
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((2, 5, 6)), rng.standard_normal((2, 6, 3))
    ai, bi = rng.standard_normal((2, 5, 6)), rng.standard_normal((2, 6, 3))
    for dt in (np.float64, np.float32):
        args = ("tij", False)
        got = tlc(1.0, TC.CArray(torch.from_numpy(a.astype(dt)), torch.from_numpy(ai.astype(dt))),
                  *args, torch.from_numpy(b.astype(dt)), "tjk", False, 0.0, None, "tik")
        if precision == "default" and dt == np.float32:
            r = lambda v: torch.from_numpy(v.astype(dt)).to(torch.bfloat16).double()
            want = (torch.einsum("tij,tjk->tik", r(a), r(b)),
                    torch.einsum("tij,tjk->tik", r(ai), r(b)))
            assert_parity((got.re, got.im), want, dt)
            continue
        from superbblas_tpu import cplx as JC

        want = jlc(1.0, JC.CArray(jnp.asarray(a.astype(dt)), jnp.asarray(ai.astype(dt))),
                   *args, jnp.asarray(b.astype(dt)), "tjk", False, 0.0, None, "tik")
        assert_parity((got.re, got.im), (want.re, want.im), dt)
