"""The tracker's recorder (``superbblas_tpu_torch.utils.tracker``): the span
tree of a CGNE solve, nothing kept and no profiler range opened while it
is off, a profile's own record (host times on the profiler's clock, closed
with the profile, replaced by the next), the convergence reads a CG solve
counts, SBT_TRACK_TIME's report of the same spans, and (on a card, marker
``cuda``) no synchronisation of its own.  The file imports no JAX; its
card case runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracker_spans.py -k card
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from superbblas_tpu_torch import cplx, flags, solvers
from superbblas_tpu_torch.models import clover as C
from superbblas_tpu_torch.utils import tracker

#: the spans a clover CGNE solve opens
SOLVE_SPANS = {"solver.cg", "solver.read", "apply_clover", "k1"}


def _clover_cgne(device="cpu", lat=(4, 4, 4, 4)):
    """A clover CGNE solve to 1e-5, as the benchmark's clover cells run it;
    returns the call."""
    op = C.wilson_clover_operator(lat, mass=0.1, c_sw=1.0, key=0, dtype=torch.complex64,
                                  layout="soa", device=device)
    gen = torch.Generator().manual_seed(0)
    b = cplx.CArray(*(torch.randn((1, 12) + lat, generator=gen).to(device) for _ in range(2)))
    signs = torch.tensor((1.0,) * 6 + (-1.0,) * 6, device=device).reshape(1, 12, 1, 1, 1, 1)

    def g5(v):
        return cplx.CArray(v.re * signs, v.im * signs)

    def A(v):
        return C.apply_clover(op, v)

    return lambda: solvers.cgne(A, lambda v: g5(A(g5(v))), b, tol=1e-5, maxiter=200)


def _recorded(call):
    tracker.start()
    try:
        out = call()
    finally:
        rec = tracker.stop()
    return out, rec


def _profiled(call):
    """``call`` under a CPU profile, with no ``start``: (its output, the
    profile's events by span name, the record ``stop`` takes after it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in SOLVE_SPANS:
            s = e.start_ns() / 1e3
            events.setdefault(e.name(), []).append((s, s + e.duration_ns() / 1e3))
    return out, events, tracker.stop()


def test_span_tree_of_a_cgne_solve():
    (_x, _rs, k), rec = _recorded(_clover_cgne())
    spans = {s[0]: s for s in rec["spans"]}
    names = [s[2] for s in rec["spans"]]
    assert set(names) == SOLVE_SPANS
    (cg,) = [s for s in rec["spans"] if s[2] == "solver.cg"]
    assert cg[1] is None
    want_parent = {"solver.read": "solver.cg", "apply_clover": "solver.cg",
                   "k1": "apply_clover"}
    for s in rec["spans"]:
        assert s[3] <= s[4] and s[5] is None   # host times; no device time on the CPU
        if s is not cg:
            up = spans[s[1]]
            assert up[2] == want_parent[s[2]]
            assert up[3] <= s[3] and s[4] <= up[4]
    # A^H b, then A and A^H an iteration; K1's two routes an apply; a read
    # an iteration and the first
    assert names.count("apply_clover") == 2 * k + 1
    assert names.count("k1") == 2 * (2 * k + 1)
    assert names.count("solver.read") == k + 1
    assert rec["counters"] == {"solver.iterations": k, "host_reads": k + 1}


def test_recording_off_keeps_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(tracker, "_RANGE", lambda name: opened.append(name))
    solve = _clover_cgne()
    assert not tracker.on
    before = tracker.counters()
    _x, _rs, k = solve()
    assert opened == []
    after = tracker.counters()
    # counters count whether or not spans are recorded; the record keeps none
    assert after["host_reads"] - before.get("host_reads", 0) == k + 1
    assert tracker.stop() == {"spans": [], "counters": {}}


def test_spans_lie_in_their_profiler_ranges():
    """A profile records the span sites with no ``start``; exported host
    times are on the profiler's clock: each span lies in the profiler event
    of its own name and order, to 50 us."""
    (_x, _rs, k), events, rec = _profiled(_clover_cgne())
    assert rec["counters"] == {"solver.iterations": k, "host_reads": k + 1}
    for name in SOLVE_SPANS:
        got = sorted((s[3], s[4]) for s in rec["spans"] if s[2] == name)
        ranges = sorted(events[name])
        assert len(got) == len(ranges) > 0
        for (t0, t1), (e0, e1) in zip(got, ranges):
            assert e0 - 50 <= t0 <= t1 <= e1 + 50, (name, t0, t1, e0, e1)


def test_a_profiles_record_closes_with_it_and_the_next_replaces_it():
    solve = _clover_cgne()
    for _ in range(2):                       # the second record replaces the first
        with profile(activities=[ProfilerActivity.CPU]):
            _x, _rs, k = solve()
        solve()                              # after the profile: closes its record
    rec = tracker.stop()
    assert [s[2] for s in rec["spans"]].count("solver.cg") == 1
    assert rec["counters"] == {"solver.iterations": k, "host_reads": k + 1}
    assert not tracker.on
    assert tracker.stop() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("maxiter, converged", [(200, True), (3, False)])
def test_cg_reads_once_an_iteration_and_once_more(maxiter, converged):
    """A converged CG reads its convergence test iterations + 1 times; one
    stopped by ``maxiter`` skips the last test."""
    rng = np.random.default_rng(1)
    m = rng.standard_normal((24, 24))
    A = torch.from_numpy(m @ m.T + 24 * np.eye(24))
    b = torch.from_numpy(rng.standard_normal(24))
    before = tracker.counters()
    _x, _rs, k = solvers.cg(lambda v: A @ v, b, tol=1e-10, maxiter=maxiter)
    after = tracker.counters()
    assert (k < maxiter) == converged
    assert after["solver.iterations"] - before.get("solver.iterations", 0) == k
    assert after["host_reads"] - before.get("host_reads", 0) == k + converged


def test_track_time_reports_the_span_sites(monkeypatch):
    """SBT_TRACK_TIME=1 turns the span sites on for the call-path report
    (``flags.clear_cache`` re-reads it), with no recording started."""
    rng = np.random.default_rng(2)
    m = rng.standard_normal((16, 16))
    A = torch.from_numpy(m @ m.T + 16 * np.eye(16))
    b = torch.from_numpy(rng.standard_normal(16))
    monkeypatch.setenv("SBT_TRACK_TIME", "1")
    flags.clear_cache()
    try:
        assert tracker.on
        tracker.reset_timings()
        _x, _rs, k = solvers.cg(lambda v: A @ v, b, tol=1e-10, maxiter=100)
        t = tracker.get_timings()
    finally:
        monkeypatch.undo()
        flags.clear_cache()
        tracker.reset_timings()
    assert not tracker.on
    assert t["solver.cg"]["calls"] == 1
    assert t["solver.cg/solver.read"]["calls"] == k + 1
    assert t["solver.cg"]["seconds"] >= t["solver.cg/solver.read"]["seconds"] > 0


@pytest.mark.cuda
def test_card_recording_adds_no_synchronisation():
    """On the card a recorded clover CGNE solve makes exactly the
    synchronising calls the unrecorded one makes (its convergence reads),
    its applies carry device times, and every iteration runs on CG's
    fused kernels (``ops/cg_update.py``), which synchronise nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    solve = _clover_cgne("cuda", (8, 8, 8, 8))
    solve()                                      # the kernels' build, the spin plans
    counts = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for record in (False, True, True, False):
            if record:
                tracker.start()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _x, _rs, k = solve()
            counts.append((len(caught), k))
            if record:
                torch.cuda.set_sync_debug_mode(0)
                rec = tracker.stop()
                torch.cuda.set_sync_debug_mode("warn")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counts[0] == counts[1] == counts[2] == counts[3]
    assert counts[0][0] >= counts[0][1] + 1
    ms = [s[5] for s in rec["spans"] if s[2] == "apply_clover"]
    assert ms and all(v is not None and v > 0 for v in ms)
    kept = rec["counters"]
    assert kept["solver.fused_iterations"] == kept["solver.iterations"] == counts[0][1]
