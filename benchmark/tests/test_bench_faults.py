"""A run on the CPU at a small size with the timed path broken underneath:
for each fault a cell can have, ``correct`` comes out false, and with
nothing broken it comes out true.  The run skips only the look for a
card; everything else (set-up, window, check, result line) is the
benchmark's own."""

import multiprocessing as mp
import socket
import time

import pytest

import _faults
import harness

SMALL = {"cls-d200.clover.hmc-1rhs": {"lattice": [4, 4, 4, 8]},
         "rbc-64i.mobius.prop-1rhs": {"lattice": [4, 4, 4, 4], "Ls": 4},
         "cls-d200.clover.prop-12rhs": {"lattice": [4, 4, 4, 4]},
         "cls-d200.clover.hmc-1rhs.whole-4gpu": {"lattice": [8, 4, 4, 8]}}
SEED = 2 ** 33 + 17


def one_card(workload, fault=None):
    part = harness.run_rank(workload, SEED, 0.5, False, device="cpu",
                            overrides=SMALL[workload], fault=fault)
    return harness.result(workload, [part], time.time(), False, 1)


#: the faults a cell on one card can have (half a batch needs more than one rhs)
CASES = [(w, f) for w in SMALL if "4gpu" not in w
         for f in (None, "unchanged", "altered") + (("half_batch",) if "12rhs" in w else ())]


@pytest.mark.parametrize("workload, fault", CASES)
def test_one_card_fault(workload, fault):
    out = one_card(workload, None if fault is None else getattr(_faults, fault))
    assert out["correct"] is (fault is None), out["check"]
    assert list(out)[-1] == "check"


def four_ranks(fault):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    workload = "cls-d200.clover.hmc-1rhs.whole-4gpu"
    procs = [ctx.Process(target=_faults.rank_main,
                         args=(r, 4, port, queue, workload, SMALL[workload], fault))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        parts = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert not any(p.is_alive() for p in procs)
    return harness.result(workload, [parts[r] for r in range(4)], time.time(), False, 4)


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_ranks_exchange_left_out(fault):
    out = four_ranks(fault)
    assert out["correct"] is (fault is None), out["check"]
    assert out["device"]["count"] == 4
