"""The readers of the port's own spans and counters (the record
``superbblas_tpu_torch.utils.tracker`` keeps while the traced solves are
profiled): on a hand-made profile whose numbers are worked out by hand,
without a record (a program that keeps none, or a cell whose ranks ran
in other processes: None, never 0), and the record a CPU traced run
leaves them."""

import copy
import json
import time
from pathlib import Path

import pytest

import harness
from superbblas_tpu_torch.utils import tracker

DATA = Path(__file__).resolve().parent / "data"
PROGRAM = json.loads((DATA / "profile_program.json").read_text())
NAMES = sorted(PROGRAM["expected"])
CELL = "cls-d200.clover.hmc-1rhs"


def test_every_program_metric_is_in_the_benchmark():
    entries = {m["name"]: m for m in harness.benchmark_json()["per_layer"]}
    for name in NAMES:
        assert entries[name]["source"] in ("program_span", "program_counter")
        assert entries[name]["moves"] == "rhs_per_s"
        assert all(harness.load("workloads", w)["chips"] == 1
                   for w in entries[name]["workloads"])


@pytest.mark.parametrize("name", NAMES)
def test_program_reader_on_hand_made_profile(name):
    got = harness.module("metrics", name).read(copy.deepcopy(PROGRAM))
    assert got == pytest.approx(PROGRAM["expected"][name])


@pytest.mark.parametrize("record", [None, [None], "ranks"],
                         ids=["nothing recorded", "no record", "ranks elsewhere"])
@pytest.mark.parametrize("name", NAMES)
def test_program_reader_without_a_record(name, record):
    t = copy.deepcopy(PROGRAM)
    del t["program"]
    tracker.stop()                        # this process keeps no record
    if record == "ranks":
        t["ranks"] = t["ranks"] * 4
    elif record is not None:
        t["program"] = record
    assert harness.module("metrics", name).read(t) is None


@pytest.mark.parametrize("name", ["apply_span_ms.clover", "apply_span_ms.mobius"])
def test_device_ms_readers_give_nothing_from_host_times(name):
    """A CPU run's spans have no device time: no device metric is read."""
    t = copy.deepcopy(PROGRAM)
    for s in t["program"][0]["spans"]:
        s[5] = None
    assert harness.module("metrics", name).read(t) is None


def test_cpu_traced_run_leaves_the_record():
    t_start = time.time()
    part = harness.run_rank(CELL, 2 ** 33 + 7, 0.3, True, device="cpu",
                            overrides={"lattice": [4, 4, 4, 8]})
    traced = harness.load("workloads", CELL)["trace_solves"]
    iters = sum(part["iters"][harness.TRACE_FROM:harness.TRACE_FROM + traced])
    line = harness.result(CELL, [part], t_start, True, 1)
    assert line["metrics"]["host_reads_per_iter"]["value"] == pytest.approx(
        (iters + traced) / iters)
    assert line["metrics"]["k1_host_us"]["value"] > 0
    assert "launches_per_iter" not in line["metrics"]      # no device kernels on the CPU
    assert not tracker.on
    assert tracker.stop() == {"spans": [], "counters": {}}
