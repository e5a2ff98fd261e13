"""The clover multigrid cell on the CPU at 4^4 (2^4 aggregates, 4 test
vectors): the configuration's keys; the coarse apply's frozen work from
shapes; the three readers on a recorded trace; correct with nothing
broken, not correct with one cycle's output returned as x or with the
whole hierarchy (fine and coarse operators) built at another mass, and
still correct with the coarse operator alone from another mass (FGCR
judges its residual against the action's own D, so a wrong coarse
operator slows the solve and does not falsify it); not correct for the
TF32 control."""

import json
import time

import pytest
import torch

import control
import gen
import harness
from counts import coarse as coarse_counts
from superbblas_tpu_torch.models import multigrid as MG
from superbblas_tpu_torch.models.clover import wilson_clover_operator

CELL = "cls-d200.clover-mg.prop-1rhs"
CONFIG = "cls-d200-local-mg"
SEED = 2 ** 33 + 23


def small() -> dict:
    mg = dict(harness.load("configs", CONFIG)["multigrid"], block=[2, 2, 2, 2], test_vectors=4,
              setup_rounds=2, setup_steps=4)
    return {"lattice": [4, 4, 4, 4], "multigrid": mg}


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of small torch ops: intra-op threads only wait for each
    other at this size."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_configuration_keys():
    cfg = harness.load("configs", CONFIG)
    base = harness.load("configs", "cls-d200-local")
    for k in ("lattice", "global_lattice", "gpu_grid", "sites", "c_sw", "r", "boundary",
              "dtype", "layout", "reduced", "changed"):
        assert cfg[k] == base[k], k
    assert cfg["action"] == "clover_mg" and len(cfg["source"]) <= 200
    assert "arXiv:1303.1377" in cfg["source"] and "arXiv:1608.08900" in cfg["source"]
    mg = cfg["multigrid"]
    assert (mg["block"], mg["test_vectors"], mg["chirality_split"]) == ([4, 4, 4, 4], 20, True)
    assert set(mg) == {"block", "test_vectors", "chirality_split", "setup_rounds",
                       "setup_steps", "refine_rounds", "smooth_steps", "coarse_steps",
                       "fgcr_restart"}
    text = " ".join(cfg["assumed"])
    for word in ("mass", "c_sw", "boundar", "GCR smooth", "SAP", "coarse solve", "restart",
                 "set-up", "random SU(3) links"):
        assert word in text, word
    w = harness.load("workloads", CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "prop-1rhs", 1)


def test_coarse_work_from_shapes():
    """9 blocks of 40 x 40 complex f32 a coarse site, x read once, y written
    once: 0.949 GB an apply at the cell's 8,192 coarse sites."""
    blocks, x_and_y = 2 * 9 * 1600 * 8192 * 4, 2 * 2 * 40 * 8192 * 4
    assert coarse_counts.coarse_bytes(8192, 40, 9) == blocks + x_and_y == 948_961_280
    assert coarse_counts.coarse_flops(8192, 40, 9, 2) == 8 * 9 * 1600 * 8192 * 2
    act_cls = harness.module("actions", "clover_mg").Action
    act = act_cls.__new__(act_cls)                 # work reads the configuration alone
    act.cfg = harness.load("configs", CONFIG)
    work = act.work(32 * 32 * 32 * 64, 1)
    assert work["coarse.apply"]["bytes"] == 948_961_280
    assert work["coarse.apply"]["file"] == "batched_gemm.cu"
    assert work["k1.site16"]["flops"] == 1152 * 32 * 32 * 32 * 64
    act.cfg = dict(act.cfg, **small())             # a coarse extent of 2: one offset a direction
    assert act.work(256, 1)["coarse.apply"]["bytes"] == coarse_counts.coarse_bytes(16, 8, 5)


def recorded() -> dict:
    """A trace as the harness hands it to the readers, with one rank's
    record of two solves: 12 cycles, 60 coarse iterations (one coarse
    apply each), the device ms of the spans."""
    spans = [[1, None, "mg.coarse", 0.0, 0.0, 100.0], [2, None, "mg.coarse", 0.0, 0.0, 50.0]]
    spans += [[10 + i, 1, "coarse.apply", 0.0, 0.0, 0.5] for i in range(60)]
    return {"ranks": [{"window": [1000.0, 501000.0], "device": []}],
            "program": [{"spans": spans,
                         "counters": {"mg.cycles": 12, "mg.coarse_iterations": 60}}],
            "work": {"coarse.apply": {"bytes": 948_961_280, "flops": 8 * 9 * 1600 * 8192,
                                      "file": "batched_gemm.cu"}},
            "peaks": harness.load("counts", "peaks")}


def test_readers_on_a_recorded_trace():
    t = recorded()

    def read(name):
        return harness.module("metrics", name).read(t)

    assert read("mg_coarse_share") == pytest.approx(100.0 * 150.0 / 500.0)
    assert read("coarse_iters_per_cycle") == pytest.approx(5.0)
    bound_ms = 1e3 * 948_961_280 / 3.35e12
    assert read("coarse_roofline") == pytest.approx(100.0 * bound_ms / 0.5)
    # a program without the spans and counters (the parent's) reads nothing
    t = recorded()
    t["program"] = [{"spans": [[1, None, "solver.cg", 0.0, 1.0, 3.0]], "counters": {}}]
    assert all(read(n) is None for n in ("mg_coarse_share", "coarse_iters_per_cycle",
                                         "coarse_roofline"))


def one_cycle_as_x(solve):
    """The action returns one cycle's output M b as the answer."""
    act = solve.__self__

    def broken(b, **kw):
        x, rs, it = solve(b, **kw)
        return MG.mg_cycle(act.mg, b), rs, it

    return broken


def at_another_mass(what):
    def fault(solve):
        act = solve.__self__
        cfg, mgc = act.cfg, act.cfg["multigrid"]
        lat = tuple(cfg["lattice"])
        U = gen.links(SEED, list(range(lat[0])), lat[1:], "cpu")
        other = wilson_clover_operator(lat, links=U, mass=cfg["mass"] + 0.5,
                                       c_sw=cfg["c_sw"], dtype=torch.complex64, layout="soa",
                                       device="cpu")
        mg = MG.clover_mg_setup(other, block=tuple(mgc["block"]), nvec=mgc["test_vectors"],
                                key=3, setup_rounds=mgc["setup_rounds"],
                                setup_steps=mgc["setup_steps"], refine_rounds=0)
        if what == "all":
            act.mg = mg
        else:
            act.mg = MG.CloverMG(act.mg.op, mg.P, mg.coarse, act.mg.block)
        return solve

    fault.__name__ = f"{what}_at_another_mass"
    return fault


@pytest.mark.parametrize("fault, correct", [
    (None, True), (one_cycle_as_x, False), (at_another_mass("all"), False),
    (at_another_mass("coarse"), True)],
    ids=["nothing", "one_cycle_as_x", "hierarchy_at_another_mass", "coarse_at_another_mass"])
def test_one_card_fault(fault, correct):
    part = harness.run_rank(CELL, SEED, 0.5, False, device="cpu", overrides=small(), fault=fault)
    out = harness.result(CELL, [part], time.time(), False, 1)
    assert out["correct"] is correct, out["check"]
    assert set(out["metrics"]) == {"rhs_per_s", "peak_mem_gib", "setup_s"}


def test_control_is_not_correct():
    """The full reference in the port's place at TF32 fails the check."""
    got = control.readings(CELL, 2 ** 35 + 5, 1, device="cpu", overrides=small())
    assert got["passed"] is False, got


def test_traced_run_reads_the_cells_program_metrics():
    """A CPU traced run: the counters' reader reads, the span readers give
    nothing (no device time on the CPU) and never raise."""
    t_start = time.time()
    part = harness.run_rank(CELL, SEED + 1, 0.3, True, device="cpu", overrides=small())
    line = harness.result(CELL, [part], t_start, True, 1)
    assert line["correct"] is True
    assert line["metrics"]["coarse_iters_per_cycle"]["value"] >= 1
    assert line["metrics"]["solver_iters"]["value"] > 0
    assert "coarse_roofline" not in line["metrics"] and "mg_coarse_share" not in line["metrics"]
    assert json.loads(json.dumps(part["trace"]["work"]))["coarse.apply"]["bytes"] == \
        coarse_counts.coarse_bytes(16, 8, 5)
