"""The result line's shape, the runner's refusals, and the control."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

import control
import harness

ROOT = Path(__file__).resolve().parent.parent
REPO = ROOT.parent
SMALL = {"lattice": [4, 4, 4, 8]}
CELL = "cls-d200.clover.hmc-1rhs"


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    t_start = time.time()
    part = harness.run_rank(CELL, 2 ** 31 + 99, 0.5, trace, device="cpu", overrides=SMALL)
    out = harness.result(CELL, [part], t_start, trace, 1)
    line = json.loads(json.dumps(out))
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace
                                                                      else []) + ["check"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    bench = harness.benchmark_json()
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    units = {m["name"]: m["unit"] for m in entries
             if CELL in m.get("workloads", [CELL])}
    assert set(line["metrics"]) <= set(units)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(units)
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        assert {"solver_iters", "apply_ms.clover"} <= set(line["metrics"])
        assert line["device"]["window_s"] > 0
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in line["check"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
                           "5", "--seconds", "1", "--trace", "0", *extra], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    p = _run(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_port_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['benchmark', '.']; import harness, check, control; "
            "import superbblas_tpu_torch, superbblas_tpu_torch.parallel, "
            "superbblas_tpu_torch.models.clover, superbblas_tpu_torch.models.domain_wall; "
            "from guard import forbidden_modules; print(forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.mark.parametrize("workload, overrides", [
    (CELL, SMALL),
    ("rbc-64i.mobius.prop-1rhs", {"lattice": [4, 4, 4, 4], "Ls": 4}),
    ("cls-d200.clover.prop-12rhs", {"lattice": [4, 4, 4, 4]}),
])
def test_control_is_not_correct(workload, overrides):
    """The reference in the port's place at TF32 fails the check."""
    got = control.readings(workload, 2 ** 35 + 1, 1, device="cpu", overrides=overrides)
    assert got["passed"] is False, got


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """One short run of the first cell on the card: correct, with its metrics."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
                        "123456789012", "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert {"rhs_per_s", "solve_s_p90", "peak_mem_gib", "setup_s"} == set(line["metrics"])
