"""BENCHMARK.json against the contract's rules that a file can show, and
every configuration, traffic mix, cell and metric file it names."""

import json
import re
from pathlib import Path

import pytest

import harness
from guard import forbidden_modules

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and 1 <= len(entry["source"]) <= 200
    assert 1 <= len(entry["why"]) <= 200 and not set(entry["why"]) & {"\n", "\t"}
    cfg = json.loads((ROOT.parent / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert all(NAME.match(k) and k in cfg for k in entry["reduced"])
    assert (ROOT / "actions" / f"{cfg['action']}.py").exists()
    assert (ROOT / "reference" / f"{cfg['action']}.py").exists()
    assert cfg["lattice"][0] * 1 and len(cfg["lattice"]) == 4
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_file(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    w, cfg, traffic = harness.cell(entry["name"])
    assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert entry["chips"] in (1, 4)
    assert cfg["lattice"][0] % entry["chips"] == 0
    assert set(w["limits"]) == {"res", "normal_res"}
    assert {"rhs", "tol", "maxiter", "warm_iters"} <= set(traffic)


def test_four_chip_cells_within_share():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "end_to_end" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "metrics" / f"{m['name']}.py").exists()
    for cell in cells:
        e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        p = [m for m in BENCH["per_layer"] if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2 and p


def test_solve_tail_only_where_it_has_a_hundred_solves():
    p90 = [m for m in BENCH["end_to_end"] if m["name"] == "solve_s_p90"]
    assert p90[0]["workloads"] == ["cls-d200.clover.hmc-1rhs"]


@pytest.mark.parametrize("names, found", [
    (["superbblas_tpu_torch", "superbblas_tpu_torch.ops", "torch", "jax_like", "jaxutils"], []),
    (["superbblas_tpu", "superbblas_tpu.ops.stencil"], ["superbblas_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen", "numpy"], ["flax", "jax", "jaxlib"]),
])
def test_import_guard_compares_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found
