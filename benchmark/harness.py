"""One rank's run of one cell, and the result line made from the ranks'.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``: the lattice, the action and its parameters)
and a traffic mix (``traffic/<mix>.json``: right-hand sides a solve, the
tolerance, the iteration cap).  The run

1. makes the links on the device from the seed and builds the operator
   through ``actions/<action>.py``, whose ``Action`` owns the timed call
   (``solve``, CGNE unless the action says otherwise: ``actions/_base.py``),
   the work a launch of each of its kernels must do (``work``) and the
   port's launch counters (``launches``);
2. warms up with a few iterations of a solve of the window's own shapes;
3. solves, in a closed loop for ``--seconds``, one new source after
   another (Gaussian from (seed, solve index)) with the action's
   ``solve``, each to the traffic's tolerance; a seed-drawn sample of the answers,
   and the last, are kept on the host (the clock paused while copying;
   inside the profiled solves the copy waits until the profile stops);
4. with ``--trace 1`` profiles a few solves after the first (the
   workload's ``trace_solves``) and records
   spans around each call into the port's apply;
5. reads the peak memory, frees the port's state and checks the kept
   answers against the plain reference (``check.py``).

End-to-end metrics are read by ``end_to_end/<name>.py`` from the run's
record, per-layer metrics by ``metrics/<name>.py`` from the trace: the
names come from BENCHMARK.json, so a new metric is a new file.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

import check
import gen
import guard
import profiling as tracing
from shard import Ranks, Spans, local

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: the traced solves start at the window's second solve, past the first's
#: one-off costs
TRACE_FROM = 1


def load(kind: str, name: str) -> dict:
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """``<kind>/<name>.py`` (names may hold dots; the folder is on the
    path for the module's own imports)."""
    path = ROOT / kind / f"{name}.py"
    if str(path.parent) not in sys.path:
        sys.path.insert(0, str(path.parent))
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, overrides=None):
    """(workload, configuration with ``overrides``, traffic) of a cell."""
    w = load("workloads", workload)
    cfg = dict(load("configs", w["config"]), **(overrides or {}))
    return w, cfg, load("traffic", w["traffic"])


def benchmark_json() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def run_rank(workload: str, seed: int, seconds: float, trace: bool, rank: int = 0,
             world: int = 1, port=None, device: str = "cuda", overrides=None,
             fault=None) -> dict:
    """One rank's part of a run; a JSON-able dict.  ``fault`` (tests only)
    takes the action's ``solve`` and returns a broken one."""
    w, cfg, traffic = cell(workload, overrides)
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    ranks = Ranks(device, cfg["lattice"], rank, world, port)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    act_mod = module("actions", cfg["action"])
    spans = Spans(device)
    ranks.sync()
    phases = {"process group": time.time()}
    links = gen.links(seed, ranks.planes if world == 1 else ranks.planes_ext, ranks.rest,
                      device)
    ranks.sync()
    phases["links"] = time.time()
    act = act_mod.Action(cfg, links, ranks, spans)
    del links
    ranks.sync()
    phases["operator"] = time.time()
    nrhs, tol, maxiter = int(traffic["rhs"]), float(traffic["tol"]), int(traffic["maxiter"])
    lead = act_mod.lead(cfg, nrhs)
    axis = len(lead)
    solve = act.solve if fault is None else fault(act.solve)

    def source(i):
        return ranks.wrap(gen.source(seed, i, lead, ranks.planes, ranks.rest, device), axis)

    # warm-up: every shape of the window, a few iterations
    b = source(-1)
    solve(b, tol=tol, maxiter=int(traffic["warm_iters"]))
    del b
    ranks.barrier()
    window_wall = phases["warm-up"] = time.time()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    trace_n = int(w["trace_solves"])
    share = float(w["check_share"])
    kept, pending, solve_s, iters = [], [], [], []
    failed, paused, i, handle, prof, launches = 0, 0.0, 0, None, None, {}
    while True:
        if trace and i == TRACE_FROM:
            launches = act.launches()
            spans.on = True
            ranks.sync()
            handle = tracing.start(device)
        b = source(i)
        ts = ranks.clock()
        x, rs, it = solve(b, tol=tol, maxiter=maxiter)
        te = ranks.clock()
        if handle is not None and i == TRACE_FROM + trace_n - 1:
            prof = tracing.stop(handle)
            handle, spans.on = None, False
            launches = {k: v - launches.get(k, 0) for k, v in act.launches().items()}
            kept += [(k, tuple(local(p).cpu() for p in v)) for k, v in pending]
            pending = []
        solve_s.append(te - ts)
        iters.append(int(it))
        failed += not (int(it) < maxiter and bool(torch.isfinite(local(rs)).all()))
        i += 1
        more = time.perf_counter() < deadline or (trace and prof is None)
        if not ranks.all_min(int(more)):
            break
        if gen.sampled(seed, i - 1, share) and handle is not None:
            pending.append((i - 1, x))      # copied once the profile has stopped
        elif gen.sampled(seed, i - 1, share):
            tp = time.perf_counter()
            kept.append((i - 1, tuple(local(p).cpu() for p in x)))
            paused += time.perf_counter() - tp
        del x, b, rs
    window_s = time.perf_counter() - t0 - paused
    found = guard.forbidden_modules()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kept.append((i - 1, tuple(local(p).cpu() for p in x)))
    work = act.work(ranks.xl * math.prod(ranks.rest), nrhs)
    del x, b, rs, act, solve
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out = {"rank": rank, "window_wall": window_wall, "window_s": window_s,
           "solve_s": solve_s, "iters": iters, "rhs": nrhs, "attempted": i,
           "failed": failed, "peak_bytes": peak, "forbidden": found,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "setup_phases": phases}
    if prof is not None:
        t = tracing.collect(prof)
        del prof
        t["spans"] = spans.read()
        t["launches"], t["work"] = launches, work
        out["trace"] = t
    out["readings"] = check.numbers(module("reference", cfg["action"]), cfg, seed, kept,
                                    lead, ranks)
    out["check"] = check.compare(out["readings"], w["limits"])
    out["forbidden"] = sorted(set(out["forbidden"]) | set(guard.forbidden_modules()))
    ranks.close()
    return out


def result(workload: str, parts: list, t_start: float, trace: bool, world: int) -> dict:
    """The result line from the ranks' parts."""
    bench = benchmark_json()
    r0 = parts[0]
    correct = all(check.passed(p["check"]) and not p["forbidden"] and not p["failed"]
                  for p in parts)
    device = {"platform": "gpu", "kind": r0["kind"], "count": world,
              "memory_peak_bytes": max(p["peak_bytes"] for p in parts)}
    out = {"correct": correct, "attempted": r0["attempted"],
           "failed": max(p["failed"] for p in parts)}

    def listed(entry):
        return "workloads" not in entry or workload in entry["workloads"]

    metrics = {}
    if trace:
        t = {"ranks": [p["trace"] for p in parts], "spans": r0["trace"]["spans"],
             "launches": r0["trace"]["launches"], "work": r0["trace"]["work"],
             "solver_iters": r0["iters"], "peaks": load("counts", "peaks"),
             "kernel_files": tracing.kernel_names(REPO / "superbblas_tpu_torch" / "csrc")}
        for entry in bench["per_layer"]:
            if listed(entry):
                value = module("metrics", entry["name"]).read(t)
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        wins = [p["trace"]["window"] for p in parts]
        device["busy_s"] = sum(tracing.busy_us(p["trace"]["device"], p["trace"]["window"])
                               for p in parts) / len(parts) / 1e6
        device["window_s"] = sum(w1 - w0 for w0, w1 in wins) / len(wins) / 1e6
    else:
        record = {"solve_s": r0["solve_s"], "rhs": r0["rhs"], "window_s": r0["window_s"],
                  "setup_s": max(p["window_wall"] for p in parts) - t_start,
                  "peak_bytes": device["memory_peak_bytes"]}
        for entry in bench["end_to_end"]:
            if listed(entry):
                value = module("end_to_end", entry["name"]).read(record)
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    out["metrics"] = metrics
    out["device"] = device
    if trace:
        out["breakdown"] = r0["trace"]["breakdown"]
    out["check"] = r0["check"]
    return out
