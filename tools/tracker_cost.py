"""What the tracker's recording costs a solve, on the card.

    python tools/tracker_cost.py [--cells CELL ...] [--solves N] [--rounds R] [--seed S]

For each one-card cell of the benchmark (``benchmark/workloads/``), in one
process: the cell's operator and sources as ``benchmark/harness.py``
builds them from the seed, one warm solve, then ``--rounds`` rounds of
four turns, recording off, on, on, off (``utils.tracker.start``/``stop``
around the turn; ``stop``'s one synchronise outside the clock).  A turn
solves the same ``--solves`` sources, each waited for as the benchmark's
window waits (host clock after a device synchronise).  Prints the card's
name and power limit, then a JSON line a cell (rhs/s of each turn, the
medians, on over off).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO / "benchmark"), str(REPO)]

import torch  # noqa: E402

import gen  # noqa: E402
import harness  # noqa: E402
from shard import Ranks, Spans  # noqa: E402
from superbblas_tpu_torch.utils import tracker  # noqa: E402

CELLS = ["cls-d200.clover.hmc-1rhs", "rbc-64i.mobius.prop-1rhs", "cls-d200.clover.prop-12rhs"]


def turn(solve, sources, tol, maxiter, ranks, record: bool) -> float:
    """rhs/s of one turn: the sources solved in order, each waited for."""
    if record:
        tracker.start()
    elapsed, rhs = 0.0, 0
    for b in sources:
        t0 = ranks.clock()
        x, _rs, _it = solve(b, tol=tol, maxiter=maxiter)
        elapsed += ranks.clock() - t0
        rhs += x.re.shape[0]
        del x
    if record:
        tracker.stop()
    return rhs / elapsed


def cell(name: str, seed: int, solves: int, rounds: int, device: str = "cuda:0",
         overrides=None) -> dict:
    """The turns of one cell (``device`` and ``overrides`` of the
    configuration: a small rehearsal on the CPU)."""
    _w, cfg, traffic = harness.cell(name, overrides)
    ranks = Ranks(device, cfg["lattice"])
    act_mod = harness.module("actions", cfg["action"])
    act = act_mod.Action(cfg, gen.links(seed, ranks.planes, ranks.rest, device), ranks,
                         Spans(device))
    nrhs, tol, maxiter = int(traffic["rhs"]), float(traffic["tol"]), int(traffic["maxiter"])
    lead = act_mod.lead(cfg, nrhs)
    sources = [ranks.wrap(gen.source(seed, i, lead, ranks.planes, ranks.rest, device),
                          len(lead)) for i in range(solves)]
    act.solve(sources[0], tol=tol, maxiter=maxiter)        # warm: plans, first calls
    rates = {"off": [], "on": []}
    for _ in range(rounds):
        for record in (False, True, True, False):
            rates["on" if record else "off"].append(
                turn(act.solve, sources, tol, maxiter, ranks, record))
    off, on = statistics.median(rates["off"]), statistics.median(rates["on"])
    out = {"cell": name, "seed": seed, "solves_a_turn": solves, "rhs_per_s": rates,
           "median_off": off, "median_on": on, "on_over_off": on / off}
    del act, sources
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", nargs="+", default=CELLS)
    p.add_argument("--solves", type=int, default=4)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--seed", type=int, default=2718281828459)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tracker_cost: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0] if smi.strip() else torch.cuda.get_device_name(0),
          flush=True)
    for name in args.cells:
        t0 = time.perf_counter()
        out = cell(name, args.seed, args.solves, args.rounds)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
