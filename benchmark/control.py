"""The control of a cell's check: the plain reference put in the port's
place, computed one precision below the configuration's (TF32 for its
float32: every operand of a product rounded to 10 mantissa bits, as a
tensor core takes it), solving the cell's own sources at the cell's own
size to the traffic's tolerance with a plain CG.  Its answers go through
the same check as the port's; a sound check calls them not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--solves 2]

on the cards the cell asks for (one process a card, as ``run.py``
starts them).  Prints one JSON line a seed: the readings, the limits and
whether the check passed.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "reference"), str(ROOT.parent)]

import torch  # noqa: E402

import check  # noqa: E402
import gen  # noqa: E402
import harness  # noqa: E402
from ref_cg import cgne  # noqa: E402
from ref_wilson import tf32  # noqa: E402
from shard import Ranks  # noqa: E402


def readings(workload: str, seed: int, solves: int, device: str = "cuda", overrides=None,
             ranks=None) -> dict:
    """The check's readings of the control's answers to solves 0..solves-1."""
    w, cfg, traffic = harness.cell(workload, overrides)
    ranks = ranks or Ranks(device, cfg["lattice"])
    act_mod = harness.module("actions", cfg["action"])
    lead = act_mod.lead(cfg, int(traffic["rhs"]))
    axis = len(lead)
    links = gen.links(seed, ranks.planes_ext, ranks.rest, ranks.device)
    ref_mod = harness.module("reference", cfg["action"])
    ref = ref_mod.Operator(links, cfg, dtype=torch.complex64, q=tf32)
    del links

    def interior(t):
        return t.narrow(axis, 1, ranks.xl)

    def dot(u, v):
        s = torch.vdot(u.reshape(-1), v.reshape(-1)).real.to(torch.float64).reshape(1)
        return float(ranks.all_sum(s))

    kept, iters = [], []
    for i in range(solves):
        re, im = gen.source(seed, i, lead, ranks.planes, ranks.rest, ranks.device)
        x, k = cgne(lambda v: interior(ref.apply(ranks.extend(v, axis))),
                    lambda v: interior(ref.adjoint(ranks.extend(v, axis))),
                    torch.complex(re, im), float(traffic["tol"]), int(traffic["maxiter"]), dot)
        kept.append((i, (x.real.float().cpu(), x.imag.float().cpu())))
        iters.append(k)
        del x, re, im
    del ref
    found = check.numbers(ref_mod, cfg, seed, kept, lead, ranks)
    compared = check.compare(found, w["limits"])
    return {"workload": workload, "seed": seed, "iters": iters, "readings": found,
            "check": compared, "passed": check.passed(compared)}


def rank_main(args):
    """One rank of a cell on several cards: every seed, then the group closes."""
    w, cfg, _ = harness.cell(args.workload)
    torch.cuda.set_device(args.rank)
    ranks = Ranks(f"cuda:{args.rank}", cfg["lattice"], args.rank, args.world, args.port)
    out = []
    for seed in args.seeds:
        out.append(readings(args.workload, seed, args.solves, ranks=ranks))
        torch.cuda.empty_cache()
    ranks.close()
    with open(args.out, "w") as f:
        json.dump(out, f)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--solves", type=int, default=2)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("control.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.rank is not None:
        return rank_main(args)
    chips = int(harness.cell(args.workload)[0]["chips"])
    if chips == 1:
        for seed in args.seeds:
            print(json.dumps(readings(args.workload, seed, args.solves)), flush=True)
            torch.cuda.empty_cache()
        return
    import run

    parts = run.ranks_run(str(Path(__file__).resolve()),
                          ["--workload", args.workload, "--seeds", *map(str, args.seeds),
                           "--solves", str(args.solves)], chips, timeout=3000)
    for line in parts[0]:
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
