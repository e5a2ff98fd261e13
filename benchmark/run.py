"""The H100 benchmark of superbblas_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``: each number compared
beside its limit, also the last lines on standard error).  Exits with
another code than 0, printing no result, where there is no CUDA card or
fewer than the cell asks for, where the port is missing, or where a
module of JAX or of the JAX package was loaded.

A cell on several cards starts one process a card (this script with
``--rank``), rank r on card r over NCCL, rendezvous on a free localhost
port; this process waits for them and prints the line.  Kernel and
compiler caches are kept in fixed directories inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
CACHE = REPO / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(REPO)]

import guard  # noqa: E402

#: a rank's time limit (the run's own is 360 s, the first in a checkout 1200)
RANK_TIMEOUT = 1150


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with_parent():
    """A rank ends with the process that started it (Linux PR_SET_PDEATHSIG)."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)


def ranks_run(script: str, argv: list, world: int, timeout: float = RANK_TIMEOUT) -> list:
    """Start ``script argv --rank r --world world --port p --out <file>``
    once a card, wait for them all, and return what each wrote (JSON)."""
    from superbblas_tpu_torch.ops import _cuda

    _cuda.library()                   # built once, before the ranks load it
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="bench_ranks_")
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, script, *argv, "--rank", str(r), "--world", str(world),
                 "--port", str(port), "--out", os.path.join(tmp, f"rank{r}.json")],
                preexec_fn=_die_with_parent))
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            codes = [p.poll() for p in procs]
            if any(c for c in codes if c is not None) or time.time() > deadline:
                fail(f"ranks exited with {codes} (None: still running, stopped)", 1)
            time.sleep(0.2)
        codes = [p.returncode for p in procs]
        if any(codes):
            fail(f"ranks exited with {codes}", 1)
        parts = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                parts.append(json.load(f))
        return parts
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    args = parse(sys.argv[1:])
    found = guard.forbidden_modules()
    if found:
        fail(f"modules of JAX or of the JAX package loaded at start: {found}")
    import torch

    import harness

    w, _cfg, _traffic = harness.cell(args.workload)
    chips = int(w["chips"])
    if args.rank is not None:             # one rank of a cell on several cards
        part = harness.run_rank(args.workload, args.seed, args.seconds, bool(args.trace),
                                rank=args.rank, world=args.world, port=args.port)
        with open(args.out, "w") as f:
            json.dump(part, f)
        return
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")
    if chips == 1:
        parts = [harness.run_rank(args.workload, args.seed, args.seconds, bool(args.trace))]
    else:
        parts = ranks_run(str(Path(__file__).resolve()),
                          ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                           str(args.seconds), "--trace", str(args.trace)], chips)
    out = harness.result(args.workload, parts, T_START, bool(args.trace), chips)
    found = sorted(set(guard.forbidden_modules()).union(*(p["forbidden"] for p in parts)))
    if found:
        fail(f"modules of JAX or of the JAX package loaded: {found}")
    prev, steps = T_START, []
    for name, at in parts[0]["setup_phases"].items():
        steps.append(f"{name} {at - prev:.3f}")
        prev = at
    print("set-up by phase, rank 0, s: " + ", ".join(steps), file=sys.stderr)
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
