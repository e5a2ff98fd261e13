"""chip_smoke.py's dist phase, part (b), on NCCL across cards.

    python tools/dist_nccl.py

Runs ``chip_smoke.dist_child`` in one process a card (rank r on cuda:r,
NCCL, DIST_RANKS cards, four on one host) and holds it to the same
checks as the smoke's four gloo ranks on one card
(``chip_smoke.dist_report_b``): the sharded apply against the
whole-lattice K1 apply, CA powers, the sharded CG against the unsharded
one, the 4-block checkpoint, the redistributions, the overlap (K3) and
the sharded gather (E1).  Prints the cards' names and power limits and
each rank's times."""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402


def main():
    if len(sys.argv) > 1:           # one rank
        rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        CS.dist_child(rank, CS.DIST_RANKS, port, out, backend="nccl")
        return
    import torch

    from superbblas_tpu_torch.ops import _cuda

    if torch.cuda.device_count() < CS.DIST_RANKS:
        sys.exit(f"dist_nccl.py: needs {CS.DIST_RANKS} cards, found "
                 f"{torch.cuda.device_count()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _cuda.library()                 # build once, before the ranks load it
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    tmp = tempfile.mkdtemp(prefix="sbt_dist_nccl_")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port),
                               os.path.join(tmp, f"rank{r}.json")])
             for r in range(CS.DIST_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=CS.DIST_TIMEOUT)
        if any(p.returncode for p in procs):
            sys.exit(f"dist_nccl.py: ranks exited {[p.returncode for p in procs]}")
        res = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
               for r in range(CS.DIST_RANKS)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    CS.dist_report_b(res, time.perf_counter() - t0, backend="nccl")
    print("dist_nccl.py: ok", flush=True)


if __name__ == "__main__":
    main()
