"""Launcher of the gloo groups the distributed parity tests run on.

A test file writes its cases (numpy inputs, made from seeds) with
:func:`run_group`, which starts ONE group of ``nproc`` processes on the
CPU (``tests/_torch_dist_worker.py``, which imports no JAX), waits for it
under a timeout of its own and returns each rank's results.  A group that
fails or times out fails that file's tests, never the suite."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"


class GroupResult:
    """Per-rank results of a group: ``case(name)`` gives the list of each
    rank's output for that case, or fails the calling test with the
    group's log."""

    def __init__(self, outs, log, error=None):
        self.outs, self.log, self.error = outs, log, error

    def case(self, name):
        import pytest

        if self.error is not None:
            pytest.fail(f"gloo group failed: {self.error}\n{self.log[-6000:]}")
        got = []
        for r, out in enumerate(self.outs):
            if out is None or name not in out:
                pytest.fail(f"rank {r} has no result for {name!r}\n{self.log[-6000:]}")
            if isinstance(out[name], dict) and "error" in out[name]:
                pytest.fail(f"rank {r} raised in {name!r}:\n{out[name]['error']}")
            got.append(out[name])
        return got


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_group(suite: str, cases, tmp: Path, nproc: int = 4, timeout: float = 180.0,
              env=None) -> GroupResult:
    """Run ``cases`` ([(name, kind, params)]) of ``suite`` on a gloo group
    of ``nproc`` processes; returns a GroupResult.  The rendezvous port is
    free when it is picked but may be taken before rank 0 binds it (several
    groups start at once under xdist): a group whose rank 0 found it taken
    starts again once on another port."""
    res = _run_group(suite, cases, tmp, nproc, timeout, env)
    if res.error is not None and "address already in use" in res.log.lower():
        res = _run_group(suite, cases, tmp, nproc, timeout, env)
    return res


def _run_group(suite, cases, tmp, nproc, timeout, env) -> GroupResult:
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    for old in tmp.glob("out_rank*.pkl"):
        old.unlink()
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(list(cases), f)
    port = str(_free_port())
    penv = {k: v for k, v in os.environ.items()
            if not k.startswith(("XLA_", "JAX_", "SBT_", "MASTER_", "WORLD_SIZE", "RANK",
                                 "LOCAL_"))}
    penv.update({"PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "",
                 "OMP_NUM_THREADS": "1"})
    penv.update(env or {})
    logs = [tmp / f"log_rank{r}.txt" for r in range(nproc)]
    procs = []
    for r in range(nproc):
        with open(logs[r], "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), suite, str(tmp), str(r), str(nproc), port],
                cwd=str(ROOT), env=penv, stdout=lf, stderr=subprocess.STDOUT))
    error = None
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        error = f"timeout after {timeout} s"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log = "\n".join(f"--- rank {r} ---\n" + lf.read_text()[-3000:] for r, lf in enumerate(logs))
    outs = []
    for r in range(nproc):
        path = tmp / f"out_rank{r}.pkl"
        outs.append(pickle.load(open(path, "rb")) if path.exists() else None)
    if error is None and any(o is None for o in outs):
        error = f"exit codes {[p.returncode for p in procs]}"
    return GroupResult(outs, log, error)
