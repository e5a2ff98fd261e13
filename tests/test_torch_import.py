"""superbblas_tpu_torch stands apart from JAX, and chip_smoke.py refuses to
run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(args, cwd=ROOT):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_does_not_load_jax():
    code = ("import sys, superbblas_tpu_torch, superbblas_tpu_torch.ops._cuda, "
            "superbblas_tpu_torch.models.wilson, superbblas_tpu_torch.models.eo_packed, "
            "superbblas_tpu_torch.models.even_odd, superbblas_tpu_torch.solvers, "
            "superbblas_tpu_torch.bsr, superbblas_tpu_torch.ops.batched_gemm, "
            "superbblas_tpu_torch.models.coarse, superbblas_tpu_torch.models.multigrid, "
            "superbblas_tpu_torch.storage, superbblas_tpu_torch.dense, superbblas_tpu_torch.aot, "
            "superbblas_tpu_torch.context, superbblas_tpu_torch.native, superbblas_tpu_torch.utils, "
            "superbblas_tpu_torch.parallel, superbblas_tpu_torch.parallel.partition, "
            "superbblas_tpu_torch.parallel.mesh, superbblas_tpu_torch.parallel.multihost, "
            "superbblas_tpu_torch.parallel.halo, superbblas_tpu_torch.parallel.stencil_sharded, "
            "superbblas_tpu_torch.parallel.dist, superbblas_tpu_torch.parallel.redistribute, "
            "superbblas_tpu_torch.parallel.overlap, superbblas_tpu_torch.parallel.powers, "
            "superbblas_tpu_torch.parallel.gather_sharded; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'superbblas_tpu')); "
            "assert not bad, bad")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_package_sources_never_import_jax():
    for path in (ROOT / "superbblas_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "superbblas_tpu"), \
                    f"{path}: {line}"


def test_distributed_worker_never_imports_jax():
    """The gloo groups' worker (tests/_torch_dist_worker.py) and its
    launcher import no JAX: neither in their sources nor once loaded
    (torch.distributed.tensor included)."""
    for name in ("_torch_dist_worker.py", "_torch_dist.py"):
        for line in (ROOT / "tests" / name).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "superbblas_tpu"), line
    code = ("import sys; sys.path.insert(0, 'tests'); import _torch_dist_worker, _torch_dist, "
            "torch.distributed.tensor; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'superbblas_tpu')); assert not bad, bad")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_cuda():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "is_available() is false" in proc.stderr


def test_native_loader_never_opens_the_jax_package(tmp_path):
    """The port's plan engine is built from its own source into its own
    ``_build/`` and loaded from there: no file under superbblas_tpu/ is
    opened, compiled or loaded (an audit hook records every open, dlopen
    and process the loader starts)."""
    code = (
        "import sys\n"
        "seen = []\n"
        "sys.addaudithook(lambda ev, args: seen.append((ev, repr(args)))\n"
        "    if ev in ('open', 'ctypes.dlopen', 'subprocess.Popen', 'os.exec') else None)\n"
        "from superbblas_tpu_torch import native\n"
        "lib = native.get_lib()\n"
        "rows = native.intersect_all([[[0, 0], [2, 2]]], [[[1, 1], [2, 2]]], (4, 4))\n"
        "assert lib is None or rows is not None\n"
        "bad = [s for s in seen if '/superbblas_tpu/' in s[1]]\n"
        "assert not bad, bad\n"
        "assert lib is None or '/superbblas_tpu_torch/_build/' in lib._name, lib._name\n"
        "assert not any(m.split('.')[0] in ('jax', 'superbblas_tpu') for m in sys.modules)\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
