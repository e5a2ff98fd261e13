"""superbblas_tpu_torch stands apart from JAX, chip_smoke.py refuses to
run without a GPU, and the kernel layer builds one design of each kernel
and launches it through ``ops/_cuda.py`` (CPU checks, no card needed)."""

import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

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


def test_kernel_sources_build_one_design():
    """Every kernel is built at one design: no preprocessor test of an
    ``SBT_`` macro in csrc/, and no ``-D`` among the build's flags."""
    from superbblas_tpu_torch.ops import _cuda

    test = re.compile(r"^\s*#\s*(if|ifdef|ifndef|elif)\b.*\bSBT_")
    for path in sorted(_cuda.CSRC.glob("*.cu")) + sorted(_cuda.CSRC.glob("*.cuh")):
        for no, line in enumerate(path.read_text().splitlines(), 1):
            assert not test.match(line), f"{path.name}:{no}: {line}"
    assert not any(f.startswith("-D") for f in _cuda.NVCC_FLAGS), _cuda.NVCC_FLAGS


def test_on_card_sends_cpu_to_the_plain_version_and_refuses_other_devices(monkeypatch):
    """``_cuda.on_card``: False for CPU tensors, True for a CUDA first
    operand, ValueError naming the wrapper for another device; it never
    builds or loads the library."""
    import torch

    from superbblas_tpu_torch.ops import _cuda

    def no_library():
        raise AssertionError("on_card loaded the kernel library")

    monkeypatch.setattr(_cuda, "library", no_library)
    cpu = torch.zeros(2)
    assert _cuda.on_card("op", cpu) is False
    assert _cuda.on_card("op", cpu, torch.ones(3)) is False
    with pytest.raises(ValueError, match="op: no kernel for device meta"):
        _cuda.on_card("op", cpu.to("meta"))
    with pytest.raises(ValueError, match="op: no kernel for device cpu"):
        _cuda.on_card("op", cpu, cpu.to("meta"))
    with torch._subclasses.fake_tensor.FakeTensorMode():
        assert _cuda.on_card("op", torch.empty(2, device="cuda")) is True


def test_grid_cap_reads_each_device_once(monkeypatch):
    """``_cuda.grid_cap``: SMs x blocks an SM, the device's properties read
    once per (device, blocks an SM)."""
    import torch

    from superbblas_tpu_torch.ops import _cuda

    reads = []

    def properties(device):
        reads.append(device)
        return types.SimpleNamespace(multi_processor_count=132 if device.index == 0 else 114)

    monkeypatch.setattr(torch.cuda, "get_device_properties", properties)
    _cuda.grid_cap.cache_clear()
    try:
        d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
        assert [_cuda.grid_cap(d0, 4), _cuda.grid_cap(d0, 4), _cuda.grid_cap(d0, 2),
                _cuda.grid_cap(d1, 2), _cuda.grid_cap(d1, 2)] == [528, 528, 264, 228, 228]
        assert reads == [d0, d0, d1]
    finally:
        _cuda.grid_cap.cache_clear()


def test_launch_appends_the_stream_and_raises_on_a_cuda_error(monkeypatch):
    """``_cuda.launch`` calls the C entry with the device's current stream
    last and raises RuntimeError naming the entry on a nonzero cudaError;
    it enters the device only where it is not current."""
    import torch

    from superbblas_tpu_torch.ops import _cuda

    calls, entered = [], []

    class Device:
        def __init__(self, dev):
            entered.append(dev)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def entry(*args):
        calls.append(args)
        return args[0]

    monkeypatch.setattr(_cuda, "library", lambda: types.SimpleNamespace(sbt_k=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=100 + dev.index))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", Device)
    _cuda.launch("sbt_k", torch.device("cuda", 0), 0, 7)
    _cuda.launch("sbt_k", torch.device("cuda", 1), 0, 8)
    assert calls == [(0, 7, 100), (0, 8, 101)]
    assert entered == [torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="sbt_k kernel launch failed: cudaError 9"):
        _cuda.launch("sbt_k", torch.device("cuda", 0), 9)
