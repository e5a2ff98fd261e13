"""Performance tracking: spans on the profiler's clock, counters, and the
hierarchical call-path report (counterpart of
``superbblas_tpu/utils/tracker.py``).

Re-creation of the reference's tracker subsystem
(``include/superbblas/performance.h:196-431`` in eromero-vlc/superbblas):
scopes build a "a/b/c" call path; each scope accumulates time, call
count, and flop/byte attributions; ``report_timings`` prints per-path
GFLOPS / GBYTES/s / arithmetic intensity.

One recorder serves the report and the layer boundaries of the port
(``spanned`` functions and ``begin``/``end`` pairs: the solves, the
applies, K1's wrapper, the halo extension).  A span has a name, an id,
its parent's id, its host start and end, and on a CUDA device, where it
asks for them, its device time:

  * Nothing waits for the device while a span is open.  A span with
    events records a ``torch.cuda.Event`` pair on the current stream of
    its device (``sync_on``'s, for ``track``) at entry and exit; the pairs
    are resolved where they are read (``get_timings``, ``report_timings``,
    ``stop``), with one synchronise a device.  The time a scope reports
    is then the device's, between its two events, as the reference's
    GPU event pairs give it (performance.h:282-330); on the CPU it is the
    host's.
  * Host times are taken on a monotonic clock and exported by ``stop``
    in microseconds on the clock of ``torch.profiler``'s events (the Unix
    epoch), by one offset taken when the record opens.
  * Every span is also a profiler range (PyTorch's C++ one, where this
    PyTorch has it), so the same names show in profiler traces; a span of
    the call-path report is besides an NVTX range (the reference's NVTX
    integration, performance.h:17-22) once CUDA is initialised.

Span sites record while ``on`` (between ``start()`` and ``stop()``, or
with SBT_TRACK_TIME=1: the call paths of ``get_timings``) or while a
``torch.profiler`` profile runs, so that a profile carries the port's
spans and ``stop`` then returns the record of that profile.  With none of
these a span site costs two reads of module-level flags (``on`` and
PyTorch's ``_is_profiler_enabled``); ``tracked`` ops one cached read of
the environment, and ``track(..., force=True)`` records always.

Counters (``count``) are plain integers and count always; the record
holds what they counted while it was kept.  Memory accounting
(performance.h:457-518) reads the CUDA caching allocator
(``torch.cuda.memory_allocated``) and the live tensors the garbage
collector knows of.
"""

from __future__ import annotations

import collections
import functools
import gc
import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler
from torch.utils import _pytree

from .. import flags

__all__ = ["track", "tracked", "get_timings", "reset_timings",
           "report_timings", "report_memory_usage", "memory_snapshot",
           "check_for_memory_leaks", "spanned", "begin", "end", "count",
           "counters", "to_host", "start", "stop", "refresh"]

#: spans with events kept for the report before the finished ones are
#: folded into it (``query``, no wait)
PENDING_FOLD = 4096
#: a profiler range by name: the C++ one where this PyTorch has it (about a
#: microsecond where ``record_function`` takes ten, profiler on or off)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)
if not hasattr(_profiler, "_is_profiler_enabled"):       # a PyTorch without the flag
    _profiler = type("_NoFlag", (), {"_is_profiler_enabled": False})


@dataclass
class _PathStats:
    calls: int = 0
    seconds: float = 0.0
    flops: float = 0.0
    memops: float = 0.0


class _Span:
    __slots__ = ("id", "parent", "name", "path", "stats", "flops", "memops",
                 "range", "nvtx", "stream", "events", "t0", "t1")


#: whether span sites record whether or not a profile runs (``refresh``)
on = False
_started = False            # between start() and stop()
_profiled = False           # a profile's record is open
_track_env = False          # SBT_TRACK_TIME=1, as ``refresh`` last read it
_offset_ns = 0
_spans: list = []           # the record's spans
_kept: collections.Counter = collections.Counter()     # the record's counts
_pending: list = []         # spans with events still to fold into _stats
_counts: collections.Counter = collections.Counter()
_stats: Dict[str, _PathStats] = {}
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()


def refresh() -> None:
    """Re-read whether span sites record: while a record is kept, or with
    SBT_TRACK_TIME=1 (``flags.clear_cache`` calls this; an invalid value
    leaves the sites to ``start``, and ``track``/``tracked`` raise it)."""
    global on, _track_env
    try:
        _track_env = flags.get_track_time()
    except ValueError:
        _track_env = False
    on = _started or _profiled or _track_env


def _open() -> None:
    """Start a new record (dropping one nobody took)."""
    global _offset_ns
    with _lock:
        _spans.clear()
        _kept.clear()
    _offset_ns = _clock_offset_ns()


def _keeping() -> bool:
    """Whether spans and counts go to the record now: between ``start``
    and ``stop``, or while a profile runs.  The first span or count inside
    a profile opens a record of its own (dropping one nobody took), and
    ``on`` stays set until the first after the profile closes it, keeping
    its record for ``stop``; two profiles with no span or count between
    them share one record."""
    global _profiled
    if _started:
        return True
    if _profiler._is_profiler_enabled:
        if not _profiled:
            _open()
            _profiled = True
            refresh()
        return True
    if _profiled:
        _profiled = False
        refresh()
    return False


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def synchronize(tree) -> None:
    """Wait for the CUDA devices that hold ``tree``'s tensors."""
    devices = {leaf.device for leaf in _pytree.tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def _cuda_device_of(tree):
    for leaf in _pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


def _enter_range(name: str, nvtx: bool = True):
    nvtx = nvtx and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    rf = _RANGE(name)
    rf.__enter__()
    return rf, nvtx


def _exit_range(rf, nvtx: bool) -> None:
    rf.__exit__(None, None, None)
    if nvtx:
        torch.cuda.nvtx.range_pop()


@contextmanager
def ranges(name: str):
    """A profiler range and, once CUDA is initialised, an NVTX range."""
    rf, nvtx = _enter_range(name)
    try:
        yield
    finally:
        _exit_range(rf, nvtx)


def begin(name: str, events: bool = True, device=None, stats: Optional[bool] = None,
          flops: float = 0.0, memops: float = 0.0) -> _Span:
    """Open a span (its ranges, its start event where ``events`` and CUDA
    is initialised, on ``device``'s current stream or the current one);
    ``end`` closes it.  ``stats``: fold it into the call-path report
    (default: where SBT_TRACK_TIME=1)."""
    stack = _stack()
    up = stack[-1] if stack else None
    s = _Span()
    s.id = next(_ids)
    s.parent = up.id if up is not None else None
    s.name = name
    s.path = f"{up.path}/{name}" if up is not None else name
    s.stats = _track_env if stats is None else stats
    s.flops, s.memops = flops, memops
    stack.append(s)
    # the events outside the ranges, the host times inside: the device time
    # covers the span's own bookkeeping, the host time lies in its range
    s.stream = s.events = None
    if events and torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
        s.stream = torch.cuda.current_stream(device)
        s.events = torch.cuda.Event(enable_timing=True)
        s.events.record(s.stream)
    s.range, s.nvtx = _enter_range(name, s.stats)
    s.t0 = time.perf_counter_ns()
    return s


def end(s: _Span) -> None:
    """Close a span ``begin`` opened (not necessarily the innermost)."""
    s.t1 = time.perf_counter_ns()
    _exit_range(s.range, s.nvtx)
    s.range = None
    if s.events is not None:
        e = torch.cuda.Event(enable_timing=True)
        e.record(s.stream)
        s.events = (s.events, e)
    stack = _stack()
    if stack and stack[-1] is s:
        stack.pop()
    elif s in stack:
        stack.remove(s)
    if _keeping():
        _spans.append(s)
    if not s.stats:
        return
    if s.events is None:
        _fold(s, (s.t1 - s.t0) * 1e-9)
        return
    with _lock:
        _pending.append(s)
        full = len(_pending) > PENDING_FOLD
    if full:
        _resolve(wait=False)


def spanned(name: str, events: bool = True):
    """Decorator: each call is a span while span sites record (not while
    ``torch.compile`` traces it); otherwise the call costs two flag
    reads."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (on or _profiler._is_profiler_enabled) or torch.compiler.is_compiling():
                return fn(*args, **kwargs)
            s = begin(name, events)
            try:
                return fn(*args, **kwargs)
            finally:
                end(s)
        return wrapper
    return deco


def _fold(s: _Span, seconds: float) -> None:
    with _lock:
        st = _stats.setdefault(s.path, _PathStats())
        st.calls += 1
        st.seconds += seconds
        st.flops += s.flops
        st.memops += s.memops


def _device_ms(s: _Span):
    return s.events[0].elapsed_time(s.events[1]) if s.events is not None else None


def _wait_for(spans) -> None:
    """One synchronise a device of the spans' events."""
    for dev in {s.stream.device for s in spans if s.events is not None}:
        torch.cuda.synchronize(dev)


def _resolve(wait: bool = True) -> None:
    """Fold the pending spans' device times into the report: all of them,
    after one synchronise a device, or (``wait=False``) those whose end
    event has passed."""
    with _lock:
        pending = list(_pending)
    if wait:
        _wait_for(pending)
        done = pending
    else:
        done = [s for s in pending if s.events[1].query()]
    ids = {id(s) for s in done}
    with _lock:
        _pending[:] = [s for s in _pending if id(s) not in ids]
    for s in done:
        _fold(s, _device_ms(s) * 1e-3)


@contextmanager
def track(name: str, flops: float = 0.0, memops: float = 0.0,
          sync_on=None, force: bool = False):
    """Track a scope under the hierarchical path of enclosing scopes;
    yields its span (None where tracking is off).

    ``sync_on``: a pytree of tensors whose CUDA device's current stream
    takes the scope's events (the current device's otherwise); nothing is
    synchronised.  A scope whose ``sync_on`` holds no CUDA tensor, or that
    runs before CUDA is initialised, reports host time.
    """
    if not (force or flags.get_track_time()):
        yield None
        return
    device = None if sync_on is None else _cuda_device_of(sync_on)
    events = sync_on is None or device is not None
    s = begin(name, events, device=device, stats=True, flops=flops, memops=memops)
    try:
        yield s
    finally:
        end(s)


def tracked(name: str, flops_fn=None, memops_fn=None):
    """Decorator instrumenting a public op with a tracker scope.

    With SBT_LOG and SBT_TRACK_TIME off it costs one cached read of the
    environment (``flags.wrapper_state``).  With tracking on, the scope's
    events go to the stream of the op's first CUDA operand, so the
    recorded time is execution, not launch, and nothing waits
    (performance.h:282-330 records GPU event pairs the same way).
    ``flops_fn(out, *args, **kwargs)`` supplies the flop attribution,
    ``memops_fn`` the bytes; both land under the same hierarchical path as
    the time."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            log, timing = flags.wrapper_state()
            if not (log or timing):
                return fn(*args, **kwargs)
            if log:
                flags.log(1, name)
            if not timing:
                return fn(*args, **kwargs)
            with track(name, sync_on=(args, kwargs)) as s:
                out = fn(*args, **kwargs)
            if flops_fn is not None or memops_fn is not None:
                try:
                    fl = float(flops_fn(out, *args, **kwargs)) if flops_fn else 0.0
                    mem = float(memops_fn(out, *args, **kwargs)) if memops_fn else 0.0
                except Exception:
                    fl = mem = 0.0
                with _lock:
                    st = _stats.setdefault(s.path, _PathStats())
                    st.flops += fl
                    st.memops += mem
            return out
        return wrapper
    return deco


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always), and to the record's
    while one is kept."""
    keep = _keeping()
    with _lock:
        _counts[name] += n
        if keep:
            _kept[name] += n


def counters() -> Dict[str, int]:
    """Every counter, as counted since the process started."""
    with _lock:
        return dict(_counts)


def to_host(t: torch.Tensor):
    """``t`` on the host, by one device-to-host read counted in
    ``host_reads``: a Python number for a 0-dim tensor (``item``), a
    numpy array otherwise.  The port's hot path reads the device through
    this alone."""
    count("host_reads")
    return t.item() if t.dim() == 0 else t.detach().cpu().numpy()


def _clock_offset_ns() -> int:
    """Unix-epoch ns less monotonic ns: of five readings of the epoch
    clock, the one whose two monotonic readings lie closest (a thread
    descheduled between two readings would shift the offset)."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def start() -> None:
    """Keep the span sites' spans and the counts in a new record until
    ``stop``."""
    global _started, _profiled
    _open()
    _started, _profiled = True, False
    refresh()


def stop() -> dict:
    """End the record (``start``'s, or that of the last profile) and
    return it: ``{"spans": [[id, parent, name, t0_us, t1_us, device_ms or
    None], ...], "counters": {name: count while kept}}``, host times in
    microseconds on the profiler's clock, spans in the order they closed.
    The spans' events are resolved here, with one synchronise a device."""
    global _started, _profiled
    _started = _profiled = False
    refresh()
    with _lock:
        spans, _spans[:] = list(_spans), []
        kept = dict(_kept)
        _kept.clear()
    _wait_for(spans)
    rows = [[s.id, s.parent, s.name, (s.t0 + _offset_ns) / 1e3,
             (s.t1 + _offset_ns) / 1e3, _device_ms(s)] for s in spans]
    return {"spans": rows, "counters": kept}


def get_timings() -> Dict[str, dict]:
    """Snapshot of the accumulated stats (performance.h:105 analog); the
    pending events are resolved first."""
    _resolve()
    with _lock:
        return {
            k: dict(calls=v.calls, seconds=v.seconds, flops=v.flops,
                    memops=v.memops)
            for k, v in _stats.items()
        }


def reset_timings() -> None:
    with _lock:
        _stats.clear()
        _pending.clear()


def report_timings(out=None) -> str:
    """Per-call-path report: calls, time, GFLOPS, GBYTES/s, intensity
    (performance.h:364-431 analog).  Returns the formatted string and
    optionally writes it to ``out``."""
    lines = ["Timing of superbblas_tpu kernels:",
             f"{'path':40s} {'calls':>8s} {'time(s)':>10s} "
             f"{'GFLOPS':>10s} {'GBYTES/s':>10s} {'intensity':>10s}"]
    timings = get_timings()
    for path in sorted(timings):
        st = timings[path]
        t = max(st["seconds"], 1e-12)
        gf = st["flops"] / t / 1e9
        gb = st["memops"] / t / 1e9
        inten = st["flops"] / max(st["memops"], 1.0)
        lines.append(f"{path:40s} {st['calls']:8d} {st['seconds']:10.4f} "
                     f"{gf:10.1f} {gb:10.1f} {inten:10.2f}")
    txt = "\n".join(lines)
    if out is not None:
        print(txt, file=out)
    return txt


def _cuda_devices():
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _live_cpu_tensors():
    """(count, bytes) of the CPU tensors the garbage collector knows of,
    each storage counted once."""
    seen, count, nbytes = set(), 0, 0
    for obj in gc.get_objects():
        try:
            if not (issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu"):
                continue
            count += 1
            st = obj.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                nbytes += st.nbytes()
        except Exception:  # tensors without storage (meta, fake)
            continue
    return count, nbytes


def report_memory_usage() -> dict:
    """Device-memory statistics (memory tracking analog,
    performance.h:457-518): per CUDA device the allocator's bytes in use
    and their peak (``torch.cuda.memory_stats``), and ``live_array_bytes``,
    the bytes of live tensors on every device."""
    usage = {}
    live = 0
    for dev in _cuda_devices():
        ms = torch.cuda.memory_stats(dev)
        usage[str(dev)] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": ms.get("reserved_bytes.all.current", 0),
        }
        live += torch.cuda.memory_allocated(dev)
    usage["live_array_bytes"] = live + _live_cpu_tensors()[1]
    return usage


def memory_snapshot() -> dict:
    """Live-tensor accounting snapshot for leak checking
    (getCpuMemUsed/getGpuMemUsed analog, performance.h:53-63): the CUDA
    allocator's bytes plus the live CPU tensors' storage bytes."""
    count, nbytes = _live_cpu_tensors()
    for dev in _cuda_devices():
        nbytes += torch.cuda.memory_allocated(dev)
    return {"count": count, "bytes": int(nbytes)}


def check_for_memory_leaks(baseline: dict, tol_bytes: int = 0) -> None:
    """Raise if live memory grew past the baseline snapshot
    (checkForMemoryLeaks, performance.h:497-518; the reference's tests
    call it at exit under SB_TRACK_MEM=1).  Collects garbage first."""
    gc.collect()
    now = memory_snapshot()
    grew = now["bytes"] - baseline["bytes"]
    if grew > tol_bytes:
        raise RuntimeError(
            f"memory leak: live tensor bytes grew by {grew} "
            f"({baseline['count']} -> {now['count']} tensors)")


refresh()
