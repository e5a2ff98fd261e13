"""The traced run's profile, reduced to what the per-layer readers need.

``torch.profiler`` records the card's activity (kernels, copies, sets)
and the host's operations over a few steady solves inside the window,
marked by a ``bench.window`` annotation.  The events stay in memory; each
rank keeps a list of its device activities inside the mark and a
breakdown: the device operations that took most time, and the idle gaps
between device activities grouped by the host operation that was running
when each gap began.  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import re
from pathlib import Path

WINDOW = "bench.window"
DEVICE_KINDS = ("kernel", "memcpy", "memset")


def start(device: str):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    mark = record_function(WINDOW)
    mark.__enter__()
    return prof, mark


def stop(handle):
    prof, mark = handle
    mark.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    return prof


def _kind(e) -> str:
    """'kernel', 'memcpy', 'memset' for device work; 'annotation' for a
    mark on the device's timeline (a ``record_function`` range, or one a
    library adds, such as NCCL's "nccl:all_to_all" beside its kernel);
    'host' else."""
    return kind_of(e.name(), "cuda" in str(e.device_type()).lower(),
                   _activity(e), getattr(e, "is_user_annotation", lambda: False)())


def _activity(e) -> str:
    act = getattr(e, "activity_type", None)
    if not callable(act):
        return ""
    a = act()
    return str(getattr(a, "name", a)).lower()


def kind_of(name: str, on_device: bool, activity: str = "", annotation: bool = False) -> str:
    if annotation or "annotation" in activity or name == WINDOW:
        return "annotation"
    if not on_device:
        return "host"
    low = name.lower()
    if "memcpy" in activity or low.startswith("memcpy"):
        return "memcpy"
    if "memset" in activity or low.startswith("memset"):
        return "memset"
    if "kernel" not in activity and ":" in name and "(" not in name:
        return "annotation"          # a labelled range, not a kernel's signature
    return "kernel"


def collect(prof) -> dict:
    """{"window": [t0_us, t1_us], "device": [[name, start_us, dur_us, kind]],
    "breakdown": {...}} of one rank's profile."""
    events = prof.profiler.kineto_results.events()
    host, device, window = [], [], None
    for e in events:
        kind = _kind(e)
        s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if e.name() == WINDOW and "cuda" not in str(e.device_type()).lower():
            window = [s, s + d]
        elif kind in ("host", "annotation") and "cuda" not in str(e.device_type()).lower():
            host.append((s, s + d, e.name()))
        elif kind in DEVICE_KINDS:
            device.append([e.name(), s, d, kind])
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW!r} mark")
    device = [ev for ev in device if ev[1] < window[1] and ev[1] + ev[2] > window[0]]
    device.sort(key=lambda ev: ev[1])
    return {"window": window, "device": device,
            "breakdown": breakdown(device, host, window)}


def union(device, window) -> list:
    """Merged [start, end] intervals of device activity inside ``window``."""
    out = []
    for _, s, d, _k in sorted(device, key=lambda ev: ev[1]):
        s, e = max(s, window[0]), min(s + d, window[1])
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(device, window) -> float:
    return sum(e - s for s, e in union(device, window))


def breakdown(device, host, window, top: int = 10) -> dict:
    """The ``top`` device operations by time, and the idle gaps' time by
    the innermost host operation running where each gap began."""
    by_op = {}
    for name, _s, d, _k in device:
        by_op[name] = by_op.get(name, 0.0) + d
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps, prev = {}, window[0]
    for s, e in union(device, window) + [[window[1], window[1]]]:
        if s > prev:
            label = "python (no host operation)"
            k = bisect.bisect_right(starts, prev) - 1
            for j in range(k, max(k - 400, -1), -1):
                if host[j][1] >= prev:
                    label = host[j][2]
                    break
            gaps[label] = gaps.get(label, 0.0) + (s - prev)
        prev = max(prev, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, t / 1e6] for n, t in ops],
            "idle_gaps": [[n, t / 1e6] for n, t in idle]}


def kernel_names(csrc: Path) -> dict:
    """{source file: [its __global__ function names]} of the port's CUDA
    sources: the names its kernels carry in a device trace."""
    out = {}
    for path in sorted(Path(csrc).glob("*.cu")):
        text = path.read_text()
        names = []
        for m in re.finditer(r"__global__", text):
            s = re.sub(r"^\s*void\s*", "", text[m.end():m.end() + 600])
            if s.startswith("__launch_bounds__"):
                depth = 0
                for k, ch in enumerate(s):
                    depth += ch == "("
                    depth -= ch == ")"
                    if ch == ")" and depth == 0:
                        s = s[k + 1:]
                        break
            name = re.match(r"\s*(\w+)\s*\(", s)
            if name:
                names.append(name.group(1))
        out[path.name] = sorted(set(names))
    return out


def is_named(kernel: str, names) -> bool:
    """Whether a trace's kernel name is one of ``names`` (a whole word)."""
    return any(re.search(rf"(?<!\w){re.escape(n)}(?!\w)", kernel) for n in names)


def is_nccl(kernel: str) -> bool:
    return kernel.lower().startswith("nccl")
