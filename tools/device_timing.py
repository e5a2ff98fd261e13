"""Device-only time of a call on an NVIDIA GPU, and the host time a call
takes to issue: the one definition of each that ``chip_smoke.py`` and
``tools/kernel_turns.py`` use.

``graph_ms(fn)`` runs ``fn`` three times on a side stream (a warm-up that
also keeps allocations out of the capture), captures GRAPH_CALLS calls of
it in one CUDA graph, replays the graph once, then times ``reps`` replays
with CUDA events and returns the median over GRAPH_CALLS, in ms: no host
cost of the calls is inside.

``launch_us(fn)`` runs ``fn`` three times, waits for the card, times
LAUNCH_CALLS calls of it without a wait, then waits: host microseconds a
call takes to issue while the card is busy.
"""

from __future__ import annotations

import statistics
import time

import torch

#: launches captured in one CUDA graph for a device-only time
GRAPH_CALLS = 20
#: calls timed without a wait for a host time a call
LAUNCH_CALLS = 200


def launch_us(fn, calls: int = LAUNCH_CALLS) -> float:
    """Host microseconds a call of ``fn`` takes to issue while the card is
    busy: ``calls`` calls timed without a wait (after three warm-up calls
    and a wait), then waited on."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def graph_ms(fn, reps: int = 7, calls: int = GRAPH_CALLS) -> float:
    """Device ms of one call of ``fn``: ``calls`` calls captured in one CUDA
    graph (after a warm-up on a side stream), the median of ``reps``
    replays over ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return statistics.median(times)
