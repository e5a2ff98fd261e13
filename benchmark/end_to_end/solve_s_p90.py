"""The 90th percentile of the wall time of a solve, over every solve in
the window (host clock; each solve ends with the device synchronised).
Meant for cells with 100 or more solves in the window, so that ten lie
beyond it; a window of one solve reads that solve."""

import statistics


def read(record: dict) -> float:
    times = record["solve_s"]
    if len(times) < 2:
        return max(times)
    return statistics.quantiles(times, n=10, method="inclusive")[8]
