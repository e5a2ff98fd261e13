"""Right-hand sides solved per second: the right-hand sides of every
solve completed in the window over the window's time (host clock, the
device synchronised at both ends)."""


def read(record: dict) -> float:
    return record["rhs"] * len(record["solve_s"]) / record["window_s"]
