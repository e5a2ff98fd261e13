"""Seconds from the start of the process to the start of the window:
imports, the kernels' build where the checkout has none yet, the links,
the operator and the warm-up."""


def read(record: dict) -> float:
    return record["setup_s"]
