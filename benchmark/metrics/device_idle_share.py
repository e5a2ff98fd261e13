"""Share of the traced window in which no operation ran on the device:
1 - (union of kernel, copy and set intervals on all streams) / window
(mean over ranks)."""

from _device import busy_us, per_rank


def read(t: dict):
    def one(r):
        w = r["window"][1] - r["window"][0]
        return 100.0 * (1.0 - busy_us(r["device"], r["window"]) / w) if w > 0 else None

    return per_rank(t, one)
