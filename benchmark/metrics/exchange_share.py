"""Share of busy device time in NCCL's kernels: the halo exchanges of
``parallel/halo.py`` and the solver's all-reduces (mean over ranks).
None where no NCCL kernel ran (a cell on one card)."""

from _device import busy_us, is_nccl, kernel_time, per_rank


def read(t: dict):
    def one(r):
        busy = busy_us(r["device"], r["window"])
        nccl = kernel_time(r, is_nccl)
        return 100.0 * nccl / busy if busy > 0 and nccl > 0 else None

    return per_rank(t, one)
