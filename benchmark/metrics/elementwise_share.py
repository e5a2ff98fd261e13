"""Share of busy device time in kernels built neither from the port's
``csrc/`` nor by NCCL: PyTorch's elementwise and reduction passes of
``cplx.py``, ``solvers.py`` and ``models/`` (mean over ranks)."""

from _device import busy_us, csrc_names, is_named, is_nccl, kernel_time, per_rank


def read(t: dict):
    names = csrc_names(t)

    def one(r):
        busy = busy_us(r["device"], r["window"])
        if busy <= 0:
            return None
        return 100.0 * kernel_time(r, lambda n: not is_nccl(n) and not is_named(n, names)) / busy

    return per_rank(t, one)
