"""The domain-wall s5 pass (``csrc/dw_s5.cu``) as a share of its roofline:
the bytes its launches in the traced solves had to move at the data
sheet's 3.35 TB/s, over the device time of that file's kernels in the
trace, in % (mean over ranks).  The bytes are the port's ``dw_s5.bytes``
counter: each launch adds the sizes of the planes it takes and returns,
so each read once and written once.  None where the program keeps no
such counter or no such kernel ran."""

from _device import is_named, kernel_time
from _program import per_rank


def read(t: dict):
    names = t["kernel_files"].get("dw_s5.cu") or []
    rate = t["peaks"]["hbm_bytes_per_s"]

    def one(r, p):
        nbytes = p["counters"].get("dw_s5.bytes")
        us = kernel_time(r, lambda name: is_named(name, names))
        return 100.0 * 1e6 * nbytes / rate / us if nbytes and us else None

    return per_rank(t, one)
