"""K1's tiled route (``csrc/stencil_tiled.cu``, the Wilson hopping) as a
share of its roofline: the frozen bound of one launch (``counts/k1.py``:
blocks, x and y each moved once, at the data sheet's 3.35 TB/s, or its
operations at 67 TFLOP/s, the larger) over the mean device time of a
launch in the traced solves."""

from _device import roofline


def read(t: dict):
    return roofline(t, "k1.tiled")
