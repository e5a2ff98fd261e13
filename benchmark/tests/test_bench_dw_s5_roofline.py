"""The s5 pass's roofline reader (``metrics/dw_s5_roofline.py``) on a
hand-made profile: 16 planes of 75.5 MB an iteration at 3.35 TB/s over
the device time of ``csrc/dw_s5.cu``'s kernels, and None where the
program keeps no ``dw_s5.bytes`` counter (the parent of the kernel) or
no such kernel ran."""

import copy

import pytest

import harness

PLANE = 131072 * 12 * 12 * 4
KERNEL = "void (anonymous namespace)::dw_s5_kernel<1, float, 4>((anonymous namespace)::Args<float>)"
HAND = {
    "ranks": [{"window": [0.0, 1000.0],
               "device": [[KERNEL, 0.0, 150.0, "kernel"],
                          ["void (anonymous namespace)::dw_s5_kernel<0, float, 4>(x)", 200.0, 110.0,
                           "kernel"],
                          ["void stencil_tiled_kernel<4>(x)", 400.0, 300.0, "kernel"],
                          ["Memcpy DtoD", 800.0, 50.0, "memcpy"]]}],
    "program": [{"spans": [[0, None, "apply_domain_wall", 0.0, 900.0, None]],
                 "counters": {"dw_s5.bytes": 10 * PLANE}}],
    "peaks": {"hbm_bytes_per_s": 3.35e12},
    "kernel_files": {"dw_s5.cu": ["dw_s5_kernel"], "stencil_tiled.cu": ["stencil_tiled_kernel"]},
}


def read(t):
    return harness.module("metrics", "dw_s5_roofline").read(t)


def test_bytes_at_the_data_sheet_rate_over_the_kernels_time():
    bound_us = 1e6 * 10 * PLANE / 3.35e12
    assert read(HAND) == pytest.approx(100.0 * bound_us / 260.0)


@pytest.mark.parametrize("missing", ["counter", "kernels", "file", "record"])
def test_none_without_its_source(missing):
    t = copy.deepcopy(HAND)
    if missing == "counter":
        t["program"][0]["counters"] = {"solver.iterations": 3}
    elif missing == "kernels":
        t["ranks"][0]["device"] = t["ranks"][0]["device"][2:]
    elif missing == "file":
        del t["kernel_files"]["dw_s5.cu"]
    else:
        t["program"] = [None]
    assert read(t) is None
