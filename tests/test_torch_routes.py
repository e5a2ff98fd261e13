"""The host logic that picks a route of a CUDA kernel, on the CPU:
``k1_route`` (K1's tiled, block-streaming, templated and runtime-shape
routes, and the block-streaming kernel's two forms) and ``permute_route``
(K2's 16-byte and 4-byte routes).  The kernels themselves are checked on
the card by tests/test_torch_cuda.py, on the same cases."""

import pytest
import torch

from superbblas_tpu_torch.ops import permute as P
from superbblas_tpu_torch.ops import stencil as S

F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
#: a 16-byte aligned data pointer
A = 1 << 20


@pytest.mark.parametrize("shape,st,ft,V,ptrs,route", [
    ((4, 4, 3, 3), F32, F32, 135, (A + 4,), "tiled"),
    ((1, 1, 3, 3), F64, F64, 8, (), "tiled"),
    ((1, 1, 12, 12), F32, F32, 256, (A, A), "site16"),
    ((1, 1, 12, 12), F32, F32, 900, (A, A), "site16"),
    ((1, 1, 12, 12), BF16, F32, 900, (A, A), "site"),
    ((1, 1, 12, 12), BF16, BF16, 1024, (A, A), "site16"),
    ((1, 1, 12, 12), F32, BF16, 135, (A, A), "site"),
    ((1, 1, 12, 12), F32, F32, 256, (A + 4, A), "site"),
    ((1, 1, 12, 12), BF16, F32, 256, (A, A + 8), "site"),
    ((1, 1, 12, 12), F32, F32, 24 ** 3 * 48, (A, A), "site16"),
    ((1, 1, 12, 12), F64, F64, 256, (A, A), "templated"),
    ((2, 2, 3, 3), F32, F32, 256, (A, A), "runtime"),
    ((1, 1, 12, 11), F32, F32, 256, (A, A), "runtime"),
])
def test_k1_route(shape, st, ft, V, ptrs, route):
    assert S.k1_route(shape, st, ft, V, ptrs) == route


def test_k1_route_of_the_clover_operands():
    """The clover term's CPU operands: 16-byte copies at an even volume of
    f32 blocks (a fresh tensor is aligned), element copies at an odd one
    of bf16 blocks."""
    for lat, dtype, route in (((2, 4, 4, 8), F32, "site16"), ((3, 3, 3, 5), BF16, "site")):
        b = torch.zeros((1, 144) + lat, dtype=dtype)
        assert S.k1_route(S.SITE_SHAPE, dtype, F32, b[0, 0].numel(),
                          (b.data_ptr(), b.data_ptr())) == route


def _strides(shape):
    X, Y, Z, T = shape
    return (Y * Z * T, Z * T, T, 1)


@pytest.mark.parametrize("shape,strides,ptr,route", [
    ((128, 64, 64, 128), None, A, "vec16"),
    ((60, 3, 5, 68), None, A, "vec16"),
    ((64, 2, 3, 64), None, A, "vec16"),
    ((68, 3, 2, 60), None, A, "vec16"),
    ((8, 256, 257, 8), None, A, "vec16"),
    ((64, 4, 5, 64), (3360, 560, 80, 1), A, "vec16"),
    ((64, 4, 5, 64), (3360, 560, 80, 1), A + 4, "word"),
    ((64, 4, 5, 40), (3360, 560, 80, 2), A, "word"),
    ((45, 6, 7, 70), None, A, "word"),
    ((44, 6, 7, 70), None, A, "word"),
    ((44, 6, 7, 72), None, A, "vec16"),
    ((44, 6, 7, 72), (3024, 504, 73, 1), A, "word"),
    ((44, 1, 7, 72), (504, 3, 72, 1), A, "vec16"),
    ((4, 2 ** 20, 2 ** 12, 4), None, A, "word"),
])
def test_permute_route(shape, strides, ptr, route):
    strides = strides or _strides(shape)
    assert P.permute_route(shape, strides, ptr, A) == route


def test_permute_route_output_alignment():
    assert P.permute_route((64, 2, 3, 64), _strides((64, 2, 3, 64)), A, A + 4) == "word"


def test_wrappers_count_by_route():
    """The launch counts by route exist and start as Counters (the smoke
    run and the card tests read them)."""
    assert isinstance(S.stencil_matvec_soa.by_route, type(P.permute_4d.by_route))
    assert set(S.stencil_matvec_soa.by_route) <= {"tiled", "site16", "site", "templated"}
    assert set(P.permute_4d.by_route) <= {"vec16", "word"}
