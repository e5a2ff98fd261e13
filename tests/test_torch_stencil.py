"""superbblas_tpu_torch.ops.stencil against superbblas_tpu.ops.stencil_pallas
on the same numpy inputs (the CUDA kernel's own tests are in
test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import WILSON_OFFSETS, assert_parity, both, crand_np, to_np
from superbblas_tpu.ops import stencil_pallas as JS
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.ops import stencil as TS

LAT = (2, 4, 8, 128)
BI = BD = 3


def operands(with_kron, dtype, n=2, lat=LAT, seed=0):
    ki = kd = 4 if with_kron else 1
    blocks = crand_np((len(WILSON_OFFSETS), BI * BD) + lat, seed, dtype)
    kron = crand_np((len(WILSON_OFFSETS), ki, kd), seed + 1, dtype) if with_kron else None
    x = crand_np((n, kd * BD) + lat, seed + 2, dtype)
    return blocks, kron, x


@pytest.mark.parametrize("with_kron,dtype,storage,parity", [
    (True, np.float64, None, None),
    (False, np.float64, None, None),
    (True, np.float32, None, None),
    (False, np.float32, None, None),
    (True, np.float32, "bf16", None),
    (True, np.float64, None, 0),
    (True, np.float64, None, 1),
])
def test_reference_matches_jax(with_kron, dtype, storage, parity):
    blocks, kron, x = operands(with_kron, dtype)
    jb, tb = both(blocks)
    if storage == "bf16":
        # the port converts bf16 blocks on load, as the TPU kernel does:
        # compare with JAX on the same (bf16-representable) values in f32
        tb = CArray(tb.re.to(torch.bfloat16), tb.im.to(torch.bfloat16))
        jb = both(tuple(to_np(p).astype(dtype) for p in tb))[0]
    jk, tk = both(kron) if kron is not None else (None, None)
    jx, tx = both(x)
    got = TS.stencil_matvec_soa_reference(tb, tk, tx, WILSON_OFFSETS, BI, BD,
                                          packed_parity=parity)
    want = JS.stencil_matvec_soa_reference(jb, jk, jx, WILSON_OFFSETS, BI, BD,
                                           packed_parity=parity)
    assert got.re.dtype == tx.re.dtype
    assert_parity(got, want, dtype)


def test_reference_matches_jax_pallas_kernel():
    """The port's plain version against the TPU kernel itself (Pallas
    interpret mode), with bf16-stored blocks; no kron, which keeps the
    interpreted kernel's trace short."""
    blocks, _, x = operands(False, np.float32, lat=(2, 2, 8, 128))
    jb, tb = both(blocks, jnp.bfloat16, torch.bfloat16)
    jx, tx = both(x)
    got = TS.stencil_matvec_soa_reference(tb, None, tx, WILSON_OFFSETS, BI, BD)
    want = JS.stencil_matvec_soa(jb, None, jx, WILSON_OFFSETS, BI, BD, interpret=True)
    assert_parity(got, want, np.float32)


def test_aos_soa_roundtrip_matches_jax():
    n, kd = 3, 4
    jx, tx = both(crand_np(LAT + (kd, BD, n), 3))
    t_soa = TS.aos_to_soa(tx, 4)
    assert_parity(t_soa, JS.aos_to_soa(jx, 4), np.float64)
    assert tuple(t_soa.shape) == (n, kd * BD) + LAT
    back = TS.soa_to_aos(t_soa, 4, kd, BD)
    assert_parity(back, JS.soa_to_aos(JS.aos_to_soa(jx, 4), 4, kd, BD), np.float64)
    np.testing.assert_array_equal(to_np(back.re), to_np(tx.re))


def test_cpu_dispatch_takes_plain_path():
    blocks, kron, x = operands(True, np.float32)
    _, tb = both(blocks)
    _, tk = both(kron)
    _, tx = both(x)
    before = TS.stencil_matvec_soa.launches, TS.stencil_matvec_soa_rt.launches
    got = TS.stencil_matvec_soa(tb, tk, tx, WILSON_OFFSETS, BI, BD)
    want = TS.stencil_matvec_soa_reference(tb, tk, tx, WILSON_OFFSETS, BI, BD)
    assert TS.stencil_matvec_soa.launches == before[0] == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a shape of the runtime-shape route: the plain version too
    k2 = CArray(tk.re[:, :2, :2].contiguous(), tk.im[:, :2, :2].contiguous())
    x2 = CArray(tx.re[:, :6].contiguous(), tx.im[:, :6].contiguous())
    for fn in (TS.stencil_matvec_soa, TS.stencil_matvec_soa_rt):
        got = fn(tb, k2, x2, WILSON_OFFSETS, BI, BD)
        want = TS.stencil_matvec_soa_reference(tb, k2, x2, WILSON_OFFSETS, BI, BD)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (TS.stencil_matvec_soa.launches, TS.stencil_matvec_soa_rt.launches) == before


@pytest.mark.parametrize("with_kron", [False, True])
def test_all_ones_gives_neighbour_count(with_kron):
    """tests/bsr.cpp fast check of the reference library: all-ones blocks
    and field give exactly ndir * KD * BD in every entry."""
    kd = 4 if with_kron else 1
    lat = (2, 2, 4, 8)
    ndir = len(WILSON_OFFSETS)
    ones = lambda shape: CArray(torch.ones(shape), torch.zeros(shape))  # noqa: E731
    y = TS.stencil_matvec_soa(ones((ndir, BI * BD) + lat),
                              ones((ndir, kd, kd)) if with_kron else None,
                              ones((2, kd * BD) + lat), WILSON_OFFSETS, BI, BD)
    assert torch.all(y.re == ndir * kd * BD) and torch.all(y.im == 0)


@pytest.mark.parametrize("case", ["kron_2x2", "block_4x4", "packed_parity",
                                  "f64", "f32_blocks_bf16_field", "f16", "offset_2",
                                  "wrong_x_shape", "non_contiguous"])
def test_kernel_rejects_what_it_does_not_take(case):
    """K1 takes the five pairs of KERNEL_DTYPES (f64 and f32 blocks with
    bf16 fields among them) and refuses f16; the X-inside and X-streaming
    schedules refuse those two pairs, naming ROADMAP.md."""
    blocks, kron, x = operands(True, np.float32)
    tb, tk, tx = (both(a)[1] for a in (blocks, kron, x))
    kw = dict(blocks=tb, kron=tk, x=tx, offsets=WILSON_OFFSETS, bi=BI, bd=BD)
    err = NotImplementedError
    if case == "kron_2x2":
        # a 2x2 spin factor with 9x9 blocks: KI*KD*BI*BD = 324 > 256
        kw["kron"] = CArray(tk.re[:, :2, :2], tk.im[:, :2, :2])
        kw.update(bi=9, bd=9)
        err = ValueError
    elif case == "block_4x4":
        # the kernel takes (4, 4, 4, 4); these operands hold 3x3 blocks
        kw.update(bi=4, bd=4)
        err = ValueError
    elif case == "packed_parity":
        # parities 0 and 1 run in the kernel; anything else is no parity
        kw["packed_parity"] = 2
        err = ValueError
    elif case in ("f64", "f32_blocks_bf16_field"):
        if case == "f64":
            kw["blocks"] = tb.to(torch.float64)
            kw["x"] = tx.to(torch.float64)
        else:
            kw["x"] = tx.to(torch.bfloat16)
        assert TS.check_kernel_case(**kw) == (4, 4)
        kw["shapes"] = TS.SCHEDULE_SHAPES
    elif case == "f16":
        kw["blocks"] = tb.to(torch.float16)
        kw["x"] = tx.to(torch.float16)
        err = ValueError
    elif case == "offset_2":
        kw["offsets"] = WILSON_OFFSETS[:-1] + [(0, 0, 0, 2)]
        err = ValueError
    elif case == "wrong_x_shape":
        kw["x"] = CArray(tx.re[:, :11], tx.im[:, :11])
        err = ValueError
    else:
        # right shape, columns not innermost-contiguous
        kw["x"] = CArray(*(p.transpose(0, 1).contiguous().transpose(0, 1) for p in tx))
        err = ValueError
    match = {"kron_2x2": "256", "block_4x4": "expected", "f16": "takes"}.get(
        case, "ROADMAP" if err is NotImplementedError else None)
    with pytest.raises(err, match=match):
        TS.check_kernel_case(**kw)


def test_soa_eligible():
    assert TS.soa_eligible(WILSON_OFFSETS, LAT)
    assert TS.soa_eligible(WILSON_OFFSETS, (3, 5, 6, 10))
    assert not TS.soa_eligible([(0, 0, 0, 2)], LAT)
    assert not TS.soa_eligible(WILSON_OFFSETS, (4, 4, 4))
    # JAX's rule KI*KD*BI*BD <= 256, without its TPU tiling rules
    assert TS.soa_eligible(WILSON_OFFSETS, (3, 5, 6, 10), 4, 4, 4, 4)
    assert not TS.soa_eligible(WILSON_OFFSETS, LAT, 3, 3, 4, 8)
    for args in ((3, 3, 4, 4), (12, 12, 1, 1), (4, 4, 4, 4), (17, 17, 1, 1)):
        assert TS.soa_eligible(WILSON_OFFSETS, LAT, *args) == \
            JS.soa_eligible(WILSON_OFFSETS, LAT, *args)


#: (KI, KD, BI, BD) beyond the Wilson and staggered shapes: the JAX
#: package's test shapes, the clover term's and an asymmetric one
NEW_SHAPES = [(2, 2, 3, 3), (1, 1, 2, 2), (1, 1, 12, 12), (2, 1, 4, 2)]


@pytest.mark.parametrize("parity", [None, 1])
@pytest.mark.parametrize("shape", NEW_SHAPES)
def test_reference_matches_jax_at_new_shapes(shape, parity):
    """The plain version (which K1's two routes are held to on the card)
    against JAX's at the shapes the runtime-shape route and the clover
    term take, f64, full and packed parity."""
    ki, kd, bi, bd = shape
    lat = (2, 3, 4, 8)
    offsets = WILSON_OFFSETS if parity is None else WILSON_OFFSETS[1:]
    jb, tb = both(crand_np((len(offsets), bi * bd) + lat, 0))
    jk, tk = both(crand_np((len(offsets), ki, kd), 1)) if (ki, kd) != (1, 1) \
        else (None, None)
    jx, tx = both(crand_np((3, kd * bd) + lat, 2))
    got = TS.stencil_matvec_soa(tb, tk, tx, offsets, bi, bd, packed_parity=parity)
    want = JS.stencil_matvec_soa_reference(jb, jk, jx, offsets, bi, bd,
                                           packed_parity=parity)
    assert tuple(got.re.shape) == (3, ki * bi) + lat
    assert_parity(got, want, np.float64)


def test_block_rule_raises_on_every_device():
    """Above KI*KD*BI*BD = 256 the wrappers raise ValueError, on the CPU
    too, and bsr_from_stencil refuses the SoA layout."""
    from superbblas_tpu_torch.bsr import bsr_from_stencil

    lat = (2, 2, 2, 2)
    tb = both(crand_np((1, 289) + lat, 0))[1]
    tx = both(crand_np((1, 17) + lat, 1))[1]
    for fn in (TS.stencil_matvec_soa, TS.stencil_matvec_soa_rt):
        with pytest.raises(ValueError, match="256"):
            fn(tb, None, tx, [(0, 0, 0, 0)], 17, 17)
    blocks = both(crand_np(lat + (1, 17, 17), 2))[1]
    with pytest.raises(ValueError, match="eligible"):
        bsr_from_stencil("xyzta", "xyztb", lat, {"a": 17}, {"b": 17}, [(0, 0, 0, 0)],
                         blocks, layout="soa", device="cpu")
