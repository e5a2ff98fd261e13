"""The spin plan of the stencil kernel K1 (``superbblas_tpu_torch.ops.stencil``
``factor_kron``, ``kernel_plan``, ``spin_plan``, ``stencil_matvec_soa_planned``)
against the TPU kernel's ``_factor_kron`` and its factored arithmetic
(``superbblas_tpu/ops/stencil_pallas.py``), on the same numpy inputs, and
the plan's caching across a solve.  The tiled CUDA kernel's own tests are
in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import WILSON_OFFSETS, both, crand_np, to_np
from superbblas_tpu import cplx as jcplx
from superbblas_tpu.ops import stencil_pallas as JS
from superbblas_tpu_torch import bsr
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import clover as TC
from superbblas_tpu_torch.models import domain_wall as TD
from superbblas_tpu_torch.models import eo_packed as TE
from superbblas_tpu_torch.models import wilson as TW
from superbblas_tpu_torch.ops import stencil as TS

LAT = (2, 2, 2, 4)


def _kron_np(kron):
    return to_np(kron.re), to_np(kron.im)


def _krons():
    """The spin factors of every operator family, as numpy parts; the
    staggered and clover-term stencils have none, and both packages run
    them with K_d = 1 ([ndir, 1, 1] ones, as the TPU kernel's wrapper
    makes)."""
    kw = dict(layout="soa", device="cpu")
    out = {
        "wilson r=1": _kron_np(TW.wilson_operator(LAT, **kw).kron),
        "wilson r=0.5": _kron_np(TW.wilson_operator(LAT, r=0.5, **kw).kron),
        "wilson r=1 f64": _kron_np(TW.wilson_operator(LAT, dtype=torch.complex128, **kw).kron),
        "twisted mass": _kron_np(TW.twisted_mass_operator(LAT, mu=0.3, **kw).kron),
        "moebius": _kron_np(TD.mobius_operator(LAT, Ls=4, dtype=torch.complex64, **kw)
                            .wilson.kron),
        "clover hop": _kron_np(TC.wilson_clover_operator(LAT, c_sw=1.0, **kw).hop.kron),
        "staggered": (np.ones((9, 1, 1), np.float32), np.zeros((9, 1, 1), np.float32)),
        "random": crand_np((9, 4, 4), 0, np.float32),
    }
    # a rank-1 and a rank-3 factor in every direction
    rng = np.random.default_rng(1)
    u = rng.standard_normal((9, 4, 1)) + 1j * rng.standard_normal((9, 4, 1))
    v = rng.standard_normal((9, 1, 4)) + 1j * rng.standard_normal((9, 1, 4))
    k1 = u @ v
    k3 = k1 + (rng.standard_normal((9, 4, 2)) @ rng.standard_normal((9, 2, 4)))
    out["rank 1"] = (k1.real, k1.imag)
    out["rank 3"] = (k3.real, k3.imag)
    return out


KRONS = _krons()


def _dense(rows, ncols):
    M = np.zeros((len(rows), ncols), complex)
    for i, row in enumerate(rows):
        for s, cr, ci in row:
            M[i, s] = cr + 1j * ci
    return M


@pytest.mark.parametrize("name", list(KRONS))
def test_plan_matches_jax(name):
    """The port's plan equals JAX's ``_factor_kron`` spec for spec, and
    every factored direction has R_d P_d = K_d to 1e-10."""
    kre, kim = KRONS[name]
    got = TS.factor_kron(kre, kim)
    want = JS._factor_kron(jnp.asarray(kre), jnp.asarray(kim))
    assert got == want
    K = kre.astype(np.float64) + 1j * kim
    kinds = [spec[0] for spec in got]
    for d, spec in enumerate(got):
        if spec[0] == "factored":
            P, R = _dense(spec[1], K.shape[2]), _dense(spec[2], len(spec[1]))
            np.testing.assert_allclose(R @ P, K[d], rtol=0, atol=1e-10)
        else:
            np.testing.assert_allclose(_dense(spec[1], K.shape[2]), np.where(
                np.abs(K[d]) > 1e-12, K[d], 0), rtol=0, atol=0)
    expected = {"wilson r=1": ["direct"] + ["factored"] * 8,
                "wilson r=0.5": ["direct"] * 9, "random": ["direct"] * 9,
                "staggered": ["direct"] * 9, "rank 1": ["factored"] * 9,
                "rank 3": ["factored"] * 9}
    expected["wilson r=1 f64"] = expected["twisted mass"] = expected["moebius"] = \
        expected["clover hop"] = expected["wilson r=1"]
    assert kinds == expected[name]


@pytest.mark.parametrize("name", ["wilson r=1", "twisted mass", "wilson r=0.5", "random",
                                  "rank 1", "rank 3"])
def test_kernel_table_holds_the_plan(name):
    """The tiled kernel's table reproduces each K_d: the dense form from
    K_d (direct) or R_d P_d (factored, rank <= 2), the sparse form from
    its terms; the Wilson family's plans take the sparse form."""
    kre, kim = KRONS[name]
    K = kre.astype(np.float64) + 1j * kim
    specs = TS.factor_kron(kre, kim)
    rec, sparse = TS.kernel_plan(specs, K, torch.float64)
    assert rec.itemsize == TS.PLAN_DIR_BYTES[torch.float64]
    assert TS.kernel_plan(specs, K, torch.float32)[0].itemsize == \
        TS.PLAN_DIR_BYTES[torch.float32]
    assert sparse == (name in ("wilson r=1", "twisted mass"))
    for d, r in enumerate(rec):
        k = r["k"][0] + 1j * r["k"][1]
        if r["mode"] == 0:
            np.testing.assert_allclose(k, K[d], rtol=0, atol=1e-12)
            assert specs[d][0] == "direct" or len(specs[d][1]) == 3
        else:
            rank = r["rank"]
            assert rank == len(specs[d][1]) <= 2
            rr = r["r"][0] + 1j * r["r"][1]
            np.testing.assert_allclose(rr[:, :rank] @ k[:rank], K[d], rtol=0, atol=1e-10)
        if sparse:
            t = r["t"][0] + 1j * r["t"][1]
            slots = [(int(r["slots"]) >> (4 * i)) & 15 for i in range(4)]
            rows = np.zeros((4, 4), complex)
            per = 2 if r["mode"] else 1
            for i in range(4):
                rows[i // per, slots[i]] += t[i]
            if r["mode"] == 0:
                np.testing.assert_allclose(rows, K[d], rtol=0, atol=1e-12)
            else:
                q = r["q"][0] + 1j * r["q"][1]
                R = np.zeros((4, 2), complex)
                for a in range(4):
                    R[a, (int(r["rslots"]) >> (4 * a)) & 15] = q[a]
                np.testing.assert_allclose(R @ rows[:2], K[d], rtol=0, atol=1e-10)


def _wilson_kron(dtype):
    kre, kim = KRONS["wilson r=1"]
    return kre.astype(dtype), kim.astype(dtype)


@pytest.mark.parametrize("parity", [None, 0, 1])
def test_planned_matvec_matches_pallas_kernel(parity):
    """The plain factored arithmetic (P, colour, R) against the TPU kernel
    run in interpret mode with the concrete Wilson factors (it folds
    them with ``_factor_kron``), f32, relative 1e-5, on a full lattice and
    both packed parities."""
    lat, n = (2, 2, 8, 128), 2
    offsets = WILSON_OFFSETS if parity is None else WILSON_OFFSETS[1:]
    nd = len(offsets)
    kre, kim = _wilson_kron(np.float32)
    kre, kim = kre[9 - nd:], kim[9 - nd:]
    blocks = crand_np((nd, 9) + lat, 3, np.float32)
    x = crand_np((n, 12) + lat, 4, np.float32)
    jb, tb = both(blocks)
    jx, tx = both(x)
    jk = jcplx.CArray(jnp.asarray(kre), jnp.asarray(kim))
    got = TS.stencil_matvec_soa_planned(tb, TS.factor_kron(kre, kim), tx, offsets, 3, 3,
                                        packed_parity=parity)
    want = JS.stencil_matvec_soa(jb, jk, jx, offsets, 3, 3, interpret=True,
                                 packed_parity=parity)
    scale = max(np.abs(to_np(w)).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["wilson r=1", "twisted mass", "wilson r=0.5", "rank 1"])
@pytest.mark.parametrize("parity", [None, 0, 1])
def test_planned_matvec_matches_pallas_body_f64(name, parity):
    """The plain factored arithmetic against the TPU kernel's own
    ``_matvec_body`` run on float64 numpy operands with the same plan,
    relative 1e-12, and against the port's plain version (the function
    it computes), on a full lattice and both packed parities."""
    lat, n = (4, 3, 2, 5), 3
    offsets = WILSON_OFFSETS if parity is None else WILSON_OFFSETS[1:]
    nd = len(offsets)
    kre, kim = KRONS[name]
    kre, kim = kre[9 - nd:].astype(np.float64), kim[9 - nd:].astype(np.float64)
    specs = TS.factor_kron(kre, kim)
    blocks = crand_np((nd, 9) + lat, 5)
    x = crand_np((n, 12) + lat, 6)
    tb = CArray(*(torch.from_numpy(p) for p in blocks))
    tx = CArray(*(torch.from_numpy(p) for p in x))
    got = TS.stencil_matvec_soa_planned(tb, specs, tx, offsets, 3, 3, packed_parity=parity)

    shifted = TS._shifter(tx, offsets, parity, 4, 3)
    out = [np.zeros((n, 12) + lat), np.zeros((n, 12) + lat)]

    def xs(d):
        v = shifted(d)
        return tuple(p.reshape((n, 12) + lat).numpy() for p in v)

    def store(sp, i, v):
        out[0][:, sp * 3 + i], out[1][:, sp * 3 + i] = v

    JS._matvec_body(xs, lambda d, i, j: (blocks[0][d, i * 3 + j], blocks[1][d, i * 3 + j]),
                    store, lambda: np.zeros((n,) + lat), kre, kim, ndir=nd, BI=3, BD=3,
                    KI=4, KD=4, kfact=JS._factor_kron(jnp.asarray(kre), jnp.asarray(kim)))
    plain = TS.stencil_matvec_soa_reference(tb, CArray(torch.from_numpy(kre),
                                                       torch.from_numpy(kim)), tx, offsets,
                                            3, 3, packed_parity=parity)
    scale = max(np.abs(w).max() for w in out)
    for g, w, p in zip(got, out, plain):
        np.testing.assert_allclose(to_np(g), w, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(to_np(p), w, rtol=0, atol=1e-12 * scale)


def test_plan_built_once_per_operator_across_a_cg_solve(monkeypatch):
    """Every apply of a CG solve asks for its kron's plan (as the kernel's
    wrapper does): the operator's and its adjoint's plans are built once
    each, not once an apply; the operator's kron is read to the host once
    and the adjoint's is derived from it."""
    op = TW.wilson_operator(LAT, mass=0.3, layout="soa", device="cpu")
    b = CArray(*(torch.from_numpy(p) for p in crand_np((2, 12) + LAT, 7, np.float32)))
    calls = []
    reference = TS.stencil_matvec_soa_reference

    def planned(blocks, kron, x, offsets, bi, bd, packed_parity=None):
        calls.append(TS.spin_plan(kron, torch.float32))
        return reference(blocks, kron, x, offsets, bi, bd, packed_parity=packed_parity)

    monkeypatch.setattr(bsr, "stencil_matvec_soa", planned)
    TS.clear_plans()
    builds, reads = TS.stencil_matvec_soa.plan_builds, TS.stencil_matvec_soa.kron_reads
    TW.cg_solve(op, b, n_iters=4)
    assert len(calls) == 1 + 2 * 4
    assert TS.stencil_matvec_soa.plan_builds == builds + 2
    assert TS.stencil_matvec_soa.kron_reads == reads + 1
    assert len({id(p) for p in calls}) == 2


def test_adjoint_built_every_call_reads_and_builds_once(monkeypatch):
    """A loop that builds the adjoint on every call, as
    ``apply_wilson_dagger`` and the multigrid fine level without a given
    adjoint do, builds at most one plan and reads the kron to the host at
    most once in all; the operator's own plan is one more."""
    tm = TW.twisted_mass_operator(LAT, mu=0.1, layout="soa", device="cpu")
    x = CArray(*(torch.from_numpy(p) for p in crand_np((2, 12) + LAT, 8, np.float32)))
    calls = []
    reference = TS.stencil_matvec_soa_reference

    def planned(blocks, kron, x, offsets, bi, bd, packed_parity=None):
        calls.append(TS.spin_plan(kron, torch.float32))
        return reference(blocks, kron, x, offsets, bi, bd, packed_parity=packed_parity)

    monkeypatch.setattr(bsr, "stencil_matvec_soa", planned)
    TS.clear_plans()
    builds, reads = TS.stencil_matvec_soa.plan_builds, TS.stencil_matvec_soa.kron_reads
    for _ in range(5):
        TW.apply_wilson_dagger(tm, x)
    assert TS.stencil_matvec_soa.plan_builds == builds + 1
    assert TS.stencil_matvec_soa.kron_reads == reads + 1
    assert len({id(p) for p in calls}) == 1
    TW.apply_wilson(tm, x)
    assert TS.stencil_matvec_soa.plan_builds == builds + 2
    assert TS.stencil_matvec_soa.kron_reads == reads + 1
    # the derived host value is the device value's bits
    adj = TW.adjoint_operator(tm)
    hre, him = TS.host_kron(adj.kron)
    assert np.array_equal(hre, adj.kron.re.numpy()) and np.array_equal(him, adj.kron.im.numpy())


def test_derived_operators_get_their_own_plans():
    """``twisted_mass_operator`` and ``hopping_packed_soa`` make new kron
    tensors through ``op.replace``: their plans are their own (the twist
    in the centre, the centre dropped), never the parent's, and their host
    values (derived, no read) are the device's bits; a copy of a kron
    shares its plan (plans are keyed by value); a kron written in place is
    planned again; a freed kron's host value leaves the cache."""
    op = TW.wilson_operator(LAT, layout="soa", device="cpu")
    tm = TW.twisted_mass_operator(LAT, mu=0.2, layout="soa", device="cpu")
    hop = TE.hopping_packed_soa(op, 0)
    p_op = TS.spin_plan(op.kron, torch.float32)
    p_tm, p_hop = TS.spin_plan(tm.kron, torch.float32), TS.spin_plan(hop.kron, torch.float32)
    assert p_tm is not p_op and p_hop is not p_op
    assert p_tm.specs[0] != p_op.specs[0] and p_tm.specs[1:] == p_op.specs[1:]
    assert p_hop.specs == p_op.specs[1:]
    for o in (tm, hop):
        hre, him = TS.host_kron(o.kron)
        assert np.array_equal(hre, o.kron.re.numpy()) and np.array_equal(him, o.kron.im.numpy())
    assert TS.spin_plan(op.kron, torch.float32) is p_op
    before = TS.stencil_matvec_soa.plan_builds
    k = CArray(op.kron.re.clone(), op.kron.im.clone())
    p = TS.spin_plan(k, torch.float32)
    assert p is p_op and TS.stencil_matvec_soa.plan_builds == before
    k.re[0] *= 2
    p2 = TS.spin_plan(k, torch.float32)
    assert p2 is not p and TS.stencil_matvec_soa.plan_builds == before + 1
    assert p2.specs[0][1][0][0][1] == 2 * p.specs[0][1][0][0][1]
    n = len(TS._HOST)
    del k
    assert len(TS._HOST) == n - 1


def test_x_chunk():
    """The Y rows a walk covers before X: a divisor of Y whose traffic
    fits L2_REUSE_BYTES (at least 1 row)."""
    site = 2 * (81 * 4 + 8 * 24 * 4)   # Wilson, 8 columns, f32
    yc = TS.x_chunk(32, 32, 64, site)
    assert 32 % yc == 0 and yc * 32 * 64 * site <= TS.L2_REUSE_BYTES
    assert (2 * yc) * 32 * 64 * site > TS.L2_REUSE_BYTES or 32 % (2 * yc)
    assert TS.x_chunk(7, 4, 8, site) == 7
    assert TS.x_chunk(5, 512, 512, site) == 1
