"""The clover even-odd cell on the CPU at a small lattice: correct with
nothing broken, not correct with the odd sites' reconstruction left out
or with A_oo^-1 replaced by the identity, not correct for the TF32
control; the packed route's frozen operations against the port's spin
plan; its traced run's per-layer metrics; the K1 rooflines on its
half-lattice work."""

import copy
import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

import control
import harness
from counts import k1_packed
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models.eo_packed import cb_pack_soa, cb_unpack_soa, hopping_packed_soa
from superbblas_tpu_torch.models.wilson import wilson_operator
from superbblas_tpu_torch.ops.stencil import spin_plan

CELL = "cls-d200.clover-eo.prop-12rhs"
SMALL = {"lattice": [4, 4, 4, 4]}
SEED = 2 ** 33 + 19


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of small torch ops: intra-op threads only wait for each
    other at this size."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def odd_sites_left_out(solve):
    """x_o = 0: the reconstruction of the odd sites left out."""
    def broken(b, **kw):
        x, rs, it = solve(b, **kw)
        x_e = cb_pack_soa(x, 0)
        zero = CArray(torch.zeros_like(x_e.re), torch.zeros_like(x_e.im))
        return cb_unpack_soa(x_e, zero), rs, it

    return broken


def identity_inverse(solve):
    """A_oo^-1 replaced by the identity in the action's operator."""
    act = solve.__self__
    inv = act.eo.site_o_inv
    eye = torch.eye(12, dtype=inv.blocks_re.dtype).reshape((1, 144) + (1,) * 4)
    re = eye.expand(inv.blocks_re.shape).contiguous()
    act.eo = dataclasses.replace(act.eo, site_o_inv=inv.replace(
        blocks=CArray(re, torch.zeros_like(re))))
    return solve


@pytest.mark.parametrize("fault", [None, odd_sites_left_out, identity_inverse],
                         ids=["nothing", "odd_sites_left_out", "identity_inverse"])
def test_one_card_fault(fault):
    part = harness.run_rank(CELL, SEED, 0.5, False, device="cpu", overrides=SMALL, fault=fault)
    out = harness.result(CELL, [part], time.time(), False, 1)
    assert out["correct"] is (fault is None), out["check"]
    assert set(out["metrics"]) == {"rhs_per_s", "peak_mem_gib", "setup_s"}


def test_control_is_not_correct():
    """The full reference in the port's place at TF32 fails the check."""
    got = control.readings(CELL, 2 ** 35 + 3, 1, device="cpu", overrides=SMALL)
    assert got["passed"] is False, got


def test_packed_operations_are_the_spin_plans():
    """2688 a site and column: the port's plan of the packed Wilson kron
    (8 hops of rank 2), counted as ``counts/k1.py`` counts 3072 for 9."""
    op = wilson_operator((4, 4, 4, 4), layout="soa", device="cpu")
    per_site = 0
    for spec in spin_plan(hopping_packed_soa(op, 0).kron, torch.float32).specs:
        assert spec[0] == "factored" and len(spec[1]) == 2
        nnz = sum(len(row) for row in spec[1])
        per_site += nnz * 3 + len(spec[1]) * 3 * 3 + sum(len(r) for r in spec[2]) * 3
    assert 8 * per_site == k1_packed.FLOPS_PER_SITE_COL == 2688
    assert k1_packed.k1_packed_flops(2 ** 20, 12) == 2688 * 2 ** 20 * 12


def test_traced_run_reads_the_cells_metrics():
    """A CPU traced run: the program's metrics read (the host reads an
    iteration CG's own), the device's give nothing (no device trace on the
    CPU) and never raise."""
    t_start = time.time()
    part = harness.run_rank(CELL, SEED + 1, 0.3, True, device="cpu", overrides=SMALL)
    line = harness.result(CELL, [part], t_start, True, 1)
    assert line["correct"] is True
    it = line["metrics"]["solver_iters"]["value"]
    assert it > 0
    # CG's one read an iteration and its first; preparing and reconstructing read nothing
    assert line["metrics"]["host_reads_per_iter"]["value"] == pytest.approx((it + 1) / it)
    assert line["metrics"]["k1_host_us"]["value"] > 0
    assert "apply_span_ms.schur" not in line["metrics"]       # no device time on the CPU
    work = part["trace"]["work"]
    V = 4 * 4 * 4 * 4 // 2
    assert work["k1.tiled"]["bytes"] == V * (2 * 8 * 9 * 4 + 12 * 2 * 12 * 4 * 2)
    assert work["k1.site16"]["flops"] == 1152 * V * 12


def test_rooflines_read_the_half_lattice_work():
    """``k1_roofline.tiled`` and ``k1_roofline.site16`` on the readers'
    hand-made profile with this cell's work in place of its own: the same
    launch times against the bounds of the V/2 sites of one parity (the
    site blocks' bytes half the full lattice's)."""
    hand = json.loads((Path(__file__).resolve().parent / "data" / "profile_hand.json")
                      .read_text())
    sites, nrhs = 32 * 32 * 32 * 64, 12
    t = copy.deepcopy(hand)
    eo_act, full_act = (harness.module("actions", a).Action for a in ("clover_eo", "clover"))
    t["work"] = eo_act.__new__(eo_act).work(sites, nrhs)        # work reads no state
    full = full_act.__new__(full_act).work(sites, nrhs)
    assert 2 * t["work"]["k1.site16"]["bytes"] == full["k1.site16"]["bytes"]
    device = harness.module("metrics", "_device")
    for route in ("tiled", "site16"):
        eo, own = t["work"][f"k1.{route}"], hand["work"][f"k1.{route}"]
        want = hand["expected"][f"k1_roofline.{route}"] * (
            device.bound_s(eo["bytes"], eo["flops"], hand["peaks"])
            / device.bound_s(own["bytes"], own["flops"], hand["peaks"]))
        got = harness.module("metrics", f"k1_roofline.{route}").read(t)
        assert got == pytest.approx(want)
