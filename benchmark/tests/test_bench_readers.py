"""Each per-layer metric's reader on small profiles: a hand-made one
whose numbers are worked out by hand, one recorded on the card (where
present), and profiles in which its source is missing (the reader
returns None, never 0)."""

import copy
import json
from pathlib import Path

import pytest

import harness
import profiling

DATA = Path(__file__).resolve().parent / "data"
BENCH = harness.benchmark_json()
NAMES = [m["name"] for m in BENCH["per_layer"]]
HAND = json.loads((DATA / "profile_hand.json").read_text())


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_hand_made_profile(name):
    want = HAND["expected"].get(name)
    got = harness.module("metrics", name).read(HAND)
    assert got == pytest.approx(want) if want is not None else got is None


def _empty():
    t = copy.deepcopy(HAND)
    t["ranks"][0]["device"] = []
    t["spans"], t["solver_iters"], t["launches"] = {}, [], {}
    return t


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_its_source_says_so(name):
    got = harness.module("metrics", name).read(_empty())
    if name == "device_idle_share":
        assert got == pytest.approx(100.0)       # an idle window is a reading
    else:
        assert got is None


def test_site16_reader_refuses_a_mixed_route():
    t = copy.deepcopy(HAND)
    t["launches"]["k1.site"] = 1
    assert harness.module("metrics", "k1_roofline.site16").read(t) is None


def test_union_and_breakdown():
    r = HAND["ranks"][0]
    assert profiling.busy_us(r["device"], r["window"]) == pytest.approx(520.0)
    host = [(0.0, 90.0, "aten::item"), (200.0, 260.0, "aten::mul"),
            (520.0, 700.0, "cudaLaunchKernel")]
    b = profiling.breakdown(r["device"], host, r["window"])
    assert b["device_ops"][0][0].startswith("void stencil_tiled_kernel")
    assert b["device_ops"][0][1] == pytest.approx(220e-6)
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(100e-6)
    assert gaps["aten::mul"] == pytest.approx(50e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(130e-6)


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_recorded_card_profile(name):
    path = DATA / "profile_card.json"
    if not path.exists():
        pytest.skip("no recorded card profile")
    t = json.loads(path.read_text())
    got = harness.module("metrics", name).read(t)
    if name in t["expected_present"]:
        assert got is not None and got > 0
        if name.endswith("_share") or "roofline" in name:
            assert got <= 100.0
    else:
        assert got is None


def test_kernel_names_of_the_port():
    names = profiling.kernel_names(harness.REPO / "superbblas_tpu_torch" / "csrc")
    assert names["stencil_tiled.cu"] == ["stencil_tiled_kernel"]
    assert names["stencil_site.cu"] == ["stencil_site_kernel"]
    assert profiling.is_named("void stencil_site_kernel<float>(x)", names["stencil_site.cu"])
    assert not profiling.is_named("void stencil_site_kernel2(x)", names["stencil_site.cu"])


@pytest.mark.parametrize("name, on_device, activity, kind", [
    ("nccl:all_to_all", True, "", "annotation"),            # NCCL's range beside its kernel
    ("nccl:all_to_all", True, "gpu_user_annotation", "annotation"),
    ("bench.window", True, "", "annotation"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", True, "", "kernel"),
    ("void (anonymous namespace)::stencil_tiled_kernel<4, 4, 3, 3, true, float, float>(float "
     "const*)", True, "", "kernel"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", True, "kernel", "kernel"),
    ("Memcpy DtoD (Device -> Device)", True, "", "memcpy"),
    ("Memset (Device)", True, "", "memset"),
    ("aten::mul", False, "cpu_op", "host"),
])
def test_device_activity_kinds(name, on_device, activity, kind):
    assert profiling.kind_of(name, on_device, activity) == kind


@pytest.mark.parametrize("times, want", [([0.3], 0.3), ([0.2, 0.3], 0.29),
                                         ([0.1 * k for k in range(1, 11)], 0.91)])
def test_solve_tail_reader(times, want):
    got = harness.module("end_to_end", "solve_s_p90").read({"solve_s": times})
    assert got == pytest.approx(want)
