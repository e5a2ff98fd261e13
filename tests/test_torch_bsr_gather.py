"""superbblas_tpu_torch.bsr's ``create_bsr``/``create_kron_bsr`` and the
gather mode against superbblas_tpu.bsr on the same numpy inputs, at f64
(relative 1e-12), on the cases of tests/test_bsr.py: a uniform stencil, a
near-uniform pattern merged into a stencil (and kept as a gather plan
without the merge), duplicate offsets summed, a truly irregular operator,
kron operators (uniform and gather, cross-checked against the plain BSR of
the materialised kron blocks), the open-boundary Wilson-like operator
merged into the stencil path, a rectangular operator (domain lattice other
than the image's), operator powers and alpha/beta/y in gather mode.  Each
picks the JAX package's mode."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import collect_garbage, to_np  # noqa: F401  (fixture)
from superbblas_tpu import bsr as JB
from superbblas_tpu import cplx as JC
from superbblas_tpu_torch import bsr as TB
from superbblas_tpu_torch import cplx as TC

pytestmark = pytest.mark.usefixtures("collect_garbage")

RTOL = 1e-12


def close(got, want):
    """Port result against the JAX one (plain or split complex), relative
    to the largest reference entry."""
    gp = tuple(got) if TC.is_carray(got) else (got,)
    wp = tuple(want) if JC.is_carray(want) else (want,)
    assert len(gp) == len(wp)
    scale = max(float(np.abs(to_np(w)).max()) for w in wp)
    for g, w in zip(gp, wp):
        np.testing.assert_allclose(to_np(g), to_np(w), rtol=RTOL, atol=RTOL * scale)


def stencil_offsets(dim):
    """Self + one-hop neighbours along each axis (as tests/test_bsr.py)."""
    offs = [tuple(0 for _ in dim)]
    for ax, d in enumerate(dim):
        if d == 1:
            continue
        for sgn in (1, -1):
            off = [0] * len(dim)
            off[ax] = sgn
            offs.append(tuple(off))
            if d <= 2:
                break
    return offs


def uniform_case(rng):
    dim = (4, 4)
    offs = stencil_offsets(dim)
    nnz = len(offs)
    jj = np.zeros(dim + (nnz, 2), dtype=np.int64)
    for s in itertools.product(*[range(d) for d in dim]):
        for k, off in enumerate(offs):
            jj[s][k] = [(s[0] + off[0]) % dim[0], (s[1] + off[1]) % dim[1]]
    ii = np.full(dim, nnz)
    vals = rng.standard_normal(dim + (nnz, 2, 2))
    return dict(args=("XYs", (4, 4, 2), "XYc", (4, 4, 2), (1, 1, 2), (1, 1, 2), ii, jj, vals),
                mode="stencil", x=rng.standard_normal(dim + (2, 3)), ox="XYcn")


def near_uniform_case(rng, merge=True):
    ii = np.array([2, 1, 2, 1])
    jj = np.zeros((4, 2, 1), dtype=np.int64)
    jj[0, :, 0] = [0, 1]
    jj[1, :, 0] = [1, 0]      # the second entry padded (ii = 1)
    jj[2, :, 0] = [2, 3]
    jj[3, :, 0] = [3, 0]
    vals = rng.standard_normal((4, 2, 2, 2))
    return dict(args=("Xs", (4, 2), "Xc", (4, 2), (1, 2), (1, 2), ii, jj, vals),
                kw=dict(pattern_merge=merge), mode="stencil" if merge else "gather",
                x=rng.standard_normal((4, 2, 3)), ox="Xcn")


def duplicates_case(rng):
    ii = np.array([2, 1, 1])
    jj = np.zeros((3, 2, 1), dtype=np.int64)
    jj[0, :, 0] = [1, 1]      # one neighbour twice
    jj[1, 0, 0] = 2
    jj[2, 0, 0] = 0
    vals = rng.standard_normal((3, 2, 2, 2))
    return dict(args=("Xs", (3, 2), "Xc", (3, 2), (1, 2), (1, 2), ii, jj, vals),
                mode="stencil", x=rng.standard_normal((3, 2, 2)), ox="Xcn")


def irregular_case(rng, complex_values=False):
    ii = np.full(8, 2)
    jj = np.zeros((8, 2, 1), dtype=np.int64)
    for s in range(8):
        jj[s, 0, 0] = s
        jj[s, 1, 0] = (s * 3 + 1) % 8     # offsets vary a row: a large union
    vals = rng.standard_normal((8, 2, 2, 3))
    x = rng.standard_normal((8, 3, 2))
    if complex_values:
        vals = vals + 1j * rng.standard_normal(vals.shape)
        x = x + 1j * rng.standard_normal(x.shape)
    return dict(args=("Xs", (8, 2), "Xc", (8, 3), (1, 2), (1, 3), ii, jj, vals),
                mode="gather", x=x, ox="Xcn")


def open_boundary_case(rng):
    """Wilson-like, open in axis 1: the boundary rows lose an offset, the
    union stays the full stencil (tests/test_bsr.py:456)."""
    dim = (4, 6)
    full = [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)]
    ii = np.zeros(dim, dtype=np.int64)
    jj = np.zeros(dim + (len(full), 2), dtype=np.int64)
    vals = np.zeros(dim + (len(full), 2, 2))
    for s in itertools.product(range(dim[0]), range(dim[1])):
        k = 0
        for off in full:
            t = (s[0] + off[0], s[1] + off[1])
            if not 0 <= t[1] < dim[1]:
                continue
            jj[s][k] = [t[0] % dim[0], t[1]]
            vals[s][k] = rng.standard_normal((2, 2))
            k += 1
        ii[s] = k
    return dict(args=("XYs", dim + (2,), "XYc", dim + (2,), (1, 1, 2), (1, 1, 2), ii, jj,
                      vals), mode="stencil", x=rng.standard_normal(dim + (2, 3)), ox="XYcn")


def rectangular_case(rng):
    """Image lattice 3x2, domain lattice 5x4, 1-3 nonzeros a row at random
    domain sites (no stencil: the lattices differ)."""
    dim_i, dim_d, nnz = (3, 2), (5, 4), 3
    ii = rng.integers(1, nnz + 1, size=dim_i)
    jj = np.stack([rng.integers(0, dim_d[0], size=dim_i + (nnz,)),
                   rng.integers(0, dim_d[1], size=dim_i + (nnz,))], axis=-1)
    vals = rng.standard_normal(dim_i + (nnz, 2, 3))
    return dict(args=("XYs", dim_i + (2,), "XYc", dim_d + (3,), (1, 1, 2), (1, 1, 3), ii, jj,
                      vals), mode="gather", x=rng.standard_normal(dim_d + (3, 2)), ox="XYcn")


CASES = {
    "uniform": uniform_case,
    "near_uniform_merged": near_uniform_case,
    "near_uniform_no_merge": lambda rng: near_uniform_case(rng, merge=False),
    "duplicates_summed": duplicates_case,
    "truly_irregular": irregular_case,
    "truly_irregular_complex": lambda rng: irregular_case(rng, complex_values=True),
    "open_boundary_wilson": open_boundary_case,
    "rectangular": rectangular_case,
}


def values_for(vals, jax_side):
    if not np.iscomplexobj(vals):
        return jnp.asarray(vals) if jax_side else vals
    return JC.from_complex(vals) if jax_side else TC.from_complex(vals)


@pytest.mark.parametrize("name", sorted(CASES))
def test_create_bsr_mode_and_apply_match_jax(name):
    case = CASES[name](np.random.default_rng(sorted(CASES).index(name)))
    *head, vals = case["args"]
    kw = case.get("kw", {})
    jop = JB.create_bsr(*head, values_for(vals, True), **kw)
    top = TB.create_bsr(*head, values_for(vals, False), **kw, device="cpu")
    assert jop.mode == case["mode"] and top.mode == case["mode"], (jop.mode, top.mode)
    assert top.offsets == jop.offsets and top.dim_i == jop.dim_i and top.dim_d == jop.dim_d
    close(top.blocks, jop.blocks)
    if top.mode == "gather":
        np.testing.assert_array_equal(top.jj_flat.numpy(), np.asarray(jop.jj_flat))
        np.testing.assert_array_equal(top.row_counts.numpy(), np.asarray(jop.row_counts))
        assert top.jj_flat.dtype == torch.int64 and top.row_counts.dtype == torch.int32
    x = case["x"]
    jx = JC.from_complex(x) if np.iscomplexobj(x) else jnp.asarray(x)
    tx = TC.from_complex(x) if np.iscomplexobj(x) else torch.from_numpy(x)
    close(TB.bsr_krylov(1.0, top, tx, case["ox"]), JB.bsr_krylov(1.0, jop, jx, case["ox"]))
    # a complex tensor in gives a complex tensor out, as in the JAX package
    if np.iscomplexobj(x):
        got = TB.bsr_krylov(1.0, top, torch.from_numpy(x), case["ox"])
        want = JB.bsr_krylov(1.0, jop, jnp.asarray(x), case["ox"])
        assert got.is_complex()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(want)).max())


def kron_case(uniform, complex_values, rng):
    """create_kron_bsr on a 1-D lattice of 5 sites, 2x2 spin and 3x3 colour
    blocks: uniform (periodic, 3 slots) or open boundary (gather)."""
    n, KI, CI, nnz = 5, 2, 3, 3
    ii = np.full(n, nnz) if uniform else np.array([2, 3, 3, 3, 2])
    jj = np.zeros((n, nnz, 1), dtype=np.int64)
    for s in range(n):
        nbrs = [s, (s - 1) % n, (s + 1) % n] if uniform else \
            [s] + [t for t in (s - 1, s + 1) if 0 <= t < n]
        jj[s, :len(nbrs), 0] = nbrs
        jj[s, len(nbrs):, 0] = s
    color = rng.standard_normal((n, nnz, CI, CI))
    spin = rng.standard_normal((nnz, KI, KI))
    x = rng.standard_normal((n, KI, CI, 4))
    if complex_values:
        color = color + 1j * rng.standard_normal(color.shape)
        spin = spin + 1j * rng.standard_normal(spin.shape)
        x = x + 1j * rng.standard_normal(x.shape)
    args = ("XSc", (n, KI, CI), "XSc", (n, KI, CI), (1, 1, CI), (1, 1, CI), (1, KI, 1),
            (1, KI, 1), ii, jj)
    return args, color, spin, x


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "gather"])
@pytest.mark.parametrize("complex_values", [False, True], ids=["real", "complex"])
def test_create_kron_bsr_matches_jax_and_materialised(uniform, complex_values):
    """The kron operator against the JAX package's, and against the plain
    (gather) BSR of the materialised blocks kron(spin[k], colour[s, k])."""
    rng = np.random.default_rng(40 + 2 * uniform + complex_values)
    args, color, spin, x = kron_case(uniform, complex_values, rng)
    jop = JB.create_kron_bsr(*args, values_for(color, True), values_for(spin, True))
    top = TB.create_kron_bsr(*args, values_for(color, False), values_for(spin, False),
                             device="cpu")
    mode = "stencil" if uniform else "gather"
    assert jop.mode == mode and top.mode == mode and top.kron is not None
    assert (top.kron_i, top.kron_d, top.ki, top.kd) == (jop.kron_i, jop.kron_d, jop.ki, jop.kd)
    jx = JC.from_complex(x) if complex_values else jnp.asarray(x)
    tx = TC.from_complex(x) if complex_values else torch.from_numpy(x)
    got = TB.bsr_krylov(1.0, top, tx, "XScn")
    close(got, JB.bsr_krylov(1.0, jop, jx, "XScn"))

    ii, jj = args[-2:]
    n, nnz, KI, CI = color.shape[0], color.shape[1], spin.shape[1], color.shape[2]
    mats = np.einsum("kab,skcd->skacbd", spin, color).reshape((n, nnz, KI * CI, KI * CI))
    plain = TB.create_bsr("Xz", (n, KI * CI), "Xz", (n, KI * CI), (1, KI * CI),
                          (1, KI * CI), ii, jj, values_for(mats, False),
                          pattern_merge=False, device="cpu")
    assert plain.mode == mode
    xf = x.reshape((n, KI * CI, 4))
    want = TB.bsr_krylov(1.0, plain, TC.from_complex(xf) if complex_values
                         else torch.from_numpy(xf), "Xzn")
    wp = tuple(want) if TC.is_carray(want) else (want,)
    gp = tuple(got) if TC.is_carray(got) else (got,)
    for g, w in zip(gp, wp):
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), w.numpy(), rtol=RTOL,
                                   atol=RTOL * float(w.abs().max()))
    assert top.flops_per_matvec(4, complex_values) == jop.flops_per_matvec(4, complex_values)
    assert top.memops_per_matvec(4, 8) == jop.memops_per_matvec(4, 8)


@pytest.mark.parametrize("block_image_fast", [False, True])
def test_create_kron_bsr_block_image_fast(block_image_fast):
    """``block_image_fast``: the blocks (and spin factors) given transposed,
    [..., BD, BI], on the gather path."""
    rng = np.random.default_rng(50)
    args, color, spin, x = kron_case(False, True, rng)
    if block_image_fast:
        color, spin = color.swapaxes(-1, -2).copy(), spin.swapaxes(-1, -2).copy()
    jop = JB.create_kron_bsr(*args, JC.from_complex(color), JC.from_complex(spin),
                             block_image_fast=block_image_fast)
    top = TB.create_kron_bsr(*args, TC.from_complex(color), TC.from_complex(spin),
                             block_image_fast=block_image_fast, device="cpu")
    close(top.blocks, jop.blocks)
    close(top.kron, jop.kron)
    close(TB.bsr_krylov(1.0, top, TC.from_complex(x), "XScn"),
          JB.bsr_krylov(1.0, jop, JC.from_complex(x), "XScn"))


@pytest.mark.parametrize("what", ["powers", "alpha_beta_y", "label_orders"])
def test_gather_krylov_options_match_jax(what):
    """bsr_krylov in gather mode: operator powers (okr), alpha/beta/y and
    other label orders, against the JAX package."""
    rng = np.random.default_rng(60)
    ii = np.full(8, 3)
    jj = np.stack([np.arange(8), (np.arange(8) * 3 + 1) % 8, (np.arange(8) * 5 + 2) % 8],
                  axis=1)[..., None]
    vals = rng.standard_normal((8, 3, 2, 2)) + 1j * rng.standard_normal((8, 3, 2, 2))
    args = ("Xs", (8, 2), "Xs", (8, 2), (1, 2), (1, 2), ii, jj)
    jop = JB.create_bsr(*args, JC.from_complex(vals))
    top = TB.create_bsr(*args, TC.from_complex(vals), device="cpu")
    assert jop.mode == top.mode == "gather"
    x = rng.standard_normal((8, 2, 3)) + 1j * rng.standard_normal((8, 2, 3))
    jx, tx = JC.from_complex(x), TC.from_complex(x)
    if what == "powers":
        close(TB.bsr_krylov(1.0, top, tx, "Xsn", oy="pXsn", okr="p", power=3),
              JB.bsr_krylov(1.0, jop, jx, "Xsn", oy="pXsn", okr="p", power=3))
    elif what == "alpha_beta_y":
        y = rng.standard_normal((8, 2, 3)) + 1j * rng.standard_normal((8, 2, 3))
        close(TB.bsr_krylov(0.5 - 1j, top, tx, "Xsn", beta=2.0, y=TC.from_complex(y)),
              JB.bsr_krylov(0.5 - 1j, jop, jx, "Xsn", beta=2.0, y=JC.from_complex(y)))
    else:
        xp = x.transpose(2, 0, 1).copy()
        close(TB.bsr_krylov(1.0, top, TC.from_complex(xp), "nXs", oy="snX"),
              JB.bsr_krylov(1.0, jop, JC.from_complex(xp), "nXs", oy="snX"))


def test_gather_apply_runs_one_batched_product(monkeypatch):
    """A gather apply is one batched product [voli, BI, nnz*BD] @ [voli,
    nnz*BD, N] a Gauss part (3 for complex operands), through
    ``batched_small_gemm``; the kron gather's colour stage is one
    [voli*nnz, BI, BD] @ [voli*nnz, BD, KD*N] product a part."""
    calls = []
    inner = TB.batched_small_gemm

    def counting(b, x):
        calls.append((tuple(b.shape), tuple(x.shape)))
        return inner(b, x)

    monkeypatch.setattr(TB, "batched_small_gemm", counting)
    rng = np.random.default_rng(70)
    case = irregular_case(rng, complex_values=True)
    *head, vals = case["args"]
    op = TB.create_bsr(*head, TC.from_complex(vals), device="cpu")
    TB.bsr_krylov(1.0, op, TC.from_complex(case["x"]), "Xcn")
    assert calls == [((8, 2, 6), (8, 6, 2))] * 3
    calls.clear()
    args, color, spin, x = kron_case(False, True, rng)
    op = TB.create_kron_bsr(*args, TC.from_complex(color), TC.from_complex(spin),
                            device="cpu")
    TB.bsr_krylov(1.0, op, TC.from_complex(x), "XScn")
    assert calls == [((15, 3, 3), (15, 3, 8))] * 3


def test_gather_layouts_and_operator_buffers():
    """bsr_get_preferred_layout and bsr_allowed_layouts in gather mode, as
    the JAX package's; jj_flat and row_counts are buffers (``.to`` moves
    them) and ``replace`` keeps them."""
    rng = np.random.default_rng(80)
    case = rectangular_case(rng)
    *head, vals = case["args"]
    jop = JB.create_bsr(*head, jnp.asarray(vals))
    top = TB.create_bsr(*head, vals, device="cpu")
    assert TB.bsr_get_preferred_layout(top) == JB.bsr_get_preferred_layout(jop)
    assert TB.bsr_allowed_layouts(top) == JB.bsr_allowed_layouts(jop)
    names = dict(top.named_buffers())
    assert names["jj_flat"] is top.jj_flat and names["row_counts"] is top.row_counts
    twin = top.replace(blocks=2 * top.blocks)
    assert twin.mode == "gather" and torch.equal(twin.jj_flat, top.jj_flat)
    assert twin.dim_i == top.dim_i and twin.dim_d == top.dim_d != twin.dim_i
    x = torch.from_numpy(case["x"])
    y2 = TB.bsr_krylov(1.0, twin, x, case["ox"])
    y1 = TB.bsr_krylov(1.0, top, x, case["ox"])
    np.testing.assert_allclose(y2.numpy(), 2 * y1.numpy(), rtol=RTOL)
    with pytest.raises(ValueError, match="square"):
        TB.bsr_krylov(1.0, top, x, case["ox"], oy="XYsnp", okr="p", power=2)


@pytest.mark.parametrize("complex_values", [False, True], ids=["real", "complex"])
def test_gather_blocks_are_stored_in_the_product_layout(complex_values):
    """A gather operator without spin factors stores its blocks once in the
    gather product's layout [voli, BI, nnz*BD], which the apply takes as
    they are; ``blocks`` views them back as the reference's [*lat_i, nnz,
    BI, BD] (the JAX package's blocks) without a copy, and ``replace``,
    ``bsr_cast_storage`` and ``create_kron_bsr`` start from that view.  A
    kron gather operator keeps the reference's layout, its colour stage's."""
    rng = np.random.default_rng(90)
    case = irregular_case(rng, complex_values=complex_values)
    *head, vals = case["args"]
    jop = JB.create_bsr(*head, values_for(vals, True))
    top = TB.create_bsr(*head, values_for(vals, False), device="cpu")
    parts = [top.blocks_re] + ([top.blocks_im] if complex_values else [])
    assert all(p.shape == (8, 2, 2 * 3) and p.is_contiguous() for p in parts)
    blocks = top.blocks
    view = blocks.re if complex_values else blocks
    assert view.shape == (8, 2, 2, 3) and view.data_ptr() == top.blocks_re.data_ptr()
    close(blocks, jop.blocks)
    again = top.replace(blocks=top.blocks)
    assert all(torch.equal(a, b) for a, b in zip(
        (again.blocks_re, again.blocks_im), (top.blocks_re, top.blocks_im)) if a is not None)
    cast = TB.bsr_cast_storage(top, torch.float32)
    assert cast.blocks_re.shape == top.blocks_re.shape and cast.blocks_re.is_contiguous()
    x = case["x"]
    tx = TC.from_complex(x) if np.iscomplexobj(x) else torch.from_numpy(x)
    jx = JC.from_complex(x) if np.iscomplexobj(x) else jnp.asarray(x)
    close(TB.bsr_krylov(1.0, again, tx, case["ox"]), JB.bsr_krylov(1.0, jop, jx, case["ox"]))
    args, color, spin, _ = kron_case(False, complex_values, rng)
    kop = TB.create_kron_bsr(*args, values_for(color, False), values_for(spin, False),
                             device="cpu")
    assert kop.mode == "gather" and kop.blocks_re.shape == (5, 3, 3, 3)
    assert kop.blocks_re.is_contiguous()
