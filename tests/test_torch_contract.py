"""superbblas_tpu_torch.ops.contract against superbblas_tpu.ops.contract:
the seeded case space of test_contract_sweep.py run single-device with
complex operands as CArrays, precisions, the bf16 Gauss case, the output
permute and the error cases.  Contractions sum in another order in the
two packages: 1e-12 at f64, 1e-5 at f32, one bf16 ulp (2^-8 of max|out|)
at bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, both, crand_np, to_np
from superbblas_tpu import local_contraction as j_contract
from superbblas_tpu_torch import ContractionPlan
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch import local_contraction as t_contract
from superbblas_tpu_torch.ops import contract as TK
from test_contract_sweep import _case_space

#: one bf16 ulp relative to max|out|
BF16_TOL = 2.0 ** -8

N_CASES = 60
CASES = _case_space(N_CASES)


def case_operands(idx, case, dtype=np.float64):
    """The operands of case ``idx``: complex normal x0, x1, r with the
    case's label extents (the ``dist`` field is ignored: one device)."""
    sizes = case["sizes"]
    shapes = {o: tuple(sizes[c] for c in case[o]) for o in ("o0", "o1", "o_r")}
    return [crand_np(shapes[o], 10_000 + 3 * idx + k, dtype)
            for k, o in enumerate(("o0", "o1", "o_r"))]


def run_both(case, ops, jdtype=None, tdtype=None):
    (j0, t0), (j1, t1), (jr, tr) = (both(p, jdtype, tdtype) for p in ops)
    use_r = case["beta"] != 0.0
    args = lambda x0, x1, r: (case["alpha"], x0, case["o0"], case["conj0"],  # noqa: E731
                              x1, case["o1"], case["conj1"],
                              case["beta"] if use_r else 0.0,
                              r if use_r else None, case["o_r"])
    return t_contract(*args(t0, t1, tr)), j_contract(*args(j0, j1, jr))


@pytest.mark.parametrize("idx", range(N_CASES))
def test_sweep_matches_jax(idx):
    i, case = CASES[idx]
    got, want = run_both(case, case_operands(i, case))
    assert isinstance(got, TC.CArray) and got.re.dtype == torch.float64
    assert_parity(got, want, np.float64)


@pytest.mark.parametrize("idx", [0, 7, 23])
def test_sweep_f32_matches_jax(idx):
    i, case = CASES[idx]
    got, want = run_both(case, case_operands(i, case, np.float32))
    assert got.re.dtype == torch.float32
    assert_parity(got, want, np.float32)


def test_bf16_gauss_sums_in_f32():
    """bf16 split-complex operands chosen so that the Gauss products are
    far larger than the result: half the terms are A(1-i)*B, half
    A(1+i)*iB, which cancel, plus small noise.  k1 = sum a.re(b.re+b.im)
    is then 64 while |out| is about 1.  JAX forms k1 - k2 and k1 + k3 from
    f32 products and rounds once; so does the port, within one bf16 ulp of
    max|out|.  Rounding k1, k2, k3 to bf16 first (the products in the
    operand type) misses by far more: the test would catch it."""
    rng = np.random.default_rng(5)
    K, M, N = 64, 4, 3
    sign = np.where(np.arange(K) % 2 == 0, 1.0, -1.0)[:, None]
    a_re = 1.0 + 0.05 * rng.standard_normal((K, M))
    a_im = -sign + 0.05 * rng.standard_normal((K, M))
    b_re = (sign > 0) + 0.05 * rng.standard_normal((K, N))
    b_im = (sign < 0) + 0.05 * rng.standard_normal((K, N))
    parts = [(np.float32(a_re), np.float32(a_im)), (np.float32(b_re), np.float32(b_im))]
    (j0, t0), (j1, t1) = (both(p, jnp.bfloat16, torch.bfloat16) for p in parts)
    got = t_contract(1.0, t0, "km", False, t1, "kn", False, 0.0, None, "mn")
    want = j_contract(1.0, j0, "km", False, j1, "kn", False, 0.0, None, "mn")
    assert got.re.dtype == torch.bfloat16 and want.re.dtype == jnp.bfloat16
    scale = max(np.abs(to_np(w)).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), rtol=0, atol=BF16_TOL * scale)

    def dg_bf16(x, y):   # products rounded to bf16 before the Gauss sums
        return torch.einsum("km,kn->mn", x, y)
    naive = TC.cbilinear(dg_bf16, t0, t1)
    k1 = torch.einsum("km,kn->mn", t0.re.float(), (t1.re + t1.im).float())
    assert float(k1.abs().max()) > 30 * scale
    assert max(np.abs(to_np(n) - to_np(w)).max() for n, w in zip(naive, want)) \
        > 4 * BF16_TOL * scale


def test_bf16_real_batched_matches_jax():
    """The dense-engine shape of the chip run, cut to size: T=2, A=B=C=64,
    bf16, products summed in f32 and rounded once."""
    ja, ta = both(crand_np((2, 64, 64), 6, np.float32), jnp.bfloat16, torch.bfloat16)
    jb, tb = both(crand_np((2, 64, 64), 7, np.float32), jnp.bfloat16, torch.bfloat16)
    got = t_contract(1.0, ta.re, "tab", False, tb.re, "tac", False, 0.0, None, "tbc")
    want = j_contract(1.0, ja.re, "tab", False, jb.re, "tac", False, 0.0, None, "tbc")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 64, 64)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0,
                               atol=BF16_TOL * np.abs(to_np(want)).max())


@pytest.mark.parametrize("case", ["gram", "rotation"])
def test_krylov_gram_and_rotation_match_jax(case):
    """The Krylov-basis calls of the chip run at a small size: the Gram
    matrix V^H V and the rotation V C, split complex f64; the rotation's
    result is permuted to "mSxyzt" by local_permute."""
    jv, tv = both(crand_np((4, 3, 2, 2, 2, 4), 8))
    if case == "gram":
        got = t_contract(1.0, tv, "kSxyzt", True, tv, "lSxyzt", False, 0.0, None, "kl")
        want = j_contract(1.0, jv, "kSxyzt", True, jv, "lSxyzt", False, 0.0, None, "kl")
    else:
        jc, tc = both(crand_np((4, 5), 9))
        got = t_contract(1.0, tv, "kSxyzt", False, tc, "km", False, 0.0, None, "mSxyzt")
        want = j_contract(1.0, jv, "kSxyzt", False, jc, "km", False, 0.0, None, "mSxyzt")
    assert_parity(got, want, np.float64)


def test_output_permute_through_eligible_4d_transpose():
    """A result whose raw order "xyzt" goes to "tzyx": the 4-D permute the
    kernel takes on the card (the plain version here)."""
    jx, tx = both(crand_np((3, 4, 5, 6, 2), 10))
    jw, tw = both(crand_np((2,), 11))
    got = t_contract(2.0, tx, "xyzta", False, tw, "a", True, 0.0, None, "tzyx")
    want = j_contract(2.0, jx, "xyzta", False, jw, "a", True, 0.0, None, "tzyx")
    assert got.re.is_contiguous()
    assert_parity(got, want, np.float64)


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (0.5 - 2j, -1.5 + 0.5j)])
def test_alpha_beta_and_r(alpha, beta):
    (j0, t0), (j1, t1), (jr, tr) = (both(crand_np(s, 12 + k)) for k, s in
                                    enumerate(((3, 4), (4, 5), (3, 5))))
    got = t_contract(alpha, t0, "ab", False, t1, "bc", True, beta, tr, "ac")
    want = j_contract(alpha, j0, "ab", False, j1, "bc", True, beta, jr, "ac")
    assert_parity(got, want, np.float64)


def test_r_none_takes_dimr_and_dtype():
    (j0, t0), (j1, t1) = (both(crand_np(s, 20 + k)) for k, s in
                          enumerate(((3, 4), (4, 5))))
    got = t_contract(1.0, t0, "ab", False, t1, "bc", False, 0.0, None, "ca",
                     dimr=(5, 3), dtype=torch.float32)
    want = j_contract(1.0, j0, "ab", False, j1, "bc", False, 0.0, None, "ca",
                      dimr=(5, 3), dtype=jnp.float32)
    assert got.re.dtype == torch.float32 and tuple(got.shape) == (5, 3)
    assert_parity(got, want, np.float32)


def test_plain_real_tensors_match_jax():
    x0 = np.random.default_rng(30).standard_normal((3, 4, 2))
    x1 = np.random.default_rng(31).standard_normal((4, 5, 2))
    got = t_contract(-1.0, torch.from_numpy(x0), "abt", False, torch.from_numpy(x1),
                     "bct", False, 0.0, None, "tca")
    want = j_contract(-1.0, jnp.asarray(x0), "abt", False, jnp.asarray(x1), "bct",
                      False, 0.0, None, "tca")
    assert isinstance(got, torch.Tensor)
    assert_parity(got, want, np.float64)


def test_complex_tensors_match_jax():
    """torch complex tensors (not CArrays), conjugated, with complex alpha
    and beta: the complex product runs as one einsum, as JAX's."""
    a, b, c = (p[0] + 1j * p[1] for p in (crand_np(s, 40 + k) for k, s in
                                         enumerate(((3, 4), (4, 5), (3, 5)))))
    got = t_contract(0.5 - 1j, torch.from_numpy(a), "ab", True, torch.from_numpy(b), "bc",
                     True, 2.0, torch.from_numpy(c), "ac")
    want = j_contract(0.5 - 1j, jnp.asarray(a), "ab", True, jnp.asarray(b), "bc", True,
                      2.0, jnp.asarray(c), "ac")
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_errors():
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="r must be given"):
        t_contract(1.0, x, "ab", False, x, "ab", False, 1.0, None, "")
    with pytest.raises(ValueError, match="unmatched"):
        t_contract(1.0, x, "ab", False, torch.zeros((3, 4)), "bc", False, 0.0, None, "a")
    # the three SBT_MATMUL_PRECISION values are taken ("high" is full f32
    # on the CPU); anything else, a JAX precision object included, raises
    y = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(
        t_contract(1.0, y, "ab", False, y, "ab", False, 0.0, None, "", precision="high"),
        t_contract(1.0, y, "ab", False, y, "ab", False, 0.0, None, "", precision="highest"))
    with pytest.raises(ValueError, match=r"default\|high\|highest"):
        TC.cdot_general(x, x, (((0, 1), (0, 1)), ((), ())),
                        precision=jax.lax.Precision.DEFAULT)


def test_accum_type_and_plan_export():
    assert TK._accum_type(torch.bfloat16) == torch.float32
    assert TK._accum_type(torch.float16) == torch.float32
    assert TK._accum_type(torch.float32) == torch.float32
    assert TK._accum_type(torch.float64) == torch.float64
    assert ContractionPlan("tab", (2, 3, 4), "tac", (2, 3, 5), "tbc",
                           (2, 4, 5)).flops() == 2 * 2 * 3 * 4 * 5
