"""Default calls of the port's constructors against the JAX package's: each
of the seven constructors that take a ``layout``, called with no
``layout`` in both packages (the port on the CPU), builds the AoS operator
in both, and the two apply to the same AoS field alike."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_parity, both, collect_garbage, crand_np,  # noqa: F401
                           torch_one_thread)
from superbblas_tpu import bsr as JB
from superbblas_tpu import cplx as JCX
from superbblas_tpu.models import clover as JC
from superbblas_tpu.models import domain_wall as JD
from superbblas_tpu.models import staggered as JS
from superbblas_tpu.models import wilson as JW
from superbblas_tpu_torch import bsr as TB
from superbblas_tpu_torch.models import clover as TC
from superbblas_tpu_torch.models import domain_wall as TD
from superbblas_tpu_torch.models import staggered as TS
from superbblas_tpu_torch.models import wilson as TW

pytestmark = pytest.mark.usefixtures("torch_one_thread", "collect_garbage")

LAT, LS, NCOLS = (2, 2, 2, 4), 4, 2
#: complex dtype of each part precision, in both packages
DTYPES = {np.float64: (jnp.complex128, torch.complex128),
          np.float32: (jnp.complex64, torch.complex64)}
#: (JAX constructor, port constructor, keyword arguments, JAX apply, port
#: apply, AoS field shape)
FAMILIES = {
    "wilson_operator": (JW.wilson_operator, TW.wilson_operator, dict(mass=0.3),
                        JW.apply_wilson, TW.apply_wilson, LAT + (4, 3, NCOLS)),
    "twisted_mass_operator": (JW.twisted_mass_operator, TW.twisted_mass_operator,
                              dict(mass=0.3, mu=0.07), JW.apply_wilson, TW.apply_wilson,
                              LAT + (4, 3, NCOLS)),
    "staggered_operator": (JS.staggered_operator, TS.staggered_operator, dict(mass=0.3),
                           JS.apply_staggered, TS.apply_staggered, LAT + (3, NCOLS)),
    "wilson_clover_operator": (JC.wilson_clover_operator, TC.wilson_clover_operator,
                               dict(mass=0.3, c_sw=1.2), JC.apply_clover, TC.apply_clover,
                               LAT + (4, 3, NCOLS)),
    "domain_wall_operator": (JD.domain_wall_operator, TD.domain_wall_operator,
                             dict(Ls=LS, M5=1.8, m_f=0.1), JD.apply_domain_wall,
                             TD.apply_domain_wall, (LS,) + LAT + (4, 3, NCOLS)),
    "mobius_operator": (JD.mobius_operator, TD.mobius_operator,
                        dict(Ls=LS, M5=1.8, m_f=0.1, b5=1.5, c5=0.5), JD.apply_domain_wall,
                        TD.apply_domain_wall, (LS,) + LAT + (4, 3, NCOLS)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_default_call_matches_jax(name, dtype):
    """The model constructors with no ``layout`` (the same numpy links):
    both AoS, and their applies to one AoS field agree within 1e-12 of max
    |y| at complex128 and 1e-5 at complex64."""
    jbuild, tbuild, kw, japply, tapply, shape = FAMILIES[name]
    links = JW.random_su3_links(np.random.default_rng(4), LAT)
    jdt, tdt = DTYPES[dtype]
    jop = jbuild(LAT, links=links, dtype=jdt, **kw)
    top = tbuild(LAT, links=links, dtype=tdt, device="cpu", **kw)
    for op in (top, jop):
        ops = (op.hop, op.clover) if hasattr(op, "hop") else (op,)
        assert all(o.mode == "stencil" for o in ops), name
    jx, tx = both(crand_np(shape, 5, dtype))
    assert_parity(tapply(top, tx), japply(jop, jx), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_default_bsr_from_stencil_matches_jax(dtype):
    """``bsr_from_stencil`` with no ``layout``: AoS in both packages
    (blocks [*lat, ndir, BI, BD]), applied alike through ``bsr_krylov``."""
    offsets = TW.wilson_offsets(4)
    rng = np.random.default_rng(6)
    shape = LAT + (len(offsets), 3, 3)
    vals = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex128 if dtype == np.float64 else np.complex64)
    args = ("xyztc", "xyztC", LAT, {"c": 3}, {"C": 3}, offsets)
    jop = JB.bsr_from_stencil(*args, JCX.from_complex(vals))
    top = TB.bsr_from_stencil(*args, vals, device="cpu")
    assert jop.mode == top.mode == "stencil"
    jx, tx = both(crand_np(LAT + (3, NCOLS), 7, dtype))
    assert_parity(TB.bsr_krylov(1.0, top, tx, "xyztCn"), JB.bsr_krylov(1.0, jop, jx, "xyztCn"),
                  dtype)
