"""Shared helpers of the tests that hold superbblas_tpu_torch against
superbblas_tpu: inputs made with numpy from a seed, handed to both
packages, outputs compared as float64 numpy arrays."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superbblas_tpu import cplx as jcplx
from superbblas_tpu_torch import cplx as tcplx
from superbblas_tpu_torch.models.wilson import wilson_offsets

#: (rtol, atol relative to max |reference|) per field precision
TOL = {np.float64: (1e-12, 1e-12), np.float32: (1e-5, 1e-5)}

WILSON_OFFSETS = wilson_offsets(4)


@pytest.fixture
def torch_one_thread():
    """Runs the test's torch work on one thread, then restores the count.
    A solve on a small lattice is thousands of small torch ops; while test
    processes share the cores, intra-op threads wait at every op's barrier
    for threads that are not running, which makes such a test an order of
    magnitude slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def collect_garbage():
    """Collects cyclic garbage after the test.  The JAX package's solves
    and multigrid cycles leave JAX arrays in reference cycles (closures
    that refer to themselves); they would otherwise stay live until a
    later collection, inside whatever test runs next in the process
    (tests/test_utils.py's leak check reads the live arrays)."""
    yield
    gc.collect()


def crand_np(shape, seed, dtype=np.float64):
    """(re, im) numpy parts drawn from a seeded generator."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def both(parts, jdtype=None, tdtype=None):
    """The same numpy parts as a JAX CArray and as a port CArray, each
    optionally cast (e.g. to bf16)."""
    re, im = parts
    j = jcplx.CArray(jnp.asarray(re), jnp.asarray(im))
    t = tcplx.CArray(torch.from_numpy(re.copy()), torch.from_numpy(im.copy()))
    if jdtype is not None:
        j = jcplx.CArray(j.re.astype(jdtype), j.im.astype(jdtype))
    if tdtype is not None:
        t = tcplx.CArray(t.re.to(tdtype), t.im.to(tdtype))
    return j, t


def to_np(a):
    """A JAX array or a torch tensor as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a, jnp.float64))


def assert_parity(got, want, dtype, rtol=None):
    """Port result ``got`` against reference ``want`` (CArrays or plain
    arrays) at the tolerance of ``dtype``: rtol, and atol relative to the
    largest reference entry."""
    r, a = TOL[dtype]
    rtol = r if rtol is None else rtol
    gs = tuple(got) if isinstance(got, tuple) else (got,)
    ws = tuple(want) if isinstance(want, tuple) else (want,)
    assert len(gs) == len(ws)
    scale = max(np.max(np.abs(to_np(w))) for w in ws)
    for g, w in zip(gs, ws):
        g, w = to_np(g), to_np(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=max(a, rtol) * scale)


def materialize(apply_fn, lat, blk_shape):
    """Dense matrix [V*blk, V*blk] (complex numpy, column j = A e_j) of a
    port operator on AoS fields [*lat, *blk_shape, ncols], from one apply
    to the identity batch."""
    n = int(np.prod(lat)) * int(np.prod(blk_shape))
    eye = torch.eye(n, dtype=torch.float64).reshape(tuple(lat) + tuple(blk_shape) + (n,))
    y = apply_fn(tcplx.CArray(eye, torch.zeros_like(eye)))
    return (to_np(y.re) + 1j * to_np(y.im)).reshape(n, n)


def gamma5_np():
    """gamma5 = g0 g1 g2 g3 of the JAX package's (chiral) basis."""
    from superbblas_tpu.models.wilson import gamma_matrices

    g = gamma_matrices()
    return g[0] @ g[1] @ g[2] @ g[3]


def jax_native_lib(wait: float = 60.0):
    """The JAX package's native plan library, built by whichever test
    process gets there first.  Its loader compiles with g++ straight into
    the library's path and remembers a failed load, so a process that loads
    while another is writing the file gets None for good: with several test
    processes starting at once this skipped the port's native tests.  This
    forgets such a failure and looks again until the library loads, the
    machine has no g++, or ``wait`` seconds pass."""
    import shutil
    import time

    from superbblas_tpu import native as jnative

    t0 = time.monotonic()
    while True:
        lib = jnative.get_lib()
        if lib is not None or shutil.which("g++") is None or time.monotonic() - t0 > wait:
            return lib
        jnative._tried = False
        time.sleep(0.5)
