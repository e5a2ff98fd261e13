"""Built-in verification utilities (counterpart of
``superbblas_tpu/utils/testing.py``).

Re-creation of the reference's debug nets:
  * mock-index copy verification (dist.h:1919-2116): replay a copy with
    tensors whose values are global linear indices and compare against an
    independently computed truth;
  * numpy reference implementations usable as test oracles;
  * cross-process consistency (dist.h:708-737): ``check_consistency``
    validates metadata self-consistency locally, and
    ``check_collective_consistency`` hashes call metadata across the
    processes of a ``torch.distributed`` group.

The distributed layer runs them under ``SBT_DEBUG``, as the JAX package
does: ``check_collective_consistency`` at every collective entry of the
sharded storage protocol (>=1), ``verify_copy`` on every distributed copy
(>=2).
"""

from __future__ import annotations

import itertools

import numpy as np


def numpy_copy_reference(alpha, x, o0, y, o1, from0, size0, from1, copy_add):
    """Element-by-element toroidal reference copy (the oracle)."""
    out = np.array(y, copy=True)
    dim0, dim1 = x.shape, out.shape
    from0 = tuple(from0) if from0 is not None else (0,) * len(o0)
    size0 = tuple(size0) if size0 is not None else dim0
    from1 = tuple(from1) if from1 is not None else (0,) * len(o1)
    for rel in itertools.product(*[range(s) for s in size0]):
        c0 = tuple((f + r) % d for f, r, d in zip(from0, rel, dim0))
        c1 = tuple(
            (from1[j] + (rel[o0.index(c)] if c in o0 else 0)) % dim1[j]
            for j, c in enumerate(o1)
        )
        v = alpha * x[c0]
        if copy_add == "copy":
            out[c1] = v
        else:
            out[c1] += v
    return out


def numpy_contraction_reference(alpha, x0, o0, conj0, x1, o1, conj1, beta, r, o_r):
    a = np.conj(x0) if conj0 else x0
    b = np.conj(x1) if conj1 else x1
    out = alpha * np.einsum(f"{o0},{o1}->{o_r}", a, b)
    if r is not None and beta != 0:
        out = out + beta * np.asarray(r)
    return out


def verify_copy(shape0, o0, shape1, o1, from0, size0, from1, copy_add):
    """Mock-index verification (dist.h:1919-2116 semantics): run the real
    copy on index-valued tensors and compare element-wise with the numpy
    oracle.  Raises on mismatch."""
    import torch

    from ..ops.copy import local_copy

    x = np.arange(1, int(np.prod(shape0)) + 1, dtype=np.float64).reshape(shape0)
    y = -np.arange(1, int(np.prod(shape1)) + 1, dtype=np.float64).reshape(shape1)
    got = local_copy(
        1.0, torch.from_numpy(x), o0, torch.from_numpy(y), o1,
        from0=from0, size0=size0, from1=from1, copy_add=copy_add,
    ).cpu().numpy()
    want = numpy_copy_reference(1.0, x, o0, y, o1, from0, size0, from1, copy_add)
    if not np.array_equal(got, want):
        bad = np.argwhere(got != want)
        raise AssertionError(
            f"mock-index copy verification failed at {bad[:5].tolist()} "
            f"(and {max(len(bad) - 5, 0)} more)"
        )


def check_collective_consistency(tag, payload):
    """Cross-process agreement check for HOST-side collective protocol
    (barriers, coordinated storage writes) — the analog of the
    reference's ``check_consistency``, which hashes call metadata across
    MPI ranks at every collective entry (dist.h:708-737).

    Any code that branches a barrier schedule on locally-read state (file
    contents, wall clock, rng) desynchronizes the processes.  Every
    process of the default ``torch.distributed`` group hashes ``(tag,
    payload)``, the hashes are allgathered (``all_gather_object``), and
    ALL processes raise together on any mismatch (an allgather, not a
    broadcast-and-compare, so no process is left hanging at the next
    barrier while another died).

    Returns at once unless a process group of more than one rank is
    initialised.  ``payload`` must repr deterministically (tuples of
    ints/strings — no sets/dicts with unstable order).
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return
    import hashlib

    h = hashlib.sha256(repr((tag, payload)).encode()).hexdigest()[:16]
    allh = [None] * dist.get_world_size()
    dist.all_gather_object(allh, h)
    if any(v != allh[0] for v in allh):
        bad = [i for i, v in enumerate(allh) if v != allh[0]]
        raise RuntimeError(
            f"cross-process divergence at collective entry {tag!r}: "
            f"processes {bad} disagree with process 0 on the call "
            f"metadata (local payload: {payload!r}).  A barrier schedule "
            "was branched on locally-divergent state.")


def check_consistency(**metadata):
    """Validate that op metadata is self-consistent (labels unique, sizes
    positive).  The reference hashes metadata across MPI ranks
    (dist.h:708-737); this is the local validation."""
    for key, val in metadata.items():
        if key.startswith("o") and isinstance(val, str):
            if len(set(val)) != len(val):
                raise ValueError(f"inconsistent metadata {key}={val!r}: repeated labels")
        if key.startswith("size") and val is not None:
            if any(int(s) < 0 for s in val):
                raise ValueError(f"inconsistent metadata {key}={val!r}: negative size")
