"""Label/coordinate algebra: the pure-Python planning core (counterpart
of ``superbblas_tpu/labels.py``, copied line for line so that each helper
keeps its name and behaviour).

Single-character axis labels ("orders"), boxes ``(from, size)`` over
toroidal lattices, label-permutation lookup, box intersection, and the
T/A/B/C contraction classification of the reference
(`include/superbblas/tensor.h:47-606, 1271-1457` in eromero-vlc/superbblas).
Everything here is host-side metadata work on plain Python ints/tuples.

Conventions:
  * A tensor's axes are *in the order of its label string*.
  * Coordinates are tuples of Python ints, one per label.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterable, Sequence, Tuple

Coor = Tuple[int, ...]


# ---------------------------------------------------------------------------
# Orders (label strings)
# ---------------------------------------------------------------------------


def check_order(order: str) -> str:
    """Validate that ``order`` has unique single-character labels."""
    if not isinstance(order, str):
        raise TypeError(f"order must be a str, got {type(order)!r}")
    if len(set(order)) != len(order):
        raise ValueError(f"order {order!r} has repeated labels")
    return order


def check_coor(coor: Sequence[int], order: str, name: str = "coor") -> Coor:
    coor = tuple(int(c) for c in coor)
    if len(coor) != len(order):
        raise ValueError(
            f"{name} has {len(coor)} entries but order {order!r} has {len(order)} labels"
        )
    return coor


def find_permutation(o0: str, o1: str) -> Tuple[int, ...]:
    """For each label in ``o1``, the index of that label in ``o0`` or -1.

    Mirrors the reference's ``find_permutation`` (tensor.h:470-478).
    """
    return tuple(o0.index(c) if c in o0 else -1 for c in o1)


def reorder_coor(coor: Sequence[int], perm: Sequence[int], blank: int = 0) -> Coor:
    """Apply a ``find_permutation`` result to a coordinate; -1 -> ``blank``."""
    return tuple(coor[p] if p >= 0 else blank for p in perm)


def volume(size: Iterable[int]) -> int:
    return math.prod(size)


def normalize_coor(coor: Sequence[int], dim: Sequence[int]) -> Coor:
    """Wrap a coordinate onto the torus defined by ``dim``."""
    return tuple((c % d) if d > 0 else 0 for c, d in zip(coor, dim))


def check_isomorphic(o0: str, size0: Coor, dim0: Coor, o1: str, dim1: Coor) -> None:
    """A copy from (o0, size0) into o1 is well-formed iff every label of o0
    with extent > 1 exists in o1 with sufficient extent (tensor.h:495-507)."""
    for i, c in enumerate(o0):
        if size0[i] > 1:
            if c not in o1:
                raise ValueError(
                    f"copy: label {c!r} has size {size0[i]} > 1 but is absent "
                    f"from destination order {o1!r}"
                )
            if size0[i] > dim1[o1.index(c)]:
                raise ValueError(
                    f"copy: label {c!r} size {size0[i]} exceeds destination "
                    f"extent {dim1[o1.index(c)]}"
                )
        if size0[i] > dim0[i]:
            raise ValueError(
                f"copy: size {size0[i]} of label {c!r} exceeds origin extent {dim0[i]}"
            )


# ---------------------------------------------------------------------------
# Toroidal box algebra
# ---------------------------------------------------------------------------


def split_interval(frm: int, size: int, dim: int) -> Tuple[Tuple[int, int, int], ...]:
    """Split a possibly-wrapping 1-D interval into contiguous pieces.

    Returns tuples ``(offset_in_box, from, size)`` where ``offset_in_box`` is
    the displacement of the piece inside the requested interval and ``from``
    is its (non-wrapping) start inside ``[0, dim)``.
    """
    if size == 0:
        return ()
    if size > dim:
        raise ValueError(f"interval size {size} exceeds dimension {dim}")
    frm = frm % dim if dim > 0 else 0
    if frm + size <= dim:
        return ((0, frm, size),)
    first = dim - frm
    return ((0, frm, first), (first, 0, size - first))


def split_box(frm: Coor, size: Coor, dim: Coor):
    """Split a possibly-wrapping N-D box into contiguous fragments.

    Yields ``(offset, frag_from, frag_size)`` triples (cartesian product of
    the per-axis splits, up to 2^N fragments) — the static fragment plan the
    reference computes in ``dist.h:345-560``.
    """
    per_axis = [split_interval(f, s, d) for f, s, d in zip(frm, size, dim)]
    for combo in itertools.product(*per_axis):
        yield (
            tuple(c[0] for c in combo),
            tuple(c[1] for c in combo),
            tuple(c[2] for c in combo),
        )


def intersect_interval(
    from0: int, size0: int, from1: int, size1: int, dim: int
) -> Tuple[Tuple[int, int], ...]:
    """All toroidal overlaps of two 1-D intervals, as (from, size) pairs.

    Reference: the 1-D case of the intersection engine (dist.h:345-420).
    Result intervals are expressed in absolute lattice coordinates and may
    themselves wrap.
    """
    if size0 == 0 or size1 == 0:
        return ()
    if dim <= 0:
        return ()
    if size0 >= dim and size1 >= dim:
        return ((from1 % dim, min(size0, size1)),)
    out = []
    f0 = from0 % dim
    f1 = from1 % dim
    # Consider interval 1 shifted by -dim, 0 (unwrapped comparison on a line
    # covering both possible wraps).
    for p0 in _unwrap(f0, size0, dim):
        for p1 in _unwrap(f1, size1, dim):
            lo = max(p0[0], p1[0])
            hi = min(p0[0] + p0[1], p1[0] + p1[1])
            if hi > lo:
                out.append(((lo % dim), hi - lo))
    # Deduplicate (wrapping can produce the same absolute interval twice)
    seen, uniq = set(), []
    for item in out:
        if item not in seen:
            seen.add(item)
            uniq.append(item)
    return tuple(uniq)


def _unwrap(frm: int, size: int, dim: int) -> Tuple[Tuple[int, int], ...]:
    """Represent a toroidal interval as pieces on the line [0, 2*dim)."""
    if frm + size <= dim:
        return ((frm, size),)
    return ((frm, dim - frm), (0, size - (dim - frm)))


def intersect_box(
    from0: Coor, size0: Coor, from1: Coor, size1: Coor, dim: Coor
) -> Tuple[Tuple[Coor, Coor], ...]:
    """All toroidal overlaps of two N-D boxes as (from, size) boxes.

    Cartesian product of per-axis overlaps; up to 2^N results
    (dist.h:420-560 semantics).
    """
    per_axis = [
        intersect_interval(f0, s0, f1, s1, d)
        for f0, s0, f1, s1, d in zip(from0, size0, from1, size1, dim)
    ]
    out = []
    for combo in itertools.product(*per_axis):
        out.append((tuple(c[0] for c in combo), tuple(c[1] for c in combo)))
    return tuple(out)


def translate_coor(
    coor: Coor, o0: str, from0: Coor, o1: str, from1: Coor, blank: int = 0
) -> Coor:
    """Map an absolute coordinate in tensor-0 space to tensor-1 space:
    subtract from0, permute labels, add from1 (dist.h:596-654 semantics;
    wrapping is applied by the caller against the destination dims)."""
    rel = tuple(c - f for c, f in zip(coor, from0))
    perm = find_permutation(o0, o1)
    rel1 = reorder_coor(rel, perm, blank)
    return tuple(r + f for r, f in zip(rel1, from1))


# ---------------------------------------------------------------------------
# Contraction classification (T/A/B/C)
# ---------------------------------------------------------------------------


class ContractionPlan:
    """Classification of a labeled contraction  r = op(x0) · op(x1).

    Labels are grouped exactly as the reference does
    (tensor.h:1271-1357):

      * T: in x0, x1 and r   (batch)
      * A: in x0 and x1 only (contracted)
      * B: in x0 and r only  (lhs free rows)
      * C: in x1 and r only  (rhs free cols)

    Every label of each tensor must fall in one of its groups, otherwise the
    contraction is rejected ("unmatched dimensions", tensor.h:1349-1355).
    """

    __slots__ = ("o0", "o1", "o_r", "T", "A", "B", "C",
                 "volT", "volA", "volB", "volC")

    def __init__(self, o0: str, dim0: Coor, o1: str, dim1: Coor, o_r: str, dimr: Coor):
        check_order(o0), check_order(o1), check_order(o_r)
        s0, s1, sr = set(o0), set(o1), set(o_r)
        # Order within groups follows appearance in o0 (or o1 for C), like
        # the reference scans.
        T = "".join(c for c in o0 if c in s1 and c in sr)
        A = "".join(c for c in o0 if c in s1 and c not in sr)
        B = "".join(c for c in o0 if c in sr and c not in s1)
        C = "".join(c for c in o1 if c in sr and c not in s0)
        if len(o0) != len(T) + len(A) + len(B):
            raise ValueError(f"contraction: o0={o0!r} has unmatched dimensions")
        if len(o1) != len(T) + len(A) + len(C):
            raise ValueError(f"contraction: o1={o1!r} has unmatched dimensions")
        if len(o_r) != len(T) + len(B) + len(C):
            raise ValueError(f"contraction: o_r={o_r!r} has unmatched dimensions")

        d0 = dict(zip(o0, dim0))
        d1 = dict(zip(o1, dim1))
        dr = dict(zip(o_r, dimr))
        # Extent consistency across operands.
        for c in T + A:
            if d0.get(c, d1.get(c)) != d1.get(c, d0.get(c)):
                raise ValueError(
                    f"contraction: label {c!r} extent mismatch between operands"
                )
        for c in T + B:
            if c in dr and dr[c] != d0[c]:
                raise ValueError(
                    f"contraction: label {c!r} extent mismatch with output"
                )
        for c in C:
            if dr[c] != d1[c]:
                raise ValueError(
                    f"contraction: label {c!r} extent mismatch with output"
                )

        self.o0, self.o1, self.o_r = o0, o1, o_r
        self.T, self.A, self.B, self.C = T, A, B, C
        self.volT = volume(d0[c] for c in T)
        self.volA = volume(d0[c] for c in A)
        self.volB = volume(d0[c] for c in B)
        self.volC = volume(d1[c] for c in C)

    def dot_general_dims(self):
        """dimension_numbers of a ``dot_general`` (``cplx.cdot_general``):
        ((lhs_contract, rhs_contract), (lhs_batch, rhs_batch))."""
        lc = tuple(self.o0.index(c) for c in self.A)
        rc = tuple(self.o1.index(c) for c in self.A)
        lb = tuple(self.o0.index(c) for c in self.T)
        rb = tuple(self.o1.index(c) for c in self.T)
        return ((lc, rc), (lb, rb))

    def dot_general_out_order(self) -> str:
        """Axis labels of the raw dot_general result: T (lhs order), then
        lhs free dims in o0 order, then rhs free dims in o1 order."""
        lhs_free = "".join(c for c in self.o0 if c in self.B)
        rhs_free = "".join(c for c in self.o1 if c in self.C)
        return self.T + lhs_free + rhs_free

    def flops(self, complex_dtype: bool = False) -> int:
        mul = 8 if complex_dtype else 2
        return mul * self.volT * self.volA * self.volB * self.volC
