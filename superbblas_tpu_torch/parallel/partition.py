"""Partition model: explicit (from, size) boxes per process/component
(counterpart of ``superbblas_tpu/parallel/partition.py``, host code only).

Re-creates the semantics of the reference's partition layer
(``include/superbblas/dist.h:39-88, 3265-3509, 3745-3828`` in
eromero-vlc/superbblas): a distributed tensor is described by one toroidal
box per (process, component).  Partitions translate to the port's
``NamedSharding`` (DTensor placements over a ``DeviceMesh``, see mesh.py)
where they are regular grids, and drive the explicit redistribution plans
(redistribute.py), halo shells and the sharded storage's block layout.

Key entry points, with reference-parity behavior:
  * ``factors_2_3``             (dist.h:3265-3306)
  * ``partitioning_distributed_procs`` (dist.h:3318-3383)
  * ``basic_partitioning``      (dist.h:3393-3509), incl. ``ext_power``
    halo extension and ``replicate``
  * ``make_hole``               (dist.h:3745-3828)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..labels import Coor, check_order, intersect_box, volume

Box = Tuple[Coor, Coor]  # (from, size)


# ---------------------------------------------------------------------------
# 2-3 factorization
# ---------------------------------------------------------------------------


class Factors23:
    """Approximate factorization of n into powers of 2 and 3.

    The produced value is >= 0.75 * n (dist.h:3265-3306 semantics): exact
    powers of 2/3 are peeled off, leftover factors are approximated from
    below by 3s then a 2, and 3s are upgraded to 4s while staying <= n.
    """

    __slots__ = ("two", "three", "value")

    def __init__(self, n: int = 1, _two: int = 0, _three: int = 0, _value: int = 1):
        if n == 1 and _value != 1:
            self.two, self.three, self.value = _two, _three, _value
            return
        if n <= 0:
            raise ValueError("Factors23 requires a positive integer")
        two = three = 0
        value = 1
        rem = n
        while rem % 2 == 0:
            two += 1
            rem //= 2
            value *= 2
        while rem % 3 == 0:
            three += 1
            rem //= 3
            value *= 3
        while rem >= 3:
            three += 1
            rem //= 3
            value *= 3
        if rem >= 2:
            two += 1
            rem //= 2
            value *= 2
        while three > 0 and value * 4 // 3 <= n:
            three -= 1
            two += 2
            value = value * 4 // 3
        self.two, self.three, self.value = two, three, value

    def __mul__(self, other: "Factors23") -> "Factors23":
        return Factors23(
            1,
            _two=self.two + other.two,
            _three=self.three + other.three,
            _value=self.value * other.value,
        )

    def __repr__(self):
        return f"Factors23(2^{self.two} * 3^{self.three} = {self.value})"


def partitioning_distributed_procs(
    order: str, dim: Sequence[int], dist_labels: str, nprocs: int
) -> Coor:
    """Process-grid shape: factor ``nprocs`` into 2s and 3s and greedily
    assign factors to the distributed label with the largest per-process
    extent (dist.h:3318-3383)."""
    check_order(order)
    dim = tuple(int(d) for d in dim)
    p = [1] * len(order)
    dist_axes = [order.index(c) for c in dist_labels if c in order and dim[order.index(c)] > 1]
    if not dist_axes or volume(dim) == 0 or nprocs <= 1:
        return tuple(p)

    nprocs_f = Factors23(nprocs)
    assigned = [Factors23(1) for _ in dist_axes]
    vol_p = 1
    factors = (3, 2)
    while True:
        # axis with largest local extent first
        order_idx = sorted(
            range(len(dist_axes)),
            key=lambda j: -(dim[dist_axes[j]] // assigned[j].value),
        )
        applied = False
        for j in order_idx:
            for f in factors:
                if nprocs_f.value % (vol_p * f) == 0:
                    assigned[j] = assigned[j] * Factors23(f)
                    vol_p *= f
                    applied = True
                    break
            if applied:
                break
        if not applied:
            break
    for j, ax in enumerate(dist_axes):
        p[ax] = assigned[j].value
    return tuple(p)


# ---------------------------------------------------------------------------
# Partition container
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Partition:
    """A box per (process, component) over a toroidal lattice.

    ``boxes[rank * ncomponents + c]`` is the (from, size) box owned by
    component ``c`` of process ``rank``.  Boxes may wrap, overlap
    (replication / halos), or be empty ((0...),(0...)).
    """

    dim: Coor
    boxes: Tuple[Box, ...]
    ncomponents: int = 1

    @property
    def nprocs(self) -> int:
        return len(self.boxes) // self.ncomponents

    def box(self, rank: int, component: int = 0) -> Box:
        return self.boxes[rank * self.ncomponents + component]

    def __len__(self) -> int:
        return len(self.boxes)

    def is_replicated(self) -> bool:
        full = ((0,) * len(self.dim), self.dim)
        return all(b == full for b in self.boxes)

    def has_full_support(self) -> bool:
        """Whether the union of boxes covers the whole lattice (reference
        ``has_full_support``, dist.h:667)."""
        covered = 0
        # Inclusion-exclusion is overkill; sample-free check: sum of
        # non-overlapping volumes via sweep is complex — instead check that
        # subtracting every box from the full lattice leaves nothing.
        rest = [((0,) * len(self.dim), self.dim)]
        for b in self.boxes:
            new_rest = []
            for r in rest:
                new_rest.extend(box_minus(r[0], r[1], b[0], b[1], self.dim))
            rest = new_rest
            if not rest:
                return True
        return not rest

    def are_there_repetitions(self) -> bool:
        """Whether any lattice site is owned by more than one box
        (reference ``are_there_repetitions``, dist.h:2123): replication
        and halo-extended partitions repeat; Add-copies into them must
        account for multiplicity."""
        nz = [b for b in self.boxes if volume(b[1]) > 0]
        # a single box wrapping past the full extent repeats sites by itself
        for _, size in nz:
            if any(s > d for s, d in zip(size, self.dim)):
                return True
        for i in range(len(nz)):
            for j in range(i + 1, len(nz)):
                for _, isize in intersect_box(nz[i][0], nz[i][1],
                                              nz[j][0], nz[j][1], self.dim):
                    if volume(isize) > 0:
                        return True
        return False

    def grid_shape(self) -> Optional[Coor]:
        """If this partition is a regular block grid produced by
        ``basic_partitioning`` (no halo, no replication, one component),
        return the process-grid shape per axis; else None."""
        if self.ncomponents != 1:
            return None
        # Count distinct starting offsets per axis.
        starts = [sorted({b[0][i] for b in self.boxes if volume(b[1]) > 0})
                  for i in range(len(self.dim))]
        shape = tuple(len(s) for s in starts)
        # Exact duplicates are allowed: they express replication over the
        # remaining mesh axes (e.g. a sharding that does not use every
        # mesh axis).
        distinct = {b for b in self.boxes if volume(b[1]) > 0}
        if volume(shape) != len(distinct):
            return None
        # Verify every box is the cartesian block implied by its start.
        for b in self.boxes:
            if volume(b[1]) == 0:
                continue
            for i, (f, s) in enumerate(zip(b[0], b[1])):
                ss = starts[i]
                if f not in ss:
                    return None
                k = ss.index(f)
                end = ss[k + 1] if k + 1 < len(ss) else self.dim[i]
                if f + s != end:
                    return None
        return shape


def basic_partitioning(
    order: str,
    dim: Sequence[int],
    procs: Optional[Sequence[int]] = None,
    dist_labels: Optional[str] = None,
    nprocs: int = -1,
    ncomponents: int = 1,
    replicate: bool = False,
    ext_power: Optional[Sequence[int]] = None,
) -> Partition:
    """Block-partition ``dim`` over a process grid ``procs``.

    Reference semantics (dist.h:3393-3509): the remainder of an uneven
    split goes to the lowest-coordinate processes; process ranks scan the
    grid with the *first* distributed label slowest; ``ext_power`` extends
    each box by +-k elements with toroidal wrap (halo support);
    ``replicate`` with a 1-process grid copies the full box to everyone.
    """
    check_order(order)
    dim = tuple(int(d) for d in dim)
    nd = len(dim)
    if procs is None:
        if nprocs < 0:
            raise ValueError("basic_partitioning: give procs or nprocs")
        procs = partitioning_distributed_procs(order, dim, dist_labels or order, nprocs)
    procs = tuple(int(p) for p in procs)
    vol_procs = volume(procs)
    if nprocs >= 0 and vol_procs > nprocs:
        raise ValueError("total processes in `procs` exceeds nprocs")
    ext = tuple(int(e) for e in ext_power) if ext_power is not None else (0,) * nd

    # Axis scan order: dist_labels first, then the rest.
    if dist_labels is not None:
        perm = [order.index(c) for c in dist_labels if c in order]
        perm += [i for i, c in enumerate(order) if c not in dist_labels]
    else:
        perm = list(range(nd))

    procs_perm = tuple(procs[perm[i]] for i in range(nd))
    total = vol_procs if nprocs < 0 else nprocs

    def block(i: int, cp: int) -> Tuple[int, int]:
        """(from, size) of grid coordinate ``cp`` along axis ``i``
        (pre-halo)."""
        d, np_ = dim[i], procs[i]
        size = d // np_ + (1 if d % np_ > cp else 0)
        frm = 0 if size == d else d // np_ * cp + min(cp, d % np_)
        return frm, size

    boxes = []
    for rank in range(total):
        if rank >= vol_procs:
            boxes.append(((0,) * nd, (0,) * nd))
            continue
        # decode rank into grid coordinates, first perm axis slowest
        cproc_perm = []
        r = rank
        for i in range(nd - 1, -1, -1):
            cproc_perm.append(r % procs_perm[i])
            r //= procs_perm[i]
        cproc_perm.reverse()
        cproc = [0] * nd
        for i in range(nd):
            cproc[perm[i]] = cproc_perm[i]

        frm, size = [0] * nd, [0] * nd
        for i in range(nd):
            f, s = block(i, cproc[i])
            if ext[i] > 0:
                # reference rule (dist.h:3492-3504): grow by ext on both
                # sides, clamped to the full extent (then from resets to 0)
                s2 = min(s + 2 * ext[i], dim[i])
                f = 0 if s2 == dim[i] else (f - ext[i]) % dim[i]
                s = s2
            frm[i], size[i] = f, s
        if volume(size) == 0 and all(e == 0 for e in ext):
            frm = [0] * nd
            size = [0] * nd
        boxes.append((tuple(frm), tuple(size)))

    if replicate and vol_procs == 1:
        boxes = [boxes[0]] * len(boxes)

    part = Partition(dim=dim, boxes=tuple(boxes), ncomponents=1)
    if ncomponents > 1:
        part = split_into_components(part, order, dist_labels, ncomponents)
    return part


def split_into_components(
    part: Partition, order: str, dist_labels: Optional[str], ncomponents: int
) -> Partition:
    """Split each process box into per-device component sub-boxes
    (multi-device-per-host support, dist.h:3446-3461)."""
    out = []
    for frm, size in part.boxes:
        procs = partitioning_distributed_procs(
            order, size, dist_labels or order, ncomponents
        )
        sub = basic_partitioning(order, size, procs, dist_labels, nprocs=ncomponents)
        for sfrm, ssize in sub.boxes:
            if volume(ssize) == 0:
                out.append(((0,) * len(part.dim), (0,) * len(part.dim)))
            else:
                out.append((
                    tuple((a + b) % max(d, 1) for a, b, d in zip(sfrm, frm, part.dim)),
                    ssize,
                ))
    return Partition(dim=part.dim, boxes=tuple(out), ncomponents=ncomponents)


# ---------------------------------------------------------------------------
# Box subtraction (make_hole)
# ---------------------------------------------------------------------------


def subtract_interval(f0: int, s0: int, f1: int, s1: int, dim: int):
    """Pieces of toroidal interval (f0, s0) not covered by (f1, s1).

    Returned as (from, size) pairs in absolute coordinates.
    """
    return interval_split(f0, s0, f1, s1, dim)[0]


def interval_split(f0: int, s0: int, f1: int, s1: int, dim: int):
    """Split toroidal interval (f0, s0) into the pieces outside / inside
    (f1, s1): returns (kept, removed) lists of absolute (from, size) pairs.
    The pieces of each list are disjoint and kept + removed exactly tile
    (f0, s0).  When both intervals wrap, the overlap is two DISJOINT
    toroidal arcs — both are returned (any single-arc shortcut drops
    coverage; see box_minus)."""
    if s0 == 0:
        return [], []
    if s1 == 0:
        return [(f0 % dim if dim else 0, s0)], []
    f0 = f0 % dim
    # Work in offset space of interval 0: offsets [0, s0).
    h = (f1 - f0) % dim
    holes = [(h, min(s1, dim - h))]
    if s1 > dim - h:
        holes.append((0, s1 - (dim - h)))
    kept = [(0, s0)]
    removed = []
    for hf, hs in holes:
        new_kept = []
        for kf, ks in kept:
            lo = max(kf, hf)
            hi = min(kf + ks, hf + hs)
            if hi <= lo:
                new_kept.append((kf, ks))
            else:
                if lo > kf:
                    new_kept.append((kf, lo - kf))
                removed.append((lo, hi - lo))
                if kf + ks > hi:
                    new_kept.append((hi, kf + ks - hi))
        kept = new_kept
    return ([((f0 + kf) % dim, ks) for kf, ks in kept],
            [((f0 + rf) % dim, rs) for rf, rs in removed])


def box_minus(frm: Coor, size: Coor, hole_from: Coor, hole_size: Coor, dim: Coor):
    """Decompose box \\ hole into disjoint boxes (dist.h:3745-3828
    semantics: slab decomposition per axis).  For each axis the current
    region splits into pieces outside the hole's axis range (emitted with
    the other axes unchanged) and pieces inside it (each recursed to the
    next axis — ALL of them: when both intervals wrap the overlap is two
    disjoint arcs, and following only one silently dropped the rest of
    the remainder)."""
    out = []
    if volume(size) == 0:
        return []
    nd = len(dim)

    def rec(cur_from, cur_size, ax):
        if ax == nd:
            return  # inside the hole on every axis: subtracted.
        kept, removed = interval_split(
            cur_from[ax], cur_size[ax], hole_from[ax], hole_size[ax], dim[ax]
        )
        for pf, ps in kept:
            b_from = list(cur_from)
            b_size = list(cur_size)
            b_from[ax] = pf
            b_size[ax] = ps
            out.append((tuple(b_from), tuple(b_size)))
        for of, osz in removed:
            b_from = list(cur_from)
            b_size = list(cur_size)
            b_from[ax] = of
            b_size[ax] = osz
            rec(b_from, b_size, ax + 1)

    rec(list(frm), list(size), 0)
    return out


def make_hole(part: Partition, hole_from: Coor, hole_size: Coor) -> Partition:
    """New partition whose boxes exclude the given hole box
    (dist.h:3802-3828).  Each input box may split into several disjoint
    fragments; fragments become extra components (all processes are padded
    to the same component count with empty boxes)."""
    frag_lists = [
        box_minus(b[0], b[1], tuple(hole_from), tuple(hole_size), part.dim)
        for b in part.boxes
    ]
    max_frags = max((len(f) for f in frag_lists), default=1)
    max_frags = max(max_frags, 1)
    empty = ((0,) * len(part.dim), (0,) * len(part.dim))
    boxes = []
    for frags in frag_lists:
        frags = list(frags) + [empty] * (max_frags - len(frags))
        boxes.extend(frags)
    return Partition(
        dim=part.dim,
        boxes=tuple(boxes),
        ncomponents=part.ncomponents * max_frags,
    )
