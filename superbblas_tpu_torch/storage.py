"""S3T ("simple, sparse, streamed tensor") storage: checkpoint I/O
(counterpart of ``superbblas_tpu/storage.py``, its single-process part).

Bit-compatible implementation of the reference's S3T format
(``include/superbblas/storage.h:19-58`` in eromero-vlc/superbblas):

    magic(i32)=314, version(i32)=0, values_datatype(i32),
    checksum_level(i32), dimensions(i32), metadata_size(i32),
    metadata(char*), zero padding to 8 bytes,
    size(double*dims, SlowToFast), checksum_blocksize(double),
    num_chunks(double),
    chunks: { num_blocks(double), {from,size}(double*dims each) per block,
              values(dtype), [block checksums(double each)] }
    [global checksum(double)]

Checksums are zlib CRC32 (the reference vendors Mark Adler's table,
crc32.h); data longer than ``checksum_blocksize`` is checksummed in
pieces and the CRC of the little-endian uint32 piece-CRCs is reported
(storage.h:698-730).  With checksum level 1 the trailing double holds the
CRC of the whole preceding file; with level 2 it covers the header and
block coordinate metadata only (num_chunks, values and per-block
checksums excluded) and each block's values get their own CRC
(storage.h:1465-1522).

The reference writes through POSIX/MPI-IO with a GridHash spatial index
(storage.h:552-684); here the index is a host-side box list searched with
the label-layer's toroidal intersections (the native plan engine's batch
sweep where it is built).  Files are little-endian; big-endian files are
detected by the magic number and read and written byte-swapped
(storage.h:737-749).  The files are byte-identical to the JAX package's
for the same inputs.

Tensors are staged through host numpy: ``save`` cuts the box and permutes
it into the file's label order on the tensor's own device, then copies it
to the host once; ``load`` assembles the file region on the host, copies
it to the device of the ``x`` it was given and permutes it there, and
returns a tensor (or a ``cplx.CArray``) on that device.

The sharded functions (``create_storage_sharded``, ``save_sharded``,
``save_sharded_async``, ``load_sharded``, ``close_storage_sharded``) run
the MPI-IO collective protocol of the reference (storage.h:202-342) on
``torch.distributed``: rank 0 writes the header and declares the blocks
(one per rank's shard, in rank order, after an ``all_gather_object`` of
the boxes), barriers publish them, every rank writes and reads only its
own shard's bytes, and rank 0 writes the checksums at close.  At
SBT_DEBUG>=1 every collective entry runs
``utils.testing.check_collective_consistency``.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import cplx, flags
from .labels import (
    check_order,
    find_permutation,
    intersect_box,
    reorder_coor,
    volume,
)
from .ops.copy import _extract_box, _permute_to

__all__ = [
    "Storage",
    "create_storage",
    "open_storage",
    "append_blocks",
    "save",
    "load",
    "load_stream",
    "save_stream",
    "check_or_write_checksums",
    "read_storage_header",
    "get_blocks",
    "preallocate_storage",
    "flush_storage",
    "close_storage",
    "save_async",
]

MAGIC = 314
VERSION = 0
DEFAULT_CHECKSUM_BLOCKSIZE = 64 * 1024 * 1024

_DTYPES = {
    0: np.dtype(np.float32),
    1: np.dtype(np.float64),
    2: np.dtype(np.complex64),
    3: np.dtype(np.complex128),
    4: np.dtype(np.int8),
    5: np.dtype(np.int32),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def _crc(data: bytes, prev: int = 0) -> int:
    return zlib.crc32(data, prev) & 0xFFFFFFFF


def _blocked_crc(data: bytes, blocksize: int) -> int:
    """storage.h:698-730: CRC pieces of `blocksize` bytes, then the CRC of
    the uint32-LE piece-CRC array — note the reference wraps even a single
    piece (num_blocks >= 1 whenever blocking is enabled)."""
    if blocksize <= 0:
        return _crc(data)
    n = max(1, (len(data) + blocksize - 1) // blocksize)
    piece = np.empty(n, dtype="<u4")
    for i in range(n):
        piece[i] = _crc(data[i * blocksize:(i + 1) * blocksize])
    return _crc(piece.tobytes())


_ZEROS = bytes(1 << 20)


def _zeros_crc(nbytes: int) -> int:
    """CRC of ``nbytes`` zero bytes, streamed through a 1 MiB buffer."""
    crc = 0
    for i in range(0, nbytes, len(_ZEROS)):
        crc = _crc(_ZEROS[:min(len(_ZEROS), nbytes - i)], crc)
    return crc


def _zeros_blocked_crc(nbytes: int, blocksize: int) -> int:
    """``_blocked_crc`` of ``nbytes`` zero bytes, each distinct piece's CRC
    computed once."""
    if blocksize <= 0:
        return _crc(b"") if nbytes == 0 else _zeros_crc(nbytes)
    n = max(1, (nbytes + blocksize - 1) // blocksize)
    full, last = divmod(nbytes, blocksize)
    piece = np.empty(n, dtype="<u4")
    if full:
        piece[:full] = _zeros_crc(blocksize)
    if last or not full:
        piece[full:] = _zeros_crc(last)
    return _crc(piece.tobytes())


@dataclass
class _Block:
    frm: Tuple[int, ...]
    size: Tuple[int, ...]
    values_offset: int       # absolute file offset of this block's values
    checksum_offset: int = -1  # absolute offset of this block's crc double


@dataclass
class Storage:
    """Open S3T handle (the reference's ``Storage_handle``,
    storage.h:1432-1560)."""

    path: str
    mode: str                 # "r" or "r+"
    order: Optional[str] = None   # label order fixed at creation (not in
                                  # the file format; reference passes labels
                                  # per call, storage.h:2261/2291)
    dtype: np.dtype = np.dtype(np.float64)
    checksum_level: int = 0
    dim: Tuple[int, ...] = ()
    metadata: str = ""
    checksum_blocksize: int = DEFAULT_CHECKSUM_BLOCKSIZE
    byteswap: bool = False
    blocks: List[_Block] = field(default_factory=list)
    header_crc: int = 0       # running crc of header+block metadata (lvl 2)
    num_chunks: int = 0
    _file: Optional[object] = None
    # serializes all file access: async writers (save_async) share the
    # handle; seek+IO must be atomic per operation and read-modify-write
    # atomic per save
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False, compare=False)
    # lazy spatial index over blocks (GridHash, storage.h:552-684);
    # invalidated by append_blocks
    _grid: Optional[object] = field(default=None, repr=False, compare=False)
    # outstanding async-write futures (MPI_File_iwrite analogs), resolved
    # by flush_storage / close_storage
    _pending: List[object] = field(default_factory=list, repr=False,
                                   compare=False)

    @property
    def ndim(self) -> int:
        return len(self.dim)

    def _open(self):
        if self._file is None or self._file.closed:
            self._file = open(self.path, "rb" if self.mode == "r" else "r+b")
        return self._file


def _pad_len(metadata_size: int) -> int:
    return (8 - metadata_size % 8) % 8


def create_storage(
    path: str,
    o: str,
    dim,
    dtype=np.float64,
    metadata: str = "",
    checksum: int = 0,
) -> Storage:
    """Create a new S3T file (public create_storage, storage.h:2143).

    ``dim`` is given in the order of labels ``o`` and stored SlowToFast
    (first label slowest), matching the reference's SlowToFast convention.
    """
    check_order(o)
    dim = tuple(int(d) for d in dim)
    dt = np.dtype(dtype)
    if dt not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dt}")
    meta_b = metadata.encode()
    pad = _pad_len(len(meta_b))

    hdr = struct.pack("<6i", MAGIC, VERSION, _DTYPE_CODES[dt], checksum,
                      len(dim), len(meta_b))
    hdr += meta_b + b"\x00" * pad
    hdr += np.asarray(dim, dtype="<f8").tobytes()
    hdr += struct.pack("<d", float(DEFAULT_CHECKSUM_BLOCKSIZE))
    num_chunks_off = len(hdr)
    hdr += struct.pack("<d", 0.0)   # num_chunks, updated on append

    with open(path, "wb") as f:
        f.write(hdr)

    sto = Storage(
        path=path, mode="r+", order=o, dtype=dt, checksum_level=checksum,
        dim=dim, metadata=metadata,
        checksum_blocksize=DEFAULT_CHECKSUM_BLOCKSIZE,
    )
    # level-2 header crc excludes num_chunks (storage.h:1465-1507)
    sto.header_crc = _crc(hdr[:num_chunks_off])
    sto._num_chunks_off = num_chunks_off
    return sto


def open_storage(path: str, mode: str = "r+") -> Storage:
    """Open an existing S3T file, reading the block index
    (public open_storage, storage.h:2143-2200)."""
    with open(path, "rb") as f:
        raw = f.read(24)
        magic = struct.unpack("<i", raw[:4])[0]
        swap = False
        if magic != MAGIC:
            magic_be = struct.unpack(">i", raw[:4])[0]
            if magic_be != MAGIC:
                raise ValueError(f"{path}: not an S3T file")
            swap = True
        fmt = ">6i" if swap else "<6i"
        _, version, dtcode, checksum, ndim, meta_size = struct.unpack(fmt, raw)
        if version != VERSION:
            raise ValueError(f"unsupported S3T version {version}")
        metadata = f.read(meta_size).decode()
        f.read(_pad_len(meta_size))
        dfmt = ">f8" if swap else "<f8"
        dim = tuple(int(v) for v in np.frombuffer(f.read(8 * ndim), dtype=dfmt))
        cbs = int(np.frombuffer(f.read(8), dtype=dfmt)[0])
        num_chunks_off = f.tell()
        num_chunks = int(np.frombuffer(f.read(8), dtype=dfmt)[0])

        sto = Storage(
            path=path, mode=mode, dtype=_DTYPES[dtcode],
            checksum_level=checksum, dim=dim, metadata=metadata,
            checksum_blocksize=cbs, byteswap=swap, num_chunks=num_chunks,
        )
        sto._num_chunks_off = num_chunks_off
        # running header crc: everything up to (excluding) num_chunks
        f.seek(0)
        sto.header_crc = _crc(f.read(num_chunks_off))
        f.seek(num_chunks_off + 8)

        # walk chunks to build the block index (and the header crc)
        itemsize = sto.dtype.itemsize
        for _ in range(num_chunks):
            raw_n = f.read(8)
            nblocks = int(np.frombuffer(raw_n, dtype=dfmt)[0])
            raw_coords = f.read(8 * 2 * ndim * nblocks)
            sto.header_crc = _crc(raw_coords, _crc(raw_n, sto.header_crc))
            coords = np.frombuffer(raw_coords, dtype=dfmt)
            coords = coords.reshape(nblocks, 2, ndim).astype(np.int64)
            voff = f.tell()
            offsets = []
            for b in range(nblocks):
                offsets.append(voff)
                voff += int(np.prod(coords[b, 1])) * itemsize
            f.seek(voff)
            coffs = [-1] * nblocks
            if checksum == 2:
                for b in range(nblocks):
                    coffs[b] = f.tell()
                    f.read(8)
            for b in range(nblocks):
                sto.blocks.append(_Block(
                    frm=tuple(coords[b, 0]), size=tuple(coords[b, 1]),
                    values_offset=offsets[b], checksum_offset=coffs[b],
                ))
        data_end = f.tell()
        f.seek(0, os.SEEK_END)
        sto._has_trailer = f.tell() >= data_end + 8
        sto._data_end = data_end
    return sto


def append_blocks(sto: Storage, boxes) -> None:
    """Declare new blocks as one chunk, reserving zeroed value space
    (public append_blocks, storage.h:2204-2259).  ``boxes`` is a list of
    (from, size) in the storage's label order."""
    if sto.mode == "r":
        raise ValueError("storage opened read-only")
    boxes = [(tuple(int(v) for v in f), tuple(int(v) for v in s))
             for f, s in boxes]
    f = sto._open()
    if getattr(sto, "_has_trailer", False):
        # a previously-written trailing checksum is overwritten by the
        # new chunk and re-emitted at close
        f.truncate(sto._data_end if hasattr(sto, "_data_end")
                   else os.path.getsize(sto.path) - 8)
        sto._has_trailer = False
    f.seek(0, os.SEEK_END)
    chunk_meta = struct.pack("<d", float(len(boxes)))
    for frm, size in boxes:
        chunk_meta += np.asarray(frm, dtype="<f8").tobytes()
        chunk_meta += np.asarray(size, dtype="<f8").tobytes()
    f.write(chunk_meta)
    sto.header_crc = _crc(chunk_meta, sto.header_crc)

    itemsize = sto.dtype.itemsize
    new_blocks = []
    off = f.tell()
    for frm, size in boxes:
        new_blocks.append(_Block(frm=frm, size=size, values_offset=off))
        off += volume(size) * itemsize
    # the zeroed values: the file is extended over them (the bytes read
    # as zeros, as if written), then the CRCs of zeros follow
    f.truncate(off)
    f.seek(off)
    if sto.checksum_level == 2:
        for i, blk in enumerate(new_blocks):
            blk.checksum_offset = off + 8 * i
            crc = _zeros_blocked_crc(volume(blk.size) * itemsize, sto.checksum_blocksize)
            f.write(struct.pack("<d", float(crc)))
    sto.blocks.extend(new_blocks)
    sto._grid = None          # spatial index rebuilt lazily on next query
    sto._data_end = f.tell()

    sto.num_chunks += 1
    f.seek(sto._num_chunks_off)
    f.write(struct.pack("<d", float(sto.num_chunks)))
    f.flush()


class _GridHash:
    """Coarse-grid spatial index over declared blocks (the reference's
    GridHash, storage.h:552-684): blocks are bucketed into toroidal grid
    cells whose extent is at least the largest block extent per axis, so
    every block touches at most 2 cells per axis and a query inspects
    only the blocks of the cells its request box covers — O(cells +
    candidates) instead of O(nblocks) per save/load."""

    def __init__(self, dim, blocks):
        nd = len(dim)
        self.dim = dim
        cell_min = [max((b.size[a] for b in blocks), default=1) or 1
                    for a in range(nd)]
        self.ncells = tuple(max(1, d // max(1, c))
                            for d, c in zip(dim, cell_min))
        # boundaries at i*cell; the last cell absorbs the remainder
        self.cell = tuple(-(-d // n) for d, n in zip(dim, self.ncells))
        self.buckets = {}
        for idx, b in enumerate(blocks):
            if volume(b.size) == 0:
                continue
            for ci in self._cells_of(b.frm, b.size):
                self.buckets.setdefault(ci, []).append(idx)

    def _axis_cells(self, f, s, ax):
        d, c, n = self.dim[ax], self.cell[ax], self.ncells[ax]
        if s >= d:
            return range(n)
        out = []
        pos = f % d
        remaining = s
        while remaining > 0:
            ci = min(pos // c, n - 1)
            out.append(ci)
            nxt = d if ci == n - 1 else (ci + 1) * c
            step = nxt - pos
            pos = (pos + step) % d
            remaining -= step
        return out

    def _cells_of(self, frm, size):
        import itertools as _it

        per_axis = [self._axis_cells(f, s, a)
                    for a, (f, s) in enumerate(zip(frm, size))]
        return _it.product(*per_axis)

    def query(self, frm, size):
        """Candidate block indices whose cells the request box touches."""
        out = set()
        for ci in self._cells_of(frm, size):
            out.update(self.buckets.get(ci, ()))
        return sorted(out)


# below this count a linear sweep beats building/consulting the index
_GRID_MIN_BLOCKS = 64


def _split_at_seams(ff, fs, seams, dim):
    """Split the toroidal box (ff, fs) so every piece maps CONTIGUOUSLY
    into the local frame of each origin in ``seams``.

    The local coordinate (a - origin) % D is affine except where the box
    crosses a ≡ origin (mod D); a fragment from a wrapped-box
    intersection can cross the seam of the *other* box even though it is
    contained in both (the wrapped-x-wrapped pitfall of the repo's
    working notes — this instance was found by the storage fuzz: an
    unsplit fragment placed through `(ifrom - frm) % dim` spills past
    the request extent)."""
    boxes = [(tuple(ff), tuple(fs))]
    for ax in range(len(dim)):
        out = []
        for (f, s) in boxes:
            cuts = {0, s[ax]}
            for origin in seams:
                c = (origin[ax] - f[ax]) % dim[ax]
                if 0 < c < s[ax]:
                    cuts.add(c)
            cs = sorted(cuts)
            for p0, p1 in zip(cs[:-1], cs[1:]):
                nf = list(f)
                nz = list(s)
                nf[ax] = (f[ax] + p0) % dim[ax]
                nz[ax] = p1 - p0
                out.append((tuple(nf), tuple(nz)))
        boxes = out
    return boxes


def _block_intersections(sto: Storage, frm, size):
    """All (block, ifrom, isize) overlaps of the toroidal request box with
    the declared blocks — the reference's GridHash spatial query
    (storage.h:552-684).  Large manifests go through the coarse-grid
    index; the exact intersections use the native C++ batch sweep when
    available, else the Python box algebra.  Every yielded fragment is
    seam-split so it maps contiguously into BOTH the request's and the
    block's local frames (see :func:`_split_at_seams`)."""
    if not sto.blocks:
        return
    from . import native

    if len(sto.blocks) >= _GRID_MIN_BLOCKS:
        if sto._grid is None:
            sto._grid = _GridHash(sto.dim, sto.blocks)
        cand = sto._grid.query(frm, size)
        blocks = [sto.blocks[i] for i in cand]
    else:
        blocks = sto.blocks

    rows = native.intersect_all(
        [[frm, size]],
        [[b.frm, b.size] for b in blocks], sto.dim) if blocks else None
    if rows is not None:
        nd = sto.ndim
        for r in rows:
            isize = tuple(int(v) for v in r[2 + nd:2 + 2 * nd])
            if volume(isize) == 0:
                continue
            blk = blocks[int(r[1])]
            ifrom = tuple(int(v) for v in r[2:2 + nd])
            for pf, ps in _split_at_seams(ifrom, isize,
                                          (tuple(frm), blk.frm), sto.dim):
                yield blk, pf, ps
        return
    for blk in blocks:
        for ifrom, isize in intersect_box(frm, size, blk.frm, blk.size,
                                          sto.dim):
            if volume(isize):
                for pf, ps in _split_at_seams(ifrom, isize,
                                              (tuple(frm), blk.frm),
                                              sto.dim):
                    yield blk, pf, ps


def _is_tensor(x) -> bool:
    return cplx.is_carray(x) or isinstance(x, torch.Tensor)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host copy of a tensor (bf16 and f16 read as f32)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.detach().contiguous().cpu().numpy()


def _to_numpy(x) -> np.ndarray:
    """A tensor, a CArray (as complex) or an array-like as numpy."""
    if cplx.is_carray(x):
        re, im = x.re, x.im
        if re.dtype not in (torch.float32, torch.float64):
            re, im = re.float(), im.float()
        return _to_host(torch.complex(re, im))
    if isinstance(x, torch.Tensor):
        return _to_host(x)
    return np.asarray(x)


def _read_block(sto: Storage, blk: _Block) -> np.ndarray:
    with sto._lock:
        f = sto._open()
        f.seek(blk.values_offset)
        n = volume(blk.size)
        dt = (sto.dtype.newbyteorder(">") if sto.byteswap
              else sto.dtype.newbyteorder("<"))
        arr = np.frombuffer(f.read(n * sto.dtype.itemsize), dtype=dt)
    return arr.astype(sto.dtype).reshape(blk.size)


def _read_block_rows(sto: Storage, blk: _Block, r0: int,
                     r1: int) -> np.ndarray:
    """Read only leading-axis rows [r0, r1) of a block — the windowed
    subrange read (storage.h:1326-1420 seeks per request, not per
    block), so streaming loads never materialize a whole block."""
    row_elems = volume(blk.size[1:]) if len(blk.size) > 1 else 1
    with sto._lock:
        f = sto._open()
        f.seek(blk.values_offset + r0 * row_elems * sto.dtype.itemsize)
        n = (r1 - r0) * row_elems
        dt = (sto.dtype.newbyteorder(">") if sto.byteswap
              else sto.dtype.newbyteorder("<"))
        arr = np.frombuffer(f.read(n * sto.dtype.itemsize), dtype=dt)
    return arr.astype(sto.dtype).reshape((r1 - r0,) + tuple(blk.size[1:]))


def _write_block(sto: Storage, blk: _Block, data: np.ndarray) -> None:
    with sto._lock:
        f = sto._open()
        f.seek(blk.values_offset)
        # match the file's declared endianness: a byteswapped (big-endian,
        # reference-written) storage must be written back big-endian or a
        # read-modify-write through save() silently corrupts the block
        # (and its level-2 checksum would be computed on the wrong bytes)
        dt = (sto.dtype.newbyteorder(">") if sto.byteswap
              else sto.dtype.newbyteorder("<"))
        raw = memoryview(np.ascontiguousarray(data.astype(dt, copy=False))).cast("B")
        f.write(raw)
        if sto.checksum_level == 2 and blk.checksum_offset >= 0:
            crc = _blocked_crc(raw, sto.checksum_blocksize)
            f.seek(blk.checksum_offset)
            f.write(struct.pack("<d", float(crc)))
        f.flush()


def save(alpha, x, o0: str, sto: Storage, o1: str,
         from0=None, size0=None, from1=None) -> None:
    """Write alpha * x[from0:from0+size0] into the file tensor at from1
    (public save, storage.h:2261 -> 1200).  Every overlap with a declared
    block is updated; regions outside all blocks are an error, as in the
    reference (the file is sparse: only declared blocks exist)."""
    check_order(o0)
    check_order(o1)
    from1 = tuple(from1) if from1 is not None else (0,) * len(o1)
    _write_region(sto, _stage(alpha, x, o0, o1, from0, size0), from1)


def _stage(alpha, x, o0: str, o1: str, from0, size0) -> np.ndarray:
    """alpha * x[from0:from0+size0] in the file's label order ``o1``, on
    the host: a tensor's box is cut and permuted on its own device, then
    copied to the host once."""
    from0 = tuple(from0) if from0 is not None else (0,) * len(o0)
    size0 = tuple(size0) if size0 is not None else tuple(x.shape)
    if _is_tensor(x):
        src = _to_numpy(cplx.cmap(lambda v: _permute_to(_extract_box(v, from0, size0),
                                                        o0, o1), x)
                        if cplx.is_carray(x)
                        else _permute_to(_extract_box(x, from0, size0), o0, o1))
    else:
        src = _permute_np(_extract_box_np(np.asarray(x), from0, size0), o0, o1)
    if not (isinstance(alpha, (int, float, complex)) and alpha == 1):
        src = src * alpha
    return src


def _write_region(sto: Storage, src: np.ndarray, from1) -> None:
    """Write ``src`` (in file label order) into the file tensor at from1."""
    size1 = src.shape
    # coverage must count UNIQUE request cells: overlapping blocks
    # produce multiple fragments over the same cells, and a fragment-
    # volume sum would mask genuinely uncovered cells (review-caught)
    covered = np.zeros(size1, dtype=bool)
    with sto._lock:   # atomic read-modify-write across the whole save
      for blk, ifrom, isize in _block_intersections(sto, from1, size1):
        # offsets of the intersection inside the source box and block
        src_off = tuple((f - g) % d for f, g, d in
                        zip(ifrom, from1, sto.dim))
        blk_off = tuple((f - g) % d for f, g, d in
                        zip(ifrom, blk.frm, sto.dim))
        sl_src = tuple(slice(o, o + s) for o, s in zip(src_off, isize))
        sl_blk = tuple(slice(o, o + s) for o, s in zip(blk_off, isize))
        covered[sl_src] = True
        if tuple(isize) == tuple(blk.size):
            # the whole block is written: its old values are not read
            data = np.asarray(src[sl_src], dtype=sto.dtype)
        else:
            data = _read_block(sto, blk)
            data[sl_blk] = src[sl_src]
        _write_block(sto, blk, data)
    if not covered.all():
        raise ValueError(
            "save: part of the requested region is not covered by any "
            "declared block (use append_blocks first)")


def load(alpha, sto: Storage, x, o1: str, o0: Optional[str] = None,
         from0=None, size0=None, from1=None, copy_add: str = "copy"):
    """Read the file region (from0, size0) and copy/add it into ``x`` at
    from1 (public load, storage.h:2291 -> 1326).  Returns the updated
    array.  Uncovered parts of the request are left untouched."""
    check_order(o1)
    o0 = o0 or sto.order or o1
    from0 = tuple(from0) if from0 is not None else (0,) * sto.ndim
    size0 = tuple(size0) if size0 is not None else sto.dim
    from1 = tuple(from1) if from1 is not None else (0,) * len(o1)
    perm01 = find_permutation(o0, o1)
    size1 = reorder_coor(size0, perm01, blank=1)

    # assemble the requested file region (in file order), then permute
    region = np.zeros(size0, dtype=sto.dtype)
    for blk, ifrom, isize in _block_intersections(sto, from0, size0):
        data = _read_block(sto, blk)
        req_off = tuple((f - g) % d for f, g, d in
                        zip(ifrom, from0, sto.dim))
        blk_off = tuple((f - g) % d for f, g, d in
                        zip(ifrom, blk.frm, sto.dim))
        sl_req = tuple(slice(o, o + s) for o, s in zip(req_off, isize))
        sl_blk = tuple(slice(o, o + s) for o, s in zip(blk_off, isize))
        region[sl_req] = data[sl_blk]

    if alpha != 1:
        region = region * alpha
    sl_dst = tuple(slice(f, f + s) for f, s in zip(from1, size1))
    if not _is_tensor(x):
        arr = np.asarray(x).copy()
        region = _permute_np(region, o0, o1)
        if copy_add == "copy":
            arr[sl_dst] = region
        else:
            arr[sl_dst] = arr[sl_dst] + region
        return arr
    # one host-to-device copy, the permutation on the device
    dev = x.device
    reg = _permute_to(torch.from_numpy(np.ascontiguousarray(region)).to(dev), o0, o1)
    complex_reg = reg.is_complex()

    def place(dst, part):
        dst = dst.clone()
        if copy_add == "copy":
            dst[sl_dst] = part.to(dst.dtype)
        else:
            dst[sl_dst] = (dst[sl_dst] + part).to(dst.dtype)
        return dst

    if cplx.is_carray(x):
        im = reg.imag if complex_reg else torch.zeros_like(reg)
        return cplx.CArray(place(x.re, reg.real if complex_reg else reg), place(x.im, im))
    if complex_reg and not x.is_complex():
        reg = reg.real
    return place(x, reg)


def load_stream(sto: Storage, from0=None, size0=None,
                max_window_bytes: int = 256 << 20):
    """Stream the requested file region as (window_from, window_data)
    pairs WITHOUT assembling it in host memory — the windowed-read analog
    of the reference's MPI-IO reads (storage.h:1326-1420), for tensors
    bigger than host RAM.

    Windows are slabs of whole leading-axis rows of the request, each at
    most ``max_window_bytes``; every yielded window is fully assembled
    (all intersecting blocks applied) and in file label order.  Blocks
    are read by leading-axis SUBRANGE (only the rows a window touches),
    so a single full-tensor block never gets materialized whole — host
    memory stays O(window) even for bigger-than-RAM files.
    """
    from0 = tuple(from0) if from0 is not None else (0,) * sto.ndim
    size0 = tuple(size0) if size0 is not None else sto.dim
    row_bytes = volume(size0[1:]) * sto.dtype.itemsize
    rows = max(1, min(size0[0], max_window_bytes // max(row_bytes, 1)))
    for r0 in range(0, size0[0], rows):
        wfrom = ((from0[0] + r0) % sto.dim[0],) + from0[1:]
        wsize = (min(rows, size0[0] - r0),) + size0[1:]
        window = np.zeros(wsize, dtype=sto.dtype)
        for blk, ifrom, isize in _block_intersections(sto, wfrom, wsize):
            req_off = tuple((f - g) % d for f, g, d in
                            zip(ifrom, wfrom, sto.dim))
            blk_off = tuple((f - g) % d for f, g, d in
                            zip(ifrom, blk.frm, sto.dim))
            data = _read_block_rows(sto, blk, blk_off[0],
                                    blk_off[0] + isize[0])
            sl_req = tuple(slice(o, o + s) for o, s in zip(req_off, isize))
            sl_blk = (slice(0, isize[0]),) + tuple(
                slice(o, o + s) for o, s in zip(blk_off[1:], isize[1:]))
            window[sl_req] = data[sl_blk]
        yield wfrom, window


def _write_block_rows(sto: Storage, blk: _Block, r0: int,
                      data: np.ndarray) -> None:
    """Write leading-axis rows [r0, r0 + len(data)) of a block — the
    windowed subrange write mirroring :func:`_read_block_rows` (the
    reference seeks per request through MPI-IO, storage.h:1002-1094).
    Level-2 per-block checksums are NOT updated here; callers
    recompute them once all rows landed (:func:`_refresh_block_crc`)."""
    row_elems = volume(blk.size[1:]) if len(blk.size) > 1 else 1
    dt = (sto.dtype.newbyteorder(">") if sto.byteswap
          else sto.dtype.newbyteorder("<"))
    raw = np.ascontiguousarray(data.astype(dt))
    with sto._lock:
        f = sto._open()
        f.seek(blk.values_offset + r0 * row_elems * sto.dtype.itemsize)
        f.write(raw.tobytes())
        f.flush()


def _refresh_block_crc(sto: Storage, blk: _Block,
                       max_window_bytes: int = 256 << 20) -> None:
    """Recompute a block's level-2 CRC by STREAMING its bytes in
    checksum-blocksize-aligned windows — the CRC-of-CRCs scheme
    (storage.h:698-730) builds the piece array incrementally, so host
    memory stays O(window) even for bigger-than-RAM blocks."""
    if sto.checksum_level != 2 or blk.checksum_offset < 0:
        return
    bs = sto.checksum_blocksize
    total = volume(blk.size) * sto.dtype.itemsize
    with sto._lock:
        f = sto._open()
        if bs <= 0:
            # blocking disabled: _blocked_crc is the PLAIN CRC of the
            # data (no piece wrapping, storage.h:698-730) — stream it
            # incrementally through zlib's running CRC
            crc = 0
            off = 0
            while off < total:
                f.seek(blk.values_offset + off)
                chunk = f.read(min(max_window_bytes, total - off))
                crc = _crc(chunk, crc)
                off += len(chunk)
        else:
            win = max(bs, (max_window_bytes // bs) * bs)
            pieces = []
            off = 0
            while off < total:
                f.seek(blk.values_offset + off)
                chunk = f.read(min(win, total - off))
                for i in range(0, len(chunk), bs):
                    pieces.append(_crc(chunk[i:i + bs]))
                off += len(chunk)
            if not pieces:
                pieces = [_crc(b"")]  # num_blocks >= 1, as _blocked_crc
            crc = _crc(np.asarray(pieces, dtype="<u4").tobytes())
        f.seek(blk.checksum_offset)
        f.write(struct.pack("<d", float(crc)))
        f.flush()


def save_stream(sto: Storage, windows, max_window_bytes: int = 256 << 20
                ) -> None:
    """Write a stream of (window_from, window_data) pairs — the
    write-side mirror of :func:`load_stream`, for tensors bigger than
    host RAM (the reference writes per-block windows through MPI-IO
    seeks, storage.h:1002-1094).  Windows are boxes in FILE label order
    (exactly what ``load_stream`` yields, so
    ``save_stream(dst, load_stream(src))`` streams a file-to-file copy
    at O(window) host memory).

    Each window is scattered into every declared block it intersects by
    leading-axis row-subrange writes; rows narrower than the block are
    read-modified-written at row granularity, so no whole block or
    whole-tensor coverage bitmap is ever materialized.  A window region
    outside all declared blocks raises, as in :func:`save`.  Level-2
    per-block checksums are recomputed once per TOUCHED block after the
    stream ends (streamed too — :func:`_refresh_block_crc`)."""
    touched = []
    seen = set()
    for wfrom, wdata in windows:
        wfrom = tuple(int(v) for v in wfrom)
        if _is_tensor(wdata):
            wdata = _to_numpy(wdata)
        wsize = wdata.shape
        covered = np.zeros(wsize, dtype=bool)
        with sto._lock:
            for blk, ifrom, isize in _block_intersections(sto, wfrom,
                                                          wsize):
                req_off = tuple((f - g) % d for f, g, d in
                                zip(ifrom, wfrom, sto.dim))
                blk_off = tuple((f - g) % d for f, g, d in
                                zip(ifrom, blk.frm, sto.dim))
                sl_req = tuple(slice(o, o + s)
                               for o, s in zip(req_off, isize))
                covered[sl_req] = True
                r0, r1 = blk_off[0], blk_off[0] + isize[0]
                full_rows = isize[1:] == blk.size[1:]
                if full_rows:
                    rows = wdata[sl_req]
                else:
                    # narrower than the block: read-modify-write at row
                    # granularity (still O(window) host memory)
                    rows = _read_block_rows(sto, blk, r0, r1)
                    sub = (slice(None),) + tuple(
                        slice(o, o + s)
                        for o, s in zip(blk_off[1:], isize[1:]))
                    rows[sub] = wdata[sl_req]
                _write_block_rows(sto, blk, r0, rows)
                if blk.values_offset not in seen:
                    seen.add(blk.values_offset)
                    touched.append(blk)
        if not covered.all():
            raise ValueError(
                "save_stream: part of a window is not covered by any "
                "declared block (use append_blocks first)")
    for blk in touched:
        _refresh_block_crc(sto, blk, max_window_bytes)


def _extract_box_np(arr, frm, size):
    for ax, (f, s, d) in enumerate(zip(frm, size, arr.shape)):
        if f + s > d:
            arr = np.take(arr, np.arange(f, f + s) % d, axis=ax)
        else:
            arr = arr[(slice(None),) * ax + (slice(f, f + s),)]
    return arr


def _permute_np(arr, o0, o1):
    keep = [i for i, c in enumerate(o0) if c in o1]
    arr = arr.reshape([arr.shape[i] for i in keep]) if len(keep) != len(o0) \
        else arr
    o0k = "".join(o0[i] for i in keep)
    order_in_o1 = [c for c in o1 if c in o0k]
    arr = np.transpose(arr, [o0k.index(c) for c in order_in_o1])
    if len(order_in_o1) != len(o1):
        shape = []
        k = 0
        for c in o1:
            if c in o0k:
                shape.append(arr.shape[k])
                k += 1
            else:
                shape.append(1)
        arr = arr.reshape(shape)
    return arr


def check_or_write_checksums(sto: Storage) -> None:
    """Verify (read-only) or write the trailing global checksum
    (storage.h:1964-2125)."""
    if sto.checksum_level == 0:
        return
    f = sto._open()
    if sto.checksum_level == 1:
        f.seek(0, os.SEEK_END)
        end = f.tell()
        f.seek(0)
        body = f.read(end)
        # A previously written trailer is excluded from the crc
        if sto.mode != "r" and not getattr(sto, "_has_trailer", False):
            crc = _blocked_crc(body, sto.checksum_blocksize)
            f.seek(0, os.SEEK_END)
            f.write(struct.pack("<d", float(crc)))
            sto._has_trailer = True
        else:
            crc = _blocked_crc(body[:-8], sto.checksum_blocksize)
            stored = int(struct.unpack("<d", body[-8:])[0])
            if stored != crc:
                raise ValueError(f"{sto.path}: global checksum mismatch")
    else:  # level 2
        for blk in sto.blocks:
            # the block's bytes as stored: what the reference's re-encoding
            # of the read values gives, without the two conversions
            with sto._lock:
                f.seek(blk.values_offset)
                raw = f.read(volume(blk.size) * sto.dtype.itemsize)
            crc = _blocked_crc(raw, sto.checksum_blocksize)
            f.seek(blk.checksum_offset)
            stored = int(struct.unpack("<d", f.read(8))[0])
            if stored != crc:
                raise ValueError(
                    f"{sto.path}: block checksum mismatch at {blk.frm}")
        # trailing header checksum (storage.h:2099-2116): crc of the file
        # excluding num_chunks / values / per-block checksums
        data_end = getattr(sto, "_data_end", None)
        if data_end is None:
            f.seek(0, os.SEEK_END)
            data_end = f.tell() - (8 if getattr(sto, "_has_trailer", False)
                                   else 0)
        if sto.mode != "r" and not getattr(sto, "_has_trailer", False):
            f.seek(data_end)
            f.write(struct.pack("<d", float(sto.header_crc)))
            sto._has_trailer = True
            f.flush()
        elif getattr(sto, "_has_trailer", False):
            f.seek(data_end)
            stored = int(struct.unpack("<d", f.read(8))[0])
            if stored != sto.header_crc:
                raise ValueError(f"{sto.path}: header checksum mismatch")


def read_storage_header(path: str):
    """Header fields only — ``(dtype, metadata, dim, checksum_level)`` —
    without keeping a handle or the block index around
    (read_storage_header, storage.h:2161, 2405)."""
    sto = open_storage(path, mode="r")
    return sto.dtype, sto.metadata, sto.dim, sto.checksum_level


def get_blocks(sto: Storage, o0: str, o1: Optional[str] = None,
               from1=None, size1=None):
    """(from, size) boxes — in DESTINATION order ``o1`` — of the stored
    blocks overlapping the window ``[from1, from1+size1)`` of a load into
    a tensor ordered ``o1`` (get_blocks, storage.h:1397-1420, 2330-2344).

    Each returned box is one contiguous fragment: toroidal overlaps are
    seam-split exactly as :func:`load` consumes them, so the result is a
    ready-made read plan.  ``o0`` is the storage's label order; labels of
    ``o1`` absent from ``o0`` behave as extent-1 axes."""
    check_order(o0)
    if len(o0) != sto.ndim:
        raise ValueError(
            f"o0 length {len(o0)} does not match storage rank {sto.ndim}")
    if o1 is None:
        o1 = o0
    check_order(o1)
    perm1 = find_permutation(o1, o0)   # dest coor -> storage coor
    perm0 = find_permutation(o0, o1)   # storage coor -> dest coor
    dim1 = reorder_coor(sto.dim, perm0, 1)
    if from1 is None:
        from1 = (0,) * len(o1)
    if size1 is None:
        size1 = dim1
    from0 = reorder_coor(tuple(from1), perm1, 0)
    size0 = reorder_coor(tuple(size1), perm1, 1)
    out = []
    for _blk, ifrom, isize in _block_intersections(sto, from0, size0):
        rel0 = tuple((i - f) % d for i, f, d in zip(ifrom, from0, sto.dim))
        dfrm = tuple((f1 + r) % d for f1, r, d in zip(
            from1, reorder_coor(rel0, perm0, 0), dim1))
        out.append((dfrm, reorder_coor(isize, perm0, 1)))
    return out


def preallocate_storage(sto: Storage, size: int) -> None:
    """Reserve ``size`` bytes of physical allocation for the file — a
    filesystem hint that avoids fragmentation during large block appends
    (preallocate_storage, storage.h:2427).  KEEP_SIZE semantics: the
    LOGICAL file layout (append offsets, trailer position) is unchanged,
    so this is safe at any point; best-effort (silently a no-op where
    fallocate is unavailable)."""
    if sto.mode == "r":
        raise ValueError("storage opened read-only")
    with sto._lock:
        f = sto._open()
        f.flush()
        try:
            import ctypes
            import ctypes.util

            libc = ctypes.CDLL(ctypes.util.find_library("c")
                               or "libc.so.6", use_errno=True)
            FALLOC_FL_KEEP_SIZE = 0x01
            libc.fallocate(ctypes.c_int(f.fileno()),
                           ctypes.c_int(FALLOC_FL_KEEP_SIZE),
                           ctypes.c_longlong(0),
                           ctypes.c_longlong(int(size)))
        except Exception:
            pass


def flush_storage(sto: Storage) -> None:
    """Resolve pending asynchronous writes and push buffered bytes to the
    OS so other processes observe them (flush_storage, storage.h:2434 —
    the reference resolves its pending MPI_File_iwrite requests the same
    way)."""
    with sto._lock:
        pending = list(sto._pending)
        sto._pending.clear()
    # wait OUTSIDE the lock: the IO-pool writers take sto._lock per write
    for fut in pending:
        fut.result()
    with sto._lock:
        if sto._file is not None and not sto._file.closed:
            sto._file.flush()
            os.fsync(sto._file.fileno())


def close_storage(sto: Storage) -> None:
    """Resolve pending async writes, write pending checksums and close
    (close_storage, storage.h:2451-2462: flush + checksums on close)."""
    if sto._pending:
        flush_storage(sto)
    if sto.mode != "r" and sto.checksum_level != 0:
        try:
            check_or_write_checksums(sto)
        except ValueError:
            raise
    if sto._file is not None and not sto._file.closed:
        sto._file.close()


# ---------------------------------------------------------------------------
# asynchronous writes (MPI_File_iwrite_at analog, storage.h:294-342)
# ---------------------------------------------------------------------------

_io_pool = None


def _get_io_pool():
    global _io_pool
    if _io_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _io_pool = ThreadPoolExecutor(max_workers=4,
                                      thread_name_prefix="sbt-io")
    return _io_pool


def save_async(alpha, x, o0: str, sto: Storage, o1: str, **kw):
    """Asynchronous :func:`save`: a tensor is copied to the host
    synchronously (one device-to-host copy) and the file write runs on an
    IO thread.  Returns a future; call ``.result()`` — or pass
    it to :func:`context.wait` — before closing the storage.  The
    reference posts MPI_File_iwrite_at the same way and resolves the
    pending requests on flush (storage.h:294-342)."""
    check_order(o0)
    check_order(o1)
    # sync point: snapshot the values now, in file order on the host
    src = _stage(alpha, x, o0, o1, kw.get("from0"), kw.get("size0"))
    if not _is_tensor(x) and np.shares_memory(src, np.asarray(x)):
        src = src.copy()
    from1 = kw.get("from1")
    from1 = tuple(from1) if from1 is not None else (0,) * len(o1)
    fut = _get_io_pool().submit(_write_region, sto, src, from1)
    with sto._lock:
        sto._pending.append(fut)
    return fut




# ---------------------------------------------------------------------------
# sharded (distributed) checkpointing: the MPI-IO parallel-write analog
# ---------------------------------------------------------------------------


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default process group ((0, 1) without
    one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_box(x):
    """(from, size) of this rank's shard of a DTensor (or CArray of them;
    the whole array for a plain tensor) and its local data."""
    from torch.distributed.tensor import DTensor

    from .parallel.mesh import sharding_partition

    a = x.re if cplx.is_carray(x) else x
    if not isinstance(a, DTensor):
        return ((0,) * a.ndim, tuple(int(d) for d in a.shape)), x
    r = a.device_mesh.get_rank()
    ranks = a.device_mesh.mesh.reshape(-1).tolist()
    box = sharding_partition(a, tuple(a.shape)).boxes[sorted(ranks).index(r)]
    loc = (cplx.CArray(x.re.to_local(), x.im.to_local()) if cplx.is_carray(x)
           else a.to_local())
    return box, loc


def _shard_boxes(x) -> Tuple[list, int]:
    """The unique nonempty shard boxes of ALL ranks, in rank order (an
    ``all_gather_object`` of each rank's box), and the index of this
    rank's box there, or -1 where an earlier rank holds the same box (a
    replica writes once)."""
    import torch.distributed as dist

    box, _ = _local_box(x)
    r, n = _world()
    allb = [box]
    if n > 1:
        allb = [None] * n
        dist.all_gather_object(allb, box)
    boxes, first = [], {}
    for i, b in enumerate(allb):
        b = (tuple(int(v) for v in b[0]), tuple(int(v) for v in b[1]))
        if volume(b[1]) and b not in first:
            first[b] = i
            boxes.append(b)
    mine = (tuple(box[0]), tuple(box[1]))
    return boxes, (boxes.index(mine) if first.get(mine) == r else -1)


def _sync_processes(tag: str) -> None:
    """Cross-process barrier (no-op with one process): the MPI_Barrier
    the reference's MPI-IO collective writes rely on
    (storage.h:202-342)."""
    import torch.distributed as dist

    if _world()[1] > 1:
        dist.barrier()


def _check(tag: str, payload) -> None:
    if flags.get_debug_level() >= 1:
        from .utils.testing import check_collective_consistency

        check_collective_consistency(tag, payload)


def _refresh_blocks(sto: Storage) -> None:
    """Re-read the chunk/block metadata from the file into this handle:
    how ranks other than 0 observe blocks DECLARED BY RANK 0 after the
    declare barrier (storage.h:1690-1750)."""
    with sto._lock:
        if sto._file is not None and not sto._file.closed:
            sto._file.close()
            sto._file = None
        fresh = open_storage(sto.path, mode=sto.mode)
        sto.blocks = fresh.blocks
        sto.num_chunks = fresh.num_chunks
        sto.header_crc = fresh.header_crc
        sto.checksum_level = fresh.checksum_level
        sto._grid = None
        sto._data_end = fresh._data_end
        sto._has_trailer = fresh._has_trailer
        sto._num_chunks_off = fresh._num_chunks_off


def create_storage_sharded(path: str, o: str, dim, dtype=np.float64,
                           metadata: str = "", checksum: int = 0) -> Storage:
    """Collective :func:`create_storage`: rank 0 writes the header, a
    barrier publishes it, every other rank opens the file read-write.
    With one process it is create_storage (storage.h:202-342)."""
    r, n = _world()
    if n <= 1:
        return create_storage(path, o, dim, dtype, metadata, checksum)
    tag = f"sbt:s3t:create:{os.path.basename(path)}"
    _check(tag, ("create", o, tuple(int(d) for d in dim), np.dtype(dtype).str,
                 int(checksum)))
    if r == 0:
        sto = create_storage(path, o, dim, dtype, metadata, checksum)
        _sync_processes(tag)
        return sto
    _sync_processes(tag)
    sto = open_storage(path, mode="r+")
    sto.order = o
    return sto


def close_storage_sharded(sto: Storage) -> None:
    """Collective :func:`close_storage`: every rank's writes land, a
    barrier, then ONLY rank 0 writes the checksums (the reference gathers
    per-block CRCs to rank 0, storage.h:1964-2125)."""
    r, n = _world()
    if n <= 1:
        close_storage(sto)
        return
    if sto._pending:
        flush_storage(sto)
    elif sto._file is not None and not sto._file.closed:
        sto._file.flush()
    tag = f"sbt:s3t:close:{os.path.basename(sto.path)}"
    _check(tag, ("close",))
    _sync_processes(tag)
    if r == 0:
        close_storage(sto)
    elif sto._file is not None and not sto._file.closed:
        sto._file.close()
    _sync_processes(f"sbt:s3t:closed:{os.path.basename(sto.path)}")


def _declare_coordinated(sto: Storage, boxes) -> None:
    """Declare ``boxes`` exactly once across ranks: rank 0 appends the
    chunk (when the file has none yet), a barrier publishes it, the
    others re-read the block table.  Every rank calls this on every
    save; only rank 0 decides, under the barrier."""
    r, n = _world()
    if n <= 1:
        if not sto.blocks:
            append_blocks(sto, boxes)
        return
    seq = getattr(sto, "_declare_seq", 0)
    sto._declare_seq = seq + 1
    tag = f"sbt:s3t:declare:{os.path.basename(sto.path)}:{seq}"
    _check(tag, ("declare", tuple((tuple(int(v) for v in f), tuple(int(v) for v in s))
                                  for f, s in boxes)))
    if r == 0 and not sto.blocks:
        append_blocks(sto, boxes)
    _sync_processes(tag)
    if r != 0:
        _refresh_blocks(sto)


def _snapshot(sto: Storage, x, o: str):
    """Declare the blocks, then (block, host data) of this rank's shard,
    or None where it writes nothing."""
    check_order(o)
    a = x.re if cplx.is_carray(x) else x
    if len(o) != a.ndim:
        raise ValueError("order length must match array rank")
    boxes, mine = _shard_boxes(x)
    _declare_coordinated(sto, boxes)
    if mine < 0:
        return None
    box, loc = _local_box(x)
    blk = {(b.frm, b.size): b for b in sto.blocks}.get((tuple(box[0]), tuple(box[1])))
    if blk is None:
        raise ValueError(f"shard box {box} has no declared block; the file was "
                         "created with a different sharding")
    return blk, _to_numpy(loc).astype(sto.dtype)


def save_sharded(sto: Storage, x, o: str) -> None:
    """Write a sharded DTensor (or CArray of them), one S3T block per
    rank's shard (the reference's collective MPI-IO write,
    storage.h:202-342, 1002-1094): the blocks are declared on first save
    by rank 0, each rank then writes its own shard's bytes (one
    device-to-host copy) to its disjoint file region.  The file is a
    plain S3T tensor: ``load`` or the reference reads it with any
    partitioning."""
    snap = _snapshot(sto, x, o)
    if snap is not None:
        _write_block(sto, *snap)


def save_sharded_async(sto: Storage, x, o: str):
    """Asynchronous :func:`save_sharded`: the declare and the shard's
    host snapshot are synchronous, the block write runs on the IO pool.
    Returns a future."""
    snap = _snapshot(sto, x, o)

    def write():
        if snap is not None:
            _write_block(sto, *snap)

    fut = _get_io_pool().submit(write)
    with sto._lock:
        sto._pending.append(fut)
    return fut


def load_sharded(sto: Storage, sharding, dtype=None):
    """Read an S3T tensor directly into a sharded DTensor (a CArray of two
    for complex files): each rank assembles only its own shard from the
    file blocks it intersects (the reference's distributed ``load``,
    storage.h:1110-1186).  ``sharding``: a NamedSharding (the DTensor's
    mesh and spec) or a SingleDeviceSharding (the whole tensor on that
    rank, an empty tensor elsewhere).  ``dtype``: the real dtype of the
    result's parts (the file's precision by default).  The shard lands on
    the current CUDA device for a CUDA mesh, else on the CPU."""
    from torch.distributed.tensor import DTensor

    from .parallel._local import c_strides
    from .parallel.mesh import NamedSharding, device_mesh

    shape = tuple(sto.dim)
    complex_out = np.issubdtype(sto.dtype, np.complexfloating)
    if dtype is None:
        dtype = ((torch.float32 if sto.dtype == np.complex64 else torch.float64)
                 if complex_out else torch.from_numpy(np.zeros(0, sto.dtype)).dtype)
    r, n = _world()
    boxes = sharding.boxes(shape)
    if isinstance(sharding, NamedSharding):
        dm = device_mesh(sharding.mesh)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dm.device_type == "cuda" else torch.device("cpu"))
        ranks = sorted(dm.mesh.reshape(-1).tolist())
        frm, size = boxes[ranks.index(r)]
    else:
        dm = None
        device = torch.device("cpu")
        frm, size = boxes[0] if r == sharding.rank else ((0,) * len(shape), (0,) * len(shape))
    out = np.zeros(size, dtype=sto.dtype)
    if volume(size):
        for blk, ifrom, isize in _block_intersections(sto, frm, size):
            data = _read_block(sto, blk)
            roff = tuple((f - g) % d for f, g, d in zip(ifrom, frm, sto.dim))
            boff = tuple((f - g) % d for f, g, d in zip(ifrom, blk.frm, sto.dim))
            out[tuple(slice(a, a + s) for a, s in zip(roff, isize))] = \
                data[tuple(slice(a, a + s) for a, s in zip(boff, isize))]
    parts = ((out.real, out.imag) if complex_out else (out,))
    loc = [torch.from_numpy(np.ascontiguousarray(p)).to(device=device, dtype=dtype)
           for p in parts]
    if dm is not None:
        loc = [DTensor.from_local(t, dm, sharding.placements(), run_check=False,
                                  shape=shape, stride=c_strides(shape)) for t in loc]
    return cplx.CArray(*loc) if complex_out else loc[0]
