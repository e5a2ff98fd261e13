"""superbblas_tpu_torch.storage against superbblas_tpu.storage: the S3T
files the two packages write from the same numpy inputs are
byte-identical (checksum levels 0, 1 and 2, real and complex), each
package reads the other's files, and the cases of tests/test_storage.py
(partial and permuted loads, windows of load_stream and save_stream,
get_blocks, big-endian files, corruption, save_async resolved by
flush_storage and close_storage) give the JAX package's results.  The
cross-validation against the reference C++ library runs where its
headers are, as tests/test_storage_xval.py does."""

import os
import shutil
import struct
import subprocess
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superbblas_tpu import cplx as JC
from superbblas_tpu import storage as JS
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch import storage as TS

import test_storage_xval as XV

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def rand(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape).astype(dtype)
    return x


def as_jax(x):
    return JC.from_complex(x) if np.iscomplexobj(x) else jnp.asarray(x)


def as_torch(x):
    return TC.from_complex(x) if np.iscomplexobj(x) else torch.from_numpy(x.copy())


def as_np(y):
    if TC.is_carray(y) or JC.is_carray(y):
        return np.asarray(y.re) + 1j * np.asarray(y.im)
    return np.asarray(y)


def write_both(tmp_path, dim, dtype, boxes, saves, checksum=0, o="xy", metadata=""):
    """Write the same file with each package: ``saves`` is a list of
    (alpha, numpy x, o0, kwargs) passed to ``save``.  Returns the paths."""
    paths = []
    for name, S, conv in (("jax", JS, as_jax), ("torch", TS, as_torch)):
        p = str(tmp_path / f"{name}.s3t")
        sto = S.create_storage(p, o, dim, dtype=dtype, metadata=metadata, checksum=checksum)
        S.append_blocks(sto, boxes)
        for alpha, x, o0, kw in saves:
            S.save(alpha, conv(x), o0, sto, o, **kw)
        S.close_storage(sto)
        paths.append(p)
    return paths


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_header_bytes_match_jax(tmp_path):
    for name, S in (("j", JS), ("t", TS)):
        S.close_storage(S.create_storage(str(tmp_path / name), "xyz", (4, 6, 2),
                                         dtype=np.complex64, metadata="hello", checksum=1))
    assert read(tmp_path / "j") == read(tmp_path / "t")
    assert TS.read_storage_header(str(tmp_path / "j")) == JS.read_storage_header(
        str(tmp_path / "t"))


@pytest.mark.parametrize("checksum", [0, 1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_files_byte_identical_and_cross_read(tmp_path, checksum, dtype):
    """Both packages write the same bytes (a permuted, scaled save into
    two blocks), each reads the other's file, and the port's load of a
    CArray or tensor equals JAX's bit for bit."""
    dim = (6, 4, 3)
    rng = np.random.default_rng(checksum)
    x = rand(rng, (4, 6, 3), dtype)
    pj, pt = write_both(tmp_path, dim, dtype, [((0, 0, 0), (3, 4, 3)), ((3, 0, 0), (3, 4, 3))],
                        [(1.5, x, "yxz", {})], checksum=checksum, o="xyz", metadata="m")
    assert read(pj) == read(pt)
    zero = np.zeros((4, 6, 3), dtype)
    for p_read_by_torch, p_read_by_jax in ((pj, pt), (pt, pj)):
        st = TS.open_storage(p_read_by_torch, mode="r")
        sj = JS.open_storage(p_read_by_jax, mode="r")
        if checksum:
            TS.check_or_write_checksums(st)
            JS.check_or_write_checksums(sj)
        got = TS.load(2.0, st, as_torch(zero), "yxz", "xyz")
        want = JS.load(2.0, sj, as_jax(zero), "yxz", "xyz")
        assert TC.is_carray(got) == JC.is_carray(want)
        np.testing.assert_array_equal(as_np(got), as_np(want))
        TS.close_storage(st)
        JS.close_storage(sj)


def test_partial_load_with_permutation_matches_jax(tmp_path):
    dim = (4, 6)
    x = np.arange(24, dtype=np.float64).reshape(dim)
    pj, pt = write_both(tmp_path, dim, np.float64, [((0, 0), dim)], [(1.0, x, "xy", {})])
    assert read(pj) == read(pt)
    st, sj = TS.open_storage(pt, "r"), JS.open_storage(pj, "r")
    kw = dict(from0=(1, 2), size0=(2, 3), from1=(0, 0))
    for copy_add in ("copy", "add"):
        got = TS.load(2.0, st, torch.ones((6, 4), dtype=torch.float64), "yx", "xy",
                      copy_add=copy_add, **kw)
        want = JS.load(2.0, sj, np.ones((6, 4)), "yx", "xy", copy_add=copy_add, **kw)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a numpy destination stays numpy, as in the JAX package
    got = TS.load(1.0, st, np.zeros((6, 4)), "yx", "xy", **kw)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.asarray(JS.load(1.0, sj, np.zeros((6, 4)), "yx",
                                                          "xy", **kw)))


def test_wrapped_partial_save_matches_jax(tmp_path):
    """A box that wraps around the source's edge, saved into a wrapped
    file window, and a partial save into a block: same bytes."""
    dim = (5, 6)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5))
    saves = [(1.0, x, "yx", dict(from0=(4, 3), size0=(4, 3), from1=(3, 5))),
             (3.0, np.ones((2, 2)), "xy", dict(from1=(1, 1)))]
    pj, pt = write_both(tmp_path, dim, np.float64, [((0, 0), dim)], saves, checksum=2)
    assert read(pj) == read(pt)


def test_save_outside_blocks_raises(tmp_path):
    sto = TS.create_storage(str(tmp_path / "t.s3t"), "xy", (4, 4), dtype=np.float64)
    TS.append_blocks(sto, [((0, 0), (2, 4))])
    with pytest.raises(ValueError, match="not covered"):
        TS.save(1.0, torch.ones((4, 4), dtype=torch.float64), "xy", sto, "xy")
    TS.close_storage(sto)


@pytest.mark.parametrize("level", [1, 2])
def test_checksum_detects_corruption(tmp_path, level):
    dim = (4, 4)
    p = str(tmp_path / "t.s3t")
    sto = TS.create_storage(p, "xy", dim, dtype=np.float64, checksum=level)
    TS.append_blocks(sto, [((0, 0), dim)])
    TS.save(1.0, torch.ones(dim, dtype=torch.float64), "xy", sto, "xy")
    off = sto.blocks[0].values_offset
    TS.close_storage(sto)
    back = TS.open_storage(p, mode="r")
    back._has_trailer = True
    TS.check_or_write_checksums(back)          # intact: verifies
    TS.close_storage(back)
    with open(p, "r+b") as f:
        f.seek(off)
        f.write(struct.pack("<d", 99.0))
    for S in (TS, JS):                          # both packages see the damage
        bad = S.open_storage(p, mode="r")
        bad._has_trailer = True
        with pytest.raises(ValueError, match="checksum mismatch"):
            S.check_or_write_checksums(bad)
        S.close_storage(bad)


def test_crc_is_zlib_compatible():
    data = b"superbblas-tpu"
    assert TS._crc(data) == zlib.crc32(data) & 0xFFFFFFFF == JS._crc(data)
    big = bytes(range(256)) * 1000
    assert TS._blocked_crc(big, 4096) == JS._blocked_crc(big, 4096)
    assert TS._blocked_crc(memoryview(big), 4096) == JS._blocked_crc(big, 4096)


def big_endian_file(path, vals, meta=b"be!"):
    dim = vals.shape
    pad = b"\x00" * ((8 - len(meta) % 8) % 8)
    hdr = struct.pack(">6i", 314, 0, 1, 0, 2, len(meta)) + meta + pad
    hdr += np.asarray(dim, dtype=">f8").tobytes()
    hdr += struct.pack(">d", float(64 * 1024 * 1024))
    hdr += struct.pack(">d", 1.0)
    chunk = struct.pack(">d", 1.0)
    chunk += np.asarray((0, 0), dtype=">f8").tobytes()
    chunk += np.asarray(dim, dtype=">f8").tobytes()
    chunk += vals.astype(">f8").tobytes()
    with open(path, "wb") as f:
        f.write(hdr + chunk)


def test_big_endian_read_and_write_match_jax(tmp_path):
    """A big-endian file reads as in JAX; a partial save and a
    save_stream keep it big-endian, with the bytes JAX writes."""
    vals = (np.arange(12) * 1.25).reshape(4, 3)
    for name in ("j", "t"):
        big_endian_file(str(tmp_path / name), vals)
    st = TS.open_storage(str(tmp_path / "t"), mode="r+")
    assert st.byteswap and st.dim == (4, 3) and st.metadata == "be!"
    got = TS.load(1.0, st, torch.zeros((4, 3), dtype=torch.float64), "xy")
    np.testing.assert_array_equal(got.numpy(), vals)
    sj = JS.open_storage(str(tmp_path / "j"), mode="r+")
    for S, sto in ((TS, st), (JS, sj)):
        S.save(1.0, np.array([[7.5, 8.5]]), "xy", sto, "xy", from1=(1, 1))
        S.save_stream(sto, [((2, 0), np.full((2, 3), 9.0))])
        S.close_storage(sto)
    assert read(tmp_path / "j") == read(tmp_path / "t")


def test_gridhash_matches_linear_sweep_and_jax(tmp_path):
    """The GridHash index and the linear sweep yield the same fragments,
    and both the JAX package's."""
    dim = (32, 24)
    rng = np.random.default_rng(5)
    boxes = [((int(rng.integers(0, 32)), int(rng.integers(0, 24))),
              (int(rng.integers(1, 9)), int(rng.integers(1, 7)))) for _ in range(80)]
    st = TS.create_storage(str(tmp_path / "t"), "xy", dim, dtype=np.float64)
    sj = JS.create_storage(str(tmp_path / "j"), "xy", dim, dtype=np.float64)
    TS.append_blocks(st, boxes)
    JS.append_blocks(sj, boxes)
    assert len(st.blocks) >= TS._GRID_MIN_BLOCKS
    reqs = [((int(rng.integers(0, 32)), int(rng.integers(0, 24))),
             (int(rng.integers(1, 33)), int(rng.integers(1, 25)))) for _ in range(30)]

    def collect(S, sto):
        return [sorted((b.values_offset, f, s) for b, f, s in S._block_intersections(sto, *r))
                for r in reqs]

    with_grid = collect(TS, st)
    assert with_grid == collect(JS, sj)
    orig = TS._GRID_MIN_BLOCKS
    TS._GRID_MIN_BLOCKS = 10 ** 9
    try:
        st._grid = None
        assert collect(TS, st) == with_grid
    finally:
        TS._GRID_MIN_BLOCKS = orig
    TS.close_storage(st)
    JS.close_storage(sj)


def test_load_stream_windows_match_jax(tmp_path):
    dim = (16, 8)
    x = np.random.default_rng(3).standard_normal(dim)
    boxes = [((0, 0), (10, 8)), ((10, 0), (6, 8))]
    pj, pt = write_both(tmp_path, dim, np.float64, boxes, [(1.0, x, "xy", {})])
    st, sj = TS.open_storage(pt, "r"), JS.open_storage(pj, "r")
    for kw in ({}, dict(from0=(12, 0), size0=(8, 8))):
        got = list(TS.load_stream(st, max_window_bytes=256, **kw))
        want = list(JS.load_stream(sj, max_window_bytes=256, **kw))
        assert [f for f, _ in got] == [f for f, _ in want]
        assert all(w.shape[0] <= 4 for _, w in got)
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate([w for _, w in TS.load_stream(st)]), x)


def test_save_stream_matches_jax(tmp_path):
    """3-row windows across the block seam, then a narrow
    (read-modify-write) window given as a tensor: both packages' files
    stay byte-identical and their level-2 checksums verify."""
    dim = (12, 10)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(dim)
    patch = rng.standard_normal((5, 3))
    paths = []
    for name, S in (("j", JS), ("t", TS)):
        p = str(tmp_path / name)
        sto = S.create_storage(p, "xy", dim, dtype=np.float64, checksum=2)
        S.append_blocks(sto, [((0, 0), (6, 10)), ((6, 0), (6, 10))])
        S.save_stream(sto, (((r, 0), x[r:r + 3]) for r in range(0, 12, 3)))
        S.save_stream(sto, [((4, 2), torch.from_numpy(patch) if S is TS else patch)])
        S.check_or_write_checksums(sto)
        S.close_storage(sto)
        paths.append(p)
    assert read(paths[0]) == read(paths[1])
    # file-to-file streaming copy
    src = TS.open_storage(paths[1], mode="r")
    dst = TS.create_storage(str(tmp_path / "c"), "xy", dim, dtype=np.float64)
    TS.append_blocks(dst, [((0, 0), dim)])
    TS.save_stream(dst, TS.load_stream(src, max_window_bytes=200))
    want = x.copy()
    want[4:9, 2:5] = patch
    np.testing.assert_array_equal(TS.load(1.0, dst, np.zeros(dim), "xy"), want)
    with pytest.raises(ValueError, match="not covered"):
        TS.save_stream(dst, [((0, 0), np.zeros((14, 10)))])
    TS.close_storage(dst)
    TS.close_storage(src)


def test_save_stream_unblocked_crc_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(TS, "DEFAULT_CHECKSUM_BLOCKSIZE", 0)
    monkeypatch.setattr(JS, "DEFAULT_CHECKSUM_BLOCKSIZE", 0)
    dim = (6, 8)
    rng = np.random.default_rng(7)
    x, rows = rng.standard_normal(dim), rng.standard_normal((2, 8))
    paths = []
    for name, S in (("j", JS), ("t", TS)):
        p = str(tmp_path / name)
        sto = S.create_storage(p, "xy", dim, dtype=np.float64, checksum=2)
        assert sto.checksum_blocksize <= 0
        S.append_blocks(sto, [((0, 0), dim)])
        S.save(1.0, x, "xy", sto, "xy")
        S.save_stream(sto, [((2, 0), rows)])
        S.check_or_write_checksums(sto)
        S.close_storage(sto)
        paths.append(p)
    assert read(paths[0]) == read(paths[1])


def test_get_blocks_matches_jax(tmp_path):
    boxes = [((0, 0), (4, 3)), ((0, 3), (4, 3))]
    st = TS.create_storage(str(tmp_path / "t"), "xy", (4, 6), dtype=np.float64)
    sj = JS.create_storage(str(tmp_path / "j"), "xy", (4, 6), dtype=np.float64)
    TS.append_blocks(st, boxes)
    JS.append_blocks(sj, boxes)
    for args, kw in ((("xy",), {}), (("xy", "yx"), {}),
                     (("xy", "xy"), dict(from1=(1, 1), size1=(2, 1))),
                     (("xy", "xy"), dict(from1=(3, 2), size1=(2, 2)))):
        assert sorted(TS.get_blocks(st, *args, **kw)) == sorted(JS.get_blocks(sj, *args, **kw))
    assert sorted(TS.get_blocks(st, "xy", "yx")) == [((0, 0), (3, 4)), ((3, 0), (3, 4))]
    with pytest.raises(ValueError, match="rank"):
        TS.get_blocks(st, "xyz")


def test_save_async_flush_and_close(tmp_path):
    """save_async's future is resolved by flush_storage (and, the second
    time, by close_storage); the file then equals the JAX package's."""
    dim = (4, 4)
    x = np.arange(16.0).reshape(dim)
    p = str(tmp_path / "t")
    sto = TS.create_storage(p, "xy", dim, dtype=np.float64, checksum=1)
    size = os.path.getsize(p)
    TS.preallocate_storage(sto, 1 << 16)
    assert os.path.getsize(p) == size
    TS.append_blocks(sto, [((0, 0), dim)])
    fut = TS.save_async(1.0, torch.from_numpy(x), "xy", sto, "xy")
    TS.flush_storage(sto)
    assert fut.done() and not sto._pending
    other = TS.open_storage(p, mode="r")
    np.testing.assert_array_equal(TS.load(1.0, other, np.zeros(dim), "xy"), x)
    TS.close_storage(other)
    fut2 = TS.save_async(2.0, torch.from_numpy(x), "xy", sto, "xy")
    TS.close_storage(sto)
    assert fut2.done()
    sj = JS.create_storage(str(tmp_path / "j"), "xy", dim, dtype=np.float64, checksum=1)
    JS.append_blocks(sj, [((0, 0), dim)])
    JS.save(2.0, x, "xy", sj, "xy")
    JS.close_storage(sj)
    assert read(p) == read(tmp_path / "j")
    back = TS.open_storage(p, mode="r")
    back._has_trailer = True
    TS.check_or_write_checksums(back)
    TS.close_storage(back)


def test_fuzz_random_blocks_matches_jax(tmp_path):
    """Random (wrapped, overlapping) block manifests, random saves and
    partial loads, some permuted: each load equals the JAX package's on
    the same file, and the files stay byte-identical."""
    rng = np.random.default_rng(99)
    for case in range(4):
        dim = (int(rng.integers(4, 9)), int(rng.integers(4, 9)))
        boxes = [((int(rng.integers(0, dim[0])), int(rng.integers(0, dim[1]))),
                  (int(rng.integers(1, dim[0] + 1)), int(rng.integers(1, dim[1] + 1))))
                 for _ in range(int(rng.integers(1, 5)))]
        covered = np.zeros(dim, dtype=bool)
        for f, z in boxes:
            covered[np.ix_(*[np.arange(a, a + s) % d for a, s, d in zip(f, z, dim)])] = True
        st = TS.create_storage(str(tmp_path / f"t{case}"), "xy", dim, dtype=np.float64)
        sj = JS.create_storage(str(tmp_path / f"j{case}"), "xy", dim, dtype=np.float64)
        TS.append_blocks(st, boxes)
        JS.append_blocks(sj, boxes)
        for step in range(5):
            f = (int(rng.integers(0, dim[0])), int(rng.integers(0, dim[1])))
            z = (int(rng.integers(1, dim[0] + 1)), int(rng.integers(1, dim[1] + 1)))
            if covered[np.ix_(*[np.arange(a, a + s) % d for a, s, d in zip(f, z, dim)])].all():
                vals = rng.standard_normal(z)
                TS.save(1.0, torch.from_numpy(vals), "xy", st, "xy", from1=f)
                JS.save(1.0, vals, "xy", sj, "xy", from1=f)
            lf = (int(rng.integers(0, dim[0])), int(rng.integers(0, dim[1])))
            lz = (int(rng.integers(1, dim[0] + 1)), int(rng.integers(1, dim[1] + 1)))
            o1, shape = ("xy", lz) if step % 2 else ("yx", lz[::-1])
            got = TS.load(1.0, st, torch.zeros(shape, dtype=torch.float64), o1, "xy",
                          from0=lf, size0=lz)
            want = JS.load(1.0, sj, np.zeros(shape), o1, "xy", from0=lf, size0=lz)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"case {case} step {step}")
        TS.close_storage(st)
        JS.close_storage(sj)
        assert read(tmp_path / f"t{case}") == read(tmp_path / f"j{case}")


XVAL = pytest.mark.skipif(not (os.path.isdir(XV.REF) and shutil.which("g++")),
                          reason="reference headers or g++ unavailable")


@XVAL
def test_reference_writes_port_reads(tmp_path):
    """The port of tests/test_storage_xval.py: a file the reference C++
    library wrote loads bit-exactly, and its block CRCs verify."""
    f = tmp_path / "ref.s3t"
    exe = XV._compile(tmp_path, "writer", XV.WRITER, f)
    subprocess.run([str(exe)], check=True, timeout=60)
    sto = TS.open_storage(str(f), mode="r")
    assert (sto.dim, sto.metadata, sto.checksum_level, len(sto.blocks)) == ((4, 6), "meta!", 2, 2)
    y = TS.load(1.0, sto, torch.zeros((4, 6), dtype=torch.float64), "xy")
    np.testing.assert_array_equal(y.numpy(), (np.arange(24) * 1.5).reshape(4, 6))
    TS.check_or_write_checksums(sto)
    assert sorted(TS.get_blocks(sto, "xy", "yx")) == [((0, 0), (3, 4)), ((3, 0), (3, 4))]
    TS.close_storage(sto)


@XVAL
def test_port_writes_reference_reads(tmp_path):
    f = tmp_path / "ours.s3t"
    sto = TS.create_storage(str(f), "xy", (4, 6), dtype=np.float64, metadata="meta!",
                            checksum=2)
    TS.append_blocks(sto, [((0, 0), (4, 3)), ((0, 3), (4, 3))])
    TS.save(1.0, torch.from_numpy((np.arange(24) * 1.5).reshape(4, 6)), "xy", sto, "xy")
    TS.close_storage(sto)
    exe = XV._compile(tmp_path, "reader", XV.READER, f)
    out = subprocess.run([str(exe)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "ok" in out.stdout, (out.stdout, out.stderr)
