"""The port's ``recordio`` against the reference, on the CPU: the
reference's contracts (``tests/test_io.py``: round trip, magic in the
payload, the index, labels, ``pack_img``/``unpack_img``), files written
by each package byte-identical and read by the other, and a reader in a
forked process (the reference's shares its parent's file offset; the
port's reopens, as MXNet 1.x's does).

Tolerances: bytes and labels exactly; ``unpack_img`` within the
reference's own bound (mean |error| < 4 at quality 95).
"""
import os
import struct

import numpy as np
import pytest

from mxnet_tpu import recordio as rrec

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import recordio as prec

MAGIC = struct.pack("<I", 0xced7230a)
PAYLOADS = [b"hello", b"x" * 1000, b"", b"abcd" * 33, MAGIC,
            b"abcd" + MAGIC + b"efgh", MAGIC * 3, b"xy" + MAGIC,
            MAGIC + b"tail", bytes(range(256)) * 9]


def test_recordio_roundtrip(tmp_path):
    path = str(tmp_path / "a.rec")
    w = prec.MXRecordIO(path, "w")
    payloads = [b"hello", b"x" * 1000, b"", b"abcd" * 33]
    for p in payloads:
        w.write(p)
    w.close()
    r = prec.MXRecordIO(path, "r")
    for p in payloads:
        assert r.read() == p
    assert r.read() is None
    r.close()


def test_recordio_magic_in_payload(tmp_path):
    path = str(tmp_path / "m.rec")
    cases = [MAGIC, b"abcd" + MAGIC + b"efgh", MAGIC * 3,
             b"xy" + MAGIC,  # unaligned magic stays inline
             MAGIC + b"tail"]
    w = prec.MXRecordIO(path, "w")
    for c in cases:
        w.write(c)
    w.close()
    r = prec.MXRecordIO(path, "r")
    for c in cases:
        assert r.read() == c
    r.close()


def test_indexed_recordio(tmp_path):
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = prec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(20):
        w.write_idx(i, b"rec%03d" % i)
    w.close()
    r = prec.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == list(range(20))
    assert r.read_idx(13) == b"rec013"
    assert r.read_idx(2) == b"rec002"
    r.close()


def test_pack_unpack_labels():
    hdr = prec.IRHeader(0, 3.5, 7, 0)
    s = prec.pack(hdr, b"payload")
    h2, p2 = prec.unpack(s)
    assert h2.label == 3.5 and h2.id == 7 and p2 == b"payload"
    hdr = prec.IRHeader(0, np.array([1.0, 2.0, 3.0], np.float32), 9, 0)
    s = prec.pack(hdr, b"zz")
    h2, p2 = prec.unpack(s)
    assert h2.flag == 3 and np.allclose(h2.label, [1, 2, 3]) and p2 == b"zz"


@pytest.mark.parametrize("header", [
    (0, 3.5, 7, 0), (0, 2.0, 2 ** 40, 5),
    (0, np.array([1.0, -2.5, 3.0], np.float32), 9, 0),
    (0, [0.25, 7.0], 11, 3)], ids=["scalar", "big_id", "vector", "list"])
def test_pack_is_byte_identical_with_the_reference(header):
    assert prec.pack(header, b"payload") == rrec.pack(header, b"payload")
    ph, pp = prec.unpack(rrec.pack(header, b"zz"))
    rh, rp = rrec.unpack(rrec.pack(header, b"zz"))
    assert pp == rp and ph.flag == rh.flag and ph.id == rh.id
    np.testing.assert_array_equal(np.asarray(ph.label), np.asarray(rh.label))


def _write(mod, tmp_path, name):
    rec, idx = str(tmp_path / (name + ".rec")), str(tmp_path / (name + ".idx"))
    w = mod.MXIndexedRecordIO(idx, rec, "w")
    for i, p in enumerate(PAYLOADS):
        w.write_idx(i * 3 + 1, mod.pack(mod.IRHeader(0, float(i), i, 0), p))
    w.close()
    return rec, idx


@pytest.mark.parametrize("writer,reader", [(prec, rrec), (rrec, prec)],
                         ids=["port_writes", "reference_writes"])
def test_files_are_byte_identical_and_cross_read(tmp_path, writer, reader):
    rec, idx = _write(writer, tmp_path, "a")
    rec2, idx2 = _write(reader, tmp_path, "b")
    with open(rec, "rb") as a, open(rec2, "rb") as b:
        assert a.read() == b.read()
    with open(idx) as a, open(idx2) as b:
        assert a.read() == b.read()
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == [i * 3 + 1 for i in range(len(PAYLOADS))]
    for i, p in reversed(list(enumerate(PAYLOADS))):
        h, got = reader.unpack(r.read_idx(i * 3 + 1))
        assert got == p and h.label == float(i)
    r.close()
    seq = reader.MXRecordIO(rec, "r")
    assert [reader.unpack(seq.read())[1] for _ in PAYLOADS] == PAYLOADS
    assert seq.read() is None


def test_pack_img_unpack_img():
    pytest.importorskip("cv2")
    img = (np.mgrid[0:10, 0:10][0] * 20 % 256).astype(np.uint8)
    img = np.stack([img] * 3, -1)
    s = prec.pack_img(prec.IRHeader(0, 1.0, 0, 0), img, quality=95)
    hdr, out = prec.unpack_img(s)
    assert hdr.label == 1.0
    assert out.shape == (10, 10, 3)
    assert np.abs(out.astype(np.float32) - img.astype(np.float32)).mean() < 4


@pytest.mark.parametrize("fmt,quality", [(".jpg", 95), (".jpg", 50),
                                         (".png", 3)])
def test_pack_img_is_byte_identical_with_the_reference(fmt, quality):
    pytest.importorskip("cv2")
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    hdr = (0, 4.0, 3, 0)
    s = prec.pack_img(hdr, img, quality=quality, img_fmt=fmt)
    assert s == rrec.pack_img(hdr, img, quality=quality, img_fmt=fmt)
    np.testing.assert_array_equal(prec.unpack_img(s)[1],
                                  rrec.unpack_img(s)[1])


def test_reader_pickles_at_its_position(tmp_path):
    import pickle
    rec, _ = _write(prec, tmp_path, "p")
    r = prec.MXRecordIO(rec, "r")
    r.read()
    r2 = pickle.loads(pickle.dumps(r))
    assert prec.unpack(r2.read())[1] == PAYLOADS[1]


# ---------------------------------------------------------------------------
# forked readers
# ---------------------------------------------------------------------------
def _big_pack(mod, tmp_path, n=6, size=65536):
    """Records larger than a file buffer, so each read reaches the
    file descriptor."""
    rec, idx = str(tmp_path / "f.rec"), str(tmp_path / "f.idx")
    w = mod.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        w.write_idx(i, mod.pack(mod.IRHeader(0, float(i), i, 0),
                                bytes([i]) * size))
    w.close()
    return rec, idx


def _interleave(mod, reader):
    """The DataLoader's interleaving made deterministic: the parent
    seeks to record 1, a forked child seeks to record 4 and reads it,
    then the parent reads. Returns the parent's label, or the error."""
    rfd, wfd = os.pipe()
    reader.seek(1)
    pid = os.fork()
    if pid == 0:  # the child: its own seek and read, then out
        code = 0
        try:
            reader.read_idx(4)
        except BaseException:
            code = 1
        os.write(wfd, b"x")
        os._exit(code)
    os.read(rfd, 1)
    _, status = os.waitpid(pid, 0)
    os.close(rfd)
    os.close(wfd)
    assert status == 0
    try:
        return mod.unpack(reader.read())[0].label
    except IOError as e:
        return e


FORK_WARNINGS = (pytest.mark.filterwarnings("ignore:os.fork"),
                 pytest.mark.filterwarnings("ignore:This process"))


@FORK_WARNINGS[0]
@FORK_WARNINGS[1]
def test_reference_reader_shares_its_offset_with_a_forked_child(tmp_path):
    """The fault MXNet 1.x's _check_pid repairs, confirmed on the
    reference: a child's seek and read move the parent's file offset,
    so the parent's next read after its own seek is not record 1."""
    rec, idx = _big_pack(rrec, tmp_path)
    got = _interleave(rrec, rrec.MXIndexedRecordIO(idx, rec, "r"))
    assert got != 1.0


@FORK_WARNINGS[0]
@FORK_WARNINGS[1]
def test_port_reader_reopens_in_a_forked_child(tmp_path):
    rec, idx = _big_pack(prec, tmp_path)
    r = prec.MXIndexedRecordIO(idx, rec, "r")
    assert _interleave(prec, r) == 1.0
    assert r.pid == os.getpid()
    assert prec.unpack(r.read())[0].label == 2.0


def test_port_writer_refuses_a_forked_child(tmp_path):
    w = prec.MXRecordIO(str(tmp_path / "w.rec"), "w")
    w.pid = -1   # as if opened by another process
    with pytest.raises(pt.MXNetError, match="writer"):
        w.write(b"x")
