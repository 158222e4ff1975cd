"""The record datasets of the port against the reference, on the CPU:
``gluon.data.RecordFileDataset`` (the reference's
``tests/test_gluon_data.py::test_record_file_dataset`` contract, and
item for item with the reference's), ``vision.ImageRecordDataset`` (the
reference's images with their channels reversed: the port decodes with
``image.imdecode`` and returns RGB, as MXNet 1.x does, where the
reference's ``unpack_img`` returns BGR) and ``vision.ImageFolderDataset``;
and a ``DataLoader(num_workers=4)`` over a ``RecordFileDataset`` with a
numpy decode chain, bit for bit with ``num_workers=0`` over 256 records
(forked workers each reopen the file).

Tolerances: bit for bit.
"""
import numpy as np
import pytest

from mxnet_tpu import recordio as rrec
from mxnet_tpu.gluon import data as rdata

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import recordio as prec
from mxnet_tpu_torch.gluon import data as pdata

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with pt.cpu():
        yield


def _img(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 9 + seed) % 256, (yy * 4) % 256,
                    ((xx + 2 * yy) * 3) % 256], -1) + rng.randint(0, 25,
                                                                  (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_record_file_dataset(tmp_path):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = prec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(6):
        w.write_idx(i, b"payload%d" % i)
    w.close()
    ds = pdata.RecordFileDataset(rec)
    assert len(ds) == 6
    assert ds[4] == b"payload4"
    ref = rdata.RecordFileDataset(rec)
    assert [ds[i] for i in range(6)] == [ref[i] for i in range(6)]


def _image_pack(tmp_path, n=9, label_width=1):
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = rrec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        label = float(i % 4) if label_width == 1 else \
            np.array([i, -i], np.float32)
        w.write_idx(i, rrec.pack_img(rrec.IRHeader(0, label, i, 0),
                                     _img(13 + i, 16, i)))
    w.close()
    return rec


@pytest.mark.parametrize("flag", [1, 0], ids=["color", "gray"])
@pytest.mark.parametrize("label_width", [1, 2])
def test_image_record_dataset_is_the_reference_in_rgb(tmp_path, flag,
                                                      label_width):
    rec = _image_pack(tmp_path, label_width=label_width)
    ref = rdata.vision.ImageRecordDataset(rec, flag=flag)
    port = pdata.vision.ImageRecordDataset(rec, flag=flag)
    assert len(port) == len(ref) == 9
    for i in range(9):
        (pimg, plab), (rimg, rlab) = port[i], ref[i]
        want = rimg.asnumpy()
        if flag:
            want = want[:, :, ::-1]         # the reference returns BGR
        else:
            want = want.reshape(want.shape[:2])
        got = pimg.asnumpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got.reshape(want.shape), want)
        np.testing.assert_array_equal(np.asarray(plab), np.asarray(rlab))


def test_image_record_dataset_decodes_as_mx_image(tmp_path):
    rec = _image_pack(tmp_path, n=3)
    raw = pdata.RecordFileDataset(rec)
    seen = []
    ds = pdata.vision.ImageRecordDataset(
        rec, transform=lambda img, label: seen.append(label) or (img, label))
    for i in range(3):
        header, payload = prec.unpack(raw[i])
        want = pt.image.imdecode(payload).asnumpy()
        np.testing.assert_array_equal(ds[i][0].asnumpy(), want)
    assert seen == [0.0, 1.0, 2.0]


def test_image_folder_dataset_matches_the_reference(tmp_path):
    root = tmp_path / "root"
    for c, cls in enumerate(("zebra", "ant", "cat")):
        (root / cls).mkdir(parents=True)
        for i in range(2 + c):
            ext = ".jpg" if i % 2 else ".png"
            cv2.imwrite(str(root / cls / ("%d%s" % (i, ext))),
                        _img(11, 12 + i, c * 10 + i))
        (root / cls / "notes.txt").write_text("skipped")
    (root / "README").write_text("not a folder")
    ref = rdata.vision.ImageFolderDataset(str(root))
    port = pdata.vision.ImageFolderDataset(str(root))
    assert port.synsets == ref.synsets == ["ant", "cat", "zebra"]
    assert port.items == ref.items
    for i in range(len(port)):
        (pimg, plab), (rimg, rlab) = port[i], ref[i]
        np.testing.assert_array_equal(pimg.asnumpy(), rimg.asnumpy())
        assert plab == rlab


def _decode(record):
    """A numpy-only chain: the raw 8x8 RGB record to CHW float32 in
    [0, 1], and its label."""
    header, payload = prec.unpack(record)
    img = np.frombuffer(payload, np.uint8).reshape(8, 8, 3)
    return (img.transpose(2, 0, 1).astype(np.float32) / 255.0,
            np.float32(header.label))


@pytest.mark.filterwarnings("ignore:os.fork")
@pytest.mark.filterwarnings("ignore:This process")
def test_forked_workers_read_a_record_file_bit_for_bit(tmp_path):
    """Four forked workers share nothing of the parent's open file: the
    batches equal the in-process ones (the reference's reader shares
    one file offset across the workers, and a run reads wrong records
    or raises)."""
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = prec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    for i in range(256):
        w.write_idx(i, prec.pack(prec.IRHeader(0, float(i), i, 0),
                                 rng.randint(0, 256, (8, 8, 3),
                                             np.uint8).tobytes()))
    w.close()
    ds = pdata.RecordFileDataset(rec).transform(_decode)
    want = [(d.asnumpy(), l.asnumpy())
            for d, l in pdata.DataLoader(ds, batch_size=16)]
    for _ in range(2):
        loader = pdata.DataLoader(ds, batch_size=16, num_workers=4)
        got = [(d.asnumpy(), l.asnumpy()) for d, l in loader]
        assert len(got) == len(want) == 16
        for (gd, gl), (wd, wl) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
    assert sorted(np.concatenate([l for _, l in want]).tolist()) == \
        [float(i) for i in range(256)]
