"""The port's ``io`` and its native pipeline against the reference, on
the CPU: the reference's ``tests/test_io.py`` contracts run against
``mxnet_tpu_torch.io.ImageRecordIter`` (raw, shuffled epochs,
normalisation, JPEG, a corrupt .rec, ``im2rec`` end to end, the short
tail without ``round_batch``); the port's batches and labels bit for
bit with the reference's (its prebuilt library) over raw and JPEG
records, shuffle, random crop, mirror, resize, 1 and 4 threads, label
width 2 from ``flag > 0`` headers, ``round_batch`` on and off, two
epochs after ``reset()``; ``NDArrayIter``, ``ResizeIter`` and
``PrefetchingIter``; the io library built against the system's libjpeg
and Pillow's, equal pixels; a header/library mismatch, a missing libjpeg
and concurrent builds.

Tolerances: pixels and labels bit for bit (the same C++ arithmetic, and
the reference's normalisation as XLA compiles it: the division by a
constant std becomes a multiplication by its f32 reciprocal, which the
port does too); the reference's own bound (mean error < 6) for JPEG
against the source image.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from mxnet_tpu import io as rio

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import io as pio
from mxnet_tpu_torch import native
from mxnet_tpu_torch import recordio as prec

REPO = Path(__file__).resolve().parent.parent
CPU = pt.cpu()


def _write_raw_pack(tmp_path, n=32, h=8, w=12, name="r"):
    rec = str(tmp_path / (name + ".rec"))
    idx = str(tmp_path / (name + ".idx"))
    wr = prec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    imgs = []
    for i in range(n):
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        imgs.append(img)
        wr.write_idx(i, prec.pack(prec.IRHeader(0, float(i), i, 0),
                                  img.tobytes()))
    wr.close()
    return rec, idx, imgs


def _smooth(rng, h, w, i):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 7 + i) % 256, (yy * 5 + 3 * i) % 256,
                    ((xx + yy) * 3) % 256], -1)
    return np.clip(img + rng.randint(0, 30, img.shape), 0, 255) \
        .astype(np.uint8)


def _write_jpeg_pack(tmp_path, n=23, name="j", label_width=1, sides=(20, 40),
                     seed=0):
    """JPEG records of sizes drawn in ``sides``; with ``label_width`` 2
    the headers carry a float label vector (flag 2)."""
    rec = str(tmp_path / (name + ".rec"))
    idx = str(tmp_path / (name + ".idx"))
    w = prec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, wd = rng.randint(*sides), rng.randint(*sides)
        label = float(i) if label_width == 1 else \
            np.array([i, 100 + i], np.float32)
        w.write_idx(i, prec.pack_img(prec.IRHeader(0, label, i, 0),
                                     _smooth(rng, h, wd, i), quality=95))
    w.close()
    return rec, idx


def _epoch(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _assert_epochs_equal(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


# ---------------------------------------------------------------------------
# the reference's contracts (tests/test_io.py) against the port
# ---------------------------------------------------------------------------
def test_image_record_iter_raw(tmp_path):
    rec, idx, imgs = _write_raw_pack(tmp_path)
    it = pio.ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                             data_shape=(3, 8, 12), batch_size=10, ctx=CPU)
    labels = []
    nb = 0
    for batch in it:
        nb += 1
        take = 10 - (batch.pad or 0)
        labels.extend(batch.label[0].asnumpy().astype(int)[:take].tolist())
        assert batch.data[0].shape == (10, 3, 8, 12)
        assert batch.data[0].context == CPU
    assert nb == 4 and sorted(labels) == list(range(32))
    it.reset()
    b0 = next(it)
    got = b0.data[0].asnumpy()[3].transpose(1, 2, 0)
    np.testing.assert_allclose(got, imgs[3].astype(np.float32))
    it.reset()
    assert next(it).data[0].shape[0] == 10


def test_image_record_iter_shuffle_epoch(tmp_path):
    rec, idx, _ = _write_raw_pack(tmp_path, n=24)
    it = pio.ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                             data_shape=(3, 8, 12), batch_size=8,
                             shuffle=True, seed=3, ctx=CPU)
    e1 = [tuple(b.label[0].asnumpy().astype(int)) for b in it]
    it.reset()
    e2 = [tuple(b.label[0].asnumpy().astype(int)) for b in it]
    assert sorted(x for t in e1 for x in t) == list(range(24))
    assert sorted(x for t in e2 for x in t) == list(range(24))
    assert e1 != e2


def test_image_record_iter_normalize(tmp_path):
    rec, idx, imgs = _write_raw_pack(tmp_path, n=4, name="n")
    it = pio.ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                             data_shape=(3, 8, 12), batch_size=4,
                             mean_r=1.0, mean_g=2.0, mean_b=3.0,
                             std_r=2.0, std_g=2.0, std_b=2.0, ctx=CPU)
    got = next(it).data[0].asnumpy()[0].transpose(1, 2, 0)
    want = (imgs[0].astype(np.float32) - np.array([1, 2, 3], np.float32)) / 2.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_image_record_iter_jpeg(tmp_path):
    pytest.importorskip("cv2")
    rec = str(tmp_path / "j.rec")
    yy, xx = np.mgrid[0:16, 0:24]
    img = np.stack([(xx * 9) % 256, (yy * 9) % 256, ((xx + yy) * 4) % 256],
                   -1).astype(np.uint8)
    w = prec.MXRecordIO(rec, "w")
    w.write(prec.pack_img(prec.IRHeader(0, 5.0, 0, 0), img[:, :, ::-1],
                          quality=95))
    w.close()
    it = pio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 16, 24),
                             batch_size=1, ctx=CPU)
    b = next(it)
    got = b.data[0].asnumpy()[0].transpose(1, 2, 0)
    assert float(b.label[0].asnumpy()[0]) == 5.0
    assert np.abs(got - img.astype(np.float32)).mean() < 6.0


def test_image_record_iter_decode_equals_opencv(tmp_path):
    """No resize, crop or mirror, data_shape the image's own: the
    pipeline's pixels are OpenCV's decode, RGB, bit for bit."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(5)
    rec = str(tmp_path / "d.rec")
    w = prec.MXRecordIO(rec, "w")
    images = [_smooth(rng, 37, 53, i) for i in range(6)]
    for i, img in enumerate(images):
        w.write(prec.pack_img(prec.IRHeader(0, float(i), i, 0), img))
    w.close()
    it = pio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 37, 53),
                             batch_size=6, ctx=CPU, dtype="uint8")
    got = next(it).data[0].asnumpy()
    r = prec.MXRecordIO(rec, "r")
    for i in range(6):
        payload = prec.unpack(r.read())[1]
        want = cv2.imdecode(np.frombuffer(payload, np.uint8),
                            cv2.IMREAD_COLOR)[:, :, ::-1]
        np.testing.assert_array_equal(got[i].transpose(1, 2, 0), want)


def test_corrupt_rec_raises(tmp_path):
    rec, idx, _ = _write_raw_pack(tmp_path, n=10, name="c")
    size = os.path.getsize(rec)
    with open(rec, "r+b") as f:
        f.truncate(size - 100)  # chop mid-record
    it = pio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 12),
                             batch_size=4, ctx=CPU)
    with pytest.raises(pt.MXNetError, match="truncated"):
        for _ in range(5):
            next(it)


def test_bad_path_and_shuffle_without_idx_raise(tmp_path):
    with pytest.raises(pt.MXNetError, match="cannot open"):
        pio.ImageRecordIter(path_imgrec=str(tmp_path / "none.rec"),
                            data_shape=(3, 8, 8), batch_size=2, ctx=CPU)
    rec, _, _ = _write_raw_pack(tmp_path, n=2)
    with pytest.raises(pt.MXNetError, match="path_imgidx"):
        pio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 12),
                            batch_size=2, shuffle=True, ctx=CPU)
    with pytest.raises(ValueError, match="data_shape"):
        pio.ImageRecordIter(path_imgrec=rec, data_shape=(1, 8, 12),
                            batch_size=2, ctx=CPU)


def test_default_context_is_the_card(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec, _, _ = _write_raw_pack(tmp_path, n=2)
    with pytest.raises(pt.MXNetError, match="no CUDA device"):
        pio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 12),
                            batch_size=2)


def test_image_record_iter_no_round_batch_tail_pad(tmp_path):
    rec, idx, _ = _write_raw_pack(tmp_path, n=13, name="tail")
    it = pio.ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                             data_shape=(3, 8, 12), batch_size=5,
                             round_batch=False, ctx=CPU)
    batches = list(it)
    assert len(batches) == 3
    for b in batches:
        assert b.data[0].shape == tuple(it.provide_data[0][1])
    assert batches[-1].pad == 2
    labels = []
    for b in batches:
        labels.extend(b.label[0].asnumpy().astype(int)[:5 - b.pad].tolist())
    assert sorted(labels) == list(range(13))


def _im2rec(*args):
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.im2rec", *args],
        capture_output=True, text=True, cwd=str(REPO), timeout=300)


def test_im2rec_tool_end_to_end(tmp_path):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path / "imgs"
    for cls in ("cat", "dog"):
        (root / cls).mkdir(parents=True)
    for i in range(3):
        for ci, cls in enumerate(("cat", "dog")):
            img = np.full((16, 16, 3), 40 * (i + 1) + 100 * ci, np.uint8)
            cv2.imwrite(str(root / cls / ("%d.png" % i)), img)
    prefix = str(tmp_path / "pack")
    out = _im2rec(prefix, str(root))
    assert out.returncode == 0, out.stderr
    it = pio.ImageRecordIter(path_imgrec=prefix + ".rec",
                             path_imgidx=prefix + ".idx",
                             data_shape=(3, 16, 16), batch_size=6, ctx=CPU)
    labels = sorted(next(it).label[0].asnumpy().astype(int).tolist())
    assert labels == [0, 0, 0, 1, 1, 1]
    prefix2 = str(tmp_path / "raw")
    out2 = _im2rec(prefix2, str(root), "--pass-through-raw")
    assert out2.returncode == 0, out2.stderr
    it2 = pio.ImageRecordIter(path_imgrec=prefix2 + ".rec",
                              path_imgidx=prefix2 + ".idx",
                              data_shape=(3, 16, 16), batch_size=6, ctx=CPU)
    b2 = next(it2)
    labels2 = b2.label[0].asnumpy().astype(int)
    vals = b2.data[0].asnumpy().reshape(6, -1)
    for row in range(6):
        assert vals[row].std() < 1e-6
        v = float(vals[row][0])
        if labels2[row] == 0:
            assert v in (40.0, 80.0, 120.0), v
        else:
            assert v in (140.0, 180.0, 220.0), v


@pytest.mark.parametrize("args", [[], ["--pass-through-raw"],
                                  ["--resize", "12", "--quality", "80"],
                                  ["--shuffle", "--seed", "3"]],
                         ids=["jpeg", "raw", "resize_quality", "shuffle"])
def test_im2rec_writes_the_reference_tools_files(tmp_path, args):
    """The port's tool and the reference's ``tools/im2rec.py`` write the
    same .lst, .rec and .idx bytes from one image folder."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(2)
    root = tmp_path / "imgs"
    for cls in ("a", "b", "c"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(root / cls / ("%d.jpg" % i)),
                        _smooth(rng, 18 + i, 21, i))
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    out = _im2rec(str(tmp_path / "p" / "x"), str(root), *args)
    assert out.returncode == 0, out.stderr
    ref = subprocess.run([sys.executable, str(REPO / "tools" / "im2rec.py"),
                          str(tmp_path / "r" / "x"), str(root), *args],
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    for ext in (".lst", ".rec", ".idx"):
        assert (tmp_path / "p" / ("x" + ext)).read_bytes() == \
            (tmp_path / "r" / ("x" + ext)).read_bytes(), ext


# ---------------------------------------------------------------------------
# bit for bit with the reference's ImageRecordIter
# ---------------------------------------------------------------------------
NORM = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939, std_r=58.393,
            std_g=57.12, std_b=57.375)
CASES = {
    "raw": ("raw", dict(batch_size=10)),
    "raw_shuffle_mirror": ("raw", dict(batch_size=8, shuffle=True,
                                       rand_mirror=True, seed=1,
                                       std_r=255.0, std_g=255.0,
                                       std_b=255.0)),
    "jpeg_center": ("jpeg", dict(batch_size=5, **NORM)),
    "jpeg_resize_center": ("jpeg", dict(batch_size=5, resize=18)),
    "jpeg_aug_1_thread": ("jpeg", dict(batch_size=5, shuffle=True,
                                       rand_crop=True, rand_mirror=True,
                                       resize=20, seed=7,
                                       preprocess_threads=1, **NORM)),
    "jpeg_aug_4_threads": ("jpeg", dict(batch_size=5, shuffle=True,
                                        rand_crop=True, rand_mirror=True,
                                        resize=20, seed=7,
                                        preprocess_threads=4, **NORM)),
    "jpeg_label_width_2": ("jpeg2", dict(batch_size=4, label_width=2,
                                         rand_crop=True, seed=2,
                                         preprocess_threads=4)),
    "jpeg_no_round_batch": ("jpeg", dict(batch_size=6, round_batch=False,
                                         rand_mirror=True, seed=4)),
    "jpeg_nhwc_uint8": ("jpeg", dict(batch_size=5, data_layout="NHWC",
                                     dtype="uint8", rand_crop=True)),
}


# ample for the reference's producer to fill its buffers with these
# small images
RUN_AHEAD_S = 0.5


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_record_iter_matches_the_reference(tmp_path, case):
    kind, kw = CASES[case]
    if kind == "raw":
        rec, idx, _ = _write_raw_pack(tmp_path, n=29, h=16, w=16)
    else:
        pytest.importorskip("cv2")
        rec, idx = _write_jpeg_pack(tmp_path,
                                    label_width=2 if kind == "jpeg2" else 1)
    kw = dict(kw, path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16))
    ref = rio.ImageRecordIter(**kw)
    port = pio.ImageRecordIter(ctx=CPU, **kw)
    assert port.provide_data[0][1] == ref.provide_data[0][1]
    assert port.provide_label[0][1] == ref.provide_label[0][1]
    epochs = []
    for _ in range(2):
        want = _epoch(ref)
        got = _epoch(port)
        _assert_epochs_equal(got, want)
        epochs.append(got)
        # the reference resets at once, so its next epoch's draws depend
        # on how far its producer ran ahead; given the time, it fills
        # every free buffer, which the port's reset waits for
        time.sleep(RUN_AHEAD_S)
        ref.reset()
        port.reset()
    if kw.get("shuffle"):
        assert not all(np.array_equal(a[1], b[1])
                       for a, b in zip(*epochs))


@pytest.mark.parametrize("where", ["end", "middle"])
def test_the_epoch_after_a_reset_does_not_depend_on_timing(tmp_path, where):
    """Each record's draws are seeded by its id; the port's reset waits
    for the producer to fill its buffers, so the batches after a reset
    are the same whether the consumer resets at once or late."""
    pytest.importorskip("cv2")
    rec, idx = _write_jpeg_pack(tmp_path, n=21)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16),
              batch_size=4, shuffle=True, rand_crop=True, rand_mirror=True,
              resize=20, seed=3, preprocess_threads=2, ctx=CPU)
    runs = []
    for pause in (0.0, RUN_AHEAD_S):
        it = pio.ImageRecordIter(**kw)
        if where == "end":
            _epoch(it)
        else:
            next(it)
        time.sleep(pause)
        it.reset()
        runs.append(_epoch(it))
    _assert_epochs_equal(runs[1], runs[0])


# ---------------------------------------------------------------------------
# NDArrayIter, ResizeIter, PrefetchingIter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_the_reference(handle):
    rng = np.random.RandomState(0)
    x = rng.rand(11, 3).astype(np.float32)
    y = np.arange(11, dtype=np.float32)
    np.random.seed(4)
    ref = rio.NDArrayIter(x, y, batch_size=4, shuffle=True,
                          last_batch_handle=handle)
    np.random.seed(4)
    with CPU:
        port = pio.NDArrayIter(x, y, batch_size=4, shuffle=True,
                               last_batch_handle=handle)
    assert port.provide_data == ref.provide_data
    assert port.provide_label == ref.provide_label
    for epoch in range(2):
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in ref]
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in port]
        assert len(got) == len(want)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp
        for it in (ref, port):   # each reset draws from np.random
            np.random.seed(5 + epoch)
            it.reset()


def test_resize_and_prefetching_iters(tmp_path):
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    with CPU:
        base = pio.NDArrayIter(x, np.arange(10), batch_size=4)
        resized = pio.ResizeIter(base, 5)
        got = [b.data[0].asnumpy()[:, 0].tolist() for b in resized]
    ref = rio.ResizeIter(rio.NDArrayIter(x, np.arange(10), batch_size=4), 5)
    assert got == [b.data[0].asnumpy()[:, 0].tolist() for b in ref]
    rec, idx, _ = _write_raw_pack(tmp_path, n=12)
    inner = pio.ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                                data_shape=(3, 8, 12), batch_size=4, ctx=CPU)
    pre = pio.PrefetchingIter(inner)
    assert pre.provide_data == inner.provide_data
    labels = [b.label[0].asnumpy().tolist() for b in pre]
    assert labels == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    pre.reset()
    assert next(pre).label[0].asnumpy().tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the io library: libjpeg, the build
# ---------------------------------------------------------------------------
def test_the_loaded_library_is_the_ports_own():
    lib = native.load_io_lib()
    info = native.build_info()
    assert Path(info["library"]).is_relative_to(
        REPO / "mxnet_tpu_torch" / "_build" / "host")
    assert info["libjpeg_kind"] in ("system", "pillow")
    assert os.path.realpath(info["linked"]) == \
        os.path.realpath(info["libjpeg"])
    assert lib.MXIOJpegCheck() == 0


def _native_epoch(lib, rec, idx):
    """One epoch's uint8 batches through a library's C ABI: shuffled,
    resized to 20, randomly cropped to 16^2, on 2 threads."""
    import ctypes as ct
    h = lib.MXIOCreateImageRecordIter(rec.encode(), idx.encode(), 3, 16, 16,
                                      1, 1, 1, 0, 20, 2, 0)
    assert h
    data, label, n = ct.POINTER(ct.c_uint8)(), ct.POINTER(ct.c_float)(), \
        ct.c_int(0)
    out = []
    try:
        while lib.MXIONext(h, ct.byref(data), ct.byref(label),
                           ct.byref(n)) == 0:
            out.append((np.ctypeslib.as_array(data, (n.value, 16, 16, 3))
                        .copy(), np.ctypeslib.as_array(label, (n.value, 1))
                        .copy(), 0))
    finally:
        lib.MXIOFree(h)
    return out


def test_both_libjpegs_decode_alike(tmp_path):
    """Where the system's libjpeg and Pillow's bundled one both exist,
    the io library built against each gives the same pixels."""
    system, pillow = native._system_libjpeg(), native._pillow_libjpeg()
    if not (system and pillow):
        pytest.skip("needs both the system libjpeg and Pillow's bundled one")
    pytest.importorskip("cv2")
    rec, idx = _write_jpeg_pack(tmp_path, n=9)
    batches = []
    for path in (system, pillow):
        lib = native.load_io_lib(native.build_io(path)[0])
        assert os.path.realpath(lib.MXIOJpegLibrary().decode()) == \
            os.path.realpath(path)
        batches.append(_native_epoch(lib, rec, idx))
    _assert_epochs_equal(batches[1], batches[0])


def test_a_header_library_mismatch_raises(tmp_path):
    """libjpeg's own version check refuses headers of another ABI when
    the library loads, before any pixel is decoded."""
    hdr = tmp_path / "jpeg"
    hdr.mkdir()
    for name in native.JPEG_HEADERS:
        text = (native.JPEG_INCLUDE / name).read_text()
        if name == "jconfig.h":
            text = text.replace("#define JPEG_LIB_VERSION  62",
                                "#define JPEG_LIB_VERSION  80")
        (hdr / name).write_text(text)
    path, _ = native.build_io(include=hdr)
    with pytest.raises(pt.MXNetError,
                       match="library is 62, caller expects 80"):
        native.load_io_lib(path)


def test_no_libjpeg_raises_naming_both_places(monkeypatch):
    monkeypatch.setattr(native, "_system_libjpeg", lambda: None)
    monkeypatch.setattr(native, "_pillow_libjpeg", lambda: None)
    with pytest.raises(pt.MXNetError, match="libjpeg.so.62.*pillow.libs"):
        native.build_io()


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch,
                                                        tmp_path):
    broken = tmp_path / "io.cc"
    broken.write_text(native.IO_SOURCE.read_text().replace(
        "int JpegCheck() {", "int JpegCheck() { undeclared_name;"))
    monkeypatch.setattr(native, "HOST_ROOT", tmp_path / "host")
    monkeypatch.setattr(native, "IO_SOURCE", broken)
    with pytest.raises(pt.MXNetError, match="(?s)g\\+\\+ failed.*"
                       "undeclared_name"):
        native.build_io()
    assert not list((tmp_path / "host").rglob("*.so"))


BUILD_SCRIPT = textwrap.dedent("""
    import json, sys, time
    from pathlib import Path
    from mxnet_tpu_torch import native
    native.HOST_ROOT = Path(sys.argv[1])
    go = Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.005)
    path, info = native.build_io()
    lib = native.load_io_lib(path)
    print(json.dumps({"compiled": info["compiled"], "path": str(path),
                      "check": lib.MXIOJpegCheck()}))
""")


def test_two_processes_build_the_io_library_at_once(tmp_path):
    """Two processes started together build into one directory: one
    compiles under the lock, the other waits and loads the whole
    library."""
    go = tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, str(tmp_path / "host"), str(go)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(2)]
    time.sleep(2.0)       # both imported and waiting
    go.touch()
    import json
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(o["compiled"] for o in outs) == [False, True]
    assert outs[0]["path"] == outs[1]["path"]
    assert all(o["check"] == 0 for o in outs)
    assert not list((tmp_path / "host").rglob("*.tmp"))


CUDA_BUILD_SCRIPT = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    from mxnet_tpu_torch.ops import cuda_build
    cuda_build.BUILD_ROOT = Path(sys.argv[1])
    cuda_build._nvcc = lambda: sys.argv[3]
    go = Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.005)
    print(cuda_build.build_source("__global__ void k(float* x) {}"))
""")


def test_two_processes_build_one_cuda_module_once(tmp_path):
    """The CUDA builds take the same lock: two processes building one
    runtime module compile it once (a stand-in nvcc that takes a second
    and logs each call), and both get the whole library."""
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >> %s\nsleep 1\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n' % log)
    nvcc.chmod(0o755)
    go = tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", CUDA_BUILD_SCRIPT, str(tmp_path / "build"),
         str(go), str(nvcc)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for _ in range(2)]
    time.sleep(2.0)
    go.touch()
    paths = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        paths.append(out.strip().splitlines()[-1])
    assert paths[0] == paths[1]
    assert Path(paths[0]).read_text() == "built\n"
    assert len(log.read_text().splitlines()) == 1


@pytest.mark.slow
def test_native_pipeline_throughput(tmp_path):
    """Raw 224x224 records, shuffle and mirror, one thread: well above
    3000 images/s (the reference's bar), resets at each epoch's end
    included."""
    import ctypes as ct
    rec, idx = str(tmp_path / "big.rec"), str(tmp_path / "big.idx")
    w = prec.MXIndexedRecordIO(idx, rec, "w")
    raw = np.random.randint(0, 255, (224, 224, 3), np.uint8)
    for i in range(256):
        w.write_idx(i, prec.pack(prec.IRHeader(0, float(i), i, 0),
                                 raw.tobytes()))
    w.close()
    lib = native.load_io_lib()
    h = lib.MXIOCreateImageRecordIter(rec.encode(), idx.encode(), 128, 224,
                                      224, 1, 1, 0, 1, 0, 1, 7)
    assert h
    try:
        data_p = ct.POINTER(ct.c_uint8)()
        label_p = ct.POINTER(ct.c_float)()
        n = ct.c_int(0)

        def nxt():
            rc = lib.MXIONext(h, ct.byref(data_p), ct.byref(label_p),
                              ct.byref(n))
            if rc == 1:
                lib.MXIOReset(h)
                rc = lib.MXIONext(h, ct.byref(data_p), ct.byref(label_p),
                                  ct.byref(n))
            assert rc == 0
            return n.value

        nxt()
        rates = []
        for _ in range(3):     # the best of three: the host is shared
            t0 = time.perf_counter()
            total = sum(nxt() for _ in range(10))
            rates.append(total / (time.perf_counter() - t0))
        rate = max(rates)
        assert rate > 3000, "native pipeline too slow: %.0f img/s" % rate
    finally:
        lib.MXIOFree(h)
