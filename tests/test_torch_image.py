"""The port's ``mx.image`` against the reference, on the CPU: every
function (``imread``, ``imdecode``, ``imresize``, ``resize_short``,
``fixed_crop``, ``center_crop``, ``random_crop``, ``color_normalize``),
every augmenter and ``CreateAugmenter``'s lists, and ``ImageIter`` over
a .rec pack and over an image list, with Python's ``random`` seeded
alike for both packages.

Tolerances: bit for bit (both call OpenCV on the same arrays and draw
from the same ``random`` module; the normalisation is one f32
subtraction and division in each).
"""
import random

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mxnet_tpu import image as rimg  # noqa: E402
from mxnet_tpu import recordio as rrec  # noqa: E402

import mxnet_tpu_torch as pt  # noqa: E402
from mxnet_tpu_torch import image as pimg  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with pt.cpu():
        yield


def _img(h=23, w=31, seed=0, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 7) % 256, (yy * 11) % 256, ((xx + yy) * 3) % 256],
                   -1) + rng.randint(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(dtype)


def _both(arr):
    return rimg.nd.array(arr, dtype=arr.dtype), pt.nd.array(arr,
                                                            dtype=arr.dtype)


def _eq(got, want):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_and_imread(tmp_path, flag, to_rgb):
    img = _img()
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    _eq(pimg.imdecode(buf.tobytes(), flag, to_rgb),
        rimg.imdecode(buf.tobytes(), flag, to_rgb))
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    _eq(pimg.imread(path, flag, to_rgb), rimg.imread(path, flag, to_rgb))
    r, p = _both(np.frombuffer(buf.tobytes(), np.uint8))
    _eq(pimg.imdecode(p, flag, to_rgb), rimg.imdecode(r, flag, to_rgb))


def test_decode_failures_raise(tmp_path):
    with pytest.raises(pt.MXNetError, match="imdecode failed"):
        pimg.imdecode(b"not an image")
    with pytest.raises(pt.MXNetError, match="cannot read"):
        pimg.imread(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("interp", [0, 1, 2, 3])
def test_resizes(dtype, interp):
    r, p = _both(_img(dtype=dtype))
    _eq(pimg.imresize(p, 17, 12, interp), rimg.imresize(r, 17, 12, interp))
    for size in (10, 40):
        _eq(pimg.resize_short(p, size, interp),
            rimg.resize_short(r, size, interp))
    _eq(pimg.resize_short(pimg.imresize(p, 12, 30), 9, interp),
        rimg.resize_short(rimg.imresize(r, 12, 30), 9, interp))


@pytest.mark.parametrize("size", [None, (8, 8), (5, 7)])
def test_fixed_and_center_crop(size):
    r, p = _both(_img())
    _eq(pimg.fixed_crop(p, 3, 4, 10, 9, size),
        rimg.fixed_crop(r, 3, 4, 10, 9, size))
    if size is not None:
        got, gbox = pimg.center_crop(p, size)
        want, wbox = rimg.center_crop(r, size)
        _eq(got, want)
        assert gbox == wbox
    got, gbox = pimg.center_crop(p, (40, 50))   # larger than the image
    want, wbox = rimg.center_crop(r, (40, 50))
    _eq(got, want)
    assert gbox == wbox


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crop_draws_as_the_reference(seed):
    r, p = _both(_img())
    random.seed(seed)
    want = [rimg.random_crop(r, (9, 13)) for _ in range(4)]
    random.seed(seed)
    got = [pimg.random_crop(p, (9, 13)) for _ in range(4)]
    for (g, gb), (w, wb) in zip(got, want):
        _eq(g, w)
        assert gb == wb


@pytest.mark.parametrize("std", [None, np.array([58.4, 57.1, 57.4],
                                                np.float32)])
def test_color_normalize(std):
    r, p = _both(_img())
    mean = np.array([123.7, 116.3, 103.5], np.float32)
    _eq(pimg.color_normalize(p, mean, std), rimg.color_normalize(r, mean, std))
    rf, pf = _both(_img(dtype=np.float32))
    _eq(pimg.color_normalize(pf, mean, std),
        rimg.color_normalize(rf, mean, std))


AUGS = {
    "resize": lambda m: m.ResizeAug(12),
    "force_resize": lambda m: m.ForceResizeAug((10, 14), 1),
    "random_crop": lambda m: m.RandomCropAug((11, 9)),
    "center_crop": lambda m: m.CenterCropAug((11, 9)),
    "flip": lambda m: m.HorizontalFlipAug(0.5),
    "cast": lambda m: m.CastAug(),
    "normalize": lambda m: m.ColorNormalizeAug(
        np.array([1.0, 2.0, 3.0], np.float32),
        np.array([2.0, 4.0, 8.0], np.float32)),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenters_match_the_reference(name):
    raug, paug = AUGS[name](rimg), AUGS[name](pimg)
    if name == "normalize":
        # the reference keeps numpy scalars in its kwargs, so its dumps
        # raises; the port's writes floats
        with pytest.raises(TypeError):
            raug.dumps()
        assert paug.dumps() == ('["ColorNormalizeAug", {"mean": [1.0, 2.0, '
                                '3.0], "std": [2.0, 4.0, 8.0]}]')
        r, p = _both(_img(dtype=np.float32))
    else:
        assert paug.dumps() == raug.dumps()
        r, p = _both(_img())
    random.seed(3)
    want = [raug(r) for _ in range(6)]
    random.seed(3)
    got = [paug(p) for _ in range(6)]
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("kw", [
    dict(), dict(resize=20), dict(rand_crop=True, rand_mirror=True),
    dict(resize=16, rand_crop=True, mean=True, std=True),
    dict(mean=np.array([1.0, 2.0, 3.0], np.float32))],
    ids=["center", "resize", "crop_mirror", "imagenet_norm", "mean_only"])
def test_create_augmenter_lists_run_as_the_reference(kw):
    raugs = rimg.CreateAugmenter((3, 12, 10), **kw)
    paugs = pimg.CreateAugmenter((3, 12, 10), **kw)
    assert [type(a).__name__ for a in paugs] == \
        [type(a).__name__ for a in raugs]
    assert [a.dumps() for a in paugs if type(a).__name__ != "ColorNormalizeAug"] \
        == [a.dumps() for a in raugs if type(a).__name__ != "ColorNormalizeAug"]
    r, p = _both(_img())
    random.seed(11)
    for a in raugs:
        r = a(r)
    random.seed(11)
    for a in paugs:
        p = a(p)
    _eq(p, r)


def _pack(path, idx, n=11, raw=False):
    w = rrec.MXIndexedRecordIO(idx, path, "w")
    for i in range(n):
        img = _img(14 + i % 3, 17 + i % 4, seed=i)
        label = np.array([i, i * 2], np.float32) if i % 2 else float(i)
        if raw:
            w.write_idx(i, rrec.pack(rrec.IRHeader(0, label, i, 0),
                                     _img(12, 10, seed=i).tobytes()))
        else:
            w.write_idx(i, rrec.pack_img(rrec.IRHeader(0, label, i, 0), img))
    w.close()


@pytest.mark.parametrize("raw", [False, True], ids=["jpeg", "raw"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("last", ["pad", "discard"])
def test_image_iter_over_a_rec_pack(tmp_path, raw, shuffle, last):
    rec, idx = str(tmp_path / "p.rec"), str(tmp_path / "p.idx")
    _pack(rec, idx, raw=raw)
    kw = dict(batch_size=4, data_shape=(3, 12, 10), label_width=2,
              path_imgrec=rec, path_imgidx=idx, shuffle=shuffle,
              last_batch_handle=last)
    out = []
    for m in (rimg, pimg):
        random.seed(5)
        it = m.ImageIter(aug_list=m.CreateAugmenter(
            (3, 12, 10), resize=13, rand_crop=True, rand_mirror=True), **kw)
        epochs = []
        for _ in range(2):
            epochs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                           for b in it])
            it.reset()
        out.append(epochs)
    for we, ge in zip(*out):
        assert len(ge) == len(we) > 0
        for (wd, wl, wp), (gd, gl, gp) in zip(we, ge):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp


def test_image_iter_over_an_image_list(tmp_path):
    root = tmp_path / "imgs"
    root.mkdir()
    lines = []
    for i in range(7):
        name = "%d.jpg" % i
        cv2.imwrite(str(root / name), _img(15, 18, seed=i))
        lines.append("%d\t%d\t%s\n" % (i, i % 3, name))
    lst = tmp_path / "a.lst"
    lst.write_text("".join(lines))
    out = []
    for m in (rimg, pimg):
        random.seed(2)
        it = m.ImageIter(batch_size=3, data_shape=(3, 12, 12),
                         path_imglist=str(lst), path_root=str(root),
                         shuffle=True, aug_list=m.CreateAugmenter(
                             (3, 12, 12), rand_crop=True, mean=True))
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    for (wd, wl, wp), (gd, gl, gp) in zip(*out):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp
    imglist = [([i % 3], "%d.jpg" % i) for i in range(7)]
    it = pimg.ImageIter(batch_size=7, data_shape=(3, 12, 12),
                        imglist=imglist, path_root=str(root))
    assert next(it).label[0].asnumpy().tolist() == [i % 3 for i in range(7)]


def test_image_iter_refuses_what_the_reference_refuses(tmp_path):
    with pytest.raises(pt.MXNetError, match="path_imgrec or path_imglist"):
        pimg.ImageIter(batch_size=2, data_shape=(3, 4, 4))
    with pytest.raises(ValueError, match="data_shape"):
        pimg.ImageIter(batch_size=2, data_shape=(4, 4), imglist=[])
