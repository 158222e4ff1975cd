"""The port's ``gluon.data.vision`` and ``nd.image`` ops against the
reference, on the CPU: MNIST, FashionMNIST, CIFAR-10 and CIFAR-100 read
from files the tests write (idx, gz or not; the binary batches),
``SyntheticImageDataset``, every transform under one ``np.random`` seed,
and the 15 ``_image_*`` ops.

Tolerances: the datasets and transforms bit for bit (the same numpy
arithmetic and draws in both packages); the deterministic image ops bit
for bit where they move values, within 1e-5 (f32) or one unit of a
uint8 (a rounding of x.5 the two packages' f32 sums reach from either
side) where they compute: to_tensor (XLA's division by 255 rounds
differently from torch's), resize, the colour blends and lighting. The
random ops are held the same way at pinned factors (min = max, p in
{0, 1}), and by distribution otherwise: the port draws from its own
generator where the reference splits a PRNG key.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.data import vision as rvision
from mxnet_tpu.gluon.data.vision import transforms as rtf

import mxnet_tpu_torch as pt
from chip_smoke import _write_idx
from mxnet_tpu_torch.gluon.data import vision as pvision
from mxnet_tpu_torch.gluon.data.vision import transforms as ptf


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with pt.cpu():
        yield


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _items_equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for u, v in zip(a[i], b[i]):
            np.testing.assert_array_equal(_np(u), _np(v))
            assert _np(u).dtype == _np(v).dtype


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gz", [True, False], ids=["gz", "raw"])
@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_reads_idx_files_as_the_reference(tmp_path, gz, cls):
    rng = np.random.RandomState(0)
    for prefix, n in (("train", 12), ("t10k", 5)):
        _write_idx(str(tmp_path), prefix,
                   rng.randint(0, 256, (n, 28, 28)).astype(np.uint8),
                   rng.randint(0, 10, n).astype(np.uint8), gz)
    for train in (True, False):
        ref = getattr(rvision, cls)(root=str(tmp_path), train=train)
        got = getattr(pvision, cls)(root=str(tmp_path), train=train)
        _items_equal(got, ref)
        assert got[0][0].shape == (28, 28, 1) and got[0][0].dtype == np.uint8
        assert isinstance(got[0][0], np.ndarray)
        assert got._label.dtype == np.int32
    base = pvision.MNIST(root=str(tmp_path))
    t = pvision.MNIST(root=str(tmp_path),
                      transform=lambda d, l: (d.astype(np.float32) / 255, l))
    np.testing.assert_array_equal(t[3][0], base._data[3] / np.float32(255))


def test_missing_files_raise_as_the_reference(tmp_path):
    for cls in ("MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"):
        for lib in (rvision, pvision):
            with pytest.raises(FileNotFoundError, match="not found"):
                getattr(lib, cls)(root=str(tmp_path / cls))


def _cifar_rows(rng, n, labels):
    return np.concatenate(
        [rng.randint(0, hi, (n, 1)) for hi in labels]
        + [rng.randint(0, 256, (n, 3072))], axis=1).astype(np.uint8)


def test_cifar10_reads_binary_batches_as_the_reference(tmp_path):
    rng = np.random.RandomState(1)
    for name in ["data_batch_%d.bin" % i for i in range(1, 6)] + \
            ["test_batch.bin"]:
        _cifar_rows(rng, 3, [10]).tofile(str(tmp_path / name))
    for train in (True, False):
        ref = rvision.CIFAR10(root=str(tmp_path), train=train)
        got = pvision.CIFAR10(root=str(tmp_path), train=train)
        _items_equal(got, ref)
        assert len(got) == (15 if train else 3)
        assert got[0][0].shape == (32, 32, 3)


@pytest.mark.parametrize("fine", [False, True], ids=["coarse", "fine"])
def test_cifar100_reads_binary_batches_as_the_reference(tmp_path, fine):
    rng = np.random.RandomState(2)
    for name in ("train.bin", "test.bin"):
        _cifar_rows(rng, 4, [20, 100]).tofile(str(tmp_path / name))
    for train in (True, False):
        ref = rvision.CIFAR100(root=str(tmp_path), fine_label=fine,
                               train=train)
        got = pvision.CIFAR100(root=str(tmp_path), fine_label=fine,
                               train=train)
        _items_equal(got, ref)
    raw = np.fromfile(str(tmp_path / "test.bin"), np.uint8).reshape(-1, 3074)
    np.testing.assert_array_equal(got._label, raw[:, 1 if fine else 0])


def test_synthetic_dataset_matches_the_reference():
    kw = dict(num_samples=7, shape=(6, 5, 3), num_classes=4, seed=3)
    _items_equal(pvision.SyntheticImageDataset(**kw),
                 rvision.SyntheticImageDataset(**kw))
    f = pvision.SyntheticImageDataset(dtype="float32", **kw)
    assert f[0][0].dtype == np.float32


@pytest.mark.parametrize("cls", ["ImageRecordDataset", "ImageFolderDataset"])
def test_decoding_datasets_name_the_roadmap(tmp_path, cls):
    """The ROADMAP entry these named (item 9, second part) is ported:
    both datasets decode now, as the reference's do (the record dataset
    in RGB, the reference's in BGR; tests/test_torch_record_datasets.py
    holds them item for item)."""
    cv2 = pytest.importorskip("cv2")
    img = _image(np.uint8, shape=(9, 7, 3))
    if cls == "ImageRecordDataset":
        from mxnet_tpu_torch import recordio
        rec = str(tmp_path / "a.rec")
        w = recordio.MXIndexedRecordIO(str(tmp_path / "a.idx"), rec, "w")
        w.write_idx(0, recordio.pack_img((0, 3.0, 0, 0), img, img_fmt=".png"))
        w.close()
        got, want = getattr(pvision, cls)(rec), getattr(rvision, cls)(rec)
        flip = slice(None, None, -1)
    else:
        (tmp_path / "c").mkdir()
        cv2.imwrite(str(tmp_path / "c" / "a.png"), img)
        got = getattr(pvision, cls)(str(tmp_path))
        want = getattr(rvision, cls)(str(tmp_path))
        flip = slice(None)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0][0].asnumpy(),
                                  want[0][0].asnumpy()[:, :, flip])
    np.testing.assert_array_equal(got[0][0].asnumpy(), img[:, :, ::-1])
    assert got[0][1] == want[0][1]


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
def _image(dtype, shape=(13, 11, 3), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.rand(*shape).astype(dtype)


def _transform_pair(make, img, seed=4, wrap=False):
    """``make(transforms)`` applied in both packages under one
    np.random seed; returns (port, reference) as numpy."""
    out = []
    for tf, lib, ctx in ((ptf, pt, pt.cpu()), (rtf, mx, mx.cpu())):
        np.random.seed(seed)
        x = lib.nd.array(img, ctx=ctx, dtype=img.dtype) if wrap else img
        got = make(tf)(x)
        assert isinstance(got, lib.nd.NDArray)
        out.append(got.asnumpy())
    return out


TRANSFORMS = {
    "to_tensor": lambda tf: tf.ToTensor(),
    "normalize": lambda tf: tf.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.25)),
    "normalize_scalar": lambda tf: tf.Normalize(0.5, 0.25),
    "cast": lambda tf: tf.Cast("float16"),
    "resize_down": lambda tf: tf.Resize((5, 7)),
    "resize_up": lambda tf: tf.Resize(17),
    "center_crop": lambda tf: tf.CenterCrop((6, 4)),
    "random_resized_crop": lambda tf: tf.RandomResizedCrop(8),
    "random_resized_crop_fallback": lambda tf: tf.RandomResizedCrop(
        (9, 9), scale=(3.0, 4.0)),
    "flip_lr": lambda tf: tf.RandomFlipLeftRight(),
    "flip_tb": lambda tf: tf.RandomFlipTopBottom(),
    "compose": lambda tf: tf.Compose([
        tf.RandomResizedCrop(10), tf.RandomFlipLeftRight(), tf.ToTensor(),
        tf.Normalize((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))]),
}


@pytest.mark.parametrize("wrap", [False, True], ids=["numpy", "ndarray"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=str)
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_the_reference(name, dtype, wrap):
    img = _image(dtype)
    if name == "normalize" or name == "normalize_scalar":
        img = img.transpose(2, 0, 1).astype(np.float32)
    for seed in range(4):
        got, ref = _transform_pair(TRANSFORMS[name], img, seed, wrap)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_transforms_land_on_the_current_context():
    out = ptf.ToTensor()(_image(np.uint8))
    assert out.context == pt.cpu() and out.shape == (3, 13, 11)
    assert out.dtype == np.float32


# ---------------------------------------------------------------------------
# nd.image ops
# ---------------------------------------------------------------------------
def _op_pair(name, img, **attrs):
    out = []
    for lib, ctx in ((pt, pt.cpu()), (mx, mx.cpu())):
        x = lib.nd.array(img, ctx=ctx, dtype=img.dtype)
        out.append(getattr(lib.nd, name)(x, **attrs).asnumpy())
    return out


def _close(got, ref, exact):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    elif got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


DETERMINISTIC = [
    ("_image_to_tensor", {}, False),      # XLA divides by a reciprocal
    ("_image_flip_left_right", {}, True),
    ("_image_flip_top_bottom", {}, True),
    ("_image_crop", {"x": 2, "y": 3, "width": 5, "height": 4}, True),
    ("_image_resize", {"size": (7, 5)}, False),
    ("_image_resize", {"size": 19}, False),
    ("_image_resize", {"size": (6, 4), "interp": 0}, True),
    ("_image_resize", {"size": (23, 17), "interp": 0}, True),
    ("_image_adjust_lighting", {"alpha": (0.02, -0.01, 0.03)}, False),
]


@pytest.mark.parametrize("batched", [False, True], ids=["hwc", "nhwc"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=str)
@pytest.mark.parametrize("name,attrs,exact", DETERMINISTIC,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_image_op_matches_the_reference(name, attrs, exact, dtype, batched):
    img = _image(dtype, (2, 13, 11, 3) if batched else (13, 11, 3))
    if dtype == np.float32:
        img = img * 255
    _close(*_op_pair(name, img, **attrs), exact)


@pytest.mark.parametrize("batched", [False, True], ids=["chw", "nchw"])
def test_image_normalize_matches_the_reference(batched):
    img = _image(np.float32, (2, 3, 6, 5) if batched else (3, 6, 5))
    _close(*_op_pair("_image_normalize", img, mean=(0.1, 0.2, 0.3),
                     std=(0.5, 0.25, 2.0)), True)


PINNED = [
    ("_image_random_flip_left_right", {"p": 0.0}, True),
    ("_image_random_flip_left_right", {"p": 1.0}, True),
    ("_image_random_flip_top_bottom", {"p": 0.0}, True),
    ("_image_random_flip_top_bottom", {"p": 1.0}, True),
    ("_image_random_brightness", {"min_factor": 0.7, "max_factor": 0.7},
     False),
    ("_image_random_contrast", {"min_factor": 1.3, "max_factor": 1.3},
     False),
    ("_image_random_saturation", {"min_factor": 0.4, "max_factor": 0.4},
     False),
    ("_image_random_hue", {"min_factor": 0.2, "max_factor": 0.2}, False),
    ("_image_random_hue", {"min_factor": -0.35, "max_factor": -0.35},
     False),
    ("_image_random_color_jitter", {}, True),
    ("_image_random_lighting", {"alpha_std": 0.0}, False),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=str)
@pytest.mark.parametrize("name,attrs,exact", PINNED,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_random_image_op_at_pinned_factors(name, attrs, exact, dtype):
    img = _image(dtype, (2, 9, 7, 3))
    if dtype == np.float32:
        img = img * 255
    _close(*_op_pair(name, img, **attrs), exact)


def _factor(op, img, lib, ctx, **attrs):
    """The factor a brightness draw applied, read back from a constant
    float image."""
    x = lib.nd.array(img, ctx=ctx)
    return float(getattr(lib.nd, op)(x, **attrs).asnumpy().ravel()[0]) \
        / float(img.ravel()[0])


def test_random_draws_match_the_reference_by_distribution():
    """Uniform factors in [min, max) and a flip of probability p: 400
    draws of each package within 5 binomial sigma of each other's
    mean, and inside the range."""
    img = np.full((1, 1, 3), 100.0, np.float32)
    pt.random.seed(7)
    mx.random.seed(7)
    draws = {lib.__name__: np.array([
        _factor("_image_random_brightness", img, lib, ctx,
                min_factor=0.5, max_factor=1.5) for _ in range(400)])
        for lib, ctx in ((pt, pt.cpu()), (mx, mx.cpu()))}
    for d in draws.values():
        assert d.min() >= 0.5 and d.max() < 1.5
    sigma = np.sqrt(1 / 12 / 400)
    assert abs(draws["mxnet_tpu_torch"].mean() - 1.0) < 5 * sigma
    assert abs(draws["mxnet_tpu"].mean() - 1.0) < 5 * sigma
    strip = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
    flips = [float((pt.nd._image_random_flip_left_right(
        pt.nd.array(strip), p=0.3).asnumpy()[0, 0] != strip[0, 0]).all())
        for _ in range(400)]
    assert abs(np.mean(flips) - 0.3) < 5 * np.sqrt(0.3 * 0.7 / 400)


def test_random_image_ops_repeat_under_a_seed():
    img = pt.nd.array(_image(np.uint8, (9, 7, 3)), dtype=np.uint8)
    runs = []
    for _ in range(2):
        pt.random.seed(11)
        runs.append([op(img, **kw).asnumpy() for op, kw in (
            (pt.nd.image.random_color_jitter,
             dict(brightness=0.3, contrast=0.3, saturation=0.3, hue=0.1)),
            (pt.nd.image.random_lighting, dict(alpha_std=0.1)))])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0][0], img.asnumpy())


def test_image_namespace_names_the_fifteen_ops():
    from mxnet_tpu import ops as rops
    from mxnet_tpu_torch import ops as pops
    ref = {n for n in rops._OPS if n.startswith("_image_")}
    assert ref == {n for n in pops._OPS if n.startswith("_image_")}
    assert len(ref) == 15
    assert set(dir(pt.nd.image)) == {n[len("_image_"):] for n in ref}
    x = pt.nd.array(_image(np.uint8), dtype=np.uint8)
    np.testing.assert_array_equal(pt.nd.image.to_tensor(x).asnumpy(),
                                  pt.nd._image_to_tensor(x).asnumpy())
