"""The port's ``gluon.data`` and ``metric`` against the reference, on
the CPU: datasets, samplers, the DataLoader's batches and shuffle order
under one numpy seed, its worker thread and read-ahead, and every metric
on the same inputs."""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu.gluon import data as ref_data
from mxnet_tpu_torch.gluon import data as port_data


@pytest.fixture(autouse=True)
def _port_config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)


def _xy(n=10):
    rng = np.random.RandomState(0)
    return (rng.rand(n, 3).astype(np.float32),
            rng.randint(0, 4, n).astype(np.float32))


# ---------------------------------------------------------------------------
# datasets and samplers
# ---------------------------------------------------------------------------
def test_array_and_simple_datasets_match_reference():
    x, y = _xy()
    for lib in (ref_data, port_data):
        ds = lib.ArrayDataset(x, y)
        assert len(ds) == 10
        a, b = ds[3]
        np.testing.assert_array_equal(a, x[3])
        assert b == y[3]
        single = lib.ArrayDataset(x)
        np.testing.assert_array_equal(single[2], x[2])
        simple = lib.SimpleDataset(list(range(5)))
        assert [simple[i] for i in range(len(simple))] == [0, 1, 2, 3, 4]
        assert list(simple.filter(lambda v: v % 2 == 0)._data) == [0, 2, 4]
        assert len(simple.take(2)) == 2
        t = ds.transform_first(lambda v: v * 2)
        np.testing.assert_array_equal(t[1][0], x[1] * 2)
        assert t[1][1] == y[1]
        eager = ds.transform(lambda a, b: (a.sum(), b), lazy=False)
        assert isinstance(eager, lib.SimpleDataset)
        np.testing.assert_allclose(eager[4][0], x[4].sum())
    with pytest.raises(ValueError, match="same length"):
        port_data.ArrayDataset(x, y[:3])


def test_array_dataset_of_ndarrays():
    x, y = _xy()
    ds = port_data.ArrayDataset(pt.nd.array(x, ctx=pt.cpu()),
                                pt.nd.array(y, ctx=pt.cpu()))
    a, b = ds[2]
    assert isinstance(a, pt.nd.NDArray) and a.shape == (3,)
    np.testing.assert_array_equal(a.asnumpy(), x[2])
    assert isinstance(b, np.float32) and b == y[2]      # 1-d kept as numpy


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_batch_sampler_matches_reference(last):
    got = []
    for lib in (ref_data, port_data):
        bs = lib.BatchSampler(lib.SequentialSampler(10), 4, last)
        got.append((list(bs), len(bs), list(bs), len(bs)))
    assert got[0] == got[1]
    if last == "rollover":
        # the two left over lead the next epoch
        assert got[1][2][0] == [8, 9, 0, 1]
    with pytest.raises(ValueError):
        list(port_data.BatchSampler(port_data.SequentialSampler(3), 2, "x"))


def test_random_sampler_shuffles_as_the_reference_does():
    orders = []
    for lib in (ref_data, port_data):
        np.random.seed(11)
        s = lib.RandomSampler(50)
        orders.append((list(s), list(s)))
    assert orders[0] == orders[1]
    assert sorted(orders[1][0]) == list(range(50))
    assert orders[1][0] != orders[1][1]


# ---------------------------------------------------------------------------
# the DataLoader
# ---------------------------------------------------------------------------
def _batches(lib, ctx, **kw):
    x, y = _xy(21)
    np.random.seed(5)
    with ctx:
        loader = lib.DataLoader(lib.ArrayDataset(x, y), batch_size=4, **kw)
        return len(loader), [(a.asnumpy(), b.asnumpy()) for a, b in loader]


@pytest.mark.parametrize("kw", [
    {}, {"shuffle": True}, {"shuffle": True, "last_batch": "discard"},
    {"shuffle": True, "num_workers": 2, "thread_pool": True}],
    ids=["sequential", "shuffle", "discard", "thread"])
def test_dataloader_batches_match_reference(kw):
    n_ref, ref = _batches(ref_data, mx.cpu(), **kw)
    n_got, got = _batches(port_data, pt.cpu(), **kw)
    assert n_ref == n_got == len(got) == len(ref)
    for (ra, rb), (ga, gb) in zip(ref, got):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)
        assert ga.dtype == ra.dtype == np.float32


def test_dataloader_batches_land_on_the_current_context():
    x, y = _xy(8)
    loader = port_data.DataLoader(port_data.ArrayDataset(x, y), batch_size=4,
                                  num_workers=1, thread_pool=True)
    with pt.cpu():
        data, label = next(iter(loader))
    assert data.context == pt.cpu() and label.context == pt.cpu()
    stacked = port_data.DataLoader(
        port_data.SimpleDataset([pt.nd.array(r, ctx=pt.cpu()) for r in x]),
        batch_size=3)
    with pt.cpu():
        first = next(iter(stacked))
    np.testing.assert_array_equal(first.asnumpy(), x[:3])


def test_dataloader_without_cuda_raises_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _xy(8)
    loader = port_data.DataLoader(port_data.ArrayDataset(x, y), batch_size=4)
    with pytest.raises(pt.MXNetError, match="no CUDA device"):
        next(iter(loader))


def test_dataloader_worker_processes_are_refused():
    x, y = _xy()
    with pytest.raises(pt.MXNetError, match="ROADMAP queue 1, item 9"):
        port_data.DataLoader(port_data.ArrayDataset(x, y), batch_size=4,
                             num_workers=2)


class _Failing(port_data.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise KeyError("sample %d is unreadable" % i)
        return np.float32(i)


def test_threaded_worker_errors_surface_in_the_consumer():
    loader = port_data.DataLoader(_Failing(), batch_size=2, num_workers=1,
                                  thread_pool=True)
    got = []
    with pt.cpu():
        with pytest.raises(RuntimeError, match="sample 5 is unreadable"):
            for batch in loader:
                got.append(batch.asnumpy())
    assert [list(b) for b in got] == [[0, 1], [2, 3]]


def test_threaded_loader_left_early_stops_its_worker():
    x, y = _xy(40)
    loader = port_data.DataLoader(port_data.ArrayDataset(x, y), batch_size=2,
                                  num_workers=1, thread_pool=True, prefetch=1)
    before = set(threading.enumerate())
    with pt.cpu():
        it = iter(loader)
        next(it)
        started = set(threading.enumerate()) - before
        it.close()
    assert started and not any(t.is_alive() for t in started)


class _Recording(port_data.Dataset):
    def __init__(self):
        self.read = []

    def __len__(self):
        return 12

    def __getitem__(self, i):
        self.read.append(i)
        return np.float32(i)


@pytest.mark.parametrize("depth", ["0", "2", "5"])
def test_prefetch_depth_reads_ahead(monkeypatch, depth):
    """With MXNET_PREFETCH_DEPTH = d, d batches have been made when the
    consumer gets the first (the reference's count)."""
    monkeypatch.setenv("MXNET_PREFETCH_DEPTH", depth)
    ds = _Recording()
    loader = port_data.DataLoader(ds, batch_size=2)
    with pt.cpu():
        it = iter(loader)
        first = next(it)
        ahead = len(ds.read) // 2
        rest = list(it)
    assert ahead == max(1, int(depth))
    assert [list(b.asnumpy()) for b in [first] + rest] == \
        [[2 * i, 2 * i + 1] for i in range(6)]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _metric_inputs(seed=0):
    rng = np.random.RandomState(seed)
    probs = rng.rand(6, 4).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    labels = rng.randint(0, 4, 6).astype(np.float32)
    binary = rng.randint(0, 2, 6).astype(np.float32)
    reg = rng.randn(6).astype(np.float32)
    return probs, labels, binary, reg


def _feval(label, pred):
    return float(np.abs(label - pred.argmax(1)).sum()), len(label)


METRICS = [
    ("acc", {}, "probs"), ("top_k_acc", {"top_k": 2}, "probs"),
    ("f1", {}, "binary"), ("mae", {}, "reg"), ("mse", {}, "reg"),
    ("rmse", {}, "reg"), ("ce", {}, "probs"), ("nll_loss", {}, "probs"),
    ("perplexity", {"ignore_label": 3}, "probs"), ("loss", {}, "loss"),
    ("pearsoncorrelation", {}, "reg"), ("composite", {}, "probs"),
    ("custom", {}, "probs")]


def _make(lib, name, kw):
    if name == "composite":
        return lib.metric.create(["acc", "ce"])
    if name == "custom":
        return lib.metric.CustomMetric(_feval, name="dist")
    return lib.metric.create(name, **kw)


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=[m[0] for m in METRICS])
def test_metric_matches_reference(name, kw, kind):
    results = []
    for lib, ctx in ((mx, mx.cpu()), (pt, pt.cpu())):
        m = _make(lib, name, kw)
        for seed in (0, 1):
            probs, labels, binary, reg = _metric_inputs(seed)
            if kind == "binary":
                pred = np.stack([1 - binary[::-1], binary[::-1]], 1)
                label, pred = binary, pred
            elif kind == "reg":
                label, pred = reg, reg * 0.5 + 0.1
            else:
                label, pred = labels, probs
            m.update([lib.nd.array(label, ctx=ctx)],
                     [lib.nd.array(pred, ctx=ctx)])
        results.append((m.get(), m.get_name_value()))
        m.reset()
        assert np.isnan(np.asarray(m.get()[1], np.float64)).all() or \
            name == "composite"
    (ref, ref_nv), (got, got_nv) = results
    assert got[0] == ref[0]
    np.testing.assert_allclose(np.asarray(got[1], np.float64),
                               np.asarray(ref[1], np.float64), rtol=1e-6)
    assert [n for n, _ in got_nv] == [n for n, _ in ref_nv]


def test_metric_registry_and_np_metric():
    assert isinstance(pt.metric.create("acc"), pt.metric.Accuracy)
    assert isinstance(pt.metric.create("top_k_accuracy", top_k=3),
                      pt.metric.TopKAccuracy)
    with pytest.raises(pt.MXNetError, match="Cannot find 'nope'"):
        pt.metric.create("nope")
    m = pt.metric.np_metric(_feval)
    probs, labels, _, _ = _metric_inputs()
    m.update([pt.nd.array(labels, ctx=pt.cpu())],
             [pt.nd.array(probs, ctx=pt.cpu())])
    want = _feval(labels, probs)
    assert m.get() == ("_feval", want[0] / want[1])
    cfg = pt.metric.Accuracy(axis=1).get_config()
    assert cfg["metric"] == "Accuracy" and cfg["axis"] == 1
