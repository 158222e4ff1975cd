"""The port's DataLoader worker processes (``num_workers > 0``), on the
CPU: the reference's multiprocess tests (``tests/test_gluon_data.py``)
run on the port, and the batches held against the reference's own
loader for the same data and sampler seed. Ordering and values, real
processes, an error in a worker, crash supervision with respawn and
degrade (through a poison sample and through the ``dl_worker`` fault
sites), batchify equivalence, a custom batchify with dicts, no
shared-memory segment left behind, a chain of NDArrays sent to the
threaded prefetcher with a warning, a generator batch sampler keeping
batch 0, one ``np.random`` seed a worker, and what a worker may touch.
Every comparison is bit for bit.
"""
import glob
import os
import time
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as pt
from mxnet_tpu.gluon import data as ref_data
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import data as gdata


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    pt.faultinject.reset()
    with pt.cpu():
        yield
    pt.faultinject.reset()


def _segments():
    from mxnet_tpu_torch.gluon.data.dataloader import SHM_PREFIX
    return set(glob.glob("/dev/shm/%s*" % SHM_PREFIX))


# ---------------------------------------------------------------------------
# the reference's tests, on the port
# ---------------------------------------------------------------------------
def test_mp_dataloader_ordering_and_values():
    data = np.arange(97 * 5, dtype=np.float32).reshape(97, 5)
    label = np.arange(97, dtype=np.int32)
    loader = gdata.DataLoader(gdata.ArrayDataset(data, label), batch_size=10,
                              num_workers=3)
    parent = os.getpid()
    seen = 0
    for i, (x, y) in enumerate(loader):
        lo, hi = i * 10, min(i * 10 + 10, 97)
        np.testing.assert_array_equal(x.asnumpy(), data[lo:hi])
        np.testing.assert_array_equal(y.asnumpy(), label[lo:hi])
        assert y.dtype == np.int32 and x.context == pt.cpu()
        seen += hi - lo
    assert seen == 97 and os.getpid() == parent


class _PidDataset(gdata.Dataset):
    def __len__(self):
        return 16

    def __getitem__(self, i):
        return np.array([os.getpid()], np.int64)


def test_mp_dataloader_uses_real_processes():
    pids = set()
    for batch in gdata.DataLoader(_PidDataset(), batch_size=4, num_workers=2):
        pids.update(int(p) for p in batch.asnumpy().ravel())
    assert os.getpid() not in pids
    assert 1 <= len(pids) <= 2


class _Exploding(gdata.Dataset):
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 7:
            raise ValueError("bad sample 7")
        return np.zeros(3, np.float32)


def test_mp_dataloader_worker_exception_surfaces():
    with pytest.raises(RuntimeError, match="bad sample 7"):
        list(gdata.DataLoader(_Exploding(), batch_size=4, num_workers=2))


class _Crashing(gdata.Dataset):
    """Item 5 kills every worker that reads it; the parent reads it."""

    def __init__(self):
        self._parent = os.getpid()

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5 and os.getpid() != self._parent:
            os._exit(11)
        return np.full(2, float(i), np.float32)


def test_mp_dataloader_worker_crash_supervised():
    """Respawn, then degrade; a worker killed before its queue flushed a
    result leaves no segment behind."""
    before = _segments()
    loader = gdata.DataLoader(_Crashing(), batch_size=4, num_workers=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        batches = list(loader)
    assert not _segments() - before
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[1].asnumpy()[:, 0], [4, 5, 6, 7])
    msgs = [str(w.message) for w in caught]
    assert sum("respawning" in m for m in msgs) == 2       # the budget, 2
    assert any("degrading to in-process" in m for m in msgs)


@pytest.mark.parametrize("restarts", ["0", "1"])
def test_restart_budget_and_fault_sites(monkeypatch, restarts):
    """``dl_worker`` kills the first workers at their first batch,
    ``dl_worker_respawn`` every respawned one: the loader respawns
    MXNET_DATALOADER_RESTARTS times, then finishes the epoch in-process
    with the same batches."""
    monkeypatch.setenv("MXNET_DATALOADER_RESTARTS", restarts)
    pt.faultinject.set_fault("dl_worker", 1.0)
    pt.faultinject.set_fault("dl_worker_respawn", 1.0)
    data = np.arange(24, dtype=np.float32).reshape(12, 2)
    loader = gdata.DataLoader(gdata.ArrayDataset(data), batch_size=4,
                              num_workers=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = [b.asnumpy() for b in loader]
    np.testing.assert_array_equal(np.concatenate(got), data)
    msgs = [str(w.message) for w in caught]
    assert sum("respawning" in m for m in msgs) == int(restarts)
    assert sum("degrading" in m for m in msgs) == 1


def test_mp_batchify_equivalence():
    data = np.random.RandomState(0).rand(20, 4).astype(np.float32)
    label = np.arange(20, dtype=np.float32)
    ds = gdata.ArrayDataset(data, label)
    sync = list(gdata.DataLoader(ds, batch_size=6, num_workers=0))
    mp = list(gdata.DataLoader(ds, batch_size=6, num_workers=2))
    assert len(sync) == len(mp)
    for (xs, ys), (xm, ym) in zip(sync, mp):
        np.testing.assert_array_equal(xs.asnumpy(), xm.asnumpy())
        np.testing.assert_array_equal(ys.asnumpy(), ym.asnumpy())
        assert xs.dtype == xm.dtype and ys.dtype == ym.dtype


def _fancy(samples):
    arr = np.stack(samples)
    return {"x": arr, "meta": (arr * 2, float(arr.sum()))}


def test_mp_dataloader_custom_batchify_and_dict():
    loader = gdata.DataLoader(
        gdata.ArrayDataset(np.arange(12, dtype=np.float32)), batch_size=4,
        num_workers=2, batchify_fn=_fancy)
    got = list(loader)
    assert len(got) == 3
    np.testing.assert_array_equal(got[0]["x"].asnumpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(got[0]["meta"][0].asnumpy(), [0, 2, 4, 6])
    assert isinstance(got[0]["meta"], tuple) and got[0]["meta"][1] == 6.0


def test_mp_dataloader_no_shm_leak():
    before = _segments()
    ds = gdata.ArrayDataset(np.zeros((40, 8), np.float32))
    list(gdata.DataLoader(ds, batch_size=4, num_workers=2))
    it = iter(gdata.DataLoader(ds, batch_size=4, num_workers=2))
    next(it)
    it.close()      # left early
    time.sleep(0.3)
    assert not _segments() - before


def test_ndarray_chain_goes_to_threads_with_one_warning():
    """A transform that makes NDArrays must not run in a forked child;
    the probe sends it to the threaded prefetcher with one warning, and
    the values are those of the same chain loaded in-process."""
    x = np.random.RandomState(0).rand(16, 4, 4, 3).astype(np.float32)
    ds = gdata.ArrayDataset(x).transform(
        lambda v: nd.array(v).transpose((2, 0, 1)) * 2.0)
    loader = gdata.DataLoader(ds, batch_size=4, num_workers=2)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = [b.asnumpy() for b in loader]
        again = [b.asnumpy() for b in loader]
    assert sum("fork" in str(r.message) for r in rec) == 1
    want = [b.asnumpy() for b in gdata.DataLoader(ds, batch_size=4)]
    for a, b, c in zip(out, again, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert out[0].shape == (4, 3, 4, 4)


def test_threaded_loader_surfaces_errors():
    loader = gdata.DataLoader(_Exploding(), batch_size=4, num_workers=2,
                              thread_pool=True)
    with pytest.raises(RuntimeError, match="bad sample 7"):
        list(loader)


def test_mp_loader_generator_batch_sampler_keeps_batch0():
    data = np.arange(20 * 2, dtype=np.float32).reshape(20, 2)
    gen = (list(range(i, i + 4)) for i in range(0, 20, 4))
    out = list(gdata.DataLoader(gdata.ArrayDataset(data), batch_sampler=gen,
                                num_workers=2))
    assert len(out) == 5
    np.testing.assert_array_equal(out[0].asnumpy(), data[0:4])


# ---------------------------------------------------------------------------
# against the reference's loader
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("workers", [1, 4])
def test_shuffled_worker_batches_equal_the_reference(workers):
    """The same numpy data and sampler seed: the port's worker batches
    equal the reference's in-process ones, in order, bit for bit."""
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (45, 6, 5, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 45).astype(np.int32)
    got, ref = [], []
    for lib, out, kw in ((gdata, got, {"num_workers": workers}),
                         (ref_data, ref, {})):
        np.random.seed(8)
        loader = lib.DataLoader(lib.ArrayDataset(x, y), batch_size=8,
                                shuffle=True, last_batch="rollover", **kw)
        out.extend((a.asnumpy(), b.asnumpy()) for a, b in loader)
    assert len(got) == len(ref) == 5
    for (ga, gb), (ra, rb) in zip(got, ref):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)
        assert ga.dtype == ra.dtype == np.uint8


class _Noisy(gdata.Dataset):
    """A numpy chain that draws from np.random in the worker."""

    def __len__(self):
        return 24

    def __getitem__(self, i):
        return np.float32(i) + np.random.rand(3).astype(np.float32)


def test_each_worker_has_its_own_seeded_stream():
    """Workers are seeded from one draw of the parent's np.random: a
    seeded parent repeats its epoch exactly with one worker (with more,
    which worker takes which batch is a race, as in the reference), and
    two workers do not repeat each other's draws."""
    runs = []
    for _ in range(2):
        np.random.seed(5)
        runs.append(np.concatenate([b.asnumpy() for b in gdata.DataLoader(
            _Noisy(), batch_size=4, num_workers=1)]))
    np.testing.assert_array_equal(runs[0], runs[1])
    two = np.concatenate([b.asnumpy() for b in gdata.DataLoader(
        _Noisy(), batch_size=4, num_workers=2)])
    noise = two - np.arange(24, dtype=np.float32)[:, None]
    assert len(np.unique(noise.round(6))) == noise.size


class _WhereAmI(gdata.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        ctx = pt.context.current_context()
        return np.array([ctx.device_type == "cpu", torch.get_num_threads()],
                        np.int64)


def test_worker_runs_on_the_cpu_with_one_thread():
    """Inside a worker the current context is the CPU whatever the
    parent's is (a child of a CUDA process must not touch the card), and
    torch runs one thread. The batches are read on the host side of the
    loader, before any staging."""
    loader = gdata.DataLoader(_WhereAmI(), batch_size=2, num_workers=2)
    with pt.gpu(0):
        got = [b.asnumpy() for b in loader._iter_batches(pt.cpu())]
    np.testing.assert_array_equal(np.concatenate(got), np.ones((4, 2)))


def test_shared_memory_hop_round_trips_the_tree():
    from mxnet_tpu_torch.gluon.data import dataloader as dl
    batch = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
             "b": [np.float32(2.5) * np.ones((3,), np.float32), "tag", 7],
             "c": (np.zeros((0, 4), np.float64),)}
    before = _segments()
    name = dl._pack_shm(batch)
    assert name[0].startswith(dl.SHM_PREFIX)
    out = dl._unpack_shm(*name)
    assert not _segments() - before
    np.testing.assert_array_equal(out["a"].asnumpy(), batch["a"])
    assert out["a"].dtype == np.int64
    np.testing.assert_array_equal(out["b"][0].asnumpy(), batch["b"][0])
    assert out["b"][1:] == ["tag", 7] and isinstance(out["c"], tuple)
    assert out["c"][0].shape == (0, 4)
