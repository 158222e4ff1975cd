"""Worker body of the port's multi-process tests (the counterpart of
tests/dist_worker.py and tests/dist_trainer_worker.py; ref pattern:
tests/nightly/dist_sync_kvstore.py).

Started by ``python -m mxnet_tpu_torch.tools.launch -n 2 --cpu-devices N``
with the ``DMLC_*`` environment, on gloo over CPU contexts. ``TEST_CASE``
picks the body: ``main`` runs the kvstore, Trainer, vote, watchdog and
fleet checks in one group, ``bert`` trains the 2-layer BERT slice. Each
rank hands its findings to :func:`emit`; the pytest side compares the
ranks and the reference.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

_EMITTED = [0]


def emit(out):
    """One rank's findings: a file of its own under ``TEST_RESULT_DIR``
    when that is set (the ranks share one stdout pipe, and two ranks'
    lines can interleave there), else one ``RESULT <json>`` line."""
    line = json.dumps(out)
    folder = os.environ.get("TEST_RESULT_DIR")
    if not folder:
        print("RESULT " + line, flush=True)
        return
    _EMITTED[0] += 1
    path = os.path.join(folder, "%d-%d.json" % (os.getpid(), _EMITTED[0]))
    with open(path + ".tmp", "w") as f:
        f.write(line)
    os.replace(path + ".tmp", path)


def _digest(arrays):
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def dense_net(mx, ctxs):
    """The Dense(3) of the reference's trainer worker, its weights fixed."""
    net = mx.gluon.nn.Dense(3, in_units=4, prefix="dense0_")
    net.initialize(ctx=ctxs)
    net.weight.set_data(np.arange(12, dtype=np.float32).reshape(3, 4) / 10)
    net.bias.set_data(np.zeros(3, np.float32))
    return net


def dense_batch(total):
    rng = np.random.RandomState(7)
    return (rng.rand(total, 4).astype(np.float32),
            rng.rand(total, 3).astype(np.float32))


DENSE_STEPS = 3


def _dense_steps(mx, kv, ctxs, rank, nw, steps=DENSE_STEPS):
    """SGD steps with momentum over the kvstore: rank r's context d
    takes rows r*nloc+d, (r*nloc+d)+total, ... of the global batch."""
    from mxnet_tpu_torch import autograd, gluon, nd
    nloc = len(ctxs)
    total = nw * nloc
    net = dense_net(mx, ctxs)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            kvstore=kv)
    loss_fn = gluon.loss.L2Loss()
    X, Y = dense_batch(total * steps)
    for s in range(steps):
        with autograd.record():
            losses = []
            for d in range(nloc):
                row = s * total + rank * nloc + d
                x = nd.array(X[row:row + 1], ctx=ctxs[d])
                y = nd.array(Y[row:row + 1], ctx=ctxs[d])
                losses.append(loss_fn(net(x), y))
        for loss in losses:
            loss.backward()
        trainer.step(batch_size=total)
    return net, trainer


def case_main():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, faultinject, nd, telemetry
    from mxnet_tpu_torch.guardrails import NonFiniteGradientError
    out = {}
    kv = mx.kvstore.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    ctxs = dist.local_contexts()
    nloc = len(ctxs)
    out.update(rank=rank, nw=nw, nloc=nloc, backend=kv.backend,
               dist_backend=dist.backend(), type=kv.type)
    total = nw * nloc
    expect = total * (total + 1) / 2.0

    # exact sums: replica d of rank r carries r*nloc+d+1
    vals = [nd.full((4, 5), rank * nloc + d + 1, ctx=ctxs[d])
            for d in range(nloc)]
    kv.init("w0", vals[0])
    kv.push("w0", vals)
    outs = [nd.zeros((4, 5), ctx=c) for c in ctxs]
    kv.pull("w0", out=outs)
    out["push_pull"] = [float(np.abs(o.asnumpy() - expect).max())
                        for o in outs]
    keys = ["p%d" % i for i in range(5)]
    values = []
    for i in range(5):
        values.append([nd.full((3,), (i + 1) * (rank * nloc + d + 1),
                               ctx=ctxs[d]) for d in range(nloc)])
        kv.init(keys[i], values[i][0])
    kv.pushpull_list(keys, values)
    out["pushpull_list"] = [float(np.abs(v.asnumpy() - (i + 1) * expect)
                                  .max())
                            for i in range(5) for v in values[i]]
    pulled = nd.zeros((3,), ctx=ctxs[0])
    kv.pull("p4", out=pulled)
    out["store_after_list"] = float(np.abs(pulled.asnumpy() - 5 * expect)
                                    .max())

    # dist_async: accepted, the same synchronous sum
    kva = mx.kvstore.create("dist_async")
    g = [nd.full((2,), rank * nloc + d + 1, ctx=ctxs[d])
         for d in range(nloc)]
    kva.pushpull("a", g)
    out["async"] = {"type": kva.type,
                    "err": float(max(np.abs(a.asnumpy() - expect).max()
                                     for a in g))}

    # P3 slices against dist_sync, bit for bit
    os.environ["MXNET_KVSTORE_BIGARRAY_BOUND"] = "64"
    p3 = mx.kvstore.create("p3store_dist")
    rs = np.random.RandomState(100 + rank)
    shapes = [(8, 16), (3,), (40, 5)]
    raw = [[rs.randn(*s).astype(np.float32) for s in shapes]
           for _ in ctxs]

    def _arrays():
        return [[nd.array(raw[d][k], ctx=ctxs[d]) for d in range(nloc)]
                for k in range(len(shapes))]
    a_sync, a_p3 = _arrays(), _arrays()
    kv.pushpull_list(["s%d" % k for k in range(3)], a_sync)
    p3.pushpull_list(["s%d" % k for k in range(3)], a_p3)
    out["p3_equal"] = all(np.array_equal(x.asnumpy(), y.asnumpy())
                          for xs, ys in zip(a_sync, a_p3)
                          for x, y in zip(xs, ys))
    fresh = [nd.full((8, 16), rank * nloc + d + 1, ctx=ctxs[d])
             for d in range(nloc)]
    p3.pushpull_list(["fresh"], [fresh])
    got = nd.zeros((8, 16), ctx=ctxs[0])
    p3.pull("fresh", out=got)
    out["p3_fresh"] = float(np.abs(got.asnumpy() - expect).max())

    # the Trainer over dist_sync, telemetry on for commwatch
    os.environ["MXNET_TELEMETRY"] = "1"
    telemetry.refresh()
    telemetry.reset()
    net, trainer = _dense_steps(mx, kv, ctxs, rank, nw)
    params = [net.weight.data(c).asnumpy() for c in ctxs] + \
        [net.bias.data(c).asnumpy() for c in ctxs]
    out["trainer"] = {"weight": params[0].tolist(),
                      "bias": params[nloc].tolist(),
                      "replicas_equal": all(
                          np.array_equal(params[0], params[d])
                          and np.array_equal(params[nloc], params[nloc + d])
                          for d in range(nloc)),
                      "digest": _digest(params)}
    rows = mx.commwatch.report()
    out["commwatch"] = [{k: r[k] for k in ("op", "axis", "ops", "bytes",
                                           "exposed_s", "busbw")}
                        for r in rows]
    out["kv_calls"] = {k: v for k, v in
                       telemetry.snapshot()["counters"].items()
                       if k.startswith("mx_kvstore_calls_total")}

    # the fleet view across the two ranks
    for _ in range(3):
        time.sleep(0.1 * rank)   # rank 1 is the slow one
        telemetry.mark_step()
    view = telemetry.fleet_snapshot()
    out["fleet"] = {"nw": view["nw"], "rank": view["rank"],
                    "slowest": view["slowest"],
                    "steps": [r["steps"] for r in view["ranks"]],
                    "comm_bytes": [r["comm_bytes"] for r in view["ranks"]]}
    out["allgather"] = dist.allgather_floats([rank, 10.0 + rank],
                                             tag="test").tolist()
    fleet = dist.fleet_kv()
    fleet.set("mx/test/r%d" % rank, "v%d" % rank)
    dist.barrier()
    out["fleet_kv"] = sorted(fleet.dir_get("mx/test/").items())
    os.environ["MXNET_TELEMETRY"] = "0"
    telemetry.refresh()

    # the finite vote: nan_grad armed on rank 1 only
    os.environ["MXNET_GUARD_COMM_VOTE"] = "1"
    if rank == 1:
        faultinject.set_fault("nan_grad", 1.0, max_fires=1)
    try:
        _dense_steps(mx, kv, ctxs, rank, nw, steps=1)
        out["vote"] = "no error"
    except NonFiniteGradientError as e:
        out["vote"] = str(e)
    os.environ["MXNET_GUARD_COMM_VOTE"] = "0"
    faultinject.reset()

    # kv_hang under MXNET_KVSTORE_TIMEOUT: every attempt hangs
    os.environ["MXNET_KVSTORE_TIMEOUT"] = "0.5"
    os.environ["MXNET_KVSTORE_RETRIES"] = "1"
    faultinject.set_fault("kv_hang", 1.0)
    t0 = time.monotonic()
    try:
        kv.pushpull("w0", [nd.ones((4, 5), ctx=c) for c in ctxs])
        out["kv_hang"] = {"error": None}
    except mx.MXNetError as e:
        out["kv_hang"] = {"error": str(e),
                          "seconds": time.monotonic() - t0}
    faultinject.reset()
    os.environ["MXNET_KVSTORE_TIMEOUT"] = "0"

    # a dead rank at the barrier: rank 1 leaves, rank 0 must not wait
    # past its deadline
    if rank == 1:
        emit(out)
        os._exit(0)
    t0 = time.monotonic()
    try:
        kv.barrier(timeout=5.0)
        out["dead_barrier"] = {"error": None}
    except mx.MXNetError as e:
        out["dead_barrier"] = {"error": str(e),
                               "seconds": time.monotonic() - t0}
    emit(out)
    os._exit(0)


# the 2-layer narrow BERT of the slice test (tests/test_torch_bert_train's
# KW and MLM), dropout 0
BERT_KW = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
               max_length=32, vocab_size=100, use_pooler=False,
               use_classifier=False, use_decoder=False)
BERT_MLM = dict(vocab_size=100, units=64, mode="dense", prefix="mlm_")
BERT_SEQ = 16
BERT_ROWS = 2          # a rank
BERT_STEPS = 3
BERT_SGD = {"learning_rate": 1e-2, "wd": 0.01, "momentum": 0.9}


def bert_data(nw):
    """The global batch of each step: ids, token types, labels."""
    rng = np.random.RandomState(11)
    n = nw * BERT_ROWS
    return [[rng.randint(0, hi, (n, BERT_SEQ)).astype(np.float32)
             for hi in (100, 2, 100)] for _ in range(BERT_STEPS)]


def case_bert():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, dist, gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss, BERTModel
    kv = mx.kvstore.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    ctx = dist.local_contexts()[0]
    weights = np.load(os.environ["TEST_BERT_WEIGHTS"])
    net = BERTModel(prefix="bert_", dropout=0.0, **BERT_KW)
    mlm = BERTMLMLoss(**BERT_MLM)
    for block in (net, mlm):
        mx.params_from_numpy(block, {n: weights[n] for n in
                                     block.collect_params().keys()},
                             ctx=ctx)
    params = net.collect_params()
    params.update(mlm.collect_params())
    trainer = gluon.Trainer(params, "sgd", dict(BERT_SGD), kvstore=kv)
    sl = slice(rank * BERT_ROWS, (rank + 1) * BERT_ROWS)
    for ids, tok, lab in bert_data(nw):
        ids, tok, lab = (nd.array(a[sl], ctx=ctx) for a in (ids, tok, lab))
        with autograd.record():
            loss = mlm(net(ids, tok)[0], lab).sum()
        loss.backward()
        trainer.step(nw * BERT_ROWS)
    got = {n: p.data().asnumpy() for n, p in params.items()}
    np.savez(os.path.join(os.environ["TEST_OUT_DIR"], "rank%d.npz" % rank),
             **got)
    emit({"rank": rank, "nw": nw, "backend": kv.backend,
          "digest": _digest([got[k] for k in sorted(got)])})
    kv.barrier()


def case_card():
    """The dist store on CUDA tensors: exact sums over the group, and the
    Dense Trainer's ranks bit for bit (tests/test_torch_cuda.py)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, nd
    kv = mx.kvstore.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    ctxs = dist.local_contexts()
    vals = [nd.full((3, 5), rank + 1, ctx=ctxs[0])]
    kv.init("w", vals[0])
    kv.pushpull_list(["w"], [vals])
    net, _ = _dense_steps(mx, kv, ctxs, rank, nw)
    params = [net.weight.data().asnumpy(), net.bias.data().asnumpy()]
    emit({
        "rank": rank, "nw": nw, "backend": kv.backend,
        "ctx": str(ctxs[0]), "device": str(vals[0].tensor().device),
        "sum_err": float(np.abs(vals[0].asnumpy()
                                - nw * (nw + 1) / 2).max()),
        "weight": params[0].tolist(), "digest": _digest(params)})
    kv.barrier()


QUANT_SHAPES = {"a": (6, 40), "b": (3, 17), "c": (5,)}


def quant_values(gidx, key, shape):
    """Global replica ``gidx``'s value of ``key`` at one step."""
    seed = 1000 * gidx + sorted(QUANT_SHAPES).index(key)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def case_quant():
    """The quantized wire across processes (MXNET_KVSTORE_QUANTIZE=int8
    in the environment): dist_sync and p3store_dist against the
    in-process device store over every rank's contexts, run here on
    every rank's values, two steps (the residual carried); the wire's
    bytes by dtype on kv.dcn."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, nd
    kv = mx.kvstore.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    ctxs = dist.local_contexts()
    n = len(ctxs)
    keys = sorted(QUANT_SHAPES)
    allctx = [mx.cpu(i) for i in range(nw * n)]
    ref = mx.kvstore.create("device")

    def arrays(step, contexts, base):
        return [[nd.array(quant_values(base + i + 100 * step, k,
                                       QUANT_SHAPES[k]), ctx=c)
                 for i, c in enumerate(contexts)] for k in keys]
    out = {"rank": rank, "steps": []}
    for step in range(2):
        vals = arrays(step, ctxs, rank * n)
        rvals = arrays(step, allctx, 0)
        if step == 0:
            kv.init(keys, [v[0] for v in vals])
            ref.init(keys, [v[0] for v in rvals])
        mx.telemetry.reset()
        kv.pushpull_list(keys, vals)
        rows = [r for r in mx.commwatch.report() if r["axis"] == "kv.dcn"]
        ref.pushpull_list(keys, rvals)
        out["steps"].append({
            "equal": all(np.array_equal(vals[j][i].asnumpy(),
                                        rvals[j][rank * n + i].asnumpy())
                         for j in range(len(keys)) for i in range(n)),
            "err": max(float(np.abs(vals[j][0].asnumpy() - sum(
                quant_values(g + 100 * step, k, QUANT_SHAPES[k])
                for g in range(nw * n))).max())
                for j, k in enumerate(keys)),
            "wire": {r["dtype"]: r["bytes"] for r in rows},
            "ops": sorted({r["op"] for r in rows})})
    out["digest"] = _digest([v.asnumpy() for vs in vals for v in vs])

    # p3store_dist: the big key cut into row slices, each its own
    # quantized reduce, equal to the device store's over the same slices
    os.environ["MXNET_KVSTORE_BIGARRAY_BOUND"] = "80"
    p3 = mx.kvstore.create("p3store_dist")
    vals = arrays(5, ctxs, rank * n)
    rvals = arrays(5, allctx, 0)
    p3.init(keys, [v[0] for v in vals])
    p3.pushpull_list(keys, vals)
    rows = QUANT_SHAPES["a"][0]
    per = 80 // QUANT_SHAPES["a"][1]
    ja = keys.index("a")
    for s in range(0, rows, per):
        ck = "a_p3_%d" % s
        chunk = [nd.array(v.asnumpy()[s:s + per], ctx=v.context)
                 for v in rvals[ja]]
        ref.init(ck, chunk[0])
        ref.pushpull_list([ck], [chunk])
        for i in range(n):
            got = vals[ja][i].asnumpy()[s:s + per]
            if not np.array_equal(got, chunk[rank * n + i].asnumpy()):
                out["p3_equal"] = False
    small = [j for j, k in enumerate(keys) if k != "a"]
    for j in small:
        # p3 sends each key on its own: one quantized reduce a key
        ref.pushpull_list([keys[j] + "_p3"], [rvals[j]])
    out.setdefault("p3_equal", all(
        np.array_equal(vals[j][i].asnumpy(), rvals[j][rank * n + i]
                       .asnumpy()) for j in small for i in range(n)))
    out["p3_digest"] = _digest([v.asnumpy() for vs in vals for v in vs])
    emit(out)
    kv.barrier()


if __name__ == "__main__":
    {"main": case_main, "bert": case_bert, "card": case_card,
     "quant": case_quant}[os.environ["TEST_CASE"]]()
