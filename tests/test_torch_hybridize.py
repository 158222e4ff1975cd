"""``HybridBlock.hybridize()`` in the port (``mxnet_tpu_torch/
cached_op.py``) against the reference's hybridized runs on the CPU.

The counterparts of the reference's ``tests/test_hybridize.py``
contracts (matches eager, backward, training over steps, deferred init,
BatchNorm and Dropout in train mode), each with the same numpy inputs
and the weights carried by ``interop.params_from_numpy``, plus what the
port's CachedOp adds: one tape node per call, one cache entry per input
signature, ``hybridize()`` again starting a new cache, and a 2-layer
BERT with its loss, hybridized, forward and backward.

On the CPU a CachedOp runs the block's eager forward as one tape node,
so the port's hybridized run equals its eager run bit for bit (asserted)
and the reference's within the f32 tolerances stated at each test: the
two packages sum in other orders (XLA fuses, torch does not), which
costs a few f32 ulps a layer.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMLoss as RefMLM
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as RefBERT

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import cached_op
from mxnet_tpu_torch.gluon import nn as port_nn
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss as PortMLM
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel as PortBERT

# f32 through two or three layers: a few ulps of the largest value
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    yield
    pt.autograd.disarm_fused_update()
    pt.autograd.flush_pending_step()


def _mlp(lib, prefix="mlp_", layers=(("relu", 16), (None, 4))):
    nn = ref_nn if lib is mx else port_nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        for act, units in layers:
            net.add(nn.Dense(units, activation=act))
    return net


def _weights(shapes, seed=1):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in shapes.items()}


MLP_SHAPES = {"mlp_dense0_weight": (16, 8), "mlp_dense0_bias": (16,),
              "mlp_dense1_weight": (4, 16), "mlp_dense1_bias": (4,)}


def _load(lib, net, arrays, x_shape=None):
    if lib is mx:
        net.initialize()
        if x_shape is not None:
            net(mx.nd.zeros(x_shape))
        for n, p in net.collect_params().items():
            p.set_data(mx.nd.array(arrays[n]))
    else:
        pt.params_from_numpy(net, arrays, ctx=pt.cpu())
    return net


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nd(lib, a):
    return lib.nd.array(a, ctx=lib.cpu())


def test_hybridize_matches_eager():
    arrays = _weights(MLP_SHAPES)
    x = _x((3, 8))
    port = _load(pt, _mlp(pt), arrays)
    eager = port(_nd(pt, x)).asnumpy()
    port.hybridize()
    hybrid = port(_nd(pt, x)).asnumpy()
    np.testing.assert_array_equal(hybrid, eager)
    ref = _load(mx, _mlp(mx), arrays, (3, 8))
    ref.hybridize()
    np.testing.assert_allclose(hybrid, ref(_nd(mx, x)).asnumpy(),
                               rtol=RTOL, atol=ATOL)
    # the second call reuses the cache entry
    again = port(_nd(pt, x * 2)).asnumpy()
    np.testing.assert_allclose(again, ref(_nd(mx, x * 2)).asnumpy(),
                               rtol=RTOL, atol=ATOL)
    assert port._cached_op.num_entries() == 1


def _grads(lib, net, x):
    for p in net.collect_params().values():
        p.zero_grad()
    with lib.autograd.record():
        out = net(_nd(lib, x))
        loss = (out * out).sum()
    loss.backward()
    return {n: p.grad().asnumpy() for n, p in net.collect_params().items()}


def test_hybridize_backward():
    arrays = _weights(MLP_SHAPES)
    x = _x((3, 8))
    port = _load(pt, _mlp(pt), arrays)
    eager = _grads(pt, port, x)
    port.hybridize()
    port(_nd(pt, x))
    got = _grads(pt, port, x)
    ref = _load(mx, _mlp(mx), arrays, (3, 8))
    ref.hybridize()
    ref(_nd(mx, x))
    want = _grads(mx, ref, x)
    for n in want:
        np.testing.assert_array_equal(got[n], eager[n], err_msg=n)
        # gradients of a squared sum: a few ulps of their largest value
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[n]).max(),
                                   err_msg=n)


def _train(lib, steps, momentum):
    rng = np.random.RandomState(1)
    n, d, c = 64, 10, 3
    w_true = rng.randn(d, c).astype(np.float32)
    x_np = rng.randn(n, d).astype(np.float32)
    y_np = (x_np @ w_true).argmax(axis=1).astype(np.float32)
    shapes = {"mlp_dense0_weight": (32, d), "mlp_dense0_bias": (32,),
              "mlp_dense1_weight": (c, 32), "mlp_dense1_bias": (c,)}
    net = _load(lib, _mlp(lib, layers=(("relu", 32), (None, c))),
                _weights(shapes, seed=2), (n, d))
    net.hybridize()
    tr = lib.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5, "momentum": momentum})
    loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    x, y = _nd(lib, x_np), _nd(lib, y_np)
    losses = []
    for _ in range(steps):
        with lib.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(n)
        losses.append(float(loss.mean().asnumpy().reshape(())))
    return np.array(losses), {k: p.data().asnumpy()
                              for k, p in net.collect_params().items()}


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_hybridized_training_matches_reference(momentum):
    """Thirty SGD steps of a hybridized MLP and loss (the fused update
    from the second step on) against the reference's: each loss within
    1e-4 relative (thirty steps of f32 drift), and the loss must fall
    by half, as the reference's own test asks."""
    got, pw = _train(pt, 30, momentum)
    want, rw = _train(mx, 30, momentum)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for k in rw:
        np.testing.assert_allclose(pw[k], rw[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(rw[k]).max(),
                                   err_msg=k)
    assert got[-1] < got[0] * 0.5


def test_hybridize_deferred_init():
    net = port_nn.HybridSequential()
    net.add(port_nn.Dense(4), port_nn.Dense(2))
    net.initialize(ctx=pt.cpu())
    net.hybridize()
    out = net(pt.nd.ones((3, 7), ctx=pt.cpu()))
    assert out.shape == (3, 2)
    assert net[0].weight.shape == (4, 7)
    # the shapes are complete now: the next call builds the CachedOp
    assert net._cached_op is None
    net(pt.nd.ones((3, 7), ctx=pt.cpu()))
    assert net._cached_op is not None


def _bn_net(lib):
    nn = ref_nn if lib is mx else port_nn
    net = nn.HybridSequential(prefix="bn_")
    with net.name_scope():
        net.add(nn.Dense(8), nn.BatchNorm(), nn.Dropout(0.5), nn.Dense(2))
    return net


def test_hybridize_batchnorm_dropout():
    """Eval mode, then train mode under record(): the moving statistics
    are written back through the cached op, equal to the reference's
    (Dropout comes after the BatchNorm, so its masks, which the two
    packages draw differently, do not reach them); in eval mode Dropout
    is the identity and the outputs agree."""
    shapes = {"bn_dense0_weight": (8, 4), "bn_dense0_bias": (8,),
              "bn_batch_norm0_gamma": (8,), "bn_batch_norm0_beta": (8,),
              "bn_batch_norm0_running_mean": (8,),
              "bn_batch_norm0_running_var": (8,),
              "bn_dense1_weight": (2, 8), "bn_dense1_bias": (2,)}
    arrays = _weights(shapes)
    arrays["bn_batch_norm0_running_var"] = np.abs(
        arrays["bn_batch_norm0_running_var"]) + 1.0
    x = _x((16, 4))
    out, stats = {}, {}
    for lib in (pt, mx):
        net = _load(lib, _bn_net(lib), arrays, (16, 4))
        net.hybridize()
        out[lib] = net(_nd(lib, x)).asnumpy()
        with lib.autograd.record():
            train = net(_nd(lib, x))
        assert train.shape == (16, 2)
        stats[lib] = {n: p.data().asnumpy() for n, p in
                      net.collect_params().items() if "running" in n}
    np.testing.assert_allclose(out[pt], out[mx], rtol=RTOL, atol=ATOL)
    for n in stats[mx]:
        assert not np.array_equal(stats[pt][n], arrays[n]), n
        np.testing.assert_allclose(stats[pt][n], stats[mx][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def _tape_nodes(t):
    """The nodes of the torch tape behind ``t``, leaves left out."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen or \
                type(fn).__name__ == "AccumulateGrad":
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return seen


def test_one_tape_node_per_cached_op_call():
    net = _load(pt, _mlp(pt), _weights(MLP_SHAPES))
    net.hybridize()
    loss_fn = pt.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    x, y = _nd(pt, _x((3, 8))), _nd(pt, np.array([0, 1, 3], np.float32))
    with pt.autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    assert len(_tape_nodes(out.tensor())) == 1
    nodes = _tape_nodes(loss.tensor())
    assert len(nodes) == 2
    assert {type(n).__name__ for n in nodes} == {"_NodeBackward"}
    # eagerly, the same forward is a node per op
    with cached_op.eager(), pt.autograd.record():
        loss = loss_fn(net(x), y)
    assert len(_tape_nodes(loss.tensor())) > 2


def test_new_input_shape_adds_one_cache_entry():
    net = _load(pt, _mlp(pt), _weights(MLP_SHAPES))
    net.hybridize(static_alloc=True, static_shape=True)
    net(_nd(pt, _x((3, 8))))
    cop = net._cached_op
    assert cop.num_entries() == 1
    net(_nd(pt, _x((5, 8))))
    assert cop.num_entries() == 2
    net(_nd(pt, _x((3, 8), seed=4)))
    assert cop.num_entries() == 2
    # recording is a signature of its own, as in the reference
    with pt.autograd.record():
        net(_nd(pt, _x((3, 8))))
    assert cop.num_entries() == 3


def test_hybridize_again_clears_the_cache():
    net = _load(pt, _mlp(pt), _weights(MLP_SHAPES))
    net.hybridize()
    x = _nd(pt, _x((3, 8)))
    first = net(x).asnumpy()
    cop = net._cached_op
    assert cop.num_entries() == 1
    net.hybridize(static_alloc=True)
    assert net._cached_op is None and cop.num_entries() == 0
    np.testing.assert_array_equal(net(x).asnumpy(), first)
    assert net._cached_op is not cop and net._cached_op.static_alloc
    # children never build their own cached op: the outermost captures
    assert all(c._cached_op is None for c in net._children.values())
    net.cast("float32")
    assert net._cached_op is None


BERT_KW = dict(num_layers=2, units=32, hidden_size=64, num_heads=4,
               max_length=16, vocab_size=50, use_pooler=False,
               use_classifier=False, use_decoder=False)
MLM_KW = dict(vocab_size=50, units=32, chunk_size=16, prefix="mlm_")


def _bert_batch():
    rng = np.random.RandomState(0)
    return [rng.randint(0, hi, (2, 16)).astype(np.float32)
            for hi in (50, 2, 50)]


def _bert(lib, arrays):
    net = (RefBERT if lib is mx else PortBERT)(prefix="bert_", dropout=0.0,
                                               **BERT_KW)
    mlm = (RefMLM if lib is mx else PortMLM)(**MLM_KW)
    ids, tok, _ = _bert_batch()
    if lib is mx:
        net.initialize()
        mlm.initialize()
        net(mx.nd.array(ids), mx.nd.array(tok))
        for block in (net, mlm):
            for n, p in block.collect_params().items():
                p.set_data(mx.nd.array(arrays[n]))
    else:
        for block in (net, mlm):
            pt.params_from_numpy(
                block, {n: arrays[n] for n in block.collect_params().keys()},
                ctx=pt.cpu())
    return net, mlm


def _bert_arrays():
    net, mlm = RefBERT(prefix="bert_", dropout=0.0, **BERT_KW), \
        RefMLM(**MLM_KW)
    net.initialize()
    mlm.initialize()
    ids, tok, _ = _bert_batch()
    net(mx.nd.array(ids), mx.nd.array(tok))
    rng = np.random.RandomState(1)
    out = {}
    for block in (net, mlm):
        for n, p in block.collect_params().items():
            a = (rng.randn(*p.shape) * 0.1).astype(np.float32)
            out[n] = a + 1.0 if n.endswith("gamma") else a
    return out


def _bert_step(lib, net, mlm):
    ids, tok, lab = (_nd(lib, a) for a in _bert_batch())
    params = net.collect_params()
    params.update(mlm.collect_params())
    for p in params.values():
        p.zero_grad()
    with lib.autograd.record():
        # a hybridized block with one output returns it, not a list of
        # one (the reference's CachedOp)
        seq = net(ids, tok)
        per_position = mlm(seq if isinstance(seq, lib.nd.NDArray)
                           else seq[0], lab)
    per_position.backward()
    return per_position.asnumpy(), {n: p.grad().asnumpy()
                                    for n, p in params.items()}


def test_hybridized_bert_with_loss_matches_reference(pallas_interpret):
    """A 2-layer, 32-unit BERT and its chunked-head loss over 32 rows (a
    whole number of the reference's row blocks, so its Pallas kernels
    serve every call), both hybridized; the loss per position (a tape
    of two CachedOp nodes, one backward plan) and every gradient against
    the reference's hybridized run, within 1e-4 of the largest value
    (two layers, the LM head's online softmax and f32 sums in another
    order), and bit for bit against the port's eager run."""
    arrays = _bert_arrays()
    port = _bert(pt, arrays)
    eager = _bert_step(pt, *port)
    for block in port:
        block.hybridize(static_alloc=True, static_shape=True)
    got = _bert_step(pt, *port)
    again = _bert_step(pt, *port)
    ref = _bert(mx, arrays)
    for block in ref:
        block.hybridize(static_alloc=True, static_shape=True)
    want = _bert_step(mx, *ref)
    np.testing.assert_array_equal(got[0], eager[0])
    np.testing.assert_array_equal(again[0], got[0])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4,
                               atol=1e-4 * np.abs(want[0]).max())
    for n in want[1]:
        np.testing.assert_array_equal(got[1][n], eager[1][n], err_msg=n)
        np.testing.assert_allclose(got[1][n], want[1][n], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[1][n]).max(),
                                   err_msg=n)
    assert port[0]._cached_op.num_entries() == 1
    assert port[1]._cached_op.num_entries() == 1


class _Unused(port_nn.Dense):
    def __init__(self, **kw):
        super().__init__(4, **kw)
        with self.name_scope():
            self.extra = self.params.get("extra", shape=(3,))

    def hybrid_forward(self, F, x, weight, bias, extra):
        return super().hybrid_forward(F, x, weight=weight, bias=bias)


def test_cached_op_call_with_an_unused_parameter():
    """A parameter the forward never reads gets no gradient (its .grad
    stays as it was) through the one tape node, as in the eager run."""
    net = _Unused(prefix="u_")
    net.initialize(ctx=pt.cpu())
    x = _nd(pt, _x((3, 8)))
    net(x)
    net.extra.grad().tensor().fill_(7.0)
    net.hybridize()
    with pt.autograd.record():
        out = net(x)
    assert len(_tape_nodes(out.tensor())) == 1
    out.backward()
    np.testing.assert_array_equal(net.extra.grad().asnumpy(),
                                  np.full(3, 7.0))
    assert torch.isfinite(net.weight.grad().tensor()).all()


def test_amp_casts_are_part_of_the_signature():
    """A graph keeps the casts it was captured under: turning AMP on adds
    a signature, and AMP reset and initialized again with the same lists
    finds the graphs of its first initialization."""
    from mxnet_tpu_torch.contrib import amp
    net = _load(pt, _mlp(pt), _weights(MLP_SHAPES))
    net.hybridize()
    x = _nd(pt, _x((3, 8)))
    f32 = net(x)
    try:
        amp.init(target_dtype="bfloat16")
        low = net(x)
        assert net._cached_op.num_entries() == 2
        amp.reset()
        np.testing.assert_array_equal(net(x).asnumpy(), f32.asnumpy())
        amp.init(target_dtype="bfloat16")
        np.testing.assert_array_equal(net(x).asnumpy(), low.asnumpy())
        assert net._cached_op.num_entries() == 2
    finally:
        amp.reset()
    assert low.dtype == ml_dtypes.bfloat16 and f32.dtype == np.float32
