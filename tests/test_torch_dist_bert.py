"""The slice as a whole: the 2-layer, 64-unit BERT of
tests/test_torch_bert_train.py (dropout 0, ``BERTMLMLoss(mode="dense")``)
trained 3 SGD steps (momentum 0.9, wd 0.01) by 2 gloo ranks of one CPU
context each through ``Trainer(kvstore="dist_sync")``, each rank on its
2 rows of a 4-row global batch, the weights carried from the reference by
``params_from_numpy``. The two ranks end bit for bit equal, and equal to
the reference's single-process run on the concatenated batch within
1e-5 (abs + rel, the f32 slice tolerance of test_torch_bert_train.py:
the sum over ranks adds the rows' gradients in another order).
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMLoss as RefMLM
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as RefBERT

import mxnet_tpu_torch as pt

from test_torch_bert_train import _arrays
from test_torch_dist import WORKER, launch, results

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as w  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _reference(arrays, nw):
    net = RefBERT(prefix="bert_", dropout=0.0, **w.BERT_KW)
    mlm = RefMLM(**w.BERT_MLM)
    net.initialize()
    mlm.initialize()
    data = w.bert_data(nw)
    net(mx.nd.array(data[0][0]), mx.nd.array(data[0][1]))
    for block in (net, mlm):
        for name, p in block.collect_params().items():
            p.set_data(mx.nd.array(arrays[name]))
    params = net.collect_params()
    params.update(mlm.collect_params())
    trainer = mx.gluon.Trainer(params, "sgd", dict(w.BERT_SGD))
    for ids, tok, lab in data:
        with mx.autograd.record():
            loss = mlm(net(mx.nd.array(ids), mx.nd.array(tok))[0],
                       mx.nd.array(lab)).sum()
        loss.backward()
        trainer.step(nw * w.BERT_ROWS)
    return {n: p.data().asnumpy() for n, p in params.items()}


@pytest.fixture(scope="module")
def bert_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_bert")
    arrays = _arrays()
    np.savez(tmp / "weights.npz", **arrays)
    rc, out, err = launch(2, [sys.executable, WORKER], cpu_devices=1,
                          env={"TEST_CASE": "bert",
                               "TEST_BERT_WEIGHTS": str(tmp / "weights.npz"),
                               "TEST_OUT_DIR": str(tmp)})
    assert rc == 0, (out, err[-4000:])
    res = results(out)
    assert sorted(res) == [0, 1], (out, err[-4000:])
    got = [dict(np.load(tmp / ("rank%d.npz" % r))) for r in (0, 1)]
    return arrays, res, got


def test_bert_dist_sync_ranks_equal_bit_for_bit(bert_run):
    _, res, got = bert_run
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["backend"] == "gloo" and res[0]["nw"] == 2
    for n in got[0]:
        np.testing.assert_array_equal(got[0][n], got[1][n])


def test_bert_dist_sync_matches_reference_concatenated_batch(bert_run):
    arrays, _, got = bert_run
    ref = _reference(arrays, 2)
    assert sorted(ref) == sorted(got[0])
    moved = 0
    for n, want in ref.items():
        np.testing.assert_allclose(got[0][n], want, err_msg=n, **TOL)
        moved += not np.array_equal(want, arrays[n])
    assert moved == len(ref)        # every parameter took the steps
