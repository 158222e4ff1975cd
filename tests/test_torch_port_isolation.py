"""The PyTorch/CUDA port stands alone: it imports neither JAX nor the
reference package, runs on the card unless asked for the CPU, and its
weight carry is strict."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "mxnet_tpu_torch"
KW = dict(num_layers=1, units=16, hidden_size=32, num_heads=2,
          max_length=8, vocab_size=10, prefix="bert_")


def test_port_runs_without_jax_or_reference_in_a_subprocess():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
        net = BERTModel(num_layers=1, units=16, hidden_size=32, num_heads=2,
                        max_length=8, vocab_size=10, prefix="bert_")
        net.initialize(ctx=mx.cpu())
        ids = mx.nd.array(np.ones((2, 4)), ctx=mx.cpu())
        sess = net.serve_session(ids, ids, seq_axis=1)
        out = sess.infer(np.ones((1, 3)), np.zeros((1, 3)))
        assert out[0].shape == (1, 3, 16), out[0].shape
        # one training step: autograd, the loss, dropout, the Trainer
        from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss
        train = BERTModel(num_layers=1, units=16, hidden_size=32,
                          num_heads=2, max_length=8, vocab_size=10,
                          dropout=0.1, use_pooler=False,
                          use_classifier=False, use_decoder=False,
                          prefix="train_")
        mlm = BERTMLMLoss(vocab_size=10, units=16, mode="dense",
                          prefix="mlm_")
        train.initialize(ctx=mx.cpu())
        mlm.initialize(ctx=mx.cpu())
        train(ids, ids)
        params = train.collect_params()
        params.update(mlm.collect_params())
        trainer = mx.gluon.Trainer(params, "lamb", {"learning_rate": 1e-3})
        with mx.autograd.record():
            loss = mlm(train(ids, ids)[0], ids).mean()
        loss.backward()
        trainer.step(2)
        assert np.isfinite(loss.asnumpy()).all()
        # a ResNet SGD step through Gluon, and a fused bottleneck stage
        # with its dual backward
        import torch
        from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
        from mxnet_tpu_torch.ops import cuda_fused
        net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                              [4, 8, 16, 32, 64], classes=3, thumbnail=True,
                              prefix="r_")
        net.initialize(init=mx.init.MSRAPrelu(), ctx=mx.cpu())
        img = mx.nd.array(np.ones((2, 3, 8, 8)), ctx=mx.cpu())
        net(img)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(img), mx.nd.array([0, 1], ctx=mx.cpu()))
        loss.backward()
        trainer.step(2)
        assert np.isfinite(loss.asnumpy()).all()
        x = torch.rand(4, 4, 2, 8, requires_grad=True)
        w = [torch.rand(8, 4), torch.ones(4), torch.zeros(4),
             torch.rand(3, 3, 4, 4), torch.ones(4), torch.zeros(4),
             torch.rand(4, 8), torch.ones(8), torch.zeros(8)]
        out, _ = cuda_fused.fused_stage(x, [w, w], data_format="HWNC")
        out.sum().backward()
        assert torch.isfinite(x.grad).all()
        # one step of the MNIST MLP whose relus are an rtc custom op, fed
        # by the DataLoader, scored by the metric
        import chip_smoke as cs
        mod = mx.rtc.CudaModule(cs.RTC_SOURCE, plain=cs.rtc_plain())
        cs.register_rtc_relu(mx, mod)
        X, y, _, _ = cs.mnist_synthetic(128)
        with mx.cpu():
            mlp = cs.mnist_mlp(mx, True)
            mlp.initialize(mx.init.Xavier(), ctx=mx.cpu())
            trainer = mx.gluon.Trainer(mlp.collect_params(), "sgd",
                                       {"learning_rate": 0.1})
            loader = mx.gluon.data.DataLoader(
                mx.gluon.data.ArrayDataset(X, y), batch_size=64, shuffle=True)
            data, label = next(iter(loader))
            out, loss = cs._mnist_step(
                mlp, trainer, mx.gluon.loss.SoftmaxCrossEntropyLoss(), data,
                label)
            acc = mx.metric.Accuracy()
            acc.update([label], [out])
        assert np.isfinite(loss.asnumpy()).all() and 0 <= acc.get()[1] <= 1
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    # MXNET_* variables left in os.environ by other test files (ZeRO,
    # ...) would turn on Trainer features the port refuses
    env = {k: v for k, v in os.environ.items() if not k.startswith("MXNET_")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_port_loads_only_its_own_io_library():
    """The port's image pipeline builds and loads its own library from
    mxnet_tpu_torch/_build/, never the reference's mxnet_tpu/native/*.so,
    and imports neither JAX nor the reference."""
    code = textwrap.dedent("""
        import sys, tempfile
        import numpy as np
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import native, recordio
        tmp = tempfile.mkdtemp()
        w = recordio.MXIndexedRecordIO(tmp + "/a.idx", tmp + "/a.rec", "w")
        for i in range(4):
            w.write_idx(i, recordio.pack((0, float(i), i, 0),
                                         bytes(range(48))))
        w.close()
        it = mx.io.ImageRecordIter(path_imgrec=tmp + "/a.rec",
                                   path_imgidx=tmp + "/a.idx",
                                   data_shape=(3, 4, 4), batch_size=2,
                                   shuffle=True, ctx=mx.cpu())
        assert next(it).data[0].shape == (2, 3, 4, 4)
        maps = open("/proc/self/maps").read()
        print("NATIVE", "mxnet_tpu/native" in maps)
        print("OWN", native.build_info()["library"] in maps,
              "/mxnet_tpu_torch/_build/host/" in native.build_info()["library"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MXNET_")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NATIVE False" in proc.stdout
    assert "OWN True True" in proc.stdout
    assert "LOADED []" in proc.stdout


def test_tuner_store_and_tools_load_no_jax_or_reference():
    """The autotuner, the perfwatch store, the bench-JSON schema and the
    observability tools run without JAX, the reference package or the
    reference's tools/."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        os.environ["MXNET_AUTOTUNE"] = "cost"
        import torch
        from mxnet_tpu_torch import autotune, perfwatch
        from mxnet_tpu_torch.ops import cuda_norm
        from mxnet_tpu_torch.tools import (bench_json, compile_micro,
                                           compile_report, modelwatch_micro,
                                           perfwatch as cli, telemetry_micro,
                                           trace_summary)
        assert cuda_norm.fwd_plan(4096, 768, torch.bfloat16, True, 132) \
            == cuda_norm.fwd_blocks(4096, 768, torch.bfloat16, True, 132)
        assert autotune.table()
        tmp = tempfile.mkdtemp()
        os.environ["MXNET_PERF_DB"] = tmp
        perfwatch.refresh()
        bench_json.emit({"metric": "t_ms", "value": 1.0, "unit": "ms"})
        assert cli.main(["report", "--gate"]) == 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu",
                                            "tools"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MXNET_")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PERFWATCH_GATE_OK (1 series flat or improved)" in proc.stdout
    assert "LOADED []" in proc.stdout


def test_port_sources_name_no_reference_library():
    """No port source or build file names the reference's native
    libraries."""
    files = [f for f in PORT.rglob("*")
             if f.is_file() and "_build" not in f.relative_to(PORT).parts
             and f.suffix in (".py", ".cc", ".cu", ".cuh", ".h")]
    bad = [str(f.relative_to(REPO)) for f in files
           if "libmxtpu_" in f.read_text(errors="replace")
           or "mxnet_tpu/native/lib" in f.read_text(errors="replace")]
    assert bad == []


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_import_in_port_sources():
    # _build/ holds what the kernels' build writes, not the port's sources
    files = sorted(f for f in PORT.rglob("*.py")
                   if "_build" not in f.relative_to(PORT).parts)
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
    assert bad == []


def test_every_kernel_source_is_built_and_names_its_tpu_kernel():
    """Each CUDA source under csrc/ is in the build and its header note
    names the Pallas kernel it replaces; none includes anything of the
    JAX package."""
    from mxnet_tpu_torch.ops import cuda_build
    sources = sorted(p.name for p in (PORT / "csrc").glob("*.cu"))
    assert sources == sorted(cuda_build.SOURCES)
    assert "dual_bwd.cu" in sources
    for name in sources:
        text = (PORT / "csrc" / name).read_text()
        assert "replace" in text.lower() and "mxnet_tpu/ops/pallas_" in text, \
            name
        includes = [ln for ln in text.splitlines()
                    if ln.startswith("#include")]
        assert all("mxnet_tpu/" not in ln for ln in includes), name


def test_chip_smoke_imports_no_jax():
    names = set(_imports(REPO / "chip_smoke.py"))
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")}


def test_chip_epilogue_imports_no_jax():
    names = set(_imports(REPO / "chip_epilogue.py"))
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")}


def test_default_context_is_gpu_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pt.current_context() == pt.gpu(0)
    with pytest.raises(pt.MXNetError, match="ctx=mx.cpu"):
        pt.nd.zeros((2, 2))
    net = BERTModel(**KW)
    with pytest.raises(pt.MXNetError, match="no CUDA device"):
        net.initialize()
    with pt.cpu():
        assert pt.nd.zeros((2, 2)).context == pt.cpu()


def test_serving_without_cuda_raises_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = BERTModel(**KW)
    net.initialize(ctx=pt.cpu())
    ids = np.ones((2, 4), np.float32)
    with pytest.raises(pt.MXNetError, match="no CUDA device"):
        net.serve_session(ids, ids, seq_axis=1)
    sess = net.serve_session(ids, ids, seq_axis=1, ctx=pt.cpu())
    assert sess.infer(ids, ids)[0].shape == (2, 4, 16)


def _arrays():
    net = BERTModel(**KW)
    net.initialize(ctx=pt.cpu())
    net(pt.nd.array(np.ones((1, 2)), ctx=pt.cpu()),
        pt.nd.array(np.ones((1, 2)), ctx=pt.cpu()))
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


@pytest.mark.parametrize("edit,match", [
    (lambda a: a.pop("bert_pooler_bias"), "missing.*bert_pooler_bias"),
    (lambda a: a.update(bert_extra_weight=np.zeros(3)), "unknown.*extra"),
    (lambda a: a.update(bert_pooler_bias=np.zeros(17)),
     "bert_pooler_bias has shape"),
    (lambda a: a.update(bert_word_embed_weight=np.zeros((10, 8))),
     "bert_word_embed_weight has shape"),
], ids=["missing", "extra", "wrong_shape", "wrong_shape_2d"])
def test_params_from_numpy_is_strict(edit, match):
    arrays = _arrays()
    edit(arrays)
    net = BERTModel(**KW)
    with pytest.raises(pt.MXNetError, match=match):
        pt.params_from_numpy(net, arrays, ctx=pt.cpu())
    # nothing was loaded
    assert all(p._data is None for p in net.collect_params().values())


def test_params_from_numpy_loads_and_converts():
    arrays = _arrays()
    net = BERTModel(**KW)
    net.cast("bfloat16")
    pt.params_from_numpy(net, arrays, ctx=pt.cpu())
    for name, p in net.collect_params().items():
        assert p.data().dtype == ml_dtypes.bfloat16
        np.testing.assert_allclose(p.data().asnumpy(), arrays[name],
                                   rtol=1e-2, atol=1e-2)


def test_seeded_initialization_is_reproducible():
    def draw():
        pt.random.seed(7)
        net = BERTModel(**KW)
        net.initialize(ctx=pt.cpu())
        return net.collect_params()["bert_word_embed_weight"].data().asnumpy()
    a, b = draw(), draw()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a).max() <= 0.07
    g = torch.Generator().manual_seed(3)
    x = pt.nd.zeros((4, 5), ctx=pt.cpu())
    pt.initializer.Uniform(0.5, generator=g)("w_weight", x)
    assert 0 < np.abs(x.asnumpy()).max() <= 0.5
