"""The port's op registry as a whole against the reference's: how many
of the reference's names it registers, the AMP casts of the names the
last op slice added, and a scan of the new op modules showing that no
op reads a value back to the host.

The registry counts are exact. The AMP casts are held by output dtype
against the reference's own AMP run on the same call. The scan reads
the source of ``ops/tensor_tail.py``, ``ops/vision_ops.py``,
``ops/matrix.py`` and ``ops/contrib_ops.py``: no ``.cpu()``,
``.numpy()``, ``.tolist()`` or ``.item()`` call, and no numpy import
(numpy could only see a tensor by copying it to the host).
"""
import ast
import pathlib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.ops as ref_ops
import mxnet_tpu_torch as pt
import mxnet_tpu_torch.ops as port_ops
from mxnet_tpu.contrib import amp as ref_amp
from mxnet_tpu_torch.contrib import amp

OPS_DIR = pathlib.Path(port_ops.__file__).parent
SCANNED = ("tensor_tail.py", "vision_ops.py", "matrix.py", "contrib_ops.py")
HOST_READS = ("cpu", "numpy", "tolist", "item")
# the reference's names the port still lacks, by the module that
# registers them (ROADMAP.md queue 1, item 16)
LEFT = {"numpy_ops": 228, "quantized_ops": 4, "optimizer_ops": 1}


def test_the_port_registers_354_of_587_names():
    assert len(ref_ops._OPS) == 587
    shared = [n for n in ref_ops._OPS if n in port_ops._OPS]
    assert len(shared) == 354
    left = {}
    for n, op in ref_ops._OPS.items():
        if n not in port_ops._OPS:
            mod = op.impl.__module__.rsplit(".", 1)[1]
            left[mod] = left.get(mod, 0) + 1
    assert left == LEFT


@pytest.fixture
def _amp_off():
    yield
    amp.reset()
    ref_amp.reset()


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


# name, inputs, attrs, the input dtype, the output dtype AMP must give
AMP_CASES = [
    ("L2Normalization", [_rand(2, 3, 4)], {}, "bfloat16", "float32"),
    ("_contrib_interleaved_matmul_encdec_qk",
     [_rand(5, 2, 8, seed=1), _rand(6, 2, 16, seed=2)], {"heads": 2},
     "float32", "bfloat16"),
    ("_contrib_interleaved_matmul_encdec_valatt",
     [_rand(6, 2, 16, seed=2), _rand(4, 5, 6, seed=3)], {"heads": 2},
     "float32", "bfloat16"),
    ("linalg_gemm2", [_rand(3, 4, seed=4), _rand(4, 5, seed=5)], {},
     "float32", "bfloat16"),
]


@pytest.mark.parametrize("case", AMP_CASES, ids=[c[0] for c in AMP_CASES])
def test_new_names_take_their_amp_cast(case, _amp_off):
    """Each new name in ``contrib/amp/lists.py`` is cast as listed under
    ``amp.init("bfloat16")``, as in the reference, through ``nd`` and
    ``F``: L2Normalization in f32, the encoder-decoder products and
    gemm2 in the low dtype."""
    name, inputs, attrs, in_dtype, want = case
    dtypes = []
    for lib, lib_amp in ((mx, ref_amp), (pt, amp)):
        lib_amp.init(target_dtype="bfloat16")
        arrays = [lib.nd.array(a, ctx=lib.cpu()).astype(in_dtype)
                  for a in inputs]
        out = getattr(lib.nd, name)(*arrays, **attrs)
        dtypes.append(str(np.dtype(out.dtype)))
        if lib is pt:
            via_f = getattr(pt.ops.F, name)(*arrays, **attrs)
            assert str(np.dtype(via_f.dtype)) == want
    assert dtypes == [want, want], dtypes


def _host_reads(path):
    tree = ast.parse(path.read_text())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in HOST_READS:
            found.append("%s:%d .%s()" % (path.name, node.lineno,
                                          node.func.attr))
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] if \
                isinstance(node, ast.Import) else [node.module or ""]
            if any(m.split(".")[0] == "numpy" for m in mods):
                found.append("%s:%d imports numpy" % (path.name,
                                                      node.lineno))
    return found


@pytest.mark.parametrize("name", SCANNED)
def test_new_op_modules_read_nothing_back_to_the_host(name):
    assert not _host_reads(OPS_DIR / name)


def test_the_scan_sees_a_host_read(tmp_path):
    """The scan's control: a planted ``.item()`` and numpy import are
    found."""
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy as np\n\ndef f(x):\n"
                   "    return x.sum().item()\n")
    assert len(_host_reads(bad)) == 2
