"""The port's ``mx.rtc`` against the reference's, on the CPU.

The reference launches Pallas kernels (interpret mode on the CPU); the
port's ``CudaModule`` takes CUDA C, and a CPU tensor goes to the
kernel's plain function. The same numpy inputs go through both, with the
reference's tolerances (``tests/test_rtc.py``). Signature parsing, every
binding error, the generated launcher and the runtime build (with a
stand-in compiler) run here too; the kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import os
import stat

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.ops import cuda_build

import chip_smoke

SRC = chip_smoke.RTC_SOURCE
PLAIN = chip_smoke.rtc_plain()


def saxpy(x_ref, y_ref, o_ref, *, alpha):
    o_ref[...] = alpha * x_ref[...] + y_ref[...]


def twoout(x_ref, a_ref, b_ref):
    a_ref[...] = x_ref[...] * 2.0
    b_ref[...] = x_ref[...] + 1.0


def _port(a):
    return pt.nd.array(a, ctx=pt.cpu())


def test_saxpy_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.rand(8, 128).astype(np.float32)
    y = rng.rand(8, 128).astype(np.float32)
    ref = mx.rtc.PallasModule(saxpy).get_kernel("saxpy", alpha=2.0).launch(
        [mx.nd.array(x), mx.nd.array(y)]).asnumpy()
    got = pt.rtc.CudaModule(SRC, plain=PLAIN).get_kernel(
        "saxpy", alpha=2.0).launch([_port(x), _port(y)])
    assert got.context == pt.cpu() and got.dtype == np.float32
    np.testing.assert_allclose(got.asnumpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(got.asnumpy(), 2.0 * x + y, rtol=1e-6)


def test_multi_output_matches_reference():
    x = np.arange(256, dtype=np.float32).reshape(2, 128)
    ra, rb = mx.rtc.PallasModule(twoout, num_outputs=2).get_kernel(
        "twoout").launch([mx.nd.array(x)])
    a, b = pt.rtc.CudaModule(SRC, num_outputs=2, plain=PLAIN).get_kernel(
        "twoout").launch([_port(x)])
    np.testing.assert_array_equal(a.asnumpy(), ra.asnumpy())
    np.testing.assert_array_equal(b.asnumpy(), rb.asnumpy())
    np.testing.assert_array_equal(b.asnumpy(), x + 1)


def test_unknown_kernel_raises_as_in_reference():
    with pytest.raises(mx.MXNetError):
        mx.rtc.PallasModule(saxpy).get_kernel("nope")
    with pytest.raises(pt.MXNetError, match="no kernel 'nope' in module"):
        pt.rtc.CudaModule(SRC).get_kernel("nope")


def test_out_shapes_count_checked_with_reference_text():
    x = np.ones((2, 4), np.float32)
    for lib, mod in ((mx, mx.rtc.PallasModule(twoout, num_outputs=2)),
                     (pt, pt.rtc.CudaModule(SRC, num_outputs=2,
                                            plain=PLAIN))):
        arr = lib.nd.array(x) if lib is mx else _port(x)
        with pytest.raises(lib.MXNetError, match="must have 2 entries"):
            mod.get_kernel("twoout").launch([arr], out_shapes=[(2, 4)])


def test_relu_kernels_match_reference_pallas():
    """The MLP custom op's kernels: the port's plain functions against the
    same bodies as Pallas kernels in the reference."""
    import jax.numpy as jnp

    def relu_fwd(x_ref, y_ref):
        y_ref[...] = jnp.maximum(x_ref[...], 0)

    def relu_bwd(dy_ref, y_ref, dx_ref):
        dx_ref[...] = jnp.where(y_ref[...] > 0, dy_ref[...], 0)

    rng = np.random.RandomState(1)
    x = rng.randn(64, 128).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    dy = rng.randn(64, 128).astype(np.float32)
    ref_mod = mx.rtc.PallasModule(relu_fwd, relu_bwd)
    ry = ref_mod.get_kernel("relu_fwd").launch([mx.nd.array(x)])
    rdx = ref_mod.get_kernel("relu_bwd").launch([mx.nd.array(dy), ry])
    mod = pt.rtc.CudaModule(SRC, plain=PLAIN)
    y = mod.get_kernel("relu_fwd").launch([_port(x)])
    dx = mod.get_kernel("relu_bwd").launch([_port(dy), y])
    np.testing.assert_array_equal(y.asnumpy(), ry.asnumpy())
    np.testing.assert_array_equal(dx.asnumpy(), rdx.asnumpy())


# ---------------------------------------------------------------------------
# parsing and binding
# ---------------------------------------------------------------------------
def test_declarations_are_parsed():
    mod = pt.rtc.CudaModule(SRC)
    assert mod.exports == ("saxpy", "twoout", "relu_fwd", "relu_bwd")
    assert mod.get_kernel("saxpy", alpha=1.0).params == [
        rtc.Param("x", "float", True, True),
        rtc.Param("y", "float", True, True),
        rtc.Param("out", "float", True, False),
        rtc.Param("alpha", "float", False, False),
        rtc.Param("n", "long long", False, False)]


@pytest.mark.parametrize("sig,want", [
    ("const float *x, double* y, int alpha",
     [("x", "float", True, True), ("y", "double", True, False),
      ("alpha", "int", False, False)]),
    ("const float *, double *, int64_t n",
     [("arg0", "float", True, True), ("arg1", "double", True, False),
      ("n", "int64_t", False, False)]),
    ("__global__ void k(const __nv_bfloat16* __restrict__ a, "
     "__half* const b, uint8_t* m, long long n)",
     [("a", "__nv_bfloat16", True, True), ("b", "__half", True, False),
      ("m", "uint8_t", True, False), ("n", "long long", False, False)]),
    ("void", []),
], ids=["names", "unnamed_pointers", "declaration", "void"])
def test_signature_parsing(sig, want):
    assert [tuple(p) for p in rtc.parse_signature(sig)] == want


@pytest.mark.parametrize("sig,match", [
    ("float** x", "one level of pointer"),
    ("const char* s", "unsupported type"),
    ("float x, int", "scalar needs a name"),
    ("unsigned short n", "unsupported type"),
], ids=["double_pointer", "char", "unnamed_scalar", "short"])
def test_signature_parsing_refuses(sig, match):
    with pytest.raises(pt.MXNetError, match=match):
        rtc.parse_signature(sig)


def test_declarations_skip_comments_and_read_launch_bounds():
    src = """
    // __global__ void commented(float* x) {}
    /* __global__ void also(float* x) {} */
    __global__ void __launch_bounds__(256) scale(const float* x, float* y,
                                                 float s, int n) {}
    """
    mod = pt.rtc.CudaModule(src)
    assert mod.exports == ("scale",)
    assert [p.name for p in mod.get_kernel("scale", s=2.0).params] == \
        ["x", "y", "s", "n"]


def _binding_cases():
    mod = pt.rtc.CudaModule(SRC, plain=PLAIN)
    mod2 = pt.rtc.CudaModule(SRC, num_outputs=2, plain=PLAIN)
    x = _port(np.ones((4, 8), np.float32))
    return [
        ("const output", lambda: mod2.get_kernel("saxpy", alpha=1.0),
         "output parameter 'y' points to const"),
        ("const output signature",
         lambda: mod.get_kernel("relu_fwd",
                                signature="const float* x, const float* y"),
         "points to const"),
        ("unknown attr", lambda: mod.get_kernel("saxpy", alpha=1.0, beta=2),
         r"no scalar parameter \['beta'\]"),
        ("missing attr", lambda: mod.get_kernel("saxpy"),
         r"scalar parameters \['alpha'\] are not set"),
        ("int attr not integral",
         lambda: mod.get_kernel("relu_fwd", n=2.5), "integer of 64 bits"),
        ("float attr not a number",
         lambda: mod.get_kernel("saxpy", alpha="2"), "takes a number"),
        ("too few pointers",
         lambda: mod2.get_kernel("relu_fwd"), "at least one input"),
        ("wrong input count",
         lambda: mod.get_kernel("relu_bwd").launch([x]), "takes 2 inputs"),
        ("wrong input dtype",
         lambda: mod.get_kernel("relu_fwd").launch([x.astype("float16")]),
         r"input 'x' is float\*, got dtype torch.float16"),
        ("wrong output dtype",
         lambda: mod.get_kernel("relu_fwd").launch(
             [x], out_dtypes=["float64"]),
         r"output 'y' is float\*, got dtype torch.float64"),
        ("int n overflow",
         lambda: pt.rtc.CudaModule(
             "__global__ void k(const float* x, float* y, int n) {}",
             plain={"k": lambda x, y: None}).get_kernel("k").launch(
                 [x], out_shapes=[(2 ** 16, 2 ** 15)]),
         "integer of 32 bits"),
        ("bad block", lambda: mod.get_kernel("relu_fwd").launch(
            [x], block=(64, 32)), "more than 1024 threads"),
        ("bad grid", lambda: mod.get_kernel("relu_fwd").launch(
            [x], grid=(0,)), "positive ints"),
        ("no inputs", lambda: mod.get_kernel("relu_fwd").launch([]),
         "at least one input"),
        ("plain for unexported", lambda: pt.rtc.CudaModule(
            SRC, exports=("saxpy",), plain=PLAIN), "not exported"),
        ("no kernels", lambda: pt.rtc.CudaModule("int x;"),
         "declares no __global__"),
        ("export not parsed", lambda: pt.rtc.CudaModule(
            SRC, exports=("hidden",)).get_kernel("hidden"),
         "pass signature="),
    ]


@pytest.mark.parametrize("case", range(17))
def test_binding_errors_raise_before_any_launch(case):
    what, fn, match = _binding_cases()[case]
    before = cuda_build.launch_counts()
    with pytest.raises(pt.MXNetError, match=match):
        fn()
    assert cuda_build.launch_counts() == before, what


def test_cpu_launch_without_plain_function_raises():
    x = _port(np.ones(8, np.float32))
    k = pt.rtc.CudaModule(SRC).get_kernel("relu_fwd")
    with pytest.raises(pt.MXNetError, match="has no plain function"):
        k.launch([x])


def test_given_signature_and_default_n():
    """A signature given to get_kernel binds as a parsed one; ``n``
    takes the first output's element count, attrs reach the plain
    function, other shapes and dtypes follow out_shapes/out_dtypes."""
    seen = {}

    def fill(x, out, *, value):
        seen["shape"] = tuple(out.shape)
        out[...] = value

    mod = pt.rtc.CudaModule("__global__ void fill(float* x) {}",
                            plain={"fill": fill})
    k = mod.get_kernel("fill", signature="const float* x, double* out, "
                       "double value, long long n", value=3.0)
    out = k.launch([_port(np.zeros(3, np.float32))], out_shapes=[(2, 5)],
                   out_dtypes=["float64"])
    assert seen["shape"] == (2, 5) and out.dtype == np.float64
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 5), 3.0))


def test_launcher_source_for_a_parsed_kernel():
    text = rtc.launcher_source("relu_fwd")
    assert 'extern "C"' in text and "int mxt_rtc_relu_fwd(" in text
    assert "void** args" in text and "unsigned int smem" in text
    assert ("cudaLaunchKernel((const void*)relu_fwd, dim3(gx, gy, gz),"
            in text)
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in text
    full = pt.rtc.CudaModule(SRC).generated_source()
    assert full.index("#include <cuda_fp16.h>") < full.index(SRC)
    assert full.index(SRC) < full.index("mxt_rtc_saxpy")
    assert "mxt_error_string" in full
    for name in chip_smoke.RTC_KERNELS:
        assert full.count("int mxt_rtc_%s(" % name) == 1


# ---------------------------------------------------------------------------
# the runtime build
# ---------------------------------------------------------------------------
def test_build_source_without_nvcc_raises(monkeypatch, tmp_path):
    import shutil
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(pt.MXNetError, match="nvcc not found"):
        cuda_build.build_source(SRC)
    with pytest.raises(pt.MXNetError, match="nvcc not found"):
        pt.rtc.CudaModule(SRC).build()
    assert not (tmp_path / "build").exists()


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_source_failure_raises_with_the_log(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(
        tmp_path, "echo 'module.cu(3): error: identifier \"q\" is "
        "undefined'\nexit 2\n"))
    with pytest.raises(pt.MXNetError, match='identifier "q" is undefined'):
        cuda_build.build_source("__global__ void k(float* q) { r; }")
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_source_reuses_a_module_built_for_the_same_source(
        monkeypatch, tmp_path):
    """One compile per (source, options); the compiler gets the flags,
    the options and the generated source."""
    log = tmp_path / "calls"
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(
        tmp_path, 'echo "$@" >> %s\nwhile [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n' % log))
    first = pt.rtc.CudaModule(SRC).build()
    again = pt.rtc.CudaModule(SRC).build()
    other = pt.rtc.CudaModule(SRC, options=["-lineinfo"]).build()
    assert first == again != other
    assert first.parent.parent == tmp_path / "build" / "rtc"
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert "-lineinfo" in calls[1] and "-lineinfo" not in calls[0]
    src = first.parent / "module.cu"
    assert src.read_text() == pt.rtc.CudaModule(SRC).generated_source()
    assert os.path.getsize(first) == 0


def test_rtc_launch_counts_have_their_own_entries():
    cuda_build.reset_launch_counts()
    cuda_build.count_launch("rtc:relu_fwd")
    cuda_build.count_launch("rtc:relu_fwd")
    counts = cuda_build.launch_counts()
    assert counts["rtc:relu_fwd"] == 2
    assert all(counts[k] == 0 for k in cuda_build.KERNELS)
    cuda_build.reset_launch_counts()
    assert cuda_build.launch_counts() == {k: 0 for k in cuda_build.KERNELS}
    with pytest.raises(KeyError):
        cuda_build.count_launch("relu_fwd")
