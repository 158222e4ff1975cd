"""Runtime-compiled user kernels (counterpart of ``mxnet_tpu/rtc.py``;
ref: python/mxnet/rtc.py :: CudaModule/CudaKernel, src/common/rtc.cc).

The reference's ``PallasModule``/``PallasKernel`` take Pallas functions;
on this card a user writes the kernel in CUDA C, as in MXNet 1.x's NVRTC
``CudaModule``::

    source = r'''
    __global__ void saxpy(const float* x, const float* y, float* out,
                          float alpha, long long n) {
      long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
      if (i < n) out[i] = alpha * x[i] + y[i];
    }'''
    def saxpy_plain(x, y, out, *, alpha):
        out[...] = alpha * x[...] + y[...]

    mod = mx.rtc.CudaModule(source, plain={"saxpy": saxpy_plain})
    out = mod.get_kernel("saxpy", alpha=2.0).launch([x, y])

The device decides, as everywhere in the port: a CUDA tensor goes to the
compiled kernel, a CPU tensor to the kernel's plain function (``plain``,
in the reference's kernel convention ``fn(*in_refs, *out_refs, **attrs)``
run on tensors). A CPU launch of a kernel without one raises; nothing
falls back.

Binding. The kernel's parameters come from its ``__global__`` declaration
(or the ``signature`` given to ``get_kernel``). Pointer parameters take
the inputs, then the outputs, in order; a pointer's element type must be
the tensor's dtype and an output pointer must not point to ``const``.
Scalar parameters are filled by name from the ``get_kernel`` attrs; a
parameter ``n`` the attrs leave unset takes the element count of the
first output. Every mismatch raises :class:`MXNetError` before anything
is launched, on the CPU as well.

The card path. The module's source gets the CUDA headers in front and an
``extern "C"`` launcher per exported kernel behind (``cudaLaunchKernel``
on PyTorch's current stream, returning the error code); it is built with
``nvcc`` for ``sm_90a`` by :func:`cuda_build.build_source` at the first
CUDA launch (or :meth:`CudaModule.build`) and bound with ``ctypes``. The
default launch is 256 threads a block over ``ceil(n / 256)`` blocks.
Each launch counts under ``rtc:<kernel name>`` in
``cuda_build.launch_counts()``.

Each output goes to ``engine().on_dispatch``, as the reference hands
its outputs to its engine: the launch is ordered on PyTorch's stream,
and under ``MXNET_ENGINE_TYPE=NaiveEngine`` that stream is synchronised
there, so a faulty launch raises at the call.
"""
from __future__ import annotations

import ctypes
import math
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from . import engine as _engine
from .base import MXNetError, torch_dtype
from .context import context_of
from .ndarray.ndarray import NDArray, to_tensor
from .ops import cuda_build as _cb

__all__ = ["CudaModule", "CudaKernel", "Param", "parse_signature",
           "launcher_source"]

# element types a pointer parameter may have, by the tensor dtype it takes
POINTER_DTYPES = {
    "float": torch.float32, "double": torch.float64,
    "__half": torch.float16, "__nv_bfloat16": torch.bfloat16,
    "int": torch.int32, "int32_t": torch.int32,
    "int64_t": torch.int64, "long long": torch.int64,
    "uint8_t": torch.uint8,
}
# scalar parameter types, by how they are packed
SCALAR_CTYPES = {
    "float": ctypes.c_float, "double": ctypes.c_double,
    "int": ctypes.c_int, "int32_t": ctypes.c_int32,
    "int64_t": ctypes.c_int64, "long long": ctypes.c_int64,
}
_INT_BITS = {"int": 32, "int32_t": 32, "int64_t": 64, "long long": 64}
_QUALIFIERS = ("__restrict__", "__restrict", "volatile")
_DEFAULT_BLOCK = 256

_GLOBAL_RE = re.compile(
    r"__global__\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?void\s+"
    r"(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)\s*\(([^)]*)\)")
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)

_HEADER = """#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>
#line 1 "user source"
"""


class Param(NamedTuple):
    """One kernel parameter: base type, pointer or scalar, and for a
    pointer whether the data it points to is ``const``."""
    name: str
    type: str
    pointer: bool
    const: bool


def _parse_param(text: str, index: int) -> Param:
    tokens = [t for t in text.replace("*", " * ").split()
              if t not in _QUALIFIERS]
    stars = [i for i, t in enumerate(tokens) if t == "*"]
    if len(stars) > 1:
        raise MXNetError("kernel parameter %r: only one level of pointer "
                         "is taken" % text.strip())
    pointer = bool(stars)
    # const before the '*' qualifies the data, after it the pointer
    const = "const" in (tokens[:stars[0]] if pointer else tokens)
    words = [t for t in tokens if t not in ("*", "const")]
    table = POINTER_DTYPES if pointer else SCALAR_CTYPES
    if " ".join(words) in table:          # unnamed: "const float *"
        base, name = " ".join(words), "arg%d" % index
        if not pointer:
            raise MXNetError("kernel parameter %r: a scalar needs a name, "
                             "by which the attrs fill it" % text.strip())
    else:
        base, name = " ".join(words[:-1]), words[-1] if words else ""
    if base not in table or not re.fullmatch(r"[A-Za-z_]\w*", name):
        raise MXNetError(
            "kernel parameter %r: unsupported type; a pointer takes one of "
            "%s, a scalar one of %s" % (text.strip(), sorted(POINTER_DTYPES),
                                        sorted(SCALAR_CTYPES)))
    return Param(name, base, pointer, const)


def parse_signature(signature: str) -> List[Param]:
    """The parameters of a kernel from its parameter list, as upstream's
    ``get_kernel(name, signature)`` takes it (``"const float* x, float*
    y, int n"``), or from a whole declaration (``"__global__ void k(...)"``)."""
    if "(" in signature:
        signature = signature[signature.index("(") + 1:signature.rindex(")")]
    signature = signature.strip()
    if signature in ("", "void"):
        return []
    return [_parse_param(p, i) for i, p in enumerate(signature.split(","))]


def _declarations(source: str) -> Dict[str, str]:
    """{kernel name: parameter list} of every ``__global__`` function."""
    return {m.group(1): m.group(2)
            for m in _GLOBAL_RE.finditer(_COMMENT_RE.sub(" ", source))}


def launcher_source(name: str) -> str:
    """The ``extern "C"`` launcher appended to a module for kernel
    ``name``: the kernel's arguments as ``void**``, grid, block, dynamic
    shared memory (opted in above 48 KB) and stream; it returns the
    ``cudaError_t`` of the launch, cleared from CUDA's last error."""
    return """
extern "C" __attribute__((visibility("default"))) int mxt_rtc_%(n)s(
    void** args, unsigned int gx, unsigned int gy, unsigned int gz,
    unsigned int bx, unsigned int by, unsigned int bz, unsigned int smem,
    void* stream) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        (const void*)%(n)s, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
  }
  if (e == cudaSuccess) {
    e = cudaLaunchKernel((const void*)%(n)s, dim3(gx, gy, gz),
                         dim3(bx, by, bz), args, (size_t)smem,
                         (cudaStream_t)stream);
  }
  // the caller raises on e: clear it so no later launch reports it
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
""" % {"n": name}


_ERROR_STRING = """
extern "C" __attribute__((visibility("default")))
const char* mxt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
"""


def _dims(v, what) -> tuple:
    dims = (v,) if isinstance(v, int) else tuple(v)
    if not 1 <= len(dims) <= 3 or not all(
            isinstance(d, int) and d > 0 for d in dims):
        raise MXNetError("launch: %s must be one to three positive ints, "
                         "got %r" % (what, v))
    return dims + (1,) * (3 - len(dims))


class CudaKernel:
    """A launchable kernel of a :class:`CudaModule` with its scalar
    attrs bound (ref: rtc.py :: CudaKernel)."""

    def __init__(self, module: "CudaModule", name: str,
                 params: Sequence[Param], attrs: dict):
        self._module = module
        self.name = name
        self.params = list(params)
        self._attrs = dict(attrs)
        n_out = module.num_outputs
        scalars = {p.name: p for p in self.params if not p.pointer}
        unknown = sorted(set(self._attrs) - set(scalars))
        if unknown:
            raise MXNetError("kernel %r has no scalar parameter %s (its "
                             "scalars: %s)" % (name, unknown, sorted(scalars)))
        missing = sorted(s for s in scalars
                         if s not in self._attrs and s != "n")
        if missing:
            raise MXNetError("kernel %r: scalar parameters %s are not set; "
                             "pass them to get_kernel" % (name, missing))
        pointers = [p for p in self.params if p.pointer]
        if len(pointers) <= n_out:
            raise MXNetError("kernel %r has %d pointer parameters; it needs "
                             "at least one input and the module's %d "
                             "outputs" % (name, len(pointers), n_out))
        for p in pointers[len(pointers) - n_out:]:
            if p.const:
                raise MXNetError("kernel %r: output parameter %r points to "
                                 "const" % (name, p.name))
        self._inputs = pointers[:len(pointers) - n_out]
        self._outputs = pointers[len(pointers) - n_out:]
        for p in scalars.values():
            if p.name in self._attrs:
                self._check_scalar(p, self._attrs[p.name])

    def _check_scalar(self, p: Param, value):
        bits = _INT_BITS.get(p.type)
        if bits is None:
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                raise MXNetError("kernel %r: scalar %r (%s) takes a number, "
                                 "got %r" % (self.name, p.name, p.type, value))
            return
        if isinstance(value, bool) or int(value) != value or not \
                -2 ** (bits - 1) <= int(value) < 2 ** (bits - 1):
            raise MXNetError("kernel %r: scalar %r (%s) takes an integer of "
                             "%d bits, got %r" % (self.name, p.name, p.type,
                                                  bits, value))

    def _bind(self, tensors, shapes, dtypes):
        """Check inputs and outputs against the parameters; returns the
        value of every scalar parameter by name."""
        if len(tensors) != len(self._inputs):
            raise MXNetError("kernel %r takes %d inputs (its pointer "
                             "parameters before the %d outputs), got %d"
                             % (self.name, len(self._inputs),
                                len(self._outputs), len(tensors)))
        for what, params, got in (("input", self._inputs,
                                   [t.dtype for t in tensors]),
                                  ("output", self._outputs, dtypes)):
            for p, dt in zip(params, got):
                if POINTER_DTYPES[p.type] != dt:
                    raise MXNetError("kernel %r: %s %r is %s*, got dtype %s"
                                     % (self.name, what, p.name, p.type, dt))
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise MXNetError("kernel %r: inputs on several devices %s"
                             % (self.name, sorted(map(str, devices))))
        values = dict(self._attrs)
        numel = math.prod(shapes[0])
        for p in self.params:
            if not p.pointer and p.name not in values:   # only "n" is left
                self._check_scalar(p, numel)
                values[p.name] = numel
        return values

    def launch(self, args: Sequence[NDArray],
               out_shapes: Optional[List[tuple]] = None,
               out_dtypes: Optional[List] = None,
               grid=None, block=None, shared_mem: int = 0):
        """Run the kernel on NDArrays and return its output, or a list
        of them when the module has several. Output shapes and dtypes
        default to the first input's."""
        if not args:
            raise MXNetError("launch needs at least one input")
        tensors = [to_tensor(a) for a in args]
        n_out = self._module.num_outputs
        shapes = out_shapes or [tuple(tensors[0].shape)] * n_out
        dtypes = out_dtypes or [tensors[0].dtype] * n_out
        if len(shapes) != n_out or len(dtypes) != n_out:
            raise MXNetError(
                "launch: out_shapes/out_dtypes must have %d entries "
                "(got %d/%d)" % (n_out, len(shapes), len(dtypes)))
        shapes = [tuple(int(d) for d in s) for s in shapes]
        dtypes = [torch_dtype(d) for d in dtypes]
        values = self._bind(tensors, shapes, dtypes)
        n = values.get("n", math.prod(shapes[0]))
        block = _dims(_DEFAULT_BLOCK if block is None else block, "block")
        if math.prod(block) > 1024:
            raise MXNetError("launch: block %s has more than 1024 threads"
                             % (block,))
        if grid is None:
            grid = (max(0, -(-int(n) // math.prod(block))), 1, 1)
        else:
            grid = _dims(grid, "grid")
        dev = tensors[0].device
        ctx = args[0].context if isinstance(args[0], NDArray) \
            else context_of(dev)
        if dev.type == "cuda":
            outs = self._launch_cuda(tensors, shapes, dtypes, values, grid,
                                     block, int(shared_mem))
        elif dev.type == "cpu":
            outs = self._launch_plain(tensors, shapes, dtypes)
        else:
            raise MXNetError("kernel %r: no route for device %s"
                             % (self.name, dev))
        eng = _engine.engine()
        for o in outs:
            eng.on_dispatch(o)
        res = [NDArray(o, ctx) for o in outs]
        return res if n_out > 1 else res[0]

    def _launch_plain(self, tensors, shapes, dtypes):
        fn = self._module.plain.get(self.name)
        if fn is None:
            raise MXNetError(
                "kernel %r has no plain function, so it cannot run on the "
                "CPU: pass plain={%r: fn} to CudaModule, or launch on CUDA "
                "tensors" % (self.name, self.name))
        outs = [torch.empty(s, dtype=d) for s, d in zip(shapes, dtypes)]
        with torch.no_grad():
            fn(*tensors, *outs, **self._attrs)
        return outs

    def _launch_cuda(self, tensors, shapes, dtypes, values, grid, block,
                     shared_mem):
        dev = tensors[0].device
        ins = [t.contiguous() for t in tensors]
        outs = [torch.empty(s, dtype=d, device=dev)
                for s, d in zip(shapes, dtypes)]
        if grid[0] == 0:        # nothing to compute, nothing launched
            return outs
        lib, fn = self._module._launcher(self.name)
        ptrs = iter(ins + outs)
        argv = [ctypes.c_void_p(next(ptrs).data_ptr()) if p.pointer
                else SCALAR_CTYPES[p.type](
                    int(values[p.name]) if p.type in _INT_BITS
                    else float(values[p.name]))
                for p in self.params]
        packed = (ctypes.c_void_p * max(1, len(argv)))(
            *[ctypes.addressof(v) for v in argv])
        with torch.cuda.device(dev):
            rc = fn(packed, *grid, *block, shared_mem,
                    _cb.stream_of(ins[0]))
        _cb.check_launch(lib, rc, _cb.RTC_PREFIX + self.name)
        return outs


class CudaModule:
    """User CUDA C kernels compiled at runtime (ref: rtc.py ::
    CudaModule).

    source : CUDA C holding the ``__global__`` kernels.
    options : extra ``nvcc`` options.
    exports : the kernel names; by default every ``__global__`` function
        the parser finds.
    num_outputs : outputs of each launch, the last pointer parameters.
    plain : {kernel name: fn(*inputs, *outputs, **attrs)} on tensors, the
        kernel's plain version, which the CPU runs.
    """

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = (), num_outputs: int = 1,
                 plain: Optional[Dict[str, Callable]] = None):
        self.source = source
        self.options = tuple(options)
        self._decls = _declarations(source)
        self.exports = tuple(exports) or tuple(self._decls)
        if not self.exports:
            raise MXNetError("CudaModule: the source declares no __global__ "
                             "function; name the kernels in exports=")
        self.num_outputs = int(num_outputs)
        self.plain = dict(plain or {})
        extra = sorted(set(self.plain) - set(self.exports))
        if extra:
            raise MXNetError("CudaModule: plain functions for kernels not "
                             "exported: %s" % extra)
        self._lib = None
        self._fns: Dict[str, object] = {}

    def get_kernel(self, name: str, signature: Optional[str] = None,
                   **attrs) -> CudaKernel:
        """The kernel ``name`` with its scalar parameters set from
        ``attrs``; its parameters come from ``signature`` when given,
        else from its declaration in the source."""
        if name not in self.exports:
            raise MXNetError("no kernel %r in module (have: %s)"
                             % (name, sorted(self.exports)))
        if signature is None:
            if name not in self._decls:
                raise MXNetError("kernel %r: no __global__ declaration found "
                                 "in the source; pass signature=" % name)
            signature = self._decls[name]
        return CudaKernel(self, name, parse_signature(signature), attrs)

    def generated_source(self) -> str:
        """What ``nvcc`` compiles: the headers, the user's source, a
        launcher per exported kernel."""
        return "".join([_HEADER, self.source, "\n", _ERROR_STRING] +
                       [launcher_source(n) for n in self.exports])

    def build(self):
        """Compile the module (or reuse the library built for the same
        source and options); returns the library's path."""
        return _cb.build_source(self.generated_source(), self.options)

    def _launcher(self, name):
        if self._lib is None:
            self._lib = _cb.load_library(self.build())
        fn = self._fns.get(name)
        if fn is None:
            fn = getattr(self._lib, "mxt_rtc_" + name)
            u = ctypes.c_uint
            fn.argtypes = [ctypes.c_void_p, u, u, u, u, u, u, u,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fns[name] = fn
        return self._lib, fn
