"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``mxnet_tpu_torch/csrc/`` are compiled at first use,
on the machine with the card, into ``mxnet_tpu_torch/_build/<digest>/``
(listed in ``.gitignore``). ``<digest>`` hashes the sources and the
compiler flags, so an edited kernel is rebuilt and an unchanged one is
reused. Each ``.cu`` file becomes its own shared library with a plain C
interface, built by its own ``nvcc`` process; all of them start
together. No PyTorch headers are compiled, so a build takes seconds.

The wrappers in ``cuda_norm``, ``cuda_attention``, ``cuda_epilogue``,
``cuda_dropout`` and ``cuda_fused`` call the C launchers through ``ctypes`` with
``tensor.data_ptr()`` and PyTorch's current stream, so the kernels are
stream-ordered with every other op. Each launcher returns the ``cudaError_t`` of its launch and
the wrapper raises :class:`MXNetError` on anything but success; nothing
falls back to a plain version.

Every wrapper adds one to its kernel's count in :func:`launch_counts`
where it launches, and nowhere else.

:func:`build_source` builds a source string instead of a file, for the
user kernels of :mod:`mxnet_tpu_torch.rtc`: into
``_build/rtc/<digest>/``, ``<digest>`` hashing the source, the extra
options and the flags, so a second module with the same source reuses the
first's library. A user kernel counts its launches under ``rtc:<name>``,
an entry made at its first launch and dropped by
:func:`reset_launch_counts`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from ..base import MXNetError

__all__ = ["SOURCES", "KERNELS", "build", "build_info", "library",
           "build_source", "load_library", "RTC_PREFIX",
           "launch_counts", "reset_launch_counts", "count_launch",
           "check_launch", "check_cuda_tensor", "sm_count", "stream_of",
           "DTYPE_CODES",
           "apply"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"

# one shared library per source; headers are hashed but not compiled
SOURCES = ("layer_norm.cu", "selfatt.cu", "epilogue.cu", "dropout.cu",
           "dual_bwd.cu")
HEADERS = ("common.cuh",)

# kernel name -> the source that holds it
KERNELS = {
    "layer_norm_fwd": "layer_norm.cu",
    "layer_norm_bwd": "layer_norm.cu",
    "selfatt_fwd": "selfatt.cu",
    "selfatt_bwd": "selfatt.cu",
    "bias_gelu_fwd": "epilogue.cu",
    "bias_gelu_bwd": "epilogue.cu",
    "bias_residual_fwd": "epilogue.cu",
    "dropout": "dropout.cu",
    "dual_bwd": "dual_bwd.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launch-count prefix of the user kernels of mxnet_tpu_torch.rtc
RTC_PREFIX = "rtc:"

# element-type codes of csrc/common.cuh (MxtDType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_info: Dict[str, object] = {}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def source_digest() -> str:
    """Hash of the compiler flags and every source and header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise MXNetError("nvcc not found: the CUDA kernels (mxnet_tpu_torch/csrc "
                     "and mx.rtc modules) are built at first use and need "
                     "the CUDA toolkit")


def build() -> Dict[str, Path]:
    """Compile every source not built yet for the current digest, one
    ``nvcc`` per source, all started together; returns {source: path
    of its shared library}. Raises MXNetError naming the source and the
    compiler's output when a build fails."""
    with _lock:
        out_dir = BUILD_ROOT / source_digest()
        targets = {s: out_dir / (Path(s).stem + ".so") for s in SOURCES}
        todo = [s for s, t in targets.items() if not t.exists()]
        if not todo:
            return targets
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src in todo:
            tmp = out_dir / ("%s.%d.tmp" % (targets[src].name, os.getpid()))
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
                   str(CSRC_DIR / src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for src, tmp, proc in procs:
            logs[src] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, targets[src])
            else:
                failed.append(src)
        _build_info.update(seconds=time.perf_counter() - t0,
                           built=list(todo), dir=str(out_dir), logs=logs)
        if failed:
            raise MXNetError("nvcc failed for %s:\n%s" % (
                ", ".join(failed),
                "\n".join("--- %s\n%s" % (s, logs[s]) for s in failed)))
        return targets


def build_info() -> Dict[str, object]:
    """What the last :func:`build` in this process compiled: seconds,
    sources, build directory and each compiler log (ptxas's register
    and shared-memory report included). Empty when nothing was
    compiled."""
    return dict(_build_info)


def load_library(path: Path) -> ctypes.CDLL:
    """Load a built library; every one exports ``mxt_error_string``."""
    lib = ctypes.CDLL(str(path))
    lib.mxt_error_string.argtypes = [ctypes.c_int]
    lib.mxt_error_string.restype = ctypes.c_char_p
    return lib


def library(source: str) -> ctypes.CDLL:
    """The loaded shared library of one source (built on first use)."""
    lib = _libs.get(source)
    if lib is None:
        path = build()[source]
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                lib = _libs[source] = load_library(path)
    return lib


def build_source(source: str, options=()) -> Path:
    """Compile a CUDA source string with ``nvcc`` (the flags of
    :func:`build` and ``options``) into a shared library, or reuse the
    one already built for the same source, options and flags; returns
    its path. Raises MXNetError with the compiler's output when the
    build fails, and when there is no ``nvcc``."""
    options = tuple(str(o) for o in options)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ("|",) + options).encode())
    h.update(source.encode())
    out_dir = BUILD_ROOT / "rtc" / h.hexdigest()[:16]
    target = out_dir / "module.so"
    with _lock:
        if target.exists():
            return target
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / "module.cu"
        src.write_text(source)
        tmp = out_dir / ("module.%d.tmp" % os.getpid())
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, *options, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise MXNetError("nvcc failed for a runtime-compiled module "
                             "(%s):\n%s" % (src, proc.stdout))
        os.replace(tmp, target)
        return target


def check_launch(lib: ctypes.CDLL, rc: int, kernel: str):
    """Raise when a launcher returned a CUDA error; else count the
    launch."""
    if rc != 0:
        msg = lib.mxt_error_string(rc).decode()
        raise MXNetError("%s: CUDA launch failed (%d: %s)" % (kernel, rc, msg))
    count_launch(kernel)


def count_launch(kernel: str):
    """One launch of ``kernel``: a name of :data:`KERNELS`, or
    ``rtc:<name>`` for a user kernel (its entry made here)."""
    if kernel.startswith(RTC_PREFIX):
        _launches[kernel] = _launches.get(kernel, 0) + 1
    else:
        _launches[kernel] += 1


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return dict(_launches)


def reset_launch_counts():
    for k in list(_launches):
        if k.startswith(RTC_PREFIX):
            del _launches[k]
        else:
            _launches[k] = 0


def check_cuda_tensor(kernel: str, name: str, t: torch.Tensor,
                      dtypes=None, device: Optional[torch.device] = None):
    """Raise unless ``t`` is a contiguous CUDA tensor of an accepted
    dtype (on ``device`` when given)."""
    if not t.is_cuda:
        raise MXNetError("%s: %s must be a CUDA tensor, got one on %s"
                         % (kernel, name, t.device))
    if device is not None and t.device != device:
        raise MXNetError("%s: %s is on %s, expected %s"
                         % (kernel, name, t.device, device))
    if not t.is_contiguous():
        raise MXNetError("%s: %s must be contiguous" % (kernel, name))
    if dtypes is not None and t.dtype not in dtypes:
        raise MXNetError("%s: %s has dtype %s; the kernel takes %s"
                         % (kernel, name, t.dtype,
                            ", ".join(str(d) for d in dtypes)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of ``device``'s card, from which the
    persistent kernels size their grids."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def apply(fn, forward, *args):
    """``fn.apply(*args)`` for a ``torch.autograd.Function`` ``fn`` while
    a graph is being recorded, else ``forward(*args)``, the same kernel
    or plain version without the Function: its bookkeeping costs host
    time on every call, which a forward outside ``autograd.record()``
    does not need."""
    if torch.is_grad_enabled():
        return fn.apply(*args)
    return forward(*args)
