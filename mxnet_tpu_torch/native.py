"""Build and load the port's host library: the native image pipeline
behind :class:`io.ImageRecordIter` (counterpart of
``mxnet_tpu/native/__init__.py`` :: ``load_io_lib``, ``last_error``).

``csrc/io.cc`` is the port's own copy of the reference's pipeline
(RecordIO, JPEG decode, resize/crop/mirror, the threaded
double-buffered producer). It is compiled at first use with ``g++ -O3
-fPIC -std=c++17 -pthread`` into ``mxnet_tpu_torch/_build/host/<digest>/``
(``<digest>`` hashes the flags, the source, the headers and the libjpeg
linked) and bound through ``ctypes`` with the reference's argument
types.

libjpeg: the source compiles against the ABI-62 public headers kept in
``csrc/jpeg/`` and links, by full path with an rpath, the first ABI-62
library found: the system's ``libjpeg.so.62`` where the dynamic loader
finds one, else the copy that Pillow's wheel bundles
(``pillow.libs/libjpeg-*.so.62*``). :func:`build_info` says which. If
neither exists the build raises :class:`MXNetError` naming both places.
A loaded library must pass ``MXIOJpegCheck`` (libjpeg's own version and
struct-size check), so a header/library mismatch raises here rather than
decoding garbage. Nothing falls back to a decoder in Python.

Builds are safe across processes: a build holds an ``fcntl`` lock on
its directory's lock file, compiles into a temporary file and renames
it into place, so a concurrent process either waits or finds the whole
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

from .base import MXNetError
from .ops.cuda_build import BUILD_ROOT, CSRC_DIR, build_lock

__all__ = ["IO_SOURCE", "JPEG_INCLUDE", "CXX_FLAGS", "find_libjpeg",
           "build_io", "load_io_lib", "last_error", "build_info"]

IO_SOURCE = CSRC_DIR / "io.cc"
JPEG_INCLUDE = CSRC_DIR / "jpeg"
JPEG_HEADERS = ("jpeglib.h", "jmorecfg.h", "jconfig.h")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
HOST_ROOT = BUILD_ROOT / "host"
LIB_NAME = "libmxt_io.so"
JPEG_SONAME = "libjpeg.so.62"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Dict[str, object] = {}


def _system_libjpeg() -> Optional[str]:
    """The path of ``libjpeg.so.62`` as the dynamic loader would find
    it: ``LD_LIBRARY_PATH``, then the loader's cache."""
    for d in os.environ.get("LD_LIBRARY_PATH", "").split(":"):
        if d and os.path.isfile(os.path.join(d, JPEG_SONAME)):
            return os.path.join(d, JPEG_SONAME)
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        out = subprocess.run([ldconfig, "-p"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    for line in out.splitlines():
        name, _, path = line.strip().partition(" => ")
        if name.split(" ")[0] == JPEG_SONAME and os.path.isfile(path):
            return path
    return None


def _pillow_libjpeg() -> Optional[str]:
    """The libjpeg that Pillow's wheel bundles beside the ``PIL``
    package, found without importing it."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.origin:
        return None
    libs = Path(spec.origin).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libjpeg-*.so.62*"))
    return str(found[0]) if found else None


def find_libjpeg() -> Tuple[str, str]:
    """``(kind, path)`` of the libjpeg to link: ``("system", ...)`` or
    ``("pillow", ...)``. Raises MXNetError naming both places when
    neither has one."""
    path = _system_libjpeg()
    if path:
        return "system", path
    path = _pillow_libjpeg()
    if path:
        return "pillow", path
    raise MXNetError(
        "no ABI-62 libjpeg for the native image pipeline: the dynamic "
        "loader finds no %s (LD_LIBRARY_PATH, ldconfig -p) and Pillow's "
        "wheel bundles no pillow.libs/libjpeg-*.so.62*" % JPEG_SONAME)


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise MXNetError("no C++ compiler (g++) to build the native image "
                     "pipeline (mxnet_tpu_torch/csrc/io.cc)")


def _digest(libjpeg: str, include: Path) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(IO_SOURCE.read_bytes())
    for name in JPEG_HEADERS:
        h.update(name.encode())
        h.update((include / name).read_bytes())
    h.update(os.path.realpath(libjpeg).encode())
    return h.hexdigest()[:16]


def build_io(libjpeg: Optional[str] = None,
             include: Optional[Path] = None) -> Tuple[Path, Dict[str, object]]:
    """Compile ``csrc/io.cc`` against the headers in ``include`` (default
    ``csrc/jpeg``) and link ``libjpeg`` (default: :func:`find_libjpeg`),
    or reuse the library already built for the same inputs. Returns the
    library's path and what the build did: the libjpeg linked and its
    kind, seconds, whether it compiled. Raises MXNetError with the
    compiler's output when the build fails."""
    if libjpeg is None:
        kind, libjpeg = find_libjpeg()
    else:
        kind = "given"
    include = Path(include) if include is not None else JPEG_INCLUDE
    out_dir = HOST_ROOT / _digest(libjpeg, include)
    target = out_dir / LIB_NAME
    info = {"libjpeg": libjpeg, "libjpeg_kind": kind, "library": str(target),
            "compiled": False, "seconds": 0.0}
    out_dir.mkdir(parents=True, exist_ok=True)
    with build_lock(out_dir):
        if target.exists():
            return target, info
        t0 = time.perf_counter()
        tmp = out_dir / ("%s.%d.tmp" % (LIB_NAME, os.getpid()))
        cmd = [_cxx(), *CXX_FLAGS, "-I", str(include), "-o", str(tmp),
               str(IO_SOURCE), libjpeg,
               "-Wl,-rpath," + os.path.dirname(os.path.realpath(libjpeg))]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise MXNetError("g++ failed for mxnet_tpu_torch/csrc/io.cc "
                             "(%s):\n%s" % (" ".join(cmd), proc.stdout))
        os.replace(tmp, target)
        info.update(compiled=True, seconds=time.perf_counter() - t0)
        return target, info


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.MXIOGetLastError.restype = ctypes.c_char_p
    lib.MXIOGetLastError.argtypes = []
    lib.MXIOJpegCheck.restype = ctypes.c_int
    lib.MXIOJpegCheck.argtypes = []
    lib.MXIOJpegLibrary.restype = ctypes.c_char_p
    lib.MXIOJpegLibrary.argtypes = []
    lib.MXIOCreateImageRecordIter.restype = ctypes.c_void_p
    lib.MXIOCreateImageRecordIter.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    lib.MXIONext.restype = ctypes.c_int
    lib.MXIONext.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                             ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                             ctypes.POINTER(ctypes.c_int)]
    lib.MXIOReset.restype = None
    lib.MXIOReset.argtypes = [ctypes.c_void_p]
    lib.MXIOFree.restype = None
    lib.MXIOFree.argtypes = [ctypes.c_void_p]
    return lib


def load_io_lib(path: Optional[Path] = None) -> ctypes.CDLL:
    """The io library's ctypes handle: the one at ``path``, or the
    port's own, built on first use. Raises MXNetError when there is no
    libjpeg, when the build fails, or when libjpeg refuses the headers
    the library was compiled against."""
    global _lib
    if path is None:
        with _lock:
            if _lib is None:
                target, info = build_io()
                _lib = load_io_lib(target)
                info["linked"] = _lib.MXIOJpegLibrary().decode()
                _info.clear()
                _info.update(info)
            return _lib
    lib = _bind(ctypes.CDLL(str(path)))
    if lib.MXIOJpegCheck() != 0:
        raise MXNetError("native image pipeline %s: %s"
                         % (path, last_error(lib)))
    return lib


def last_error(lib: Optional[ctypes.CDLL] = None) -> str:
    """The io library's last error message."""
    lib = lib if lib is not None else load_io_lib()
    return (lib.MXIOGetLastError() or b"").decode()


def build_info() -> Dict[str, object]:
    """What :func:`load_io_lib` built and loaded in this process: the
    libjpeg linked (``libjpeg``, ``libjpeg_kind``: system or pillow),
    the file the dynamic loader resolved it to (``linked``), the
    library's path, whether it compiled and in how many seconds. Empty
    before the first load."""
    return dict(_info)
