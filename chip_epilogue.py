#!/usr/bin/env python3
"""The bias+GeLU kernels on one NVIDIA card: their bf16 bit-equal shares
over seeds, and their device times against another tree's kernels, in
turns.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_epilogue.py [--seeds N] [--reps N] [--old DIR]

1. shares — for seeds 0 to N - 1, the inputs of
   ``tests/test_torch_cuda.py``'s bias+GeLU tests in bf16 (drawn as the
   tests draw them from a card generator seeded with the seed), and the
   share of elements of y and dx bit-equal to the plain version at each
   shape: the readings from which the tests' floor ``GELU_EQUAL`` is set.
2. turns (with ``--old DIR``) — DIR holds another tree's ``epilogue.cu``
   and ``common.cuh``, for example ``git archive <commit>
   mxnet_tpu_torch/csrc`` unpacked under the gitignored
   ``mxnet_tpu_torch/_build/``. Its library is built there with the
   port's nvcc flags and called through ctypes with the C interface of
   the kernels before their redesign (the backward in strips of 64 rows,
   one column a thread). Each of the forward at (1024, 3072) and (4096,
   3072) and the backward at (4096, 3072), bf16, is timed old, new, new,
   old (each reading the median of 7 trials of ``--reps`` calls,
   ``chip_smoke._gpu_ms``) after both are checked against the plain
   version; and the SASS instructions an element of each kernel
   (``chip_smoke._sass_per_element``).

Prints the card's name and power limit first and one JSON object last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

# the shapes of tests/test_torch_cuda.py's bias+GeLU tests ("shift": BERT's
# serving shape as a view 2 bytes off 16-byte alignment)
SHAPES = ((1024, 3072), (5, 7), (4096, 3072), (129, 300), "shift")


def _inputs(seed, shape):
    """x, dy and b as the card tests draw them, in bf16."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(n, scale=1.0):
        return (torch.randn(n, generator=g, device="cuda") * scale).to(
            torch.bfloat16)
    M, C = (1024, 3072) if shape == "shift" else shape
    if shape == "shift":
        x = randn((M * C + 1,), 2.0)[1:].view(M, C)
    else:
        x = randn((M, C), 2.0)
    return x, randn((M, C)), randn((C,))


def shares(seeds):
    import torch
    from mxnet_tpu_torch.ops import cuda_epilogue as ce
    out = []
    for seed in range(seeds):
        for shape in SHAPES:
            x, dy, b = _inputs(seed, shape)
            y = (ce.bias_gelu_cuda(x, b) == ce.bias_gelu_plain(x, b))
            dx = (ce.bias_gelu_bwd_cuda(dy, x, b)[0]
                  == ce.bias_gelu_bwd_plain(dy, x, b)[0])
            torch.cuda.synchronize()
            r = {"seed": seed, "shape": str(shape),
                 "y": float(y.float().mean()), "dx": float(dx.float().mean())}
            print("[shares] seed %d %-12s y %.6f dx %.6f bit-equal"
                  % (seed, r["shape"], r["y"], r["dx"]))
            out.append(r)
    print("[shares] least: y %.6f, dx %.6f" % (
        min(r["y"] for r in out), min(r["dx"] for r in out)))
    return out


def _old_library(old_dir):
    from mxnet_tpu_torch.ops import cuda_build
    src = Path(old_dir) / "epilogue.cu"
    lib_path = Path(old_dir) / "epilogue_old.so"
    proc = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(old_dir),
         "-o", str(lib_path), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise cs.SmokeFailure("nvcc failed for %s:\n%s" % (src, proc.stdout
                                                           + proc.stderr))
    lib = cuda_build.load_library(lib_path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.mxt_bias_gelu_fwd.argtypes = [p, p, p, i64, i32, i32, i32, p]
    lib.mxt_bias_gelu_fwd.restype = i32
    lib.mxt_bias_gelu_bwd.argtypes = [p, p, p, p, p, p, i64, i32, i32, i32,
                                      i32, p]
    lib.mxt_bias_gelu_bwd.restype = i32
    return lib, lib_path


def turns(old_dir, reps):
    import torch
    from mxnet_tpu_torch.ops import cuda_build, cuda_epilogue as ce
    lib, lib_path = _old_library(old_dir)
    bf16 = cuda_build.DTYPE_CODES[torch.bfloat16]

    def old_fwd(x, b):
        y = torch.empty_like(x)
        rc = lib.mxt_bias_gelu_fwd(x.data_ptr(), b.data_ptr(), y.data_ptr(),
                                   x.shape[0], x.shape[1], bf16, bf16,
                                   cuda_build.stream_of(x))
        assert rc == 0, rc
        return y

    def old_bwd(dy, x, b):
        M, C = x.shape
        dx, db = torch.empty_like(x), torch.empty_like(b)
        part = torch.empty((-(-M // 64), C), dtype=torch.float32,
                           device=x.device)
        rc = lib.mxt_bias_gelu_bwd(dy.data_ptr(), x.data_ptr(), b.data_ptr(),
                                   dx.data_ptr(), part.data_ptr(),
                                   db.data_ptr(), M, C, 64, bf16, bf16,
                                   cuda_build.stream_of(x))
        assert rc == 0, rc
        return dx, db

    new_lib = cuda_build.build()[ce.SOURCE]
    out = []
    randn = cs._randn(11)
    for name, M, new, old, plain in (
            ("bias_gelu_fwd", 1024, ce.bias_gelu_cuda, old_fwd,
             ce.bias_gelu_plain),
            ("bias_gelu_fwd", 4096, ce.bias_gelu_cuda, old_fwd,
             ce.bias_gelu_plain),
            ("bias_gelu_bwd", 4096, ce.bias_gelu_bwd_cuda, old_bwd,
             ce.bias_gelu_bwd_plain)):
        C = 3072
        x, b = randn(M, C, scale=2.0), randn(C)
        args = (x, b) if name == "bias_gelu_fwd" else (randn(M, C), x, b)
        ref = plain(*args)
        for who, fn in (("old", old), ("new", new)):
            got = fn(*args)
            for g, r in zip(got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,)):
                cs._check_close("%s %s (%d, %d)" % (who, name, M, C), g, r,
                                cs.KERNEL_ATOL, cs.KERNEL_RTOL)
        t = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            t[who].append(cs._gpu_ms(lambda: (old if who == "old" else new)(
                *args), reps))
        kernel = "bias_gelu_%s_kernelI13__nv_bfloat16" % name[-3:]
        per = {"old": cs._sass_per_element(lib_path, kernel + "EE", 1),
               "new": cs._sass_per_element(
                   new_lib, kernel + "Li8EE",
                   cs.GELU_FWD_PASS if name == "bias_gelu_fwd"
                   else cs.GELU_BWD_PASS)}
        r = {"name": name, "shape": [M, C], "old_ms": t["old"],
             "new_ms": t["new"], "sass_per_element": per}
        print("[turns] %s (%d, %d) bf16: old %.4f / %.4f ms, new %.4f / "
              "%.4f ms (old, new, new, old); SASS an element: old %s, new %s"
              % (name, M, C, t["old"][0], t["old"][1], t["new"][0],
                 t["new"][1], per["old"], per["new"]))
        out.append(r)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--old", help="directory of another tree's epilogue.cu "
                    "and common.cuh")
    args = ap.parse_args(argv)
    import torch
    try:
        card_line = cs.phase_device()
        result = {"card": card_line, "device": torch.cuda.get_device_name(0),
                  "shares": shares(args.seeds)}
        if args.old:
            result["turns"] = turns(args.old, args.reps)
    except cs.SmokeFailure as e:
        print("FAIL: %s" % e, file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
