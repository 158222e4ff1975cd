#!/usr/bin/env python3
"""The redesigned row-wise and elementwise kernels on one NVIDIA card (the
LayerNorm forward, bias+residual, bias+GeLU forward and backward,
dropout): their bf16 bit-equal shares over seeds, and their device times
against another tree's kernels, in turns.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_epilogue.py [--seeds N] [--reps N] [--old DIR]

1. shares — for seeds 0 to N - 1, the inputs of
   ``tests/test_torch_cuda.py``'s LayerNorm forward, bias+GeLU and
   bias+residual tests in bf16 (drawn as the tests draw them from a card
   generator seeded with the seed), and the share of elements of each
   output bit-equal to the plain version at each shape: the readings from
   which the tests' floors ``LN_EQUAL`` and ``GELU_EQUAL`` are set
   (bias+residual's must be 1).
2. turns (with ``--old DIR``) — DIR holds another tree's ``common.cuh``
   and any of its ``epilogue.cu``, ``layer_norm.cu`` and ``dropout.cu``,
   for example ``git archive <commit> mxnet_tpu_torch/csrc`` unpacked
   under the gitignored ``mxnet_tpu_torch/_build/``. The sources DIR
   holds are built there with the port's nvcc flags and called through
   ctypes with the C interface of the kernels before this tree's
   redesign (the LayerNorm forward and bias+residual without an SM
   count; dropout without a launch plan). Both row-wise sources give
   the row-wise turns, ``dropout.cu`` the dropout turns. Each of the
   LayerNorm forward and
   bias+residual at one row (the fixed cost: a launch and one row's
   latency), (1024, 768) and (4096, 768), the bias+GeLU forward at (1024,
   3072) and (4096, 3072) and its backward at (4096, 3072), bf16, is
   timed old, new, new, old (each reading the median of 7 trials of
   ``--reps`` calls, ``chip_smoke._gpu_ms``) after both are checked
   against the plain version, then the one PyTorch call that computes
   the same function; and the SASS instructions an element of each
   redesigned kernel (``chip_smoke._sass_per_element``). The dropout
   kernel (``DROPOUT_TURNS``: BERT's (4096, 768) bf16 at p 0.1, PTB's
   (1120, 650) and VGG-16's (64, 4096) f32 at p 0.5, and one element,
   its fixed cost) is timed the same way after both kernels equal the
   plain version bit for bit, with ``F.dropout`` and the byte bound (x
   read once, y written once, at the card's published memory rate)
   beside each reading, and the new kernel's launch plan.

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

# the shapes of tests/test_torch_cuda.py's bias+GeLU and bias+residual
# tests ("shift": BERT's serving shape as a view 2 bytes off 16-byte
# alignment)
SHAPES = ((1024, 3072), (5, 7), (4096, 3072), (129, 300), "shift")
# and of its LayerNorm forward tests
LN_SHAPES = ((1, 768), (1024, 768), (33, 100), (4096, 768), (64, 1024),
             (8, 2048), "shift")


def _inputs(seed, shape):
    """x, the second stream (dy of the backward, r of bias+residual) and b
    as the card tests draw them, in bf16."""
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


def _ln_inputs(seed, shape):
    """x, gamma and beta as the LayerNorm forward's card tests draw them,
    in bf16 (x = 3 N(0, 1) + 1)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(n, scale=1.0):
        return (torch.randn(n, generator=g, device="cuda") * scale).to(
            torch.bfloat16)
    M, C = (1024, 768) if shape == "shift" else shape
    if shape == "shift":
        x = (randn((M * C + 1,), 3.0) + 1)[1:].view(M, C)
    else:
        x = randn((M, C), 3.0) + 1
    return x, randn((C,)), randn((C,))


def _share(got, ref):
    return float((got == ref).float().mean())


def shares(seeds):
    import torch
    from mxnet_tpu_torch.ops import cuda_epilogue as ce, cuda_norm as cn
    out = []
    for seed in range(seeds):
        for shape in SHAPES:
            x, dy, b = _inputs(seed, shape)
            r = {"seed": seed, "shape": str(shape),
                 "y": _share(ce.bias_gelu_cuda(x, b), ce.bias_gelu_plain(x, b)),
                 "dx": _share(ce.bias_gelu_bwd_cuda(dy, x, b)[0],
                              ce.bias_gelu_bwd_plain(dy, x, b)[0]),
                 "residual": _share(ce.bias_residual_cuda(x, b, dy),
                                    ce.bias_residual_plain(x, b, dy))}
            torch.cuda.synchronize()
            print("[shares] seed %d %-12s bias_gelu y %.6f dx %.6f, "
                  "bias_residual y %.6f bit-equal"
                  % (seed, r["shape"], r["y"], r["dx"], r["residual"]))
            out.append(r)
        for shape in LN_SHAPES:
            x, g, b = _ln_inputs(seed, shape)
            r = {"seed": seed, "shape": str(shape), "ln": min(
                _share(cn.layer_norm_cuda(x, gg, bb, 1e-5),
                       cn.layer_norm_plain(x, gg, bb, 1e-5))
                for gg, bb in ((g, b), (g.float(), b.float())))}
            torch.cuda.synchronize()
            print("[shares] seed %d %-12s layer_norm_fwd y %.6f bit-equal "
                  "(the lesser of bf16 and f32 gamma/beta)"
                  % (seed, r["shape"], r["ln"]))
            out.append(r)
    least = {k: min(r[k] for r in out if k in r)
             for k in ("y", "dx", "residual", "ln")}
    print("[shares] least: bias_gelu y %.6f, dx %.6f; bias_residual %.6f; "
          "layer_norm_fwd %.6f" % (least["y"], least["dx"],
                                   least["residual"], least["ln"]))
    return out


# the dropout turns: path, shape, dtype, p
DROPOUT_TURNS = (("bert", (4096, 768), "bfloat16", 0.1),
                 ("ptb", (1120, 650), "float32", 0.5),
                 ("vgg", (64, 4096), "float32", 0.5),
                 ("one element", (1,), "float32", 0.5))


def _old_libraries(old_dir):
    """Build those of another tree's epilogue.cu, layer_norm.cu and
    dropout.cu that ``old_dir`` holds (one nvcc each, started together);
    returns {source: (library, path)}."""
    from mxnet_tpu_torch.ops import cuda_build
    procs = {}
    for src in ("epilogue.cu", "layer_norm.cu", "dropout.cu"):
        if not (Path(old_dir) / src).exists():
            continue
        path = Path(old_dir) / (Path(src).stem + "_old.so")
        procs[src] = (path, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(old_dir),
             "-o", str(path), str(Path(old_dir) / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise cs.SmokeFailure("nvcc failed for %s:\n%s" % (src, log))
        libs[src] = (cuda_build.load_library(path), path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    if "epilogue.cu" in libs:
        ep = libs["epilogue.cu"][0]
        ep.mxt_bias_gelu_fwd.argtypes = [p, p, p, i64, i32, i32, i32, i32, p]
        ep.mxt_bias_gelu_bwd.argtypes = [p, p, p, p, p, i64, p, i64, i32,
                                         i32, i32, i32, p]
        ep.mxt_bias_gelu_bwd_strips.argtypes = [i64, i32, i32, i32]
        ep.mxt_bias_gelu_bwd_strips.restype = i64
        ep.mxt_bias_residual_fwd.argtypes = [p, p, p, p, i64, i32, i32, i32,
                                             p]
    if "layer_norm.cu" in libs:
        ln = libs["layer_norm.cu"][0]
        ln.mxt_layer_norm_fwd.argtypes = [p, p, p, p, i64, i32,
                                          ctypes.c_float, i32, i32, p]
    if "dropout.cu" in libs:
        dr = libs["dropout.cu"][0]
        dr.mxt_dropout.argtypes = [p, p, p, i64, ctypes.c_uint32,
                                   ctypes.c_float, i32, p]
        dr.mxt_dropout.restype = i32
    return libs


def dropout_turns(lib, reps):
    """The dropout kernel against ``lib``'s (another tree's, one element a
    thread) at ``DROPOUT_TURNS``, in turns, with ``F.dropout`` and the
    byte bound."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import cuda_build, cuda_dropout as cd
    dev = torch.device("cuda")
    bw = cs._peaks(torch.cuda.get_device_name(0))[0]
    g = torch.Generator(device="cuda").manual_seed(16)
    seed = torch.tensor([16], dtype=torch.int32, device="cuda")

    def old(x, p):
        y = torch.empty_like(x)
        rc = lib.mxt_dropout(x.data_ptr(), y.data_ptr(), seed.data_ptr(),
                             x.numel(), cd.keep_threshold(p), cd._scale(p),
                             cuda_build.DTYPE_CODES[x.dtype],
                             cuda_build.stream_of(x))
        if rc:
            raise cs.SmokeFailure("the old dropout kernel: CUDA error %d"
                                  % rc)
        return y

    out = []
    for name, shape, dtype, p in DROPOUT_TURNS:
        x = torch.randn(shape, generator=g, device="cuda").to(
            getattr(torch, dtype))
        ref = cd.dropout_plain(x, p, seed)
        fns = {"new": lambda: cd.dropout_cuda(x, p, seed),
               "old": lambda: old(x, p)}
        for who, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise cs.SmokeFailure("%s dropout %s %s: not the plain "
                                      "version bit for bit"
                                      % (who, shape, dtype))
        t = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            t[who].append(cs._gpu_ms(fns[who], reps))
        lib_ms = cs._gpu_ms(lambda: F.dropout(x, p, training=True), reps)
        nbytes = 2 * x.numel() * x.element_size()
        bound = nbytes / bw * 1e3
        plan = cd.launch_plan(x.numel(), x.element_size(), True,
                              cuda_build.sm_count(dev),
                              cd._per_sm(dev, cuda_build.DTYPE_CODES[x.dtype],
                                         True))
        r = {"name": "dropout", "path": name, "shape": list(shape),
             "dtype": dtype, "p": p, "old_ms": t["old"], "new_ms": t["new"],
             "library_ms": lib_ms, "bound_ms": bound, "bound_by": "bytes",
             "plan": plan._asdict()}
        print("[turns] dropout %s %s %s p %g: old %.4f / %.4f ms, new %.4f / "
              "%.4f ms (old, new, new, old); F.dropout %.4f ms; byte bound "
              "%.4f ms (%d bytes); new plan %d accesses a thread, %d blocks"
              % (name, shape, dtype, p, t["old"][0], t["old"][1],
                 t["new"][0], t["new"][1], lib_ms, bound, nbytes, plan.units,
                 plan.blocks))
        out.append(r)
    return out


def turns(libs, reps):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import (cuda_build, cuda_epilogue as ce,
                                     cuda_norm as cn)
    ep, ep_path = libs["epilogue.cu"]
    ln, ln_path = libs["layer_norm.cu"]
    bf16 = cuda_build.DTYPE_CODES[torch.bfloat16]
    sms = cuda_build.sm_count(torch.device("cuda"))

    def call(rc):
        assert rc == 0, rc

    def old_ln(x, g, b):
        y = torch.empty_like(x)
        call(ln.mxt_layer_norm_fwd(x.data_ptr(), g.data_ptr(), b.data_ptr(),
                                   y.data_ptr(), x.shape[0], x.shape[1],
                                   1e-5, bf16, bf16, cuda_build.stream_of(x)))
        return y

    def old_residual(x, b, r):
        y = torch.empty_like(x)
        call(ep.mxt_bias_residual_fwd(x.data_ptr(), b.data_ptr(),
                                      r.data_ptr(), y.data_ptr(), x.shape[0],
                                      x.shape[1], bf16, bf16,
                                      cuda_build.stream_of(x)))
        return y

    def old_fwd(x, b):
        y = torch.empty_like(x)
        call(ep.mxt_bias_gelu_fwd(x.data_ptr(), b.data_ptr(), y.data_ptr(),
                                  x.shape[0], x.shape[1], sms, bf16, bf16,
                                  cuda_build.stream_of(x)))
        return y

    def old_bwd(dy, x, b):
        M, C = x.shape
        dx, db = torch.empty_like(x), torch.empty_like(b)
        strips = ep.mxt_bias_gelu_bwd_strips(M, C, 8, sms)
        part = torch.empty((strips, C), dtype=torch.float32, device=x.device)
        call(ep.mxt_bias_gelu_bwd(dy.data_ptr(), x.data_ptr(), b.data_ptr(),
                                  dx.data_ptr(), part.data_ptr(), strips,
                                  db.data_ptr(), M, C, sms, bf16, bf16,
                                  cuda_build.stream_of(x)))
        return dx, db

    built = cuda_build.build()
    # name, shape, new, old, plain, library, the new kernel's SASS
    # (source, fragment, elements a pass) and the old's (fragment,
    # elements a pass), None where its loop is not one pass
    ln_sass = (cn.SOURCE, cs.LN_FWD_SASS, cs.LN_FWD_PASS)
    res_sass = (ce.SOURCE, cs.RESIDUAL_SASS, cs.RESIDUAL_PASS)
    old_gelu = "bias_gelu_%s_kernelI13__nv_bfloat16Li8EE"
    cases = []
    for M in (1, 1024, 4096):
        cases.append(("layer_norm_fwd", (M, 768), cn.layer_norm_cuda,
                      old_ln, cn.layer_norm_plain,
                      lambda x, g, b: F.layer_norm(x, (768,), g, b, 1e-5),
                      ln_sass, None))
        cases.append(("bias_residual_fwd", (M, 768), ce.bias_residual_cuda,
                      old_residual, ce.bias_residual_plain,
                      lambda x, b, r: x + b + r, res_sass,
                      ("bias_residual_fwd_kernelI13__nv_bfloat16EE", 1)))
    for M in (1024, 4096):
        cases.append(("bias_gelu_fwd", (M, 3072), ce.bias_gelu_cuda, old_fwd,
                      ce.bias_gelu_plain, lambda x, b: F.gelu(x + b),
                      (ce.SOURCE, cs.GELU_FWD_SASS, cs.GELU_FWD_PASS),
                      (old_gelu % "fwd", cs.GELU_FWD_PASS)))
    xl = bl = yl = None

    def gelu_bwd_library(dy, x, b):
        return torch.autograd.grad(yl, (xl, bl), dy, retain_graph=True)
    cases.append(("bias_gelu_bwd", (4096, 3072), ce.bias_gelu_bwd_cuda,
                  old_bwd, ce.bias_gelu_bwd_plain, gelu_bwd_library,
                  (ce.SOURCE, cs.GELU_BWD_SASS, cs.GELU_BWD_PASS),
                  (old_gelu % "bwd", cs.GELU_BWD_PASS)))

    out = []
    randn = cs._randn(11)
    for name, (M, C), new, old, plain, library, new_sass, old_sass in cases:
        x, b = randn(M, C, scale=2.0), randn(C)
        if name == "layer_norm_fwd":
            args = (x, randn(C), b)
        elif name == "bias_residual_fwd":
            args = (x, b, randn(M, C))
        elif name == "bias_gelu_fwd":
            args = (x, b)
        else:
            args = (randn(M, C), x, b)
            xl, bl = x.clone().requires_grad_(), b.clone().requires_grad_()
            yl = F.gelu(xl + bl)
        ref = plain(*args) if name != "layer_norm_fwd" else plain(*args, 1e-5)
        fns = {"new": (lambda: new(*args, 1e-5)) if name == "layer_norm_fwd"
               else (lambda: new(*args)),
               "old": lambda: old(*args)}
        for who, fn in fns.items():
            got = fn()
            for g, r in zip(got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,)):
                cs._check_close("%s %s (%d, %d)" % (who, name, M, C), g, r,
                                cs.KERNEL_ATOL, cs.KERNEL_RTOL)
        t = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            t[who].append(cs._gpu_ms(fns[who], reps))
        lib_ms = cs._gpu_ms(lambda: library(*args), reps)
        src, frag, per_pass = new_sass
        per = {"new": cs._sass_per_element(built[src], frag, per_pass),
               "old": None}
        if old_sass is not None:
            old_path = ep_path if name.startswith("bias") else ln_path
            per["old"] = cs._sass_per_element(old_path, *old_sass)
        r = {"name": name, "shape": [M, C], "old_ms": t["old"],
             "new_ms": t["new"], "library_ms": lib_ms,
             "sass_per_element": per}
        print("[turns] %s (%d, %d) bf16: old %.4f / %.4f ms, new %.4f / "
              "%.4f ms (old, new, new, old); library %.4f ms; SASS an "
              "element: old %s, new %s"
              % (name, M, C, t["old"][0], t["old"][1], t["new"][0],
                 t["new"][1], lib_ms, per["old"], per["new"]))
        out.append(r)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--old", help="directory of another tree's common.cuh "
                    "and any of its epilogue.cu, layer_norm.cu, dropout.cu")
    args = ap.parse_args(argv)
    import torch
    try:
        card_line = cs.phase_device()
        result = {"card": card_line, "device": torch.cuda.get_device_name(0),
                  "shares": shares(args.seeds)}
        if args.old:
            libs = _old_libraries(args.old)
            if {"epilogue.cu", "layer_norm.cu"} <= set(libs):
                result["turns"] = turns(libs, args.reps)
            if "dropout.cu" in libs:
                result["dropout_turns"] = dropout_turns(
                    libs["dropout.cu"][0], args.reps)
    except cs.SmokeFailure as e:
        print("FAIL: %s" % e, file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
