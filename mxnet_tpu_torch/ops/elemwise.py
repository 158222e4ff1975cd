"""Elementwise, scalar and broadcast operators, the subset the serving
and training slices run (counterpart of ``mxnet_tpu/ops/elemwise.py``; ref:
src/operator/tensor/elemwise_*).

MXNet semantics kept: ``broadcast_*`` applies numpy broadcasting; a
scalar operand takes the array's dtype before the op, as in the
reference.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from . import register


for _n, _f in {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
               "div": torch.div}.items():
    register("broadcast_" + _n)(_f)


def _make_scalar(opname, fn, reverse=False):
    def impl(data, *, scalar=0.0):
        s = torch.tensor(scalar, dtype=data.dtype, device=data.device)
        return fn(s, data) if reverse else fn(data, s)
    impl.__name__ = opname
    return impl


for _n, _f, _r in [
        ("_plus_scalar", torch.add, False),
        ("_minus_scalar", torch.sub, False),
        ("_rminus_scalar", torch.sub, True),
        ("_mul_scalar", torch.mul, False),
        ("_div_scalar", torch.div, False),
        ("_rdiv_scalar", torch.div, True)]:
    register(_n)(_make_scalar(_n, _f, _r))


register("identity", aliases=["_copy"])(lambda data: data)
register("negative")(torch.neg)
register("square")(torch.square)


@register("Cast", aliases=["cast"])
def cast(data, *, dtype):
    return data.to(torch_dtype(dtype))
