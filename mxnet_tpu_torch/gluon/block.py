"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``;
ref: python/mxnet/gluon/block.py).

Name scopes and prefixes follow the reference exactly — parameter names
for the same ``prefix`` equal the reference's, name-scope counters
included — because the weight carry (:mod:`mxnet_tpu_torch.interop`)
matches parameters by name.

``HybridBlock.hybrid_forward(F, x, ...)`` always receives the op
namespace as ``F`` and runs on NDArrays. ``hybridize()`` makes the block
run through a :class:`mxnet_tpu_torch.cached_op.CachedOp` built at its
next call (after deferred shapes are complete): captured CUDA graphs on
the card, the same function run eagerly on the CPU, one tape node under
``autograd.record()``. Only the outermost active block captures; its
children run eagerly inside its call. ``hybridize()`` again, ``cast`` and
``initialize(force_reinit=True)`` drop the cached op, whose graphs would
read the old parameters' memory; ``load_parameters`` writes into that
memory, so the graphs stay and read the loaded values.

``save_parameters``/``load_parameters`` use the reference's format: the
NDArray container of ``nd.save`` keyed by structural names (``0.weight``,
``1.running_mean``, ...), so a file written by either package loads in
the other.
"""
from __future__ import annotations

import math
import re
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from .. import cached_op as _cached_op
from .. import ndarray as nd
from ..context import cpu, current_context
from ..ndarray import NDArray
from ..ops import F as _F
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope(threading.local):
    def __init__(self):
        self.current = None
        self.counters = {}


_scope = _BlockScope()


class _NameScopeCM:
    def __init__(self, block):
        self._block = block

    def __enter__(self):
        self._old = _scope.current
        _scope.current = self._block
        return self._block._prefix

    def __exit__(self, *exc):
        _scope.current = self._old
        return False


def _gen_prefix(hint: str) -> str:
    parent = _scope.current
    if parent is not None:
        counters = parent._child_counters
        base = parent._prefix
    else:
        counters = _scope.counters
        base = ""
    idx = counters.get(hint, 0)
    counters[hint] = idx + 1
    return "%s%s%d_" % (base, hint, idx)


def _strip_prefix(name, prefix):
    return name[len(prefix):] if name.startswith(prefix) else name


class Block:
    """Base container (ref: block.py :: Block)."""

    def __init__(self, prefix: Optional[str] = None,
                 params: Optional[ParameterDict] = None):
        hint = re.sub(r"(?!^)([A-Z]+)", r"_\1", type(self).__name__).lower()
        if prefix is None:
            prefix = _gen_prefix(hint)
        elif _scope.current is not None:
            prefix = _scope.current._prefix + prefix
        self._prefix = prefix
        self._child_counters: Dict[str, int] = {}
        self._params = ParameterDict(prefix, shared=params)
        self._children: "OrderedDict[str, Block]" = OrderedDict()
        self._forward_hooks: List = []
        self._forward_pre_hooks: List = []

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") else self._prefix

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self):
        return _NameScopeCM(self)

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=repr(block).replace("\n", "\n  "))
            for key, block in self._children.items())
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            existing = self.__dict__.get("_children")
            if existing is not None:
                existing[name] = value
        elif isinstance(value, Parameter):
            if "_params" in self.__dict__:
                self._params._params[value.name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after every call."""
        self._forward_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before every call."""
        self._forward_pre_hooks.append(hook)

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from .. import initializer as init_mod
        if force_reinit:
            self._clear_cached_op()
        self.collect_params().initialize(
            init or init_mod.Uniform(), ctx, verbose, force_reinit)

    def cast(self, dtype):
        self._clear_cached_op()
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def zero_grad(self):
        self.collect_params().zero_grad()

    def _structural_params(self, prefix="") -> "OrderedDict[str, Parameter]":
        """The parameters by structural name: the child attribute names
        joined by '.', then the name without the block's prefix (ref:
        Block._collect_params_with_prefix; the save_parameters format,
        which does not change when prefixes are numbered anew)."""
        ret = OrderedDict()
        for name, p in self._params.items():
            ret[prefix + _strip_prefix(name, self._prefix)] = p
        for cname, child in self._children.items():
            ret.update(child._structural_params(prefix + cname + "."))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """``nd.save`` of every parameter by structural name; with
        ``deduplicate`` a shared parameter is written once, under its
        first name (ref: save_parameters)."""
        arg_dict, seen = {}, set()
        for name, param in self._structural_params().items():
            if deduplicate and id(param) in seen:
                continue
            seen.add(id(param))
            arg_dict[name] = param.data()
        nd.save(filename, arg_dict)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set the parameters from ``filename`` (ref: load_parameters).
        A name resolves as a structural name, else a full parameter
        name, else a name without this block's prefix. Values are
        written into the parameters' arrays, converted to their dtypes
        (so captured graphs that read them stay valid); a parameter
        whose shape was deferred takes the file's. ``ctx`` moves the
        parameters there first. ``cast_dtype`` and ``dtype_source`` are
        accepted and change nothing, as in the reference."""
        loaded = nd.load(filename, ctx=cpu())
        params = self._structural_params()
        full_names = self.collect_params()
        resolved = {}
        for k, v in loaded.items():
            if k in params:
                resolved[k] = (params[k], v)
            elif k in full_names:
                resolved[k] = (full_names[k], v)
            elif self._prefix + k in full_names:
                resolved[k] = (full_names[self._prefix + k], v)
            elif not ignore_extra:
                raise ValueError("Parameter %s in file %s unknown to block"
                                 % (k, filename))
        if not allow_missing:
            matched = {id(p) for p, _ in resolved.values()}
            for name, p in params.items():
                if id(p) not in matched:
                    raise AssertionError("Parameter %s missing in file %s"
                                         % (name, filename))
        for p, data in resolved.values():
            if p._data is None and p._deferred_init is None:
                p._shape = tuple(data.shape)
                p.initialize(ctx=ctx or [current_context()])
            elif p._deferred_init is not None:
                p._shape = tuple(data.shape)
                if ctx is not None:
                    p.reset_ctx(ctx)
                p._finish_deferred_init()
            elif ctx is not None:
                p.reset_ctx(ctx)
            p.set_data(data)

    save_params = save_parameters
    load_params = load_parameters

    def _clear_cached_op(self):
        """Drop this block's and its children's captured graphs."""
        for child in self._children.values():
            child._clear_cached_op()

    def __call__(self, *args, **kwargs):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args, **kwargs)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def _iter_blocks(self):
        yield self
        for child in self._children.values():
            yield from child._iter_blocks()

    def summary(self, *inputs):
        """Print a table of every block's type, output shape and
        parameter count (shared parameters counted once) from one
        forward with hooks (ref: block.py :: summary). Call it before
        ``hybridize()``: a captured call runs no child's hooks."""
        if any(getattr(b, "_active", False) for b in self._iter_blocks()):
            raise AssertionError(
                "'summary' is only supported before hybridize: the "
                "traced CachedOp bypasses child forward hooks")
        summary: "OrderedDict[str, dict]" = OrderedDict()
        seen = set()
        hooks = []

        def _shape_of(out):
            first = out[0] if isinstance(out, (list, tuple)) else out
            return tuple(first.shape)

        def _register(blk, prefix=""):
            def hook(b, _args, out, _name=prefix or type(blk).__name__):
                key = "%s-%d" % (_name, len(summary) + 1)
                n_params = n_shared = 0
                for p in b._params.values():
                    sz = math.prod(p.shape) if p.shape else 0
                    if id(p) in seen:
                        n_shared += sz
                    else:
                        seen.add(id(p))
                        n_params += sz
                summary[key] = dict(type=type(b).__name__,
                                    output=_shape_of(out),
                                    n_params=n_params, n_shared=n_shared)
            blk.register_forward_hook(hook)
            hooks.append(hook)
            for child in blk._children.values():
                _register(child, (prefix + "." if prefix else "")
                          + type(child).__name__)

        _register(self)
        try:
            self(*inputs)
        finally:
            for blk in self._iter_blocks():
                blk._forward_hooks = [h for h in blk._forward_hooks
                                      if h not in hooks]
        lines = ["-" * 76,
                 "%-34s %-24s %15s" % ("Layer (type)", "Output Shape",
                                       "Param #"),
                 "=" * 76]
        total = shared = 0
        for key, row in summary.items():
            lines.append("%-34s %-24s %15d"
                         % (key + " (" + row["type"] + ")",
                            str(row["output"]), row["n_params"]))
            total += row["n_params"]
            shared += row["n_shared"]
        lines += ["=" * 76, "Total params: %d" % total,
                  "Shared params: %d" % shared, "-" * 76]
        print("\n".join(lines))
        return summary

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)


class HybridBlock(Block):
    """Block whose forward is written once against ``F`` (ref:
    HybridBlock)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = []
        self._cached_op = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Run this block through a CachedOp from its next call
        (``active``), with the flags ``static_alloc`` (parameters read
        in place; else copied in like data) and ``static_shape`` (kept:
        a graph is one signature either way); the cached op is built
        anew."""
        self._active = active
        self._flags = [("static_alloc", static_alloc),
                       ("static_shape", static_shape)]
        self._clear_cached_op()
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _clear_cached_op(self):
        if self._cached_op is not None:
            self._cached_op.release()
            self._cached_op = None
        super()._clear_cached_op()

    def _call_cached_op(self, *args):
        """The call through the CachedOp (ref: block.py ::
        _call_cached_op); the first call with a parameter's shape still
        deferred runs eagerly and completes it."""
        cop = self._cached_op
        if cop is None:
            params = list(self.collect_params().values())
            if any(p._data is None for p in params):
                with _cached_op.eager():
                    return self.forward(*args)
            datas = []
            for a in args:
                _cached_op._flatten(a, datas)
            names = ["data%d" % i for i in range(len(datas))] + \
                [p.name for p in params]
            cop = self._cached_op = _cached_op.CachedOp(
                self.forward, params, names, self._flags, name=self.name)
        return cop(*args)

    def infer_shape(self, *args):
        """Per-layer hook: layers with input-dependent parameter shapes
        override this to complete deferred shapes from real inputs."""

    def forward(self, x: NDArray, *args):
        if self._active and _cached_op.outermost():
            return self._call_cached_op(x, *args)
        ctx = x.context
        try:
            params = {_strip_prefix(name, self._prefix): p.data(ctx)
                      for name, p in self._params.items()}
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            for p in self._params.values():
                p._finish_deferred_init()
            params = {_strip_prefix(name, self._prefix): p.data(ctx)
                      for name, p in self._params.items()}
        return self.hybrid_forward(_F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def serve_session(self, *example_inputs, **kwargs):
        """Open an :class:`mxnet_tpu_torch.serve.InferenceSession` over
        this block: padded shape buckets, eval mode, weights read live.
        Keyword args pass through (``max_batch``, ``seq_axis``,
        ``max_seq``, ``buckets``, ``ctx``, and ``mesh``/``param_specs``/
        ``data_spec`` for mesh-sharded serving)."""
        from ..serve import InferenceSession
        return InferenceSession(
            self, example_inputs=example_inputs or None, **kwargs)
