"""The port's ``symbol`` package (counterpart of ``mxnet_tpu/symbol``).

It holds only the graph passes the hybridized path runs
(:mod:`.layout_opt`); the Symbol API itself is still to be ported
(ROADMAP.md queue 1, item 16).
"""
from . import layout_opt  # noqa: F401

__all__ = ["layout_opt"]
