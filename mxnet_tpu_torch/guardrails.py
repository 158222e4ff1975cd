"""Training guardrails, the part the AMP loss scaler uses (counterpart
of ``mxnet_tpu/guardrails.py``): the finiteness check of a whole
gradient set. The grad guard itself (``GradGuard``, the
``MXNET_GUARD_*`` policies) waits (ROADMAP.md queue 1, item 13).
"""
from __future__ import annotations

from typing import Sequence

__all__ = ["all_finite"]


def all_finite(arrays: Sequence) -> bool:
    """True iff every element of every array is finite: one
    ``multi_all_finite`` over the whole set and one host read."""
    if not arrays:
        return True
    from .ndarray import invoke
    flag = invoke("multi_all_finite", list(arrays),
                  {"num_arrays": len(arrays)})
    return bool(flag.tensor().item() > 0)
