"""Dynamic loss scaler (counterpart of
``mxnet_tpu/contrib/amp/loss_scaler.py``; ref:
python/mxnet/contrib/amp/loss_scaler.py :: LossScaler): ×2 after
``scale_window`` clean steps, ÷2 on overflow with the gradients zeroed.
The overflow check is ``guardrails.all_finite``: one reduction and one
host read for the whole gradient set.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


def _scale_(grads, factor):
    """Each gradient times ``factor`` in place, the factor rounded to
    the gradient's dtype first (a weakly typed scalar in the
    reference)."""
    with torch.no_grad():
        for g in grads:
            t = g.tensor()
            t.mul_(torch.tensor(factor, dtype=t.dtype).item())


class LossScaler:
    def __init__(self, init_scale=2.**16, scale_factor=2., scale_window=2000,
                 dynamic=True):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self._dynamic = dynamic
        self.last_overflow = False

    def backoff(self):
        """Overflow: halve the scale (not below 1) and restart the
        clean-step window."""
        self.last_overflow = True
        self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
        self._unskipped = 0

    def good_step(self):
        """A clean step: grow the scale after ``scale_window`` of them."""
        self.last_overflow = False
        self._unskipped += 1
        if self._unskipped >= self._scale_window:
            self.loss_scale *= self._scale_factor
            self._unskipped = 0

    def unscale(self, grads):
        """Divide the gradients by the scale, without the check."""
        _scale_(grads, 1.0 / self.loss_scale)

    def unscale_and_check(self, grads) -> bool:
        """Divide the gradients by the scale; True if all are finite.
        A dynamic scaler then grows or, on overflow, halves its scale
        and zeroes the gradients."""
        from ... import guardrails
        _scale_(grads, 1.0 / self.loss_scale)
        if not self._dynamic:
            return True
        ok = guardrails.all_finite(grads)
        if ok:
            self.good_step()
        else:
            self.backoff()
            with torch.no_grad():
                for g in grads:
                    g.tensor().zero_()
        return ok

    def has_overflow(self, params) -> bool:
        from ... import guardrails
        grads = [p.grad() for p in params if p.grad_req != "null"]
        return not guardrails.all_finite(grads)
