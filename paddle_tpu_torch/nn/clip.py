"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``: ``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``).

Pass one as an optimizer's ``grad_clip``. The optimizer applies it inside
its fused update, as the JAX package applies ``_apply_jax`` inside the
jitted step: on CUDA the norm clips' sums of squares are one
``multi_tensor_sumsq`` pass and the scale is applied where the update
kernel reads each gradient, so no clipped copy of the gradients is ever
written. ``_apply_plain(grads)`` is the same clip on a list of tensors in
plain PyTorch, rounded as the reference rounds:
``(g.float() * scale).to(g.dtype)``. Calling a clip on ``(param, grad)``
pairs (the reference's static-graph API) returns the clipped gradients as
new tensors: a norm clip's sums of squares come from ``multi_tensor_sumsq``
(the kernel on CUDA, its plain version on the CPU), then each gradient is
scaled; a value clip clamps.
"""
from __future__ import annotations

from ..kernels import optimizer as _kopt
from ..kernels.optimizer import clip_norms_plain, clip_plain

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class ClipGradBase:
    def _spec(self):
        """What the fused update applies: ``("value", lo, hi)`` or
        ``("norm", clip_norm, scale_mode)`` (1 per tensor, 2 global)."""
        raise NotImplementedError

    def _apply_plain(self, grads):
        """The clipped gradients, each by ``clip_plain``, as the optimizer's
        plain update clips them."""
        grads = list(grads)
        kind, a, b = self._spec()
        if kind == "value":
            return [clip_plain(g, (kind, a, b)) for g in grads]
        norms = clip_norms_plain(grads, a, b)
        return [clip_plain(g, ("scale",), norms, i)
                for i, g in enumerate(grads)]

    def __call__(self, params_grads):
        """``[(param, grad)]`` -> ``[(param, clipped grad)]``
        (``paddle_tpu/nn/clip.py:13-18``)."""
        pairs = list(params_grads)
        grads = [g for _, g in pairs]
        kind, a, b = self._spec()
        if kind == "value" or not grads:
            new = self._apply_plain(grads)
        else:
            n = len(grads)
            batch = _kopt.StepBatch(grads, grads, [[None] * n] * 3,
                                    [True] * n, 0.0, 1, rule="grads")
            norms = _kopt.multi_tensor_sumsq(batch, a, b)
            new = [clip_plain(g, ("scale",), norms, i)
                   for i, g in enumerate(grads)]
        return [(p, g) for (p, _), g in zip(pairs, new)]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _spec(self):
        return ("value", self.min, self.max)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _spec(self):
        return ("norm", self.clip_norm, 1)


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _spec(self):
        return ("norm", self.clip_norm, 2)
