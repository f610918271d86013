"""Tensor and autograd (port of ``paddle_tpu/core/{tensor,dispatch,autograd}.py``).

The JAX package needs a ``Tensor`` class of its own: a ``jax.Array`` has no
gradient and cannot be changed in place, so ``paddle_tpu/core/tensor.py``
wraps one, ``core/dispatch.py`` sends each op to a jitted XLA function and
``core/autograd.py`` keeps the tape. A ``torch.Tensor`` has all three
already: here ``Tensor`` *is* ``torch.Tensor``, the dispatcher is torch's
and the tape is autograd's. There is no wrapper class, no subclass with
``__torch_function__`` and no patched method; paddle's semantics come from
the free functions of ``paddle_tpu_torch.ops``, which take paddle's
signatures. A paddle ``stop_gradient`` is ``not requires_grad``.
"""
from __future__ import annotations

import torch

__all__ = ["Tensor", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "grad"]

Tensor = torch.Tensor
no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad (``paddle_tpu/__init__.py:34-56``): the gradients of
    ``outputs`` with respect to ``inputs``, as a list, leaving every
    input's ``.grad`` as it was. An input that ``outputs`` do not depend on
    raises unless ``allow_unused``, and then its gradient is ``None``.
    ``no_grad_vars`` is not ported (the JAX package ignores it too)."""
    outs = _as_list(outputs)
    ins = _as_list(inputs)
    if grad_outputs is None:
        gouts = [None] * len(outs)
    else:
        gouts = _as_list(grad_outputs)
    gouts = [torch.ones_like(o) if g is None else g
             for o, g in zip(outs, gouts)]
    got = torch.autograd.grad(outs, ins, grad_outputs=gouts,
                              retain_graph=True if retain_graph is None
                              else retain_graph,
                              create_graph=create_graph, allow_unused=True)
    for i, g in enumerate(got):
        if g is None and not allow_unused:
            raise RuntimeError(f"grad: input {i} is unused in the graph of "
                               f"the outputs (pass allow_unused=True)")
    return list(got)
