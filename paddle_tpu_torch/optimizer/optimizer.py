"""AdamW (port of ``paddle_tpu/optimizer/optimizer.py`` ``Adam`` and
``AdamW`` with the decoupled decay of ``Optimizer._get_fused``).

The rule is written out rather than taken from ``torch.optim.AdamW`` so
that it rounds where the reference rounds, which matters in bf16:

- the moments have the parameter's dtype (``zeros_like(p)``);
- the update is computed in fp32 with bias correction,
  ``m_hat = m / (1 - b1^t)``, ``v_hat = v / (1 - b2^t)``,
  ``p_new = cast(p - lr * m_hat / (sqrt(v_hat) + eps))``, and the moments
  are cast back to their dtype;
- the decoupled decay ``p_new - cast(lr * wd * p_old)`` is applied after the
  rule, in the parameter's dtype.

Only a constant learning rate is ported; schedulers come later.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

__all__ = ["AdamW"]


class AdamW:
    """``parameters``: the tensors to update, or ``(name, tensor)`` pairs
    (``model.named_parameters()``), which ``apply_decay_param_fun(name)``
    needs: it returns True where the decay applies."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters: Optional[Iterable] = None,
                 weight_decay=0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        items = list(parameters)
        named = bool(items) and isinstance(items[0], tuple)
        if apply_decay_param_fun is not None and not named:
            raise ValueError("apply_decay_param_fun needs parameter names: "
                             "pass parameters=model.named_parameters()")
        self._params = [p for _, p in items] if named else items
        self._decay = [apply_decay_param_fun is None
                       or bool(apply_decay_param_fun(n))
                       for n, _ in items] if named \
            else [True] * len(self._params)
        self._lr = float(learning_rate)
        self._b1, self._b2, self._eps = (float(beta1), float(beta2),
                                         float(epsilon))
        self._wd = float(weight_decay or 0.0)
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    @torch.no_grad()
    def step(self):
        t = self._global_step + 1
        b1, b2, lr, eps = self._b1, self._b2, self._lr, self._eps
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for p, decay in zip(self._params, self._decay):
            if p.grad is None or not p.requires_grad:
                continue
            st = self._state.get(id(p))
            if st is None:
                st = self._state[id(p)] = {
                    "moment1": torch.zeros_like(p),
                    "moment2": torch.zeros_like(p)}
            g = p.grad.to(p.dtype).float()
            m = st["moment1"].float().mul_(b1).add_(g, alpha=1.0 - b1)
            v = st["moment2"].float().mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (m / c1).div_((v / c2).sqrt_().add_(eps)).mul_(lr)
            new = (p.float() - upd).to(p.dtype)
            if self._wd and decay:
                new -= (p.float() * (lr * self._wd)).to(p.dtype)
            p.copy_(new)
            st["moment1"].copy_(m)
            st["moment2"].copy_(v)
        self._global_step = t

    def clear_grad(self):
        for p in self._params:
            p.grad = None
