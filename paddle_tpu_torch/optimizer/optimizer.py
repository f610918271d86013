"""AdamW and Adafactor (port of ``paddle_tpu/optimizer/optimizer.py``:
``Adam``/``AdamW`` with the decoupled decay of ``Optimizer._get_fused``, and
``Adafactor``).

The rule is written out rather than taken from ``torch.optim.AdamW`` so
that it rounds where the reference rounds, which matters in bf16:

- the moments have the parameter's dtype (``zeros_like(p)``);
- the update is computed in fp32 with bias correction,
  ``m_hat = m / (1 - b1^t)``, ``v_hat = v / (1 - b2^t)``,
  ``p_new = cast(p - lr * m_hat / (sqrt(v_hat) + eps))``, and the moments
  are cast back to their dtype;
- the decoupled decay ``p_new - cast(lr * wd * p_old)`` is applied after the
  rule, in the parameter's dtype.

Adafactor (Shazeer & Stern 2018) is the JAX rule written out the same way:
second moments factored into per-row ``vr`` and per-column ``vc`` fp32
accumulators over the last two axes of a tensor of 2 or more dimensions
(a plain fp32 ``v`` otherwise), ``beta2_t = 1 - t^-decay_rate``, the rank-1
reconstruction ``vr vc^T / mean(vr)``, the update clipped by its RMS, and
the step scaled by the parameter's RMS; the update is computed in fp32 and
cast to the parameter's dtype. Its statistics (the clip's RMS, the
parameter scale, the factoring) are taken per parameter tensor, and the
port keeps one tensor per layer: the JAX package's scanned decoder stack
keeps one stacked tensor for all layers, so the two agree with the JAX
model built with ``scan_layers=False``.

Only a constant learning rate is ported; schedulers come later, and so do
gradient clipping and Adafactor's weight decay.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

__all__ = ["AdamW", "Adafactor"]


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


class Adafactor:
    """``parameters``: the tensors to update. Defaults are the JAX
    package's (``beta1`` 0: no first moment)."""

    def __init__(self, learning_rate=0.01, beta1=0.0, decay_rate=0.8,
                 epsilon1=1e-30, epsilon2=1e-3, clip_threshold=1.0,
                 multiply_by_parameter_scale=True,
                 parameters: Optional[Iterable] = None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._params = list(parameters)
        self._lr = float(learning_rate)
        self._b1 = float(beta1)
        self._decay = float(decay_rate)
        self._eps1, self._eps2 = float(epsilon1), float(epsilon2)
        self._clip = float(clip_threshold)
        self._pscale = bool(multiply_by_parameter_scale)
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    def _init_state(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            st = {"vr": torch.zeros(p.shape[:-1], **f32),
                  "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        else:
            st = {"v": torch.zeros(p.shape, **f32)}
        if self._b1 > 0.0:
            st["m"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self):
        t = self._global_step + 1
        beta2t = 1.0 - t ** (-self._decay)
        for p in self._params:
            if p.grad is None or not p.requires_grad:
                continue
            st = self._state.get(id(p))
            if st is None:
                st = self._state[id(p)] = self._init_state(p)
            g = p.grad.to(p.dtype).float()
            g2 = g * g + self._eps1
            if "v" in st:
                vhat = st["v"].mul_(beta2t).add_(g2, alpha=1.0 - beta2t)
            else:
                vr = st["vr"].mul_(beta2t).add_(g2.mean(dim=-1),
                                                alpha=1.0 - beta2t)
                vc = st["vc"].mul_(beta2t).add_(g2.mean(dim=-2),
                                                alpha=1.0 - beta2t)
                vhat = (vr / vr.mean(dim=-1, keepdim=True))[..., None] * \
                    vc[..., None, :]
            u = g / vhat.sqrt()
            u = u / (u.square().mean().sqrt() / self._clip).clamp_min(1.0)
            if "m" in st:
                m = st["m"].float() * self._b1 + u * (1.0 - self._b1)
                st["m"].copy_(m)
                u = m
            pf = p.float()
            if self._pscale:
                u = u * pf.square().mean().sqrt().clamp_min(self._eps2)
            p.copy_((pf - self._lr * u).to(p.dtype))
        self._global_step = t

    def clear_grad(self):
        for p in self._params:
            p.grad = None
