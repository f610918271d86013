"""Dynamic loss scaling (port of ``paddle_tpu/amp/grad_scaler.py``).

``GradScaler`` keeps the reference's state machine: ``scale(loss)``
multiplies the loss by the scale; ``step(optimizer)`` unscales the
gradients, skips the update where any is not finite and adjusts the scale
(halved after ``decr_every_n_nan_or_inf`` such steps in a row, doubled
after ``incr_every_n_steps`` finite ones). ``unscale_`` is Paddle's
``check_finite_and_unscale`` as two hand-written multi-tensor kernels
(``kernels/optimizer.py``: ``check_finite`` then ``unscale``): the check
tests ``g * (1 / scale)`` in fp32 into one device flag, the host reads it
(as the reference's ``bool(_all_finite(...))`` does), and only where every
value is finite does the unscale write ``cast(g * inv)`` into each gradient
in place; on overflow the gradients stay as they were (``:63-67``). It
takes bf16 and fp32 gradients and raises on any other dtype: no kernel of
the port takes fp16. CPU gradients take the kernels' plain versions.

A step that runs the state machine inside a CUDA graph
(``distributed.ShardedTrainStep(scaler=)``) takes the state onto the device
(:meth:`GradScaler.device_state`); from then on the scale, the good and bad
counts and the found-inf flag are those tensors, which every field reads
(a host read) and writes in place.
"""
from __future__ import annotations

import torch

from ..kernels import optimizer as _kopt

__all__ = ["GradScaler", "AmpScaler"]

_GRAD_DTYPES = (torch.float32, torch.bfloat16)


def _field(i: int, kind):
    """One field of the state: the host value, or where the state is on
    the device its tensor, read when used and filled in place when set."""

    def get(self):
        if self._dev is None:
            return self._host[i]
        return kind(self._dev[i].item())

    def put(self, v):
        v = kind(v)
        if self._dev is None:
            self._host[i] = v
        else:
            self._dev[i].fill_(float(v) if kind is float else int(v))

    return property(get, put)


class GradScaler:
    _scale = _field(0, float)
    _good_steps = _field(1, int)
    _bad_steps = _field(2, int)
    _found_inf = _field(3, bool)

    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._dev = None
        self._host = [1.0, 0, 0, False]
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def device_state(self, device) -> tuple:
        """The state on ``device``: (scale fp32 [1], good, bad, found int32
        [1]), made from the current state at the first call there. They
        stay the state: a captured graph that updates them and the host
        fields see one another's writes."""
        device = torch.device(device)
        d = self._dev
        if d is None or d[0].device.type != device.type:
            vals = (self._scale, self._good_steps, self._bad_steps,
                    self._found_inf)
            d = (torch.tensor([vals[0]], dtype=torch.float32, device=device),
                 *(torch.tensor([int(v)], dtype=torch.int32, device=device)
                   for v in vals[1:]))
            self._dev = d
        return d

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        return var * self._scale

    @staticmethod
    def _grads_batch(params):
        grads = [p.grad for p in params]
        for i, g in enumerate(grads):
            if g.dtype not in _GRAD_DTYPES:
                raise TypeError(f"GradScaler: the unscale kernels take "
                                f"float32 or bfloat16 gradients, got "
                                f"{g.dtype} (tensor {i})")
        n = len(params)
        return _kopt.StepBatch(params, grads, [[None] * n] * 3, [True] * n,
                               0.0, 1, rule="grads")

    def unscale_(self, optimizer):
        """Unscale the gradients of ``optimizer``'s parameters in place
        where all are finite; records whether some were not."""
        if not self._enable:
            self._found_inf = False
            return
        params = [p for p in optimizer._parameter_list
                  if p.requires_grad and p.grad is not None]
        if not params:
            self._found_inf = False
            return
        batch = self._grads_batch(params)
        inv = 1.0 / self._scale
        finite = not bool(_kopt.check_finite(batch, inv).item())
        self._found_inf = not finite
        if finite:
            _kopt.unscale(batch, inv)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update_scale()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        pass  # folded into step(), as the reference

    def _update_scale(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self) -> torch.Tensor:
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": float(self._scale), "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": int(self._good_steps),
                "bad_steps": int(self._bad_steps)}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)

    set_state_dict = load_state_dict


AmpScaler = GradScaler
