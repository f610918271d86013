"""Optimizers (port of ``paddle_tpu/optimizer/optimizer.py``: the
``Optimizer`` base, its eleven rules and ``make_master_update``).

As in the JAX package, ``step()`` applies the gradient clip, the weight
decay (coupled: ``g + wd * p`` before the rule, as ``Adam`` and
``Adafactor`` take it; decoupled: ``p_new - lr * wd * p_old`` after it,
``AdamW``) and the rule to every parameter that has a gradient at once:
the JAX package jits that as one function (``Optimizer._get_fused``);
here it is a few launches of the hand-written multi-tensor kernels of
``kernels/optimizer.py`` on CUDA (AdamW, SGD, Momentum, Adagrad, Adamax,
RMSProp, Adadelta, Lamb, LarsMomentum: one wrapper call; with a norm clip,
one more; Adafactor: two, with a norm clip three), and their plain
versions, the per-tensor loop, on the CPU. The learning rate (a float or an
``LRScheduler``) and the step number reach the kernels as device
scalars, never as kernel arguments.

The optimizer keeps the step's table (``kernels.optimizer.StepBatch``)
across steps: it is built again only when a tensor's address, shape or
dtype or a decay flag changes, and otherwise only its header (rate and
step) is written, one 24-byte copy. So a CUDA graph that captured a step
(``jit.TrainStep``) replays it with each step's rate and number.

Rounding follows the reference, which matters in bf16: every state has
the parameter's dtype (``zeros_like(p)``) but Adafactor's factors. Adam,
Lamb and LarsMomentum compute in fp32 and cast p and their state back;
the decoupled decay subtracts ``cast(lr * wd * p_old)`` from the cast
result. SGD, Momentum, Adagrad, Adamax, RMSProp and Adadelta compute each
operation in the parameter's dtype, their Python-float hyperparameters and
the rate constants of that dtype. The coupled decay ``g + wd * p`` (the
base path, ``weight_decay`` a float, an ``L2Decay`` or an ``L1Decay``,
whose coefficient the reference adds as the same coupled term) is taken
in the parameter's dtype; Lamb and LarsMomentum take theirs inside the
rule.

Adafactor (Shazeer & Stern 2018) factors the second moments of a tensor of
2 or more dimensions into per-row ``vr`` and per-column ``vc`` fp32
accumulators over its last two axes (a plain fp32 ``v`` otherwise), with
``beta2_t = 1 - t^-decay_rate``, the rank-1 reconstruction ``vr vc^T /
mean(vr)``, the update clipped by its RMS and the step scaled by the
parameter's RMS. Its statistics are per parameter tensor, and the port
keeps one tensor per layer: the JAX package's scanned decoder stack keeps
one stacked tensor for all layers, so the two agree with the JAX model
built with ``scan_layers=False``.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch

from ..kernels import optimizer as _kopt
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Lamb", "LarsMomentum", "Adafactor",
           "Adadelta", "make_master_update"]


def _wd_value(weight_decay) -> float:
    """The coupled decay's coefficient (``optimizer.py:204-209``): None is
    0; a regularizer (``L2Decay``, and ``L1Decay`` as well) gives its
    ``_coeff``; anything else is a float."""
    if weight_decay is None:
        return 0.0
    if hasattr(weight_decay, "_coeff"):
        return float(weight_decay._coeff)
    return float(weight_decay)


class Optimizer:
    """``parameters``: the tensors to update, or ``(name, tensor)`` pairs
    (``model.named_parameters()``), which ``apply_decay_param_fun(name)``
    needs (True where the decay applies) and which name the state in
    :meth:`state_dict` (by index otherwise). ``learning_rate``: a float or
    an ``LRScheduler``; ``grad_clip``: one of ``nn.ClipGradBy*``."""

    _rule = "adam"

    def __init__(self, learning_rate=0.001, parameters: Optional[Iterable] = None,
                 weight_decay=None, grad_clip=None,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        items = list(parameters)
        named = bool(items) and isinstance(items[0], tuple)
        if apply_decay_param_fun is not None and not named:
            raise ValueError("apply_decay_param_fun needs parameter names: "
                             "pass parameters=model.named_parameters()")
        self._parameter_list = [p for _, p in items] if named else items
        self._named = named
        self._names = [n for n, _ in items] if named else \
            [f"param_{i}" for i in range(len(items))]
        self._decay = [apply_decay_param_fun is None
                       or bool(apply_decay_param_fun(n)) for n in self._names]
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = _wd_value(weight_decay)
        self._weight_decay_arg = weight_decay  # as given (None: unset)
        self._decoupled = False  # AdamW
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_dev = None  # the update count, once held on the device
        self._step_host = 0
        self._batch = None      # the last step's StepBatch, kept across steps
        self._batch_key = None  # what it was built from
        self._reserved = None   # the table buffer of the next captured step

    # -- the update count ----------------------------------------------------
    @property
    def _global_step(self) -> int:
        """The updates applied: a host int, or once a step keeps the count
        on the device (:meth:`device_updates`) that tensor, read when
        used."""
        if self._step_dev is None:
            return self._step_host
        return int(self._step_dev.item())

    @_global_step.setter
    def _global_step(self, v):
        if self._step_dev is None:
            self._step_host = int(v)
        else:
            self._step_dev.fill_(int(v))

    def device_updates(self, device) -> torch.Tensor:
        """The update count as an int32 [1] tensor on ``device``, made from
        the current count at the first call there; from then on it is the
        count, which a captured step advances on the device (the in-graph
        GradScaler's, whose skipped steps do not count)."""
        device = torch.device(device)
        d = self._step_dev
        if d is None or d.device.type != device.type:
            d = torch.tensor([self._global_step], dtype=torch.int32,
                             device=device)
            self._step_dev = d
        return d

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate.get_lr())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr cannot override an LRScheduler")
        self._learning_rate = float(value)

    # -- the rule (subclasses) -------------------------------------------------
    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _slots(self, st: Dict[str, torch.Tensor]) -> List[Optional[torch.Tensor]]:
        """The state tensors in the kernels' slot order."""
        raise NotImplementedError

    def _update(self, batch, clip, norms):
        raise NotImplementedError

    # -- step ----------------------------------------------------------------
    def step(self):
        """One update of every parameter with a gradient (and
        ``requires_grad``), as ``optimizer.py:79-107``."""
        self._apply()
        self._global_step += 1

    def _state_slots(self, params):
        """The kernels' three state slot lists over ``params``, creating
        the state of a parameter that has none."""
        states = []
        for p in params:
            st = self._state.get(id(p))
            if st is None:
                st = self._state[id(p)] = self._init_state(p)
            states.append(self._slots(st))
        return [list(s) for s in zip(*states)]

    def _reserve_table(self):
        """Before a CUDA graph capture: create the state of every trainable
        parameter that has none (a step inside the capture must not: each
        replay would zero it again), and allocate the device table of a
        step over all of them (each gets a gradient in a captured step),
        which the capture's step then takes (``StepBatch.reserve``): its
        length depends on the shapes alone."""
        live = [i for i, p in enumerate(self._parameter_list)
                if p.requires_grad]
        if not live:
            self._reserved = None
            return
        params = [self._parameter_list[i] for i in live]
        shape_only = _kopt.StepBatch(params, params, self._state_slots(params),
                                     [self._decay[i] for i in live], 0.0, 1,
                                     rule=self._rule)
        self._reserved = torch.empty(shape_only.words(), dtype=torch.int64,
                                     device=params[0].device)

    @torch.no_grad()
    def _apply(self, grads: Optional[List[Optional[torch.Tensor]]] = None,
               clip: Optional[Callable] = None, device_step=None,
               split=None):
        """The update of step ``_global_step + 1`` without advancing the
        step: the parameters with a gradient (``grads``, one entry per
        parameter or None, else each ``.grad``) and ``requires_grad``.
        ``clip(batch)`` gives the update's (clip, norms) in place of
        :meth:`_clip` (a caller whose tensors are shards of larger ones
        reduces their norms).
        Returns the :class:`~paddle_tpu_torch.kernels.optimizer.StepBatch`
        it ran (None where no parameter had a gradient). Inside a CUDA
        graph capture the batch is always new and is not kept: the graph
        owns it, and writes its header before each replay; its table takes
        the buffer of :meth:`_reserve_table`. The kept batch stays the
        optimizer's, for the eager steps. ``device_step`` ``(count,
        skip)``, int32 [1] device tensors, gives the step number (count +
        1) and a skip flag from the device
        (``StepBatch.bind_device_step``): the in-graph GradScaler's.
        ``split`` (a ``kernels.optimizer.TensorSplits``): the parameters
        are shards, and the rules that take statistics over a whole tensor
        sum them over the ranks that hold its other shards."""
        plist = self._parameter_list
        if grads is None:
            grads = [p.grad for p in plist]
        live = [i for i, p in enumerate(plist)
                if p.requires_grad and grads[i] is not None]
        if not live:
            return None
        params = [plist[i] for i in live]
        gs = [grads[i] for i in live]
        slots = self._state_slots(params)
        decay = [self._decay[i] for i in live]
        # a device step count is read on the device: no host read here
        lr = self.get_lr()
        step = 1 if device_step is not None else self._global_step + 1
        capturing = params[0].is_cuda and \
            torch.cuda.is_current_stream_capturing()
        key = (tuple(decay),) + tuple(
            None if t is None else (t.data_ptr(), t.dtype, t.shape,
                                    t.stride())
            for t in params + gs + [t for s in slots for t in s])
        batch = self._batch
        if batch is not None and key == self._batch_key and not capturing:
            batch.grads = gs
            batch.set_step(lr, step)
        else:
            batch = _kopt.StepBatch(params, gs, slots, decay, lr, step,
                                    rule=self._rule)
            if capturing:
                batch.reserve(self._reserved)
                self._reserved = None
            else:
                self._batch, self._batch_key = batch, key
        batch.device_step = None
        batch.split = split
        if device_step is not None:
            batch.bind_device_step(*device_step)
        self._update(batch, *(clip or self._clip)(batch))
        batch.grads = None  # the step's gradients are not kept alive
        return batch

    def _clip(self, batch):
        """(clip, norms) for the update: the norm clips' sums of squares and
        scales come from one ``multi_tensor_sumsq`` pass."""
        c = self._grad_clip
        if c is None:
            return ("none",), None
        spec = c._spec()
        if spec[0] == "value":
            return spec, None
        return ("scale",), _kopt.multi_tensor_sumsq(batch, spec[1], spec[2])

    def clear_grad(self, set_to_zero: bool = False):
        """Clear every parameter's gradient: with ``set_to_zero`` it is
        zeroed in place (its storage kept), otherwise set to None. The
        JAX package accepts ``set_to_zero`` and ignores it
        (``optimizer.py:149-151``: its gradients are always dropped)."""
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Dygraph ``minimize``: one :meth:`step` from the gradients that
        ``loss.backward()`` left, as ``optimizer.py:155-165`` outside static
        mode; returns ``(None, None)``."""
        self.step()
        return None, None

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """``global_step``, ``LR_Scheduler`` (a scheduler's state) and
        ``{name}_{key}`` for every state tensor (a copy), as
        ``optimizer.py:168-177``."""
        sd: Dict[str, object] = {"global_step": int(self._global_step)}
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        for name, p in zip(self._names, self._parameter_list):
            for k, v in self._state.get(id(p), {}).items():
                sd[f"{name}_{k}"] = v.detach().clone()
        return sd

    def set_state_dict(self, state_dict):
        self._global_step = int(state_dict.get("global_step", 0))
        if isinstance(self._learning_rate, LRScheduler) and \
                "LR_Scheduler" in state_dict:
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for name, p in zip(self._names, self._parameter_list):
            proto = self._init_state(p)
            for k, v in proto.items():
                saved = state_dict.get(f"{name}_{k}")
                if saved is not None:
                    v.copy_(torch.as_tensor(saved).to(v.device, v.dtype)
                            .reshape(v.shape))
            if proto:
                self._state[id(p)] = proto


class Adam(Optimizer):
    """Adam with the coupled decay of the base path: ``g + wd * p`` before
    the rule (``optimizer.py:133-134``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters: Optional[Iterable] = None,
                 weight_decay=None, grad_clip=None,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         apply_decay_param_fun)
        self._b1, self._b2, self._eps = (float(beta1), float(beta2),
                                         float(epsilon))

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}

    def _slots(self, st):
        return [st["moment1"], st["moment2"], None]

    def _update(self, batch, clip, norms):
        _kopt.adam_update(batch, beta1=self._b1, beta2=self._b2,
                          epsilon=self._eps, weight_decay=self._weight_decay,
                          decoupled=self._decoupled, clip=clip, norms=norms)


class AdamW(Adam):
    """Adam with the decoupled decay ``p_new - cast(lr * wd * p_old)``,
    applied where ``apply_decay_param_fun(name)`` is True (every tensor
    without one)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters: Optional[Iterable] = None,
                 weight_decay=0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, apply_decay_param_fun)
        self._decoupled = True


class Adafactor(Optimizer):
    """Defaults are the JAX package's (``beta1`` 0: no first moment); the
    weight decay is the base path's, coupled."""

    _rule = "adafactor"

    def __init__(self, learning_rate=0.01, beta1=0.0, decay_rate=0.8,
                 epsilon1=1e-30, epsilon2=1e-3, clip_threshold=1.0,
                 multiply_by_parameter_scale=True,
                 parameters: Optional[Iterable] = None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._b1 = float(beta1)
        self._decay_rate = float(decay_rate)
        self._eps1, self._eps2 = float(epsilon1), float(epsilon2)
        self._clip_threshold = float(clip_threshold)
        self._pscale = bool(multiply_by_parameter_scale)

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

    def _slots(self, st):
        return [st["vr"] if "vr" in st else st["v"], st.get("vc"),
                st.get("m")]

    def _update(self, batch, clip, norms):
        wd = self._weight_decay
        stats = _kopt.adafactor_stats(
            batch, decay_rate=self._decay_rate, epsilon1=self._eps1,
            weight_decay=wd, pscale=self._pscale, clip=clip, norms=norms)
        _kopt.adafactor_update(
            batch, stats, beta1=self._b1, epsilon2=self._eps2,
            clip_threshold=self._clip_threshold, pscale=self._pscale,
            weight_decay=wd, clip=clip, norms=norms)


class SGD(Optimizer):
    """``p - lr g`` (``optimizer.py:212-215``), in the parameter's dtype."""

    _rule = "sgd"

    def __init__(self, learning_rate=0.001,
                 parameters: Optional[Iterable] = None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _slots(self, st):
        return [None, None, None]

    def _update(self, batch, clip, norms):
        _kopt.sgd_update(batch, weight_decay=self._weight_decay, clip=clip,
                         norms=norms)


class Momentum(Optimizer):
    """``v = mu v + g``; ``p - lr v``, or with ``use_nesterov`` ``p - lr (g
    + mu v)`` (``optimizer.py:218-235``); state ``velocity``."""

    _rule = "momentum"

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 parameters: Optional[Iterable] = None, use_nesterov=False,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _slots(self, st):
        return [st["velocity"], None, None]

    def _update(self, batch, clip, norms):
        _kopt.momentum_update(batch, momentum=self._momentum,
                              nesterov=self._nesterov,
                              weight_decay=self._weight_decay, clip=clip,
                              norms=norms)


class Adagrad(Optimizer):
    """``m += g g``; ``p - lr g / (sqrt(m) + eps)`` (``optimizer.py:
    238-250``); state ``moment``, filled with ``initial_accumulator_value``
    in the parameter's dtype."""

    _rule = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 parameters: Optional[Iterable] = None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = float(epsilon)
        self._init = float(initial_accumulator_value)

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init)}

    def _slots(self, st):
        return [st["moment"], None, None]

    def _update(self, batch, clip, norms):
        _kopt.adagrad_update(batch, epsilon=self._eps,
                             weight_decay=self._weight_decay, clip=clip,
                             norms=norms)


class Adamax(Optimizer):
    """Adam with the infinity norm (``optimizer.py:291-307``); state
    ``moment``, ``inf_norm``."""

    _rule = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters: Optional[Iterable] = None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._b1, self._b2, self._eps = (float(beta1), float(beta2),
                                         float(epsilon))

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p)}

    def _slots(self, st):
        return [st["moment"], st["inf_norm"], None]

    def _update(self, batch, clip, norms):
        _kopt.adamax_update(batch, beta1=self._b1, beta2=self._b2,
                            epsilon=self._eps,
                            weight_decay=self._weight_decay, clip=clip,
                            norms=norms)


class RMSProp(Optimizer):
    """RMSProp (``optimizer.py:310-332``), ``centered`` or not, with
    ``momentum``; state ``mean_square``, ``mean_grad`` (kept at zero unless
    centered), ``velocity``."""

    _rule = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters: Optional[Iterable] = None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps = float(rho), float(epsilon)
        self._momentum = float(momentum)
        self._centered = bool(centered)

    def _init_state(self, p):
        return {"mean_square": torch.zeros_like(p),
                "mean_grad": torch.zeros_like(p),
                "velocity": torch.zeros_like(p)}

    def _slots(self, st):
        return [st["mean_square"], st["mean_grad"], st["velocity"]]

    def _update(self, batch, clip, norms):
        _kopt.rmsprop_update(batch, rho=self._rho, epsilon=self._eps,
                             momentum=self._momentum,
                             centered=self._centered,
                             weight_decay=self._weight_decay, clip=clip,
                             norms=norms)


class Lamb(Optimizer):
    """Lamb (``optimizer.py:335-366``): Adam's moments, the update ``r``
    with the decay ``lamb_weight_decay * p`` inside, scaled by the trust
    ratio ``|p| / |r|`` per tensor, in fp32. ``exclude_from_weight_decay_fn
    (param)`` True excludes a tensor from the decay. State ``moment1``,
    ``moment2``."""

    _rule = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 parameters: Optional[Iterable] = None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._b1, self._b2, self._eps = (float(beta1), float(beta2),
                                         float(epsilon))
        self._lamb_wd = float(lamb_weight_decay)
        if exclude_from_weight_decay_fn is not None:
            self._decay = [not exclude_from_weight_decay_fn(p)
                           for p in self._parameter_list]

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}

    def _slots(self, st):
        return [st["moment1"], st["moment2"], None]

    def _update(self, batch, clip, norms):
        _kopt.lamb_update(batch, beta1=self._b1, beta2=self._b2,
                          epsilon=self._eps, weight_decay=self._lamb_wd,
                          clip=clip, norms=norms)


class LarsMomentum(Optimizer):
    """LARS (``optimizer.py:369-407``): ``local_lr = lr lars_coeff |p| /
    (|g| + lars_weight_decay |p| + epsilon)`` per tensor, ``v = mu v +
    local_lr (g + wd p)``, ``p - v``, in fp32. ``exclude_from_weight_decay``:
    name fragments; a tensor whose name holds one gets no decay (which
    needs ``parameters=model.named_parameters()``). State ``velocity``."""

    _rule = "lars"

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005,
                 parameters: Optional[Iterable] = None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum, self._coeff = float(momentum), float(lars_coeff)
        self._lars_wd, self._eps = float(lars_weight_decay), float(epsilon)
        if exclude_from_weight_decay:
            if not self._named:
                raise ValueError("exclude_from_weight_decay needs parameter "
                                 "names: pass parameters="
                                 "model.named_parameters()")
            fragments = list(exclude_from_weight_decay)
            self._decay = [not any(f in n for f in fragments)
                           for n in self._names]

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _slots(self, st):
        return [st["velocity"], None, None]

    def _update(self, batch, clip, norms):
        _kopt.lars_update(batch, momentum=self._momentum,
                          lars_coeff=self._coeff,
                          weight_decay=self._lars_wd, epsilon=self._eps,
                          clip=clip, norms=norms)


class Adadelta(Optimizer):
    """Adadelta (``optimizer.py:476-498``): rho-averaged squared gradients
    and squared updates; state ``avg_squared_grad``,
    ``avg_squared_update``."""

    _rule = "adadelta"

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters: Optional[Iterable] = None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps = float(rho), float(epsilon)

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _slots(self, st):
        return [st["avg_squared_grad"], st["avg_squared_update"], None]

    def _update(self, batch, clip, norms):
        _kopt.adadelta_update(batch, rho=self._rho, epsilon=self._eps,
                              weight_decay=self._weight_decay, clip=clip,
                              norms=norms)


def make_master_update(opt: Optimizer, train_params, dtypes,
                       with_clip: bool = True):
    """The fp32-master update (``optimizer.py:501-540``): returns
    ``update(master, grads, states, lr, step_no) -> (new_master,
    new_states, new_params)``, ``opt``'s rule, coupled or decoupled decay
    and (``with_clip``) clip over fp32 ``master`` tensors, one per tensor of
    ``train_params`` (which must be ``opt``'s parameters: their decay flags
    are ``opt``'s), with ``states`` one state dict per tensor as
    ``opt._init_state(master)`` makes them (fp32), ``grads`` of any float
    dtype (cast to fp32 first, as the reference casts them), ``lr`` and
    ``step_no`` the rate and the 1-based step. ``new_params`` are the new
    masters cast to ``dtypes``.

    Unlike the JAX function, which returns new arrays, ``update`` writes
    the masters and the states in place and returns those same tensors:
    on CUDA ``opt``'s kernels run over them (fp32 parameters, fp32 state,
    fp32 gradients), on the CPU their plain versions. ``update(...,
    clip=, norms=, split=)`` takes a clip already reckoned over a larger
    set of tensors (``norms`` this subset's rows of its
    ``multi_tensor_sumsq``, as the offloaded step's walk passes them per
    group) and the ``TensorSplits`` of tensors that are shards."""
    index = {id(p): i for i, p in enumerate(opt._parameter_list)}
    missing = [k for k, p in enumerate(train_params) if id(p) not in index]
    if missing:
        raise ValueError(f"make_master_update: train_params {missing} are "
                         f"not parameters of the optimizer")
    decay = [opt._decay[index[id(p)]] for p in train_params]
    dtypes = list(dtypes)

    def update(master, grads, states, lr, step_no, clip=None, norms=None,
               split=None):
        master = list(master)
        per = [opt._slots(st) for st in states]
        slots = [[s[j] for s in per] for j in range(3)]
        batch = _kopt.StepBatch(master, [g.float() for g in grads], slots,
                                decay, float(lr), int(step_no),
                                rule=opt._rule)
        batch.split = split
        if clip is None:
            clip, norms = opt._clip(batch) if with_clip else (("none",),
                                                               None)
        opt._update(batch, clip, norms)
        return master, states, [m.to(dt) for m, dt in zip(master, dtypes)]

    return update
