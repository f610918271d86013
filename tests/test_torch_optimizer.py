"""The port's optimizer module against the JAX package's.

LR schedules, gradient clips, the steps of all eleven optimizers (the
plain versions of the fused kernels, which a CPU tensor takes), the
optimizer state and ``TrainStep`` loss curves. Inputs are drawn with
numpy and handed to both packages; the JAX package runs on its CPU
backend, in fp32, and in bf16 op by op (``jax.disable_jit()``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models import llama as jllama
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn.layer.layers import Parameter as JParameter
from paddle_tpu_torch import kernels, resolve_device
from paddle_tpu_torch import regularizer as preg
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import optimizer as kopt
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_state_from_numpy)
from paddle_tpu_torch.optimizer import (SGD, Adadelta, Adafactor, Adagrad,
                                        Adam, Adamax, AdamW, Lamb,
                                        LarsMomentum, Momentum, RMSProp)
from paddle_tpu_torch.optimizer import lr as plr

# -- LR schedules ---------------------------------------------------------------

# (name, required arguments, one setting of the optional ones); a value
# "sched" stands for a nested schedule built by each package
SCHEDULES = [
    ("NoamDecay", dict(d_model=64, warmup_steps=10),
     dict(learning_rate=2.0, last_epoch=3)),
    ("PiecewiseDecay", dict(boundaries=[5, 20], values=[0.1, 0.05, 0.01]),
     dict(last_epoch=6)),
    ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.1),
     dict(last_epoch=2)),
    ("InverseTimeDecay", dict(learning_rate=0.5, gamma=0.2),
     dict(last_epoch=5)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=15),
     dict(end_lr=0.01, power=2.0, cycle=True)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=10, start_lr=0.0,
                          end_lr=0.1),
     dict(learning_rate="sched")),
    ("ExponentialDecay", dict(learning_rate=0.5, gamma=0.9),
     dict(last_epoch=4)),
    ("MultiStepDecay", dict(learning_rate=0.5, milestones=[5, 15]),
     dict(gamma=0.5)),
    ("StepDecay", dict(learning_rate=0.5, step_size=7), dict(gamma=0.3)),
    ("LambdaDecay", dict(learning_rate=0.5, lr_lambda=lambda e: 0.95 ** e),
     dict(lr_lambda=lambda e: 1.0 / (1.0 + e))),
    ("CosineAnnealingDecay", dict(learning_rate=0.5, T_max=20),
     dict(eta_min=0.01)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.5, T_0=5),
     dict(T_mult=2, eta_min=0.05)),
    ("ReduceOnPlateau", dict(learning_rate=0.5),
     dict(mode="max", factor=0.5, patience=2, threshold_mode="abs",
          cooldown=1, min_lr=0.01)),
    ("OneCycleLR", dict(max_learning_rate=1.0, total_steps=40),
     dict(divide_factor=10.0, end_learning_rate=0.001, phase_pct=0.5,
          anneal_strategy="linear")),
    ("CyclicLR", dict(base_learning_rate=0.1, max_learning_rate=1.0,
                      step_size_up=5),
     dict(step_size_down=3, mode="exp_range", exp_gamma=0.9)),
]
STEPS = 40


def _schedule(mod, name, kw):
    kw = dict(kw)
    if kw.get("learning_rate") == "sched":
        kw["learning_rate"] = mod.CosineAnnealingDecay(0.1, T_max=12)
    return getattr(mod, name)(**kw)


def _metrics(mode):
    """A seeded metric for ReduceOnPlateau that improves, then stalls."""
    rng = np.random.default_rng(5)
    x = np.maximum(1.0 - 0.05 * np.arange(STEPS), 0.4) + \
        1e-3 * rng.standard_normal(STEPS)
    return (x if mode == "min" else -x).tolist()


def _run(sched, steps, metrics=None, start=0):
    out = []
    for i in range(start, start + steps):
        if metrics is None:
            sched.step()
        else:
            sched.step(metrics[i])
        out.append(sched.last_lr)
    return out


def test_every_schedule_is_ported():
    assert len(SCHEDULES) == 15
    assert sorted(n for n, _, _ in SCHEDULES) == sorted(
        n for n in plr.__all__ if n != "LRScheduler")


@pytest.mark.parametrize("setting", ["default", "non_default"])
@pytest.mark.parametrize("name,required,optional", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(name, required, optional, setting):
    """40 steps of each schedule give the JAX schedule's floats exactly,
    and a schedule restored from its ``state_dict`` after 20 steps goes on
    as the uninterrupted one."""
    kw = {**required, **(optional if setting == "non_default" else {})}
    metrics = _metrics(kw.get("mode", "min")) \
        if name == "ReduceOnPlateau" else None
    ref_s = _schedule(jopt.lr, name, kw)
    got_s = _schedule(plr, name, kw)
    assert got_s.last_lr == ref_s.last_lr
    ref = _run(ref_s, STEPS, metrics)
    got = _run(got_s, STEPS, metrics)
    assert got == ref
    if name == "ReduceOnPlateau":
        assert len(set(got)) > 1  # the metric made it reduce
    first = _schedule(plr, name, kw)
    head = _run(first, STEPS // 2, metrics)
    second = _schedule(plr, name, kw)
    second.set_state_dict(first.state_dict())
    tail = _run(second, STEPS // 2, metrics, start=STEPS // 2)
    assert head + tail == got


# -- optimizer steps against the JAX Optimizer.step / _get_fused ------------------

# (name, shape, grad?, trainable?): odd sizes, 1-, 2- and 3-D, one element,
# one tensor without a gradient and one that is not trainable
TENSORS = [("w2d", (5, 3), True, True), ("b1d", (7,), True, True),
           ("w3d", (2, 3, 5), True, True), ("nograd", (4,), False, True),
           ("frozen", (3, 6), True, False), ("norm.w", (6,), True, True),
           ("one", (1,), True, True), ("wide", (3, 17), True, True)]
CLIPS = {"none": None, "value": ("ClipGradByValue", (0.5,)),
         "norm": ("ClipGradByNorm", (1.0,)),
         "global": ("ClipGradByGlobalNorm", (1.0,))}
RULES = {
    "adam": (Adam, jopt.Adam, dict(learning_rate=None, weight_decay=0.01)),
    "adamw": (AdamW, jopt.AdamW, dict(learning_rate=None, weight_decay=0.1,
                                      apply_decay_param_fun="no_norm")),
    "adafactor_b0": (Adafactor, jopt.Adafactor,
                     dict(learning_rate=None, beta1=0.0)),
    "adafactor_b05": (Adafactor, jopt.Adafactor,
                      dict(learning_rate=None, beta1=0.5)),
    # the eight other rules, with settings off their defaults: an L2Decay
    # (and an L1Decay, which the reference adds as the same coupled term)
    # as the base path's decay, Nesterov, centered RMSProp with momentum,
    # Adagrad's initial accumulator, Lamb's exclude function (on rank, which
    # both packages' parameters have) and LARS's name fragments
    "sgd": (SGD, jopt.SGD, dict(learning_rate=None, weight_decay="L2Decay")),
    "momentum": (Momentum, jopt.Momentum,
                 dict(learning_rate=None, momentum=0.8, use_nesterov=True,
                      weight_decay=0.01)),
    "momentum_l1": (Momentum, jopt.Momentum,
                    dict(learning_rate=None, weight_decay="L1Decay")),
    "adagrad": (Adagrad, jopt.Adagrad,
                dict(learning_rate=None, epsilon=1e-5,
                     initial_accumulator_value=0.1)),
    "adamax": (Adamax, jopt.Adamax,
               dict(learning_rate=None, beta1=0.8, beta2=0.99, epsilon=1e-6,
                    weight_decay=0.01)),
    "rmsprop": (RMSProp, jopt.RMSProp,
                dict(learning_rate=None, rho=0.9, epsilon=1e-5, momentum=0.5,
                     centered=True)),
    "rmsprop_plain": (RMSProp, jopt.RMSProp, dict(learning_rate=None)),
    "adadelta": (Adadelta, jopt.Adadelta,
                 dict(learning_rate=None, epsilon=1e-5, rho=0.9,
                      weight_decay="L2Decay")),
    "lamb": (Lamb, jopt.Lamb,
             dict(learning_rate=None, lamb_weight_decay=0.02, beta1=0.8,
                  exclude_from_weight_decay_fn="rank1")),
    "lars": (LarsMomentum, jopt.LarsMomentum,
             dict(learning_rate=None, momentum=0.8, lars_coeff=0.01,
                  lars_weight_decay=0.001, exclude_from_weight_decay=["norm"],
                  epsilon=1e-6)),
}
NEW_RULES = ["sgd", "momentum", "momentum_l1", "adagrad", "adamax",
             "rmsprop", "rmsprop_plain", "adadelta", "lamb", "lars"]
# fp32: the rules differ from the JAX package's only in summation order,
# where XLA fuses, and in the last bit of a power (XLA's fp32 pow and the
# C library's disagree at a few steps); Lamb's and LARS's per-tensor norms
# are sums the reference takes in fp32 in XLA's order (the port in fp64)
RTOL = {"adam": 1e-6, "adamw": 1e-6, "adafactor_b0": 1e-5,
        "adafactor_b05": 1e-5, "adafactor_wd": 1e-5,
        **{r: 1e-6 for r in NEW_RULES}, "lamb": 1e-5, "lars": 1e-5}
# each rule's rate: updates of about 1e-3 to 1e-2 of the parameters
LR = {"adafactor_b0": 1e-2, "adafactor_b05": 1e-2, "adafactor_wd": 1e-2,
      "adadelta": 1.0, **{r: 1e-2 for r in NEW_RULES if r != "adadelta"}}


def _inputs(seed=7, steps=3):
    """Parameters of magnitude 0.5-1.5 (so rtol means something) with
    random signs, and each step's gradients."""
    rng = np.random.default_rng(seed)
    params = {n: (rng.choice([-1.0, 1.0], size=s) *
                  rng.uniform(0.5, 1.5, size=s)).astype(np.float32)
              for n, s, _, _ in TENSORS}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s, has, _ in TENSORS if has} for _ in range(steps)]
    return params, grads


def _lr(mod, lr):
    return mod.LinearWarmup(learning_rate=lr, warmup_steps=2,
                            start_lr=lr / 4, end_lr=lr)


def _make(rule, clip, pkg, params, lr, bf16=False):
    """The optimizer of ``pkg`` ("jax" or "port") over fresh parameters
    holding ``params`` (rounded to bf16 with ``bf16``); returns
    (optimizer, {name: parameter}, schedule)."""
    port_cls, jax_cls, kw = RULES["adafactor_b05" if rule == "adafactor_wd"
                                  else rule]
    kw = dict(kw)
    if rule == "adafactor_wd":
        kw["weight_decay"] = 0.01
    sched = _lr(jopt.lr if pkg == "jax" else plr, lr)
    kw["learning_rate"] = sched
    if clip is not None:
        kw["grad_clip"] = getattr(jnn if pkg == "jax" else pnn,
                                  clip[0])(*clip[1])
    fn = kw.pop("apply_decay_param_fun", None)
    decay = (lambda name: "norm" not in name) if fn else None
    if isinstance(kw.get("weight_decay"), str):
        kw["weight_decay"] = getattr(jreg if pkg == "jax" else preg,
                                     kw["weight_decay"])(0.01)
    if kw.get("exclude_from_weight_decay_fn") == "rank1":
        kw["exclude_from_weight_decay_fn"] = lambda p: p.ndim == 1
    if pkg == "jax":
        ps = {n: JParameter(jnp.asarray(params[n]).astype(
                  jnp.bfloat16 if bf16 else jnp.float32), name=n,
                  trainable=tr)
              for n, _, _, tr in TENSORS}
        if decay:
            kw["apply_decay_param_fun"] = decay
        opt = jax_cls(parameters=list(ps.values()), **kw)
    else:
        ps = {n: torch.nn.Parameter(torch.from_numpy(params[n].copy()).to(
                  torch.bfloat16 if bf16 else torch.float32),
                                    requires_grad=tr)
              for n, _, _, tr in TENSORS}
        if decay:
            kw["apply_decay_param_fun"] = decay
        opt = port_cls(parameters=list(ps.items()), **kw)
    return opt, ps, sched


def _step(pkg, opt, ps, grads, sched):
    """One step from the fp32 ``grads``, each cast to its parameter's
    dtype."""
    for n, g in grads.items():
        if pkg == "jax":
            ps[n].grad = JTensor(jnp.asarray(g).astype(ps[n].data.dtype))
        else:
            ps[n].grad = torch.from_numpy(g.copy()).to(ps[n].dtype)
    opt.step()
    opt.clear_grad()
    sched.step()


def _state_of(pkg, opt, p):
    if pkg == "jax":
        return {k: np.asarray(v) for k, v in opt._accumulators[id(p)].items()}
    return {k: v.numpy() for k, v in opt._state[id(p)].items()}


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("rule", ["adam", "adamw", "adafactor_b0",
                                  "adafactor_b05", "adafactor_wd"] +
                         NEW_RULES)
def test_optimizer_step_matches_jax(rule, clip):
    """Three steps of the port's ``Optimizer.step`` (the fused kernels'
    plain versions) against the JAX ``Optimizer.step``, with an
    ``LRScheduler`` for the rate: every parameter and state tensor within
    rtol 1e-6 (Adam, AdamW and the six rules computed in the parameter's
    dtype) or 1e-5 (Adafactor, Lamb, LARS), state tensors also within
    that rtol of their largest element; the tensor without a gradient and
    the frozen one keep their values and get no state."""
    params, grads = _inputs()
    lr = LR.get(rule, 1e-3)
    jo, jps, jsched = _make(rule, CLIPS[clip], "jax", params, lr)
    po, pps, psched = _make(rule, CLIPS[clip], "port", params, lr)
    for g in grads:
        _step("jax", jo, jps, g, jsched)
        _step("port", po, pps, g, psched)
    rtol = RTOL[rule]
    for name, _, has, trainable in TENSORS:
        got = pps[name].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jps[name].data), rtol=rtol,
                                   err_msg=name)
        if not (has and trainable):
            np.testing.assert_array_equal(got, params[name])
            assert id(pps[name]) not in po._state
            continue
        ref_st = _state_of("jax", jo, jps[name])
        got_st = _state_of("port", po, pps[name])
        assert set(got_st) == set(ref_st)
        for k in ref_st:
            # a moment is a sum that cancels (0.9 m + 0.1 g): its elements
            # are held to rtol of the tensor's largest one as well
            np.testing.assert_allclose(
                got_st[k], ref_st[k], rtol=rtol,
                atol=rtol * np.abs(ref_st[k]).max(), err_msg=f"{name} {k}")
    assert po._global_step == jo._global_step == len(grads)


def _bf16_ulps(a, b):
    """|a - b| of two bf16 arrays (as fp32) in bf16 ulps of the larger."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    top = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(top, 2.0 ** -126))) - 7)
    return np.abs(a - b) / ulp


# bf16 against the JAX step run op by op: the six rules computed in the
# parameter's dtype equal it in every bit (0 ulps), and so does Adam with
# its coupled decay (the decay's constant rounded to bf16 as the
# reference's weakly typed float); Lamb and LARS, which scale by
# whole-tensor norms that the reference sums in fp32 in XLA's order,
# within 1 ulp
BF16_ULPS = {**{r: 0 for r in NEW_RULES}, "adam": 0, "lamb": 1, "lars": 1}


@pytest.mark.parametrize("rule", ["adam"] + NEW_RULES)
def test_bf16_step_matches_jax_op_by_op(rule):
    """Three steps of the port's ``Optimizer.step`` over bf16 parameters
    and gradients against the JAX ``Optimizer.step`` run op by op
    (``jax.disable_jit()``: XLA's CPU compiler keeps excess precision
    across fused bf16 operations and contracts into FMAs), with an
    ``LRScheduler`` for the rate: every parameter and state tensor within
    ``BF16_ULPS`` of the reference (bf16 ulps of the larger value)."""
    params, grads = _inputs()
    lr = LR.get(rule, 1e-3)
    jo, jps, jsched = _make(rule, None, "jax", params, lr, bf16=True)
    po, pps, psched = _make(rule, None, "port", params, lr, bf16=True)
    with jax.disable_jit():
        for g in grads:
            _step("jax", jo, jps, g, jsched)
    for g in grads:
        _step("port", po, pps, g, psched)
    worst = 0.0
    for name, _, has, trainable in TENSORS:
        pairs = [(name, pps[name].detach(), jps[name].data)]
        if has and trainable:
            ref_st = _state_of("jax", jo, jps[name])
            got_st = po._state[id(pps[name])]
            assert set(got_st) == set(ref_st)
            pairs += [(f"{name} {k}", got_st[k], ref_st[k]) for k in ref_st]
        for what, got, ref in pairs:
            assert got.dtype == torch.bfloat16, what
            ulps = _bf16_ulps(got.float().numpy(),
                              np.asarray(ref.astype(jnp.float32)))
            worst = max(worst, float(ulps.max()))
            assert ulps.max() <= BF16_ULPS[rule], (what, ulps.max())
    print(f"{rule}: largest distance {worst} bf16 ulps")


@pytest.mark.parametrize("rule", ["adam", "adamw"])
def test_adam_update_and_moments_match_jax_over_1000_steps(rule):
    """1000 steps at beta2 0.999 of the port's ``Adam``/``AdamW`` against
    the JAX package's updater (``make_param_updater`` over ``Adam._rule``,
    the decays of its fused step; run op by op, as the rule is written:
    XLA's CPU compiler contracts ``b2 * v + x`` into one fused multiply-add,
    which over 1000 steps moves v by ~2e-6 of itself), fed the same
    gradients: at every step
    the update p_new - p_old and both moments within rtol 1e-6 (and rtol
    of the tensor's largest element: an update or a moment near a zero
    crossing is a sum that cancels). The bias corrections ``1 - beta^t``
    are taken in fp32 as the reference takes them (a double power, rounded
    once, is ~6e-6 of the update off at step 1). Each step starts from the
    same parameters, of magnitude 1e-3, so the update is not lost in the
    rounding of p and the decay is ~1e-4 of it."""
    rng = np.random.default_rng(11)
    shapes = {"w": (4, 5), "norm.b": (7,)}
    p0 = {n: (rng.choice([-1.0, 1.0], size=s) * rng.uniform(0.5, 1.5, size=s)
              * 1e-3).astype(np.float32) for n, s in shapes.items()}
    lr, steps = 1e-3, 1000
    kw = dict(learning_rate=lr, beta1=0.9, beta2=0.999, epsilon=1e-8)
    if rule == "adam":
        kw["weight_decay"] = 0.01
    else:
        kw.update(weight_decay=0.1,
                  apply_decay_param_fun=lambda n: "norm" not in n)
    jps = [JParameter(jnp.asarray(p0[n]), name=n) for n in shapes]
    jo = (jopt.Adam if rule == "adam" else jopt.AdamW)(parameters=jps, **kw)
    update = jjit.make_param_updater(jo, jps)
    jstates = [jo._init_state(p.data) for p in jps]
    pps = {n: torch.nn.Parameter(torch.from_numpy(p0[n].copy()))
           for n in shapes}
    po = (Adam if rule == "adam" else AdamW)(parameters=list(pps.items()),
                                             **kw)
    rtol = RTOL[rule]
    for t in range(1, steps + 1):
        gs = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
        new, jstates = update([jnp.asarray(p0[n]) for n in shapes],
                              [jnp.asarray(gs[n]) for n in shapes], jstates,
                              jnp.asarray(lr, jnp.float32),
                              jnp.asarray(t, jnp.int32))
        for n, p in pps.items():
            p.data.copy_(torch.from_numpy(p0[n]))
            p.grad = torch.from_numpy(gs[n])
        po.step()
        for k, n in enumerate(shapes):
            ref = np.asarray(new[k], np.float64) - p0[n]
            got = pps[n].detach().numpy().astype(np.float64) - p0[n]
            pairs = [("update", got, ref)] + [
                (m, po._state[id(pps[n])][m].numpy(),
                 np.asarray(jstates[k][m])) for m in ("moment1", "moment2")]
            for what, a, b in pairs:
                np.testing.assert_allclose(
                    a, b, rtol=rtol, atol=rtol * np.abs(b).max(),
                    err_msg=f"step {t}, {n} {what}")
    assert po._global_step == steps


def test_clips_match_jax():
    """``_apply_plain`` of each clip against ``_apply_jax`` on the same
    gradients (fp32, and bf16 rounded as the reference rounds)."""
    rng = np.random.default_rng(3)
    gs = [rng.standard_normal(s).astype(np.float32)
          for s in [(5, 3), (7,), (2, 3, 5), (1,)]]
    for name, args in [("ClipGradByValue", (0.3,)),
                       ("ClipGradByNorm", (1.0,)),
                       ("ClipGradByGlobalNorm", (2.0,))]:
        ref = getattr(jnn, name)(*args)._apply_jax(
            [jnp.asarray(g) for g in gs])
        got = getattr(pnn, name)(*args)._apply_plain(
            [torch.from_numpy(g) for g in gs])
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        got16 = getattr(pnn, name)(*args)._apply_plain(
            [torch.from_numpy(g).bfloat16() for g in gs])
        ref16 = getattr(jnn, name)(*args)._apply_jax(
            [jnp.asarray(g).astype(jnp.bfloat16) for g in gs])
        for a, b in zip(got16, ref16):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))


# -- lr and state ------------------------------------------------------------------

def test_get_and_set_lr():
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW(learning_rate=0.1, parameters=[p])
    assert opt.get_lr() == 0.1
    opt.set_lr(0.05)
    assert opt.get_lr() == 0.05
    sched = plr.StepDecay(0.2, step_size=1, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.2
    sched.step()
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.3)


# the reference's state names (optimizer.py:212-498), the state_dict keys
STATE_KEYS = {"adamw": {"moment1", "moment2"}, "adafactor_b05": {"vr", "vc",
                                                                 "m"},
              "sgd": set(), "momentum": {"velocity"}, "adagrad": {"moment"},
              "adamax": {"moment", "inf_norm"},
              "rmsprop": {"mean_square", "mean_grad", "velocity"},
              "adadelta": {"avg_squared_grad", "avg_squared_update"},
              "lamb": {"moment1", "moment2"}, "lars": {"velocity"}}


@pytest.mark.parametrize("rule", list(STATE_KEYS))
def test_state_dict_restores_the_run_bit_for_bit(rule):
    """Four steps, against two steps, a ``state_dict`` (parameters saved
    beside it), a fresh optimizer and schedule restored from it and two
    more steps: every parameter equal bit for bit. Keys follow the
    reference: ``global_step``, ``LR_Scheduler``, ``{name}_{key}`` with
    the JAX package's state names, which the JAX optimizer's state_dict
    holds for the same tensors."""
    params, grads = _inputs(steps=4)
    lr = LR.get(rule, 1e-3)
    opt, ps, sched = _make(rule, CLIPS["global"], "port", params, lr)
    for g in grads:
        _step("port", opt, ps, g, sched)
    full = {n: p.detach().clone() for n, p in ps.items()}

    opt, ps, sched = _make(rule, CLIPS["global"], "port", params, lr)
    for g in grads[:2]:
        _step("port", opt, ps, g, sched)
    sd = opt.state_dict()
    saved = {n: p.detach().clone() for n, p in ps.items()}
    assert sd["global_step"] == 2 and "LR_Scheduler" in sd
    assert {k[len("w2d_"):] for k in sd if k.startswith("w2d_")} == \
        STATE_KEYS[rule]
    assert not any(k.startswith("nograd_") for k in sd)
    jo, jps, jsched = _make(rule, CLIPS["global"], "jax", params, lr)
    for g in grads[:2]:
        _step("jax", jo, jps, g, jsched)
    assert set(jo.state_dict()) == set(sd)

    mid = {n: v.numpy() for n, v in saved.items()}
    opt, ps, sched = _make(rule, CLIPS["global"], "port", mid, lr)
    opt.set_state_dict(sd)
    assert opt._global_step == 2 and sched.last_epoch == 2
    for g in grads[2:]:
        _step("port", opt, ps, g, sched)
    for n, p in ps.items():
        assert torch.equal(p.detach(), full[n]), n


def test_clear_grad_zeroes_in_place_or_drops():
    """``clear_grad(set_to_zero=True)`` zeroes each gradient in its
    storage; without it the gradient is dropped (None), as the JAX package
    always drops it; ``clear_gradients`` is the same method."""
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    a.grad = torch.full((3,), 2.0)
    opt = AdamW(learning_rate=0.1, parameters=[a, b])
    ptr = a.grad.data_ptr()
    opt.clear_grad(set_to_zero=True)
    assert a.grad.data_ptr() == ptr and not a.grad.any()
    assert b.grad is None
    opt.clear_grad()
    assert a.grad is None
    a.grad = torch.ones(3)
    opt.clear_gradients()
    assert a.grad is None
    assert type(opt).clear_gradients is type(opt).clear_grad


def test_minimize_is_one_step_as_in_jax():
    """Dygraph ``minimize(loss)`` applies one step from the gradients the
    backward left and returns ``(None, None)``, as the JAX package's: the
    parameters equal the JAX ``minimize``'s and the port's ``step()``'s."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal(6).astype(np.float32)
    x = rng.standard_normal(6).astype(np.float32)
    outs = []
    for how in ("minimize", "step"):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = AdamW(learning_rate=0.1, parameters=[p], weight_decay=0.1)
        loss = (p * torch.from_numpy(x)).square().sum()
        loss.backward()
        if how == "minimize":
            assert opt.minimize(loss) == (None, None)
        else:
            opt.step()
        assert opt._global_step == 1
        outs.append(p.detach().numpy().copy())
    jp = JParameter(jnp.asarray(p0), name="p")
    jo = jopt.AdamW(learning_rate=0.1, parameters=[jp], weight_decay=0.1)
    jp.grad = JTensor(jnp.asarray(2 * x * x * p0))
    assert jo.minimize(None) == (None, None)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], np.asarray(jp.data), rtol=1e-6)


def test_the_step_table_is_kept_while_its_tensors_stay():
    """The optimizer builds its step's table once and keeps it while the
    step's tensors keep their storage (gradients zeroed in place): a later
    step only rewrites the header's rate and step. A replaced parameter
    storage or a new gradient storage builds a new table."""
    p = torch.nn.Parameter(torch.ones(6))
    sched = plr.StepDecay(0.2, step_size=1, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=[p], weight_decay=0.0)
    p.grad = torch.ones(6)
    real = kopt.adam_update

    def spy(batch, **kw):  # the words the card would hold (built once)
        batch.host_table()
        return real(batch, **kw)

    kopt.adam_update = spy
    try:
        opt.step()
    finally:
        kopt.adam_update = real
    first = opt._batch
    opt.clear_grad(set_to_zero=True)
    p.grad.fill_(1.0)
    sched.step()
    opt.step()
    assert opt._batch is first and first.grads is None
    head = first.host_table()[:2].view(np.int32)
    assert head[0] == np.array([0.1], np.float32).view(np.int32)[0]
    assert head[1] == 2
    p.data = torch.full((6,), 2.0)
    opt.step()
    assert opt._batch is not first
    p.grad = torch.ones(6)
    second = opt._batch
    opt.step()
    assert opt._batch is not second


def test_unnamed_parameters_are_named_by_index():
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(3))
    opt = Adam(learning_rate=0.1, parameters=[a, b])
    b.grad = torch.ones(3)
    opt.step()
    sd = opt.state_dict()
    assert set(sd) == {"global_step", "param_1_moment1", "param_1_moment2"}


# -- TrainStep curve: the JAX package's finetune recipe ---------------------------

def _llama_pair(seed=3, scan_layers=True):
    """The JAX tiny Llama (its decoder layers stacked into one tensor per
    weight with ``scan_layers``, else a tensor per layer as the port keeps
    them) and the port's, holding the same seeded weights."""
    paddle.seed(seed)
    cfg = dict(ce_chunk=8)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        scan_layers=scan_layers, **cfg))
    rng = np.random.default_rng(seed)
    state = {}
    for name, v in jm.state_dict().items():
        shape = tuple(v.shape)
        a = (1.0 if "norm" in name else 0.0) + 0.1 * rng.standard_normal(shape)
        state[name] = a.astype(np.float32)
    jm.set_state_dict(state)
    pcfg = LlamaConfig.tiny(**cfg)
    pm = LlamaForCausalLM(pcfg, device="cpu")
    pm.load_state_dict(llama_state_from_numpy(state, pcfg))
    return jm, pm


@pytest.fixture
def jax_flags():
    """The JAX package's eager embedding needs the 'clip' OOV policy under
    this jax; restored afterwards."""
    from paddle_tpu.framework import flags as flags_mod

    names = ["FLAGS_embedding_oov_policy"]
    prior = flags_mod.get_flags(names)
    paddle.set_flags({"FLAGS_embedding_oov_policy": "clip"})
    yield
    paddle.set_flags(prior)


def test_trainstep_curve_with_warmup_and_global_clip_matches_jax(jax_flags):
    """``LinearWarmup`` + ``ClipGradByGlobalNorm(1.0)`` + AdamW, the JAX
    package's finetune recipe (``bench.py:855-864``), three steps of the
    port's ``TrainStep`` against the JAX ``jit.TrainStep``: each loss
    within 1e-4, and the clip active (the global norm exceeds 1)."""
    jm, pm = _llama_pair()
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, size=(3, 12)).astype(np.int32)
    labels = rng.integers(0, 256, size=(3, 12)).astype(np.int64)

    def recipe(mod, nn_mod, params):
        sched = mod.lr.LinearWarmup(learning_rate=1e-2, warmup_steps=2,
                                    start_lr=0.0, end_lr=1e-2)
        return sched, mod.AdamW(learning_rate=sched, parameters=params,
                                weight_decay=0.01,
                                grad_clip=nn_mod.ClipGradByGlobalNorm(1.0))

    import paddle_tpu_torch.optimizer as popt

    jsched, jo = recipe(jopt, jnn, jm.parameters())
    psched, po = recipe(popt, pnn, pm.parameters())
    jstep = jjit.TrainStep(jm, lambda m, x, y: m(x, labels=y), jo)
    pstep = TrainStep(pm, lambda m, x, y: m(x, labels=y), po)
    ref, got = [], []
    for _ in range(3):
        ref.append(float(jstep(paddle.to_tensor(ids),
                               paddle.to_tensor(labels))))
        jsched.step()
    kernels.reset_counters()
    norms = []
    real = kopt.multi_tensor_sumsq

    def spy(*a, **k):
        out = real(*a, **k)
        norms.append(math.sqrt(float(out[-1])))
        return out

    kopt.multi_tensor_sumsq = spy
    try:
        for _ in range(3):
            got.append(float(pstep(torch.from_numpy(ids),
                                   torch.from_numpy(labels))))
            psched.step()
    finally:
        kopt.multi_tensor_sumsq = real
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert min(norms) > 1.0
    c = kernels.counters()
    assert c["multi_tensor_sumsq"] == {"launches": 0, "plain_calls": 3}
    assert c["adam_update"] == {"launches": 0, "plain_calls": 3}


@pytest.mark.parametrize("rule", ["momentum", "lamb"])
def test_trainstep_curve_matches_jax(rule, jax_flags):
    """Three steps of the port's ``TrainStep`` against the JAX
    ``jit.TrainStep`` on the same small Llama, under Momentum (Nesterov,
    an ``L2Decay``) or Lamb (1-D tensors excluded from its decay): each
    loss within rtol 1e-4 and, after the steps, every weight within rtol
    1e-4 of the JAX model's (plus 1e-4 of its tensor's largest element).
    Lamb's trust ratio is per tensor, so the JAX model keeps a tensor per
    layer (``scan_layers=False``), as the port does."""
    jm, pm = _llama_pair(scan_layers=False)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 256, size=(3, 12)).astype(np.int32)
    labels = rng.integers(0, 256, size=(3, 12)).astype(np.int64)

    def make(mod, reg, params):
        if rule == "momentum":
            return mod.Momentum(learning_rate=0.05, momentum=0.9,
                                parameters=params, use_nesterov=True,
                                weight_decay=reg.L2Decay(1e-3))
        return mod.Lamb(learning_rate=1e-2, lamb_weight_decay=0.01,
                        parameters=params,
                        exclude_from_weight_decay_fn=lambda p: p.ndim == 1)

    import paddle_tpu_torch.optimizer as popt

    jstep = jjit.TrainStep(jm, lambda m, x, y: m(x, labels=y),
                           make(jopt, jreg, jm.parameters()))
    pstep = TrainStep(pm, lambda m, x, y: m(x, labels=y),
                      make(popt, preg, pm.parameters()))
    ref = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)))
           for _ in range(3)]
    kernels.reset_counters()
    got = [float(pstep(torch.from_numpy(ids), torch.from_numpy(labels)))
           for _ in range(3)]
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[-1] < got[0]
    name = "momentum_update" if rule == "momentum" else "lamb_update"
    assert kernels.counters()[name] == {"launches": 0, "plain_calls": 3}
    want = llama_state_from_numpy(
        {k: np.asarray(v.data) for k, v in jm.state_dict().items()},
        pm.config)
    for k, v in pm.state_dict().items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


# -- the kernel wrappers on the CPU ------------------------------------------------

def _batch(rule, device="cpu", shapes=((5, 3), (7,), (2, 3, 4))):
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(s, generator=gen).to(device) for s in shapes]
    grads = [torch.randn(s, generator=gen).to(device) for s in shapes]
    if rule != "adafactor":
        k = kopt._RULE_SLOTS[rule]
        slots = [[torch.zeros_like(p) for p in params] if j < k
                 else [None] * len(params) for j in range(3)]
    else:
        slots = [[torch.zeros(p.shape[:-1] if p.dim() > 1 else p.shape,
                              device=device) for p in params],
                 [torch.zeros(p.shape[:-2] + p.shape[-1:], device=device)
                  if p.dim() > 1 else None for p in params],
                 [None] * len(params)]
    return kopt.StepBatch(params, grads, slots, [True] * len(params), 1e-2,
                          1, rule=rule)


# (wrapper, rule of its batch, its keyword arguments) of the rules added
# beside Adam and Adafactor
RULE_WRAPPERS = [
    ("sgd_update", "sgd", dict(weight_decay=0.01)),
    ("momentum_update", "momentum", dict(momentum=0.9, nesterov=True)),
    ("adagrad_update", "adagrad", dict(epsilon=1e-6)),
    ("adamax_update", "adamax", dict(beta1=0.9, beta2=0.999, epsilon=1e-8)),
    ("rmsprop_update", "rmsprop", dict(rho=0.95, epsilon=1e-6, momentum=0.5,
                                       centered=True)),
    ("adadelta_update", "adadelta", dict(rho=0.95, epsilon=1e-6)),
    ("lamb_update", "lamb", dict(beta1=0.9, beta2=0.999, epsilon=1e-6,
                                 weight_decay=0.01)),
    ("lars_update", "lars", dict(momentum=0.9, lars_coeff=0.001,
                                 weight_decay=5e-4, epsilon=0.0)),
]


@pytest.mark.parametrize("name,rule,kw", RULE_WRAPPERS,
                         ids=[w[0] for w in RULE_WRAPPERS])
def test_rule_wrappers_take_the_plain_version_on_the_cpu(name, rule, kw):
    """Each new wrapper on a CPU batch runs its plain version (one plain
    call, no launch) and updates the parameters; on a batch that is
    neither on the CPU nor on CUDA it raises."""
    kernels.reset_counters()
    b = _batch(rule)
    before = [p.clone() for p in b.params]
    getattr(kopt, name)(b, **kw)
    assert kernels.counters()[name] == {"launches": 0, "plain_calls": 1}
    assert all(not torch.equal(p, q) for p, q in zip(b.params, before))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kopt, name)(_batch(rule, device="meta"), **kw)


def test_wrappers_take_the_plain_version_on_the_cpu():
    kernels.reset_counters()
    b = _batch("adam")
    norms = kopt.multi_tensor_sumsq(b, 1.0, 2)
    kopt.adam_update(b, beta1=0.9, beta2=0.999, epsilon=1e-8,
                     weight_decay=0.1, decoupled=True, clip=("scale",),
                     norms=norms)
    b = _batch("adafactor")
    stats = kopt.adafactor_stats(b, decay_rate=0.8, epsilon1=1e-30,
                                 weight_decay=0.0, pscale=True)
    kopt.adafactor_update(b, stats, beta1=0.0, epsilon2=1e-3,
                          clip_threshold=1.0, pscale=True, weight_decay=0.0)
    c = kernels.counters()
    for name in ("multi_tensor_sumsq", "adam_update", "adafactor_stats",
                 "adafactor_update"):
        assert c[name] == {"launches": 0, "plain_calls": 1}, name
    # stats: a sum of p^2 per tensor, then mean(vr) per matrix (1 + 2)
    assert stats.shape == (3 + 3,)


def test_a_cuda_request_without_a_card_raises():
    """Neither CPU nor CUDA: the wrappers raise rather than run anything;
    the port's default device, CUDA, raises on a machine without a card."""
    b = _batch("adam", device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kopt.adam_update(b, beta1=0.9, beta2=0.999, epsilon=1e-8,
                         weight_decay=0.0, decoupled=True)
    with pytest.raises(ValueError, match="CUDA"):
        kopt.multi_tensor_sumsq(b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)


@pytest.mark.parametrize("which", ["param", "grad", "state"])
def test_a_batch_on_two_devices_raises(which):
    """Every tensor of a step lies on its first parameter's device, or the
    batch raises before any wrapper routes it: a CPU first parameter with
    the rest elsewhere must not take the plain version for all of them."""
    b = _batch("adam")
    params, grads, slots = list(b.params), list(b.grads), b.slots
    if which == "param":
        params[1] = params[1].to("meta")
    elif which == "grad":
        grads[2] = grads[2].to("meta")
    else:
        slots[1][2] = slots[1][2].to("meta")
    with pytest.raises(ValueError, match="tensor on meta"):
        kopt.StepBatch(params, grads, slots, b.decay, 1e-2, 1)
    p, q = torch.nn.Parameter(torch.ones(8)), torch.nn.Parameter(
        torch.ones(8, device="meta"))
    p.grad, q.grad = torch.ones_like(p), torch.ones_like(q)
    kernels.reset_counters()
    with pytest.raises(ValueError, match="tensor on meta"):
        AdamW(parameters=[p, q]).step()
    assert kernels.counters()["adam_update"] == {"launches": 0,
                                                 "plain_calls": 0}


def test_a_scale_clip_needs_norms_of_its_batch():
    """A kernel's ``("scale",)`` clip reads fp32 norms of the batch's own
    length, on its device."""
    b = _batch("adam", device="meta")
    with pytest.raises(ValueError, match="norms"):
        kopt._clip_args(b, ("scale",), None)
    with pytest.raises(ValueError, match="norms"):
        kopt._clip_args(b, ("scale",), torch.zeros(3, device="meta"))
    assert kopt._clip_args(b, ("scale",), torch.zeros(
        7, device="meta")) == (1, 0.0, 0.0)
    assert kopt._clip_args(b, ("value", -1, 2), None) == (2, -1.0, 2.0)


def _decode(batch):
    """The chunks of ``batch``'s table as the kernels read them:
    {tensor: [(offset, length)]}, in order."""
    host = batch._plan()
    hw = kopt.HEADER_WORDS
    head = host[:hw].view(np.int32)
    n, n_chunks = int(head[2]), int(head[3])
    words = host[hw:hw + n * kopt.TENSOR_WORDS].reshape(n, kopt.TENSOR_WORDS)
    chunks = host[hw + n * kopt.TENSOR_WORDS:][:n_chunks]
    out = {}
    for c, w in enumerate(chunks):
        i, k = int(w >> 40), int(w & ((1 << 40) - 1))
        e = words[i]
        assert e[10] <= c < e[11]
        span = int(e[8])
        if e[12] & 8:  # factored: a tile of whole rows
            C, R, tiles = int(e[6]), int(e[7]), int(e[9])
            b, r0 = divmod(k, tiles)
            r0 *= span
            off, length = (b * R + r0) * C, min(span, R - r0) * C
        else:
            off = k * span
            length = min(span, int(e[5]) - off)
        out.setdefault(i, []).append((off, length))
    return out, head, words


@pytest.mark.parametrize("rule", kopt.RULES)
def test_chunk_table_covers_every_element_once(rule, monkeypatch):
    """With small chunks and tiles, the table's chunks of each tensor are
    contiguous, in order and cover it exactly once; Adafactor's tiles of a
    tensor of 2+ dims start on a row and stay in one matrix."""
    monkeypatch.setattr(kopt, "FLAT_CHUNK", 16)
    monkeypatch.setattr(kopt, "TILE_ELEMENTS", 20)
    b = _batch(rule, shapes=((5, 3), (37,), (3, 7, 4), (1,), (2, 9)))
    chunks, head, words = _decode(b)
    assert head[0] == np.array([1e-2], np.float32).view(np.int32)[0]
    assert head[1] == 1
    for i, p in enumerate(b.params):
        pos = 0
        for off, length in chunks[i]:
            assert off == pos and length > 0
            pos += length
            if b.factored(i):
                C, R = p.shape[-1], p.shape[-2]
                assert off % C == 0 and length % C == 0
                assert off // (R * C) == (off + length - 1) // (R * C)
        assert pos == p.numel()
        assert words[i, 0] == p.data_ptr() and words[i, 1] == b.grads[i].data_ptr()
        for j in range(3):  # the rule's state slots, 0 where it keeps fewer
            t = b.slots[j][i]
            assert words[i, 2 + j] == (0 if t is None else t.data_ptr())


def test_a_new_step_reads_a_replaced_storage():
    """The table is built per step: a parameter whose storage is replaced
    between steps (and every fresh gradient) is read at its new address,
    and the update lands there."""
    p = torch.nn.Parameter(torch.ones(6))
    opt = AdamW(learning_rate=0.1, parameters=[p], weight_decay=0.0)
    seen = []
    real = kopt.adam_update

    def spy(batch, **kw):
        hw = kopt.HEADER_WORDS
        seen.append(batch._plan()[hw:hw + 2].tolist())
        return real(batch, **kw)

    kopt.adam_update = spy
    try:
        p.grad = torch.ones(6)
        opt.step()
        p.data = torch.full((6,), 2.0)
        p.grad = torch.ones(6)
        opt.step()
    finally:
        kopt.adam_update = real
    assert seen[1][0] == p.data_ptr() != seen[0][0]
    assert seen[1][1] == p.grad.data_ptr()
    assert float(p.detach()[0]) < 2.0
