"""The port's ``amp`` package, ``make_master_update``, the clips'
``__call__`` and the regularizers against the JAX package's.

Inputs are drawn with numpy and handed to both packages; the JAX package
runs on its CPU backend, the port on the CPU (the kernels' plain
versions).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn.layer.layers import Parameter as JParameter
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import kernels
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import regularizer as preg

SHAPES = {"w": (5, 3), "b": (7,), "norm.w": (6,), "x": (2, 3, 4)}


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.standard_normal(s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _params(pkg, values, dtype):
    if pkg == "jax":
        return {n: JParameter(jnp.asarray(v).astype(dtype), name=n)
                for n, v in values.items()}
    return {n: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype))
            for n, v in values.items()}


def _np(x):
    """A JAX array or a torch tensor as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- GradScaler ------------------------------------------------------------------

# the steps whose gradients carry a planted inf (3, 4: two in a row halve
# the scale) or NaN (8), of 11
BAD_STEPS = {3: np.inf, 4: -np.inf, 8: np.nan}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_scaler_sequence_matches_jax(dtype):
    """Eleven AdamW steps through ``GradScaler.step`` (the gradients given
    as the scaled loss's would be: g * scale), three with a non-finite
    value planted: after each step the parameters (fp32: rtol 1e-6; bf16:
    equal), the scale, the skip, the good and bad step counters and the
    ``state_dict`` equal the JAX scaler's; ``incr_every_n_steps`` 3 and
    ``decr_every_n_nan_or_inf`` 2 make the scale both grow and halve. On
    a skipped step the gradients keep their scaled values."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    p0 = _arrays(1)
    jps, pps = _params("jax", p0, jdt), _params("port", p0, tdt)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    js, ps = jamp.GradScaler(**kw), pamp.GradScaler(**kw)
    jo = jopt.AdamW(learning_rate=1e-2, parameters=list(jps.values()))
    po = popt.AdamW(learning_rate=1e-2, parameters=list(pps.values()))
    kernels.reset_counters()
    scales = []
    for step in range(11):
        grads = _arrays(100 + step)
        for n, g in grads.items():
            g = (g * js._scale).astype(np.float32)
            if step in BAD_STEPS and n == "x":
                g.reshape(-1)[5] = BAD_STEPS[step]
            jps[n].grad = JTensor(jnp.asarray(g).astype(jdt))
            pps[n].grad = torch.from_numpy(g).to(tdt)
        js.step(jo)
        ps.step(po)
        assert ps._found_inf == js._found_inf == (step in BAD_STEPS)
        for n in SHAPES:
            got, ref = _np(pps[n]), _np(jps[n].data)
            if dtype == "bfloat16":
                np.testing.assert_array_equal(got, ref, err_msg=n)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=n)
            if step in BAD_STEPS:  # left scaled, as the reference leaves it
                np.testing.assert_array_equal(_np(pps[n].grad),
                                              _np(jps[n].grad.data))
        assert ps.state_dict() == js.state_dict()
        assert float(ps.get_loss_scaling()) == float(js.get_loss_scaling())
        scales.append(ps._scale)
        jo.clear_grad()
        po.clear_grad()
    assert any(b > a for a, b in zip(scales, scales[1:]))  # grew
    assert any(b < a for a, b in zip(scales, scales[1:]))  # halved
    assert po._global_step == jo._global_step == 11 - len(BAD_STEPS)
    c = kernels.counters()
    assert c["check_finite"] == {"launches": 0, "plain_calls": 11}
    assert c["unscale"] == {"launches": 0, "plain_calls": 8}


def test_grad_scaler_state_dict_round_trip_and_switches():
    """``load_state_dict`` restores the scale and the counters; a disabled
    scaler passes the loss through and steps the optimizer unscaled; a
    static scale never moves; ``AmpScaler`` is ``GradScaler``; fp16
    gradients raise (no kernel of the port takes them)."""
    s = pamp.GradScaler(init_loss_scaling=8.0)
    s._good_steps, s._bad_steps = 5, 1
    t = pamp.GradScaler()
    t.load_state_dict(s.state_dict())
    assert t.state_dict() == s.state_dict()
    assert pamp.AmpScaler is pamp.GradScaler
    off = pamp.GradScaler(enable=False)
    loss = torch.tensor(3.0)
    assert off.scale(loss) is loss and not off.is_enable()
    assert float(pamp.GradScaler(init_loss_scaling=4.0).scale(loss)) == 12.0
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    opt = popt.SGD(learning_rate=0.5, parameters=[p])
    off.step(opt)
    assert torch.equal(p.detach(), torch.zeros(3))
    static = pamp.GradScaler(init_loss_scaling=4.0,
                             use_dynamic_loss_scaling=False)
    p.grad = torch.tensor([1.0, float("inf"), 1.0])
    static.step(opt)
    assert static._found_inf and static._scale == 4.0
    assert not static.is_use_dynamic_loss_scaling()
    q = torch.nn.Parameter(torch.ones(3, dtype=torch.float16))
    q.grad = torch.ones_like(q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pamp.GradScaler().unscale_(popt.SGD(parameters=[q]))


# -- decorate and the rest of amp ----------------------------------------------------

def test_decorate_casts_as_jax():
    """``decorate`` casts every floating parameter of each model to the
    dtype in place, keeps the parameters an optimizer holds, and returns
    what it was given (one model, a list, with optimizers a pair), as the
    JAX ``decorate``."""
    jm = jnn.Linear(4, 3)
    pm = torch.nn.Linear(4, 3)
    po = popt.SGD(parameters=pm.parameters())
    held = list(po._parameter_list)
    out = pamp.decorate(pm, po, level="O2", dtype="bfloat16")
    jout = jamp.decorate(jm, jopt.SGD(parameters=jm.parameters()),
                         level="O2", dtype="bfloat16")
    assert out[0] is pm and out[1] is po and len(jout) == 2
    assert {str(p.dtype) for p in jm.parameters()} == {"bfloat16"}
    assert {p.dtype for p in pm.parameters()} == {torch.bfloat16}
    assert all(a is b for a, b in zip(po._parameter_list, held))
    assert held[0].dtype == torch.bfloat16
    ms = [torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)]
    assert pamp.decorate(ms, dtype="float32") == ms
    assert pamp.decorate(ms[0], dtype=torch.bfloat16) is ms[0]
    assert pamp.is_bfloat16_supported() == jamp.is_bfloat16_supported()
    assert pamp.is_float16_supported() == jamp.is_float16_supported()


def test_auto_cast_raises_until_the_dispatch_layer_is_ported():
    for fn in (pamp.auto_cast, pamp.amp_guard):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            fn()


# -- make_master_update ---------------------------------------------------------

def _master_opts(rule, pkg, params):
    mod, nn_mod = (jopt, jnn) if pkg == "jax" else (popt, pnn)
    clip = nn_mod.ClipGradByGlobalNorm(1.0)
    if rule == "adamw":
        return mod.AdamW(learning_rate=1e-2, parameters=params,
                         weight_decay=0.1, grad_clip=clip)
    if rule == "momentum":
        return mod.Momentum(learning_rate=1e-2, parameters=params,
                            use_nesterov=True, weight_decay=0.01,
                            grad_clip=clip)
    return mod.Lamb(learning_rate=1e-2, parameters=params, grad_clip=clip,
                    exclude_from_weight_decay_fn=lambda p: p.ndim == 1)


@pytest.mark.parametrize("with_clip", [True, False])
@pytest.mark.parametrize("rule", ["adamw", "momentum", "lamb"])
def test_make_master_update_matches_jax(rule, with_clip):
    """Three updates of ``make_master_update`` (fp32 masters and state,
    bf16 gradients cast to fp32, the model's bf16 parameters cast from the
    new masters) against the JAX function's: masters and states within
    rtol 1e-6 (Lamb 1e-5: its norms are sums in another order, and fp32
    masters show the difference) and of their largest element, the bf16
    parameters equal but where a master lies that close to a bf16 rounding
    boundary; the masters and states are the caller's tensors, written in
    place."""
    p0 = _arrays(2)
    jps = _params("jax", p0, jnp.bfloat16)
    pps = _params("port", p0, torch.bfloat16)
    names = list(SHAPES)
    jo = _master_opts(rule, "jax", [jps[n] for n in names])
    po = _master_opts(rule, "port", [pps[n] for n in names])
    jup = jopt.optimizer.make_master_update(
        jo, [jps[n] for n in names], [jnp.bfloat16] * len(names),
        with_clip=with_clip)
    pup = popt.make_master_update(po, [pps[n] for n in names],
                                  [torch.bfloat16] * len(names),
                                  with_clip=with_clip)
    jm = [jps[n].data.astype(jnp.float32) for n in names]
    pm = [pps[n].detach().float() for n in names]
    js = [jo._init_state(m) for m in jm]
    ps = [po._init_state(m) for m in pm]
    rtol = 1e-5 if rule == "lamb" else 1e-6
    for step in range(1, 4):
        grads = _arrays(200 + step, scale=3.0)
        jm, js, jp = jup(jm, [jnp.asarray(grads[n]).astype(jnp.bfloat16)
                              for n in names], js,
                         jnp.asarray(1e-2, jnp.float32),
                         jnp.asarray(step, jnp.int32))
        out_m, out_s, pp = pup(pm, [torch.from_numpy(grads[n]).bfloat16()
                                    for n in names], ps, 1e-2, step)
        assert all(a is b for a, b in zip(out_m, pm))
        assert all(a is b for a, b in zip(out_s, ps))
        for k, n in enumerate(names):
            ref = _np(jm[k])
            np.testing.assert_allclose(_np(pm[k]), ref, rtol=rtol,
                                       atol=rtol * np.abs(ref).max(),
                                       err_msg=n)
            assert pp[k].dtype == torch.bfloat16
            # a bf16 parameter may differ only where the JAX master lies
            # within the masters' tolerance of a rounding boundary (half an
            # ulp of its bf16 value away from it)
            jb = _np(jp[k])
            half = np.exp2(np.floor(np.log2(np.maximum(np.abs(jb),
                                                       2.0 ** -126))) - 8)
            near = np.abs(np.abs(ref - jb) - half) <= \
                2 * rtol * (np.abs(ref) + np.abs(ref).max())
            differ = _np(pp[k]) != jb
            assert not np.any(differ & ~near), n
            for key in js[k]:
                r = _np(js[k][key])
                np.testing.assert_allclose(_np(ps[k][key]), r, rtol=rtol,
                                           atol=rtol * np.abs(r).max(),
                                           err_msg=f"{n} {key}")


def test_make_master_update_needs_the_optimizers_parameters():
    a = torch.nn.Parameter(torch.ones(3))
    opt = popt.SGD(parameters=[a])
    with pytest.raises(ValueError, match="not parameters"):
        popt.make_master_update(opt, [torch.nn.Parameter(torch.ones(3))],
                                [torch.float32])


# -- the clips' __call__ and the regularizers ----------------------------------------

@pytest.mark.parametrize("clip", [("ClipGradByValue", (0.3,)),
                                  ("ClipGradByNorm", (1.0,)),
                                  ("ClipGradByGlobalNorm", (2.0,))],
                         ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_call_matches_jax(clip, dtype):
    """``clip([(param, grad)])`` against the JAX clip's ``__call__``: the
    same parameters back, each gradient clipped (fp32 rtol 1e-6; bf16
    equal), new tensors; the norm clips count one plain sums-of-squares
    call."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    gs = _arrays(4, scale=2.0)
    jpairs = [(n, JTensor(jnp.asarray(g).astype(jdt))) for n, g in gs.items()]
    ppairs = [(n, torch.from_numpy(g.copy()).to(tdt)) for n, g in gs.items()]
    kernels.reset_counters()
    ref = getattr(jnn, clip[0])(*clip[1])(jpairs)
    got = getattr(pnn, clip[0])(*clip[1])(ppairs)
    assert kernels.counters()["multi_tensor_sumsq"]["plain_calls"] == (
        0 if clip[0] == "ClipGradByValue" else 1)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (_, a), (_, b), (_, g0) in zip(got, ref, ppairs):
        assert a.dtype == tdt and a is not g0
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_np(a), _np(b.data))
        else:
            np.testing.assert_allclose(_np(a), _np(b.data), rtol=1e-6)
    assert getattr(pnn, clip[0])(*clip[1])([]) == []


@pytest.mark.parametrize("reg", ["L2Decay", "L1Decay"])
def test_regularizers_as_weight_decay_match_jax(reg):
    """An ``L2Decay`` or ``L1Decay`` as ``weight_decay`` gives its
    coefficient (``_wd_value``: the reference adds either as the coupled
    term ``g + coeff p``): two Adam and two SGD steps equal the JAX
    package's (rtol 1e-6) and the steps with the plain float."""
    p0, grads = _arrays(5), [_arrays(6), _arrays(7)]
    outs = {}
    for how in ("jax", "port", "float"):
        for cls in ("Adam", "SGD"):
            pkg = "jax" if how == "jax" else "port"
            ps = _params(pkg, p0, jnp.float32 if pkg == "jax"
                         else torch.float32)
            wd = 0.05 if how == "float" else getattr(
                jreg if pkg == "jax" else preg, reg)(0.05)
            opt = getattr(jopt if pkg == "jax" else popt, cls)(
                learning_rate=1e-2, parameters=list(ps.values()),
                weight_decay=wd)
            assert opt._weight_decay == 0.05
            for g in grads:
                for n, v in g.items():
                    ps[n].grad = (JTensor(jnp.asarray(v)) if pkg == "jax"
                                  else torch.from_numpy(v.copy()))
                opt.step()
            outs[how, cls] = {n: _np(p.data if pkg == "jax" else p)
                              for n, p in ps.items()}
    for cls in ("Adam", "SGD"):
        for n in SHAPES:
            np.testing.assert_array_equal(outs["port", cls][n],
                                          outs["float", cls][n])
            np.testing.assert_allclose(outs["port", cls][n],
                                       outs["jax", cls][n], rtol=1e-6)
