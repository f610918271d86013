"""``FLAGS_cudnn_deterministic`` and the promotion of mixed float operands
in the port's products, against the JAX package.

The flag: the port's ``set_flags`` / ``get_flags`` take it with the JAX
registry's default, names and readings of a value (bools, and strings
such as ``"1"`` or ``"false"``), and ``True`` turns on torch's strict
deterministic mode with cuDNN's deterministic choice, ``False`` puts back
what was there.

Promotion: the JAX ``linear`` is ``jnp.matmul(x, w) + b`` and its
``matmul`` is ``jnp.matmul``, so an fp32 input against a bf16 weight gives
an fp32 result, and the weight's gradient is bf16. The port's
``nn.functional.linear``, ``matmul`` / ``bmm`` / ``mm``, ``nn.Linear`` and
the tensor-parallel layers at mp = 1 do the same: fp32 results within
1e-6 of the JAX ones (both take the product in fp32 over the same bf16
weights), and bf16 weight gradients within one bf16 ulp (2^-7) of the
JAX ones. Same-dtype calls are untouched (the result is the plain torch
call's, bit for bit).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed.meta_parallel import mp_layers as jmp
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.distributed.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear)
from paddle_tpu_torch.framework import flags as pflags

FLAG = "FLAGS_cudnn_deterministic"


@pytest.fixture(autouse=True)
def cpu_place():
    prior = P.get_device()
    P.set_device("cpu")
    yield
    P.set_device(prior)


@pytest.fixture
def restore_flag():
    jprior, pprior = J.get_flags([FLAG]), P.get_flags([FLAG])
    yield
    J.set_flags(jprior)
    P.set_flags(pprior)
    assert not torch.are_deterministic_algorithms_enabled()


def test_flag_default_and_names_match_jax():
    assert P.get_flags(FLAG) == J.get_flags(FLAG) == {FLAG: False}
    assert P.get_flags("cudnn_deterministic") == {FLAG: False}
    assert FLAG in P.get_flags() and FLAG in J.get_flags()


@pytest.mark.parametrize("value", [True, False, 1, 0, "1", "true", "On",
                                   "false", "0", "no"])
def test_flag_reads_values_as_jax(value, restore_flag):
    J.set_flags({FLAG: value})
    P.set_flags({FLAG: value})
    assert P.get_flags(FLAG) == J.get_flags(FLAG)
    on = P.get_flags(FLAG)[FLAG]
    assert torch.are_deterministic_algorithms_enabled() == on
    if on:
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark


def test_flag_false_puts_back_the_prior_settings(restore_flag):
    bench = torch.backends.cudnn.benchmark
    det = torch.backends.cudnn.deterministic
    P.set_flags({FLAG: True})
    P.set_flags({FLAG: True})  # again: nothing more is saved
    assert torch.are_deterministic_algorithms_enabled()
    P.set_flags({FLAG: False})
    assert not torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.benchmark == bench
    assert torch.backends.cudnn.deterministic == det
    assert pflags.flag("cudnn_deterministic") is False


def test_flag_mode_is_strict_not_warn_only(restore_flag):
    """An operation with no deterministic implementation raises under the
    flag instead of warning (``torch.Tensor.put_`` with accumulation is
    such an operation on the CPU too)."""
    P.set_flags({FLAG: "yes"})
    assert not torch.is_deterministic_algorithms_warn_only_enabled()
    t = torch.zeros(4)
    with pytest.raises(RuntimeError):
        t.put_(torch.tensor([0, 0]), torch.ones(2), accumulate=False)


def _mixed(seed=0, b=3, n_in=8, n_out=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n_in)).astype(np.float32)
    w = rng.standard_normal((n_in, n_out)).astype(np.float32)
    bias = rng.standard_normal((n_out,)).astype(np.float32)
    return x, w, bias


def _jax_linear_grad(x, w, b):
    """(fp32 result, bf16 weight gradient) of the JAX ``F.linear`` over a
    bf16 weight and bias, gradient of sum(out^2)."""
    jx = J.to_tensor(x)
    jw = J.to_tensor(w).astype("bfloat16")
    jb = J.to_tensor(b).astype("bfloat16")
    jw.stop_gradient = False
    out = JF.linear(jx, jw, jb)
    (out * out).sum().backward()
    return out, jw.grad


def test_functional_linear_promotes_as_jax():
    x, w, b = _mixed()
    jout, jgrad = _jax_linear_grad(x, w, b)
    assert str(jout.dtype) in ("float32", "paddle.float32")
    pw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    pb = torch.from_numpy(b).to(torch.bfloat16)
    out = PF.linear(torch.from_numpy(x), pw, pb)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.numpy()),
                               rtol=1e-6, atol=1e-6)
    (out * out).sum().backward()
    assert pw.grad.dtype == torch.bfloat16
    ref = np.asarray(jgrad.numpy(), np.float32)
    np.testing.assert_allclose(pw.grad.float().numpy(), ref,
                               rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("op", ["matmul", "matmul_ty", "mm", "bmm"])
def test_products_promote_as_jax(op):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    y = rng.standard_normal((2, 4, 5)).astype(np.float32)
    if op in ("mm",):
        x, y = x[0], y[0]
    jy = J.to_tensor(y).astype("bfloat16")
    py = torch.from_numpy(y).to(torch.bfloat16)
    if op == "matmul_ty":
        jy = J.to_tensor(np.swapaxes(y, -1, -2)).astype("bfloat16")
        py = torch.from_numpy(np.swapaxes(y, -1, -2).copy()).to(
            torch.bfloat16)
        ref = J.matmul(J.to_tensor(x), jy, transpose_y=True)
        got = P.matmul(torch.from_numpy(x), py, transpose_y=True)
    else:
        ref = getattr(J, "matmul" if op == "matmul" else op)(
            J.to_tensor(x), jy)
        got = getattr(P, "matmul" if op == "matmul" else op)(
            torch.from_numpy(x), py)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()),
                               rtol=1e-6, atol=1e-6)


def test_linear_layer_promotes_as_jax():
    x, w, b = _mixed(2)
    J.seed(0)
    jl = jnn.Linear(8, 5)
    jl.set_state_dict({"weight": w, "bias": b})
    jl.to(dtype="bfloat16")
    pl = pnn.Linear(8, 5)
    pl.set_state_dict({"weight": w, "bias": b})
    pl.to(dtype="bfloat16")
    jout = jl(J.to_tensor(x))
    out = pl(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.numpy()),
                               rtol=1e-6, atol=1e-6)
    (jout * jout).sum().backward()
    (out * out).sum().backward()
    assert pl.weight.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(
        pl.weight.grad.float().numpy(),
        np.asarray(jl.weight.grad.numpy(), np.float32), rtol=2.0 ** -7,
        atol=1e-6)


@pytest.mark.parametrize("kind", ["column", "row"])
def test_mp_layers_at_mp1_promote_as_jax(kind):
    x, w, b = _mixed(3)
    J.seed(0)
    if kind == "column":
        jl = jmp.ColumnParallelLinear(8, 5, has_bias=True,
                                      gather_output=False)
        pl = ColumnParallelLinear(8, 5, has_bias=True, gather_output=False,
                                  device="cpu")
    else:
        jl = jmp.RowParallelLinear(8, 5, has_bias=True,
                                   input_is_parallel=True)
        pl = RowParallelLinear(8, 5, has_bias=True, input_is_parallel=True,
                               device="cpu")
    jl.set_state_dict({"weight": w, "bias": b})
    jl.to(dtype="bfloat16")
    with torch.no_grad():
        pl.weight.copy_(torch.from_numpy(w.T.copy()))
        pl.bias.copy_(torch.from_numpy(b))
    pl.to(torch.bfloat16)
    jout = jl(J.to_tensor(x))
    out = pl(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.numpy()),
                               rtol=1e-6, atol=1e-6)
    (jout * jout).sum().backward()
    (out * out).sum().backward()
    assert pl.weight.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(
        pl.weight.grad.float().numpy().T,
        np.asarray(jl.weight.grad.numpy(), np.float32), rtol=2.0 ** -7,
        atol=1e-6)


def test_same_dtype_products_are_the_plain_torch_calls():
    x, w, b = (torch.from_numpy(a) for a in _mixed(4))
    for dt in (torch.float32, torch.bfloat16):
        xx, ww, bb = x.to(dt), w.to(dt), b.to(dt)
        assert torch.equal(PF.linear(xx, ww, bb),
                           torch.nn.functional.linear(xx, ww.t(), bb))
        assert torch.equal(P.matmul(xx, ww), torch.matmul(xx, ww))
        cl = ColumnParallelLinear(8, 5, device="cpu").to(dt)
        assert torch.equal(cl(xx), torch.nn.functional.linear(
            xx, cl.weight, cl.bias))
