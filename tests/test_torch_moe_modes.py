"""The port's ``sort`` and ``einsum`` MoE dispatch modes against the JAX
package's, on the CPU.

Inputs and weights are drawn with numpy. Both modes are XLA in the JAX
package and plain PyTorch in the port. fp32; outputs and aux within 1e-5,
gradients within 1e-4 (rtol and atol).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.layer import moe as jmoe_layer
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.kernels import counters, reset_counters
from paddle_tpu_torch.nn import MoELayer
from paddle_tpu_torch.nn.layer.moe import moe_mlp

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _weights(h=32, e=4, i=48, seed=8):
    rng = np.random.default_rng(seed)
    return [0.1 * rng.standard_normal(s, dtype=np.float32)
            for s in ((h, e), (e, h, i), (e, h, i), (e, i, h))]


def _loss(o, aux):
    return (o * o).sum() + 0.1 * aux


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
@pytest.mark.parametrize("mode", ["sort", "einsum"])
def test_dispatch_mode_matches_jax(mode, capacity_factor):
    """Output, aux and the gradients of x, the router and the three expert
    stacks against the JAX mode, with every row kept (capacity factor 4)
    and with rows dropped past capacity (0.5)."""
    weights = _weights()
    x = np.random.default_rng(5).standard_normal((2, 12, 32),
                                                 dtype=np.float32)

    def jfn(*a):
        return jmoe_layer._moe_mlp.fn(*a, top_k=2,
                                      capacity_factor=capacity_factor,
                                      ep_degree=1, dispatch=mode)

    jargs = [jnp.asarray(a) for a in [x] + weights]
    jo, jaux = jfn(*jargs)
    jgrads = jax.grad(lambda *a: _loss(*jfn(*a)),
                      argnums=tuple(range(5)))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_() for a in [x] + weights]
    reset_counters()
    o, aux = moe_mlp(*leaves, top_k=2, capacity_factor=capacity_factor,
                     dispatch=mode)
    _loss(o, aux).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    for t, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   **GRAD_TOL)
    # no MoE kernel runs in these modes
    c = counters()
    assert all(c[n]["plain_calls"] == 0 for n in (
        "moe_route", "moe_gather", "moe_combine", "grouped_matmul"))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_capacity_modes_agree(capacity_factor):
    """``index``, ``sort`` and ``einsum`` share the slot-major drop rule:
    the same output and gradients, drops included."""
    weights = _weights(seed=9)
    x = np.random.default_rng(6).standard_normal((3, 10, 32),
                                                 dtype=np.float32)
    runs = {}
    for mode in ("index", "sort", "einsum"):
        leaves = [torch.from_numpy(a).requires_grad_()
                  for a in [x] + weights]
        o, aux = moe_mlp(*leaves, top_k=2, capacity_factor=capacity_factor,
                         dispatch=mode)
        _loss(o, aux).backward()
        runs[mode] = [o.detach()] + [t.grad for t in leaves]
    for mode in ("sort", "einsum"):
        for a, b in zip(runs[mode], runs["index"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_layer_takes_the_new_modes_from_the_flag():
    prior = get_flags("FLAGS_moe_dispatch")
    torch.manual_seed(0)
    layer = MoELayer(16, 4, intermediate_size=24)
    x = torch.randn(2, 5, 16)
    try:
        outs = {}
        for mode in ("index", "sort", "einsum"):
            set_flags({"FLAGS_moe_dispatch": mode})
            with torch.no_grad():
                outs[mode] = layer(x)
    finally:
        set_flags(prior)
    np.testing.assert_allclose(outs["sort"].numpy(), outs["index"].numpy(),
                               **TOL)
    np.testing.assert_allclose(outs["einsum"].numpy(),
                               outs["index"].numpy(), **TOL)
