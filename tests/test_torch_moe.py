"""The port's MoE training path against the JAX package's.

Inputs and weights are drawn with numpy and handed to both packages. On
the CPU the port's kernel wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode (or its composed twin), and its
grouped matmul through ``jax.lax.ragged_dot``. All fp32.

Tolerances: 1e-5 (rtol and atol) for the outputs of single modules, 1e-4
for gradients and for loss curves, as the two sum in different orders.
Integer outputs of the router (choices, positions, counts) must be exact.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.kernels.pallas import moe_dispatch as jmoe
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn.layer import moe as jmoe_layer
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import counters, reset_counters
from paddle_tpu_torch.kernels.grouped_matmul import grouped_matmul
from paddle_tpu_torch.kernels.moe_dispatch import (combine_rows,
                                                   fused_moe_mlp,
                                                   fused_route, gather_rows)
from paddle_tpu_torch.models import (LlamaForCausalLM, LlamaMoEConfig,
                                     llama_moe_flops_per_token,
                                     llama_moe_param_counts,
                                     llama_state_from_numpy)
from paddle_tpu_torch.nn import MoELayer
from paddle_tpu_torch.nn.layer.moe import collect_aux, drain_aux, moe_mlp
from paddle_tpu_torch.optimizer import Adafactor

TOL = dict(rtol=1e-5, atol=1e-5)        # single modules
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)   # gradients, loss curves


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture
def moe_flags():
    """Both packages' ``FLAGS_moe_dispatch`` set per test, and the JAX
    package's embedding OOV policy at 'clip' (its eager embedding crashes
    under jax 0.9 with the default); all restored afterwards."""
    from paddle_tpu.framework import flags as jflags

    jnames = ["FLAGS_embedding_oov_policy", "FLAGS_moe_dispatch"]
    jprior = jflags.get_flags(jnames)
    prior = get_flags("FLAGS_moe_dispatch")
    paddle.set_flags({"FLAGS_embedding_oov_policy": "clip"})

    def use(mode):
        paddle.set_flags({"FLAGS_moe_dispatch": mode})
        set_flags({"FLAGS_moe_dispatch": mode})

    yield use
    paddle.set_flags(jprior)
    set_flags(prior)


# -- grouped matmul -----------------------------------------------------------

@pytest.mark.parametrize("sizes", [[5, 0, 1, 7], [0, 13, 0, 0], [3, 1, 2, 0]])
def test_grouped_matmul_matches_ragged_dot(sizes):
    """Forward and both gradients against ``jax.lax.ragged_dot`` (the JAX
    package's CPU path), with empty groups, a 1-row group, and (last case)
    rows past the groups' sum, which give zeros."""
    rng = np.random.default_rng(0)
    m, k, n = 13, 8, 16
    lhs = rng.standard_normal((m, k), dtype=np.float32)
    rhs = rng.standard_normal((len(sizes), k, n), dtype=np.float32)
    cot = rng.standard_normal((m, n), dtype=np.float32)
    gs = np.asarray(sizes, np.int32)

    def jf(a, b):
        return jax.lax.ragged_dot(a, b, jnp.asarray(gs),
                                  preferred_element_type=jnp.float32)

    ref = jf(lhs, rhs)
    ref_da, ref_db = jax.grad(lambda a, b: jnp.sum(jf(a, b) * cot),
                              argnums=(0, 1))(lhs, rhs)
    a, b = _t(lhs).requires_grad_(), _t(rhs).requires_grad_()
    reset_counters()
    out = grouped_matmul(a, b, torch.from_numpy(gs))
    (out * _t(cot)).sum().backward()
    _close(out.detach(), ref)
    _close(a.grad, ref_da, GRAD_TOL)
    _close(b.grad, ref_db, GRAD_TOL)
    if sum(sizes) < m:
        assert float(out.detach()[sum(sizes):].abs().max()) == 0.0
    c = counters()
    assert [c[f"grouped_matmul{s}"]["plain_calls"]
            for s in ("", "_dgrad", "_wgrad")] == [1, 1, 1]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "cuda_core")])
@pytest.mark.parametrize("call", ["forward", "dgrad", "wgrad"])
def test_grouped_matmul_picks_its_kernel(call, dtype, route, monkeypatch):
    """The wrappers' choice of kernel on CUDA, in plain code: bf16 goes to
    the tensor-core kernels and fp32 to the CUDA-core ones. Driven on meta
    tensors (neither CPU nor CUDA) with every kernel wrapper replaced by a
    recorder, so the choice itself is what runs."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm

    took = []
    for name in ("gmm", "tgmm"):
        for r in ("sm90", "cuda_core"):
            monkeypatch.setattr(gm, f"{name}_{r}",
                                lambda *a, n=name, r=r: took.append((n, r)))
    lhs = torch.empty(40, 16, dtype=dtype, device="meta")
    rhs = torch.empty(3, 16, 24, dtype=dtype, device="meta")
    sizes = torch.empty(3, dtype=torch.int32, device="meta")
    if call == "wgrad":
        gm.tgmm(lhs, torch.empty(40, 24, dtype=dtype, device="meta"), sizes)
    else:
        gm.gmm(lhs, rhs, sizes, trans_rhs=call == "dgrad")
    assert took == [("tgmm" if call == "wgrad" else "gmm", route)]
    assert gm.takes_sm90(dtype) is (route == "sm90")


@pytest.mark.parametrize("wrapper", ["gmm_sm90", "dgrad_sm90", "tgmm_sm90"])
@pytest.mark.parametrize("case,error,match", [
    ("float32", TypeError, "bfloat16"),
    ("float16", TypeError, "float32 or bfloat16"),
    ("width12", ValueError, "multiples of 8"),
    ("groups129", ValueError, "groups"),
    ("cpu", ValueError, "CUDA tensors")])
def test_grouped_matmul_sm90_wrappers_reject_what_the_kernels_do_not_take(
        wrapper, case, error, match):
    """Each tensor-core wrapper raises, before any build or launch, on
    operands its kernel does not take (not bf16, a width that is not a
    multiple of 8, more than 128 groups) and on tensors off the card; it
    never falls back."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm

    dtype = {"float32": torch.float32,
             "float16": torch.float16}.get(case, torch.bfloat16)
    k = 12 if case == "width12" else 16
    g = 129 if case == "groups129" else 2
    lhs = torch.zeros(8, k, dtype=dtype)
    sizes = torch.full((g,), 4, dtype=torch.int32)
    reset_counters()
    with pytest.raises(error, match=match):
        if wrapper == "tgmm_sm90":
            gm.tgmm_sm90(lhs, torch.zeros(8, 24, dtype=dtype), sizes)
        else:
            gm.gmm_sm90(lhs, torch.zeros(g, k, 24, dtype=dtype), sizes,
                        trans_rhs=wrapper == "dgrad_sm90")
    assert all(v == {"launches": 0, "plain_calls": 0}
               for n, v in counters().items() if n.startswith("grouped"))


# -- routing, gather, combine ------------------------------------------------

def _router_inputs(n, h, e, seed):
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((n, h), dtype=np.float32)
    wg = 0.3 * rng.standard_normal((h, e), dtype=np.float32)
    return xt, wg


def _topk_margin(xt, wg, k):
    """Smallest gap between consecutive sorted probabilities among the top
    k + 1 of any token: no near-tie may decide the exact comparisons."""
    logits = xt.astype(np.float64) @ wg.astype(np.float64)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    top = -np.sort(-p, axis=1)[:, :k + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


@pytest.mark.parametrize("impl", ["interpret", "composed"])
@pytest.mark.parametrize("n,h,e,k", [(30, 24, 4, 2), (37, 16, 8, 1),
                                     (33, 8, 6, 3)])
def test_fused_route_matches_jax(impl, n, h, e, k):
    """Gates and aux within 1e-5; choices, positions and counts exact; the
    positions give the stable argsort's order. The seed's top-k margin is
    above 1e-5, so no near-tie decides the test."""
    xt, wg = _router_inputs(n, h, e, seed=n + e)
    assert _topk_margin(xt, wg, k) > 1e-5
    jgv, jgi, jpos, jcnt, jaux = jmoe.fused_route(jnp.asarray(xt),
                                                  jnp.asarray(wg), k, impl)
    reset_counters()
    gv, gi, pos, cnt, aux = fused_route(_t(xt), _t(wg), k)
    assert counters()["moe_route"] == {"launches": 0, "plain_calls": 1}
    _close(gv, jgv)
    _close(aux, jaux)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi, np.int32))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos, np.int32))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt, np.int32))
    flat_e = gi.numpy().reshape(-1)
    offsets = np.concatenate([[0], np.cumsum(cnt.numpy())[:-1]])
    dest = offsets[flat_e] + pos.numpy().reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    ref_dest = np.empty_like(order)
    ref_dest[order] = np.arange(len(order))
    np.testing.assert_array_equal(dest, ref_dest)


def test_route_ties_go_to_the_lowest_expert():
    """Equal logits: every token picks experts 0..k-1, in order."""
    xt = np.zeros((5, 8), np.float32)
    wg = np.ones((8, 6), np.float32)
    _gv, gi, pos, cnt, _aux = fused_route(_t(xt), _t(wg), 3)
    jgi = np.asarray(jmoe.fused_route(jnp.asarray(xt), jnp.asarray(wg), 3,
                                      "interpret")[1], np.int32)
    np.testing.assert_array_equal(gi.numpy(), jgi)
    np.testing.assert_array_equal(gi.numpy(), np.tile([0, 1, 2], (5, 1)))
    np.testing.assert_array_equal(cnt.numpy(), [5, 5, 5, 0, 0, 0])
    np.testing.assert_array_equal(pos.numpy()[:, 0], np.arange(5))


def _fixed_order_sum(parts):
    """Sum of ``parts`` [nb, e] over its rows in the routing kernels' order:
    lane q adds rows q, q + 32, ... in turn, then a butterfly over the 32
    lanes (xor 16, 8, 4, 2, 1)."""
    lanes = torch.zeros(32, parts.shape[1])
    for q in range(parts.shape[0]):
        lanes[q % 32] += parts[q]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ o]
    return lanes[0]


def _route_emulated(xt, wg, k, sms):
    """The routing kernels' plan in PyTorch: ``route_plan``'s blocks, each
    a contiguous run of tokens whose rows (token-major) get their rank
    among the block's rows of their expert; the exclusive scan of the
    block counts over the blocks gives each block's base, which the
    fix-up adds; the counts are the totals, me and ce the blocks' sums
    added in the kernels' fixed order."""
    from paddle_tpu_torch.kernels import moe_dispatch as md

    n, e = xt.shape[0], wg.shape[1]
    p = torch.softmax(xt.float() @ wg.float(), dim=-1)
    gv, gi = md.topk_first(p, k)
    gv = gv / gv.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    blocks, tokens = md.route_plan(n, sms)
    pos = torch.empty(n * k, dtype=torch.int64)
    blk_cnt = torch.zeros(blocks, e, dtype=torch.int64)
    blk_me = torch.zeros(blocks, e)
    blk_ce = torch.zeros(blocks, e)
    flat = gi.reshape(-1)
    for b in range(blocks):
        t0, t1 = b * tokens, min(n, (b + 1) * tokens)
        assert t0 < t1  # no block is empty
        rows = flat[t0 * k:t1 * k]
        oh = TF.one_hot(rows, e)
        pos[t0 * k:t1 * k] = ((torch.cumsum(oh, 0) - 1) * oh).sum(-1)
        blk_cnt[b] = oh.sum(0)
        for t in range(t0, t1):  # token order, as thread j adds them
            blk_me[b] += p[t]
        blk_ce[b] = TF.one_hot(gi[t0:t1, 0], e).sum(0).float()
    base = torch.cumsum(blk_cnt, 0) - blk_cnt
    pos += base[torch.arange(n * k) // (tokens * k), flat]
    return (gv, gi.to(torch.int32), pos.view(n, k).to(torch.int32),
            blk_cnt.sum(0).to(torch.int32), _fixed_order_sum(blk_me),
            _fixed_order_sum(blk_ce))


@pytest.mark.parametrize("n,h,e,k,sms,seed", [
    (37, 16, 8, 2, 4, 45),     # 8 blocks of 5 tokens, the last of 2
    (5, 16, 8, 1, 4, 13),      # fewer tokens than blocks: a token a block
    (100, 24, 16, 2, 3, 116),  # 6 blocks of 17, the last of 15
    (64, 16, 128, 8, 2, 1),    # 128 experts, top-8, 4 blocks of 16
    (300, 12, 128, 2, 132, 428)])
def test_routing_plan_emulation_matches_jax(n, h, e, k, sms, seed):
    """The routing kernels' block plan, emulated in PyTorch, against the
    JAX ``fused_route``: choices, positions and counts exact; gates and
    aux within 1e-5 (me summed per block, then over the blocks in a fixed
    order). The seeds keep every top-k margin above 1e-5."""
    xt, wg = _router_inputs(n, h, e, seed)
    assert _topk_margin(xt, wg, k) > 1e-5
    jgv, jgi, jpos, jcnt, jaux = jmoe.fused_route(jnp.asarray(xt),
                                                  jnp.asarray(wg), k,
                                                  "composed")
    gv, gi, pos, cnt, me, ce = _route_emulated(_t(xt), _t(wg), k, sms)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi, np.int32))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos, np.int32))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt, np.int32))
    _close(gv, jgv)
    _close(e * ((me / n) * (ce / n)).sum(), jaux)


@pytest.mark.parametrize("n,sms,blocks,tokens", [
    (1, 132, 1, 1), (200, 132, 200, 1), (264, 132, 264, 1),
    (265, 132, 133, 2), (8192, 132, 256, 32), (8448, 132, 264, 32),
    (8449, 132, 257, 33), (37, 4, 8, 5)])
def test_route_plan_covers_the_tokens(n, sms, blocks, tokens):
    """``route_plan``: at most the resident blocks (2 a SM), none empty,
    together exactly the n tokens; one token a block when there are fewer
    tokens than blocks."""
    from paddle_tpu_torch.kernels.moe_dispatch import route_plan

    assert route_plan(n, sms) == (blocks, tokens)
    assert blocks <= 2 * sms
    assert (blocks - 1) * tokens < n <= blocks * tokens


@pytest.mark.parametrize("impl", ["interpret", "composed"])
def test_gather_and_combine_match_jax(impl):
    rng = np.random.default_rng(3)
    src = rng.standard_normal((11, 16), dtype=np.float32)
    idx = rng.integers(0, 11, size=19).astype(np.int32)
    ref = jmoe._gather_rows(jnp.asarray(src), jnp.asarray(idx), impl)
    _close(gather_rows(_t(src), torch.from_numpy(idx)), ref)
    y = rng.standard_normal((20, 16), dtype=np.float32)
    gates = rng.random((7, 3), dtype=np.float32)
    dest2 = rng.integers(0, 20, size=(7, 3)).astype(np.int32)
    ref = jmoe._combine_rows(jnp.asarray(y), jnp.asarray(gates),
                             jnp.asarray(dest2), impl)
    reset_counters()
    got = combine_rows(_t(y), _t(gates), torch.from_numpy(dest2))
    _close(got, ref)
    assert counters()["moe_combine"]["plain_calls"] == 1


@pytest.mark.parametrize("impl", ["interpret", "composed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_gather_matches_jax_composition(impl, dtype):
    """``gather_rows(src, idx, scale)`` equals the JAX combine backward's
    composition ``(_gather_rows(src, idx).astype(f32) * scale[:, None])
    .astype(dtype)`` exactly, with scales of 0 and below 0. Indices -1
    and n_src give zero rows in the port (its kernel's contract); the
    reference leaves them undefined (the composed gather wraps -1 and fills
    past the end with NaN, the interpret-mode kernel clamps), so those
    rows are held to zero and the rest to the reference."""
    rng = np.random.default_rng(21)
    n_src, n_out, h = 11, 23, 16
    src = rng.standard_normal((n_src, h), dtype=np.float32)
    idx = rng.integers(0, n_src, size=n_out).astype(np.int32)
    idx[:2] = [-1, n_src]
    scale = rng.standard_normal(n_out).astype(np.float32)
    scale[2:5] = [0.0, -0.0, -2.5]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jsrc = jnp.asarray(src).astype(jdt)
    ref = (jmoe._gather_rows(jsrc, jnp.asarray(idx), impl)
           .astype(jnp.float32) * jnp.asarray(scale)[:, None]).astype(jdt)
    ref = np.asarray(ref.astype(jnp.float32))
    tsrc = torch.from_numpy(np.array(jsrc.astype(jnp.float32))).to(
        getattr(torch, dtype))
    reset_counters()
    got = gather_rows(tsrc, torch.from_numpy(idx), torch.from_numpy(scale))
    assert got.dtype == tsrc.dtype
    assert counters()["moe_gather"] == {"launches": 0, "plain_calls": 1}
    got = got.float().numpy()
    np.testing.assert_array_equal(got[2:], ref[2:])
    np.testing.assert_array_equal(got[:2], 0.0)
    unscaled = gather_rows(tsrc, torch.from_numpy(idx)).float().numpy()
    np.testing.assert_array_equal(unscaled[:2], 0.0)
    np.testing.assert_array_equal(
        unscaled[2:], np.asarray(jsrc.astype(jnp.float32))[idx[2:]])


# -- the fused MoE MLP ---------------------------------------------------------

def _moe_weights(h=32, e=4, i=48, seed=7):
    rng = np.random.default_rng(seed)
    return [0.1 * rng.standard_normal(s, dtype=np.float32)
            for s in ((h, e), (e, h, i), (e, h, i), (e, i, h))]


def _jax_loss(fn):
    def f(*args):
        o, aux = fn(*args)
        return jnp.sum(o * o) + 0.1 * aux
    return f


def _port_out_and_grads(fn, x, weights):
    leaves = [_t(a).requires_grad_() for a in [x] + weights]
    o, aux = fn(*leaves)
    ((o * o).sum() + 0.1 * aux).backward()
    return o.detach(), aux.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("ref", ["interpret", "composed", "gmm"])
def test_fused_moe_mlp_matches_jax(ref):
    """Output and aux within 1e-5, the gradients of x, the router and the
    three expert stacks within 1e-4, against the JAX fused path (Pallas in
    interpret mode, or composed) and its gmm dispatch; 30 tokens, which no
    kernel block size divides."""
    weights = _moe_weights()
    x = np.random.default_rng(4).standard_normal((2, 15, 32),
                                                 dtype=np.float32)
    assert _topk_margin(x.reshape(30, 32), weights[0], 2) > 1e-5
    if ref == "gmm":
        def jfn(*a):
            return jmoe_layer._moe_mlp_gmm(*a, top_k=2)
    else:
        def jfn(*a):
            return jmoe.fused_moe_mlp(*a, top_k=2, impl=ref)
    jargs = [jnp.asarray(a) for a in [x] + weights]
    jo, jaux = jfn(*jargs)
    jgrads = jax.grad(_jax_loss(jfn), argnums=tuple(range(5)))(*jargs)
    reset_counters()
    o, aux, grads = _port_out_and_grads(
        lambda *a: fused_moe_mlp(*a, top_k=2), x, weights)
    _close(o, jo)
    _close(aux, jaux)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, GRAD_TOL)
    c = counters()
    assert {n: c[n]["plain_calls"] for n in (
        "moe_route", "moe_gather", "moe_combine", "grouped_matmul",
        "grouped_matmul_dgrad", "grouped_matmul_wgrad")} == {
        "moe_route": 1, "moe_gather": 3, "moe_combine": 2,
        "grouped_matmul": 3, "grouped_matmul_dgrad": 3,
        "grouped_matmul_wgrad": 3}


@pytest.mark.parametrize("mode", ["index", "gmm"])
def test_moe_dispatch_modes_match_jax(mode):
    """The port's ``index`` (capacity = e: nothing dropped) and ``gmm``
    dispatch against the JAX package's, output and gradients."""
    weights = _moe_weights(seed=8)
    x = np.random.default_rng(5).standard_normal((2, 12, 32),
                                                 dtype=np.float32)

    def jfn(*a):
        return jmoe_layer._moe_mlp.fn(*a, top_k=2, capacity_factor=4.0,
                                      ep_degree=1, dispatch=mode)

    jargs = [jnp.asarray(a) for a in [x] + weights]
    jo, jaux = jfn(*jargs)
    jgrads = jax.grad(_jax_loss(jfn), argnums=tuple(range(5)))(*jargs)
    o, aux, grads = _port_out_and_grads(
        lambda *a: moe_mlp(*a, top_k=2, capacity_factor=4.0,
                           dispatch=mode), x, weights)
    _close(o, jo)
    _close(aux, jaux)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, GRAD_TOL)


def test_index_dispatch_drops_past_capacity():
    """With capacity_factor 0.5 the ``index`` path drops rows as the JAX
    one does (choice-major priority)."""
    weights = _moe_weights(seed=9)
    x = np.random.default_rng(6).standard_normal((1, 16, 32),
                                                 dtype=np.float32)
    jo, jaux = jmoe_layer._moe_mlp.fn(
        *[jnp.asarray(a) for a in [x] + weights], top_k=2,
        capacity_factor=0.5, ep_degree=1, dispatch="index")
    with torch.no_grad():
        o, aux = moe_mlp(*[_t(a) for a in [x] + weights], top_k=2,
                         capacity_factor=0.5, dispatch="index")
    _close(o, jo)
    _close(aux, jaux)


def test_moe_layer_flags_and_aux(moe_flags):
    """The layer reads ``FLAGS_moe_dispatch`` per call; fused and gmm agree;
    ``forward`` records its aux for ``collect_aux``; too many experts for
    the fused kernels, and unknown flag values, raise."""
    torch.manual_seed(0)
    layer = MoELayer(16, 4, intermediate_size=24)
    x = torch.randn(2, 5, 16)
    outs = {}
    for mode in ("fused", "gmm", "index"):
        moe_flags(mode)
        reset_counters()
        with collect_aux() as bucket:
            outs[mode] = layer(x)
        assert len(bucket) == 1
        outs[mode + "_aux"] = drain_aux(bucket)
        assert (counters()["moe_route"]["plain_calls"] == 1) == \
            (mode == "fused")
    _close(outs["fused"].detach(), outs["gmm"].detach())
    _close(outs["fused_aux"].detach(), outs["gmm_aux"].detach())
    with pytest.raises(ValueError, match="moe_dispatch"):
        set_flags({"FLAGS_moe_dispatch": "scatter"})
    with pytest.raises(ValueError, match="unknown flag"):
        set_flags({"FLAGS_nope": "index"})
    assert get_flags("moe_dispatch") == {"FLAGS_moe_dispatch": "index"}
    e = 130
    with pytest.raises(ValueError, match="128"):
        fused_moe_mlp(torch.zeros(1, 4, 8), torch.zeros(8, e),
                      torch.zeros(e, 8, 8), torch.zeros(e, 8, 8),
                      torch.zeros(e, 8, 8), top_k=2)


# -- the MoE Llama --------------------------------------------------------------

TINY = dict(ce_chunk=8)


def _numpy_state(jm, rng):
    state = {}
    for name, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if "norm" in name:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        state[name] = a.astype(np.float32)
    return state


def make_pair(seed=0, scan_layers=True, **cfg):
    """A JAX MoE Llama and the port's holding the same numpy weights."""
    cfg = {**TINY, **cfg}
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.LlamaMoEConfig.tiny(
        scan_layers=scan_layers, **cfg))
    state = _numpy_state(jm, np.random.default_rng(seed))
    jm.set_state_dict(state)
    pcfg = LlamaMoEConfig.tiny(**cfg)
    pm = LlamaForCausalLM(pcfg, device="cpu")
    pm.load_state_dict(llama_state_from_numpy(state, pcfg))
    return jm, pm, state


def _batch(seed=1, vocab=256):
    ids = np.random.default_rng(seed).integers(0, vocab, size=(3, 12))
    labels = ids.copy()
    labels[1, 4:7] = -100  # not counted
    return ids, labels


def test_moe_llama_matches_jax(moe_flags):
    """The tiny MoE Llama with fused dispatch and recompute: logits within
    1e-5, the labelled loss (CE + 0.01 x aux) within 1e-5, every
    parameter's gradient within 1e-4 (the JAX gradients of the stacked
    layers carried across by the converter)."""
    moe_flags("fused")
    jm, pm, _ = make_pair(use_recompute=True)
    ids, labels = _batch()
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    ref_logits = np.asarray(jm(jx).numpy())
    jm.train()
    jloss = jm(jx, labels=jy)
    jloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    with torch.no_grad():
        logits = pm(torch.from_numpy(ids))
    pm.train()
    reset_counters()
    loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    _close(logits, ref_logits)
    _close(loss.item(), float(jloss))
    ref = llama_state_from_numpy(jgrads, pm.config)
    for name, p in pm.named_parameters():
        _close(p.grad, ref[name], GRAD_TOL)
    # per step, with recompute: each layer's forward runs twice
    L = pm.config.num_hidden_layers
    c = counters()
    assert {n: c[n]["plain_calls"] for n in (
        "moe_route", "moe_gather", "moe_combine", "grouped_matmul",
        "grouped_matmul_dgrad", "grouped_matmul_wgrad")} == {
        "moe_route": 2 * L, "moe_gather": 4 * L, "moe_combine": 3 * L,
        "grouped_matmul": 6 * L, "grouped_matmul_dgrad": 3 * L,
        "grouped_matmul_wgrad": 3 * L}


def test_moe_recompute_equals_no_recompute(moe_flags):
    """Recompute changes what is kept, not what is computed: the loss and
    every gradient agree, the aux counted once per layer."""
    moe_flags("fused")
    ids, labels = _batch()
    runs = []
    for remat in (False, True):
        _jm, pm, _ = make_pair(seed=2, use_recompute=remat)
        pm.train()
        loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        runs.append((loss.item(), {n: p.grad for n, p in
                                   pm.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert l0 == pytest.approx(l1, rel=1e-6)
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_adafactor_curve_matches_unscanned_jax(moe_flags):
    """Three Adafactor steps (lr 1e-2) of the port's ``TrainStep`` against
    the JAX ``jit.TrainStep`` on the model built with ``scan_layers=False``
    (per-layer tensors, as the port keeps them: Adafactor's statistics are
    per tensor), fused dispatch; each loss within 1e-4."""
    moe_flags("fused")
    jm, pm, _ = make_pair(seed=3, scan_layers=False)
    pm.config.use_recompute = True
    ids, labels = _batch(seed=4)
    jstep = jjit.TrainStep(jm, lambda m, x, y: m(x, labels=y),
                           jopt.Adafactor(learning_rate=1e-2,
                                          parameters=jm.parameters()))
    pstep = TrainStep(pm, lambda m, x, y: m(x, labels=y),
                      Adafactor(learning_rate=1e-2,
                                parameters=pm.parameters()))
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    px, py = torch.from_numpy(ids), torch.from_numpy(labels)
    ref = [float(jstep(jx, jy)) for _ in range(3)]
    got = [float(pstep(px, py)) for _ in range(3)]
    np.testing.assert_allclose(got, ref, **GRAD_TOL)
    assert got[-1] < got[0] - 0.5


@pytest.mark.parametrize("shape", [(6,), (3, 4, 5)])
def test_adafactor_rule_matches_jax(shape):
    """Two steps of the rule on a 1-D tensor (plain ``v``) and a 3-D one
    (``vr``/``vc`` over the last two axes, statistics over the whole
    tensor), with a first moment, against the JAX ``Adafactor._rule``."""
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal(shape).astype(np.float32)
    gs = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    kw = dict(learning_rate=0.05, beta1=0.5)
    jo = jopt.Adafactor(parameters=[], **kw)
    jp, jstate = jnp.asarray(p0), jo._init_state(jnp.asarray(p0))
    p = torch.nn.Parameter(_t(p0))
    opt = Adafactor(parameters=[p], **kw)
    for step, g in enumerate(gs, start=1):
        jp, jstate = jopt.Adafactor._rule(
            jp, jnp.asarray(g), jstate, jnp.asarray(0.05, jnp.float32),
            jnp.asarray(step, jnp.int32), jo._hyper())
        p.grad = _t(g)
        opt.step()
        _close(p.detach(), jp)
    st = opt._state[id(p)]
    assert set(st) == set(jstate)
    for k, v in jstate.items():
        _close(st[k], v)
    opt.clear_grad()
    assert p.grad is None


def test_convert_moe_layouts():
    """Both JAX layouts of the MoE Llama convert to the same state: Linear
    weights transposed, the router and the expert stacks as they are; a
    missing, unexpected or misshapen entry raises."""
    _jm, pm, stacked = make_pair(seed=5)
    cfg = pm.config
    got = llama_state_from_numpy(stacked, cfg)
    assert set(got) == set(pm.state_dict())
    for li in range(cfg.num_hidden_layers):
        np.testing.assert_array_equal(
            got[f"llama.layers.{li}.mlp.gate_weight"].numpy(),
            stacked["llama.layers.mlp__gate_weight"][li])       # not .T
        np.testing.assert_array_equal(
            got[f"llama.layers.{li}.mlp.experts.down"].numpy(),
            stacked["llama.layers.mlp__experts__down"][li])
        np.testing.assert_array_equal(
            got[f"llama.layers.{li}.self_attn.q_proj.weight"].numpy(),
            stacked["llama.layers.self_attn__q_proj__weight"][li].T)
    # the unscanned layout: per-layer entries, Linear [in, out]
    paddle.seed(5)
    jm = jllama.LlamaForCausalLM(jllama.LlamaMoEConfig.tiny(
        scan_layers=False, **TINY))
    flat = {}
    for name, v in jm.state_dict().items():
        flat[name] = np.asarray(v.numpy())
    per = llama_state_from_numpy(flat, cfg)
    assert set(per) == set(got)
    np.testing.assert_array_equal(
        per["llama.layers.1.self_attn.k_proj.weight"].numpy(),
        flat["llama.layers.1.self_attn.k_proj.weight"].T)
    np.testing.assert_array_equal(
        per["llama.layers.1.mlp.experts.gate"].numpy(),
        flat["llama.layers.1.mlp.experts.gate"])
    np.testing.assert_array_equal(
        per["llama.layers.0.mlp.gate_weight"].numpy(),
        flat["llama.layers.0.mlp.gate_weight"])
    with pytest.raises(KeyError, match="missing"):
        llama_state_from_numpy({k: v for k, v in flat.items()
                                if "experts.up" not in k}, cfg)
    with pytest.raises(KeyError, match="unexpected"):
        llama_state_from_numpy({**stacked, "llama.layers.mlp__gate_proj__"
                                "weight": np.zeros(1)}, cfg)
    bad = dict(stacked)
    bad["llama.layers.mlp__gate_weight"] = np.zeros((2, 4, 128), np.float32)
    with pytest.raises(ValueError, match="gate_weight"):
        llama_state_from_numpy(bad, cfg)


def test_moe_counts_match_jax():
    """The flagship MoE config (bench.py ``_configs()["moe"]``): parameter
    and FLOP counts as the JAX formulas give them, 1,457,505,792 in all and
    551,536,128 activated per token; the tiny model's count is its own."""
    big = dict(vocab_size=32000, hidden_size=1536, intermediate_size=2048,
               num_hidden_layers=16, num_attention_heads=12,
               num_key_value_heads=12, max_position_embeddings=2048,
               num_experts=8, top_k=2)
    got = llama_moe_param_counts(LlamaMoEConfig(**big))
    assert got == jllama.llama_moe_param_counts(jllama.LlamaMoEConfig(**big))
    assert got == (1457505792, 551536128)
    assert llama_moe_flops_per_token(LlamaMoEConfig(**big), 2048) == \
        jllama.llama_moe_flops_per_token(jllama.LlamaMoEConfig(**big), 2048)
    cfg = LlamaMoEConfig.tiny()
    model = LlamaForCausalLM(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        llama_moe_param_counts(cfg)[0]
