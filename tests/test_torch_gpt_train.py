"""The port's GPT training path, attention composition and dropout against
the JAX package's, on the CPU.

Weights and inputs are drawn with numpy; the JAX package runs on its CPU
backend, the port its kernels' plain versions. All fp32. Tolerances: rtol
1e-5 for single functions and the loss, 1e-4 for gradients (both sum in
different orders) and for loss curves.

The JAX dropouts draw their keep masks from ``jax.random`` keys and the
port's from a ``torch.Generator``, so the formulas are compared by drawing
the mask with ``jax.random.bernoulli`` from the JAX function's own key and
handing it to the port's composition in place of its draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import gpt_param_count as jgpt_param_count
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.nn.functional import common as jcommon
from paddle_tpu_torch.device import seed as pt_seed
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import counters, reset_counters
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     gpt_param_count, gpt_state_from_numpy)
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention as pattn
from paddle_tpu_torch.nn.functional import common as pcommon
from paddle_tpu_torch.optimizer import AdamW

SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, max_position_embeddings=64)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


@pytest.fixture
def clip_embedding():
    """Eager ``F.embedding`` of the JAX package crashes under jax 0.9 with
    the default 'error' OOV policy; 'clip' takes the path that works.
    Restored afterwards."""
    from paddle_tpu.framework import flags as flags_mod

    prior = flags_mod.get_flags(["FLAGS_embedding_oov_policy"])
    paddle.set_flags({"FLAGS_embedding_oov_policy": "clip"})
    yield
    paddle.set_flags(prior)


def _numpy_state(jm, rng):
    state = {}
    for name, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if ".ln_" in name and name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = 0.3 * rng.standard_normal(shape)
        state[name] = a.astype(np.float32)
    return state


def make_pair(seed=0, **cfg):
    """A JAX GPT and the port's GPT holding the same numpy weights."""
    cfg = {**SMALL, **cfg}
    paddle.seed(seed)
    jm = JGPTForCausalLM(JGPTConfig(**cfg, dtype="float32"))
    state = _numpy_state(jm, np.random.default_rng(seed))
    jm.set_state_dict(state)
    pcfg = GPTConfig(**cfg, dtype="float32")
    pm = GPTForCausalLM(pcfg, device="cpu")
    pm.load_state_dict(gpt_state_from_numpy(state, pcfg))
    return jm, pm, state


def _batch(seed=1, rows=3, cols=12, vocab=64):
    ids = np.random.default_rng(seed).integers(0, vocab, size=(rows, cols))
    labels = ids.copy()
    labels[1, 4:7] = -100  # not counted
    labels[2, -1] = -100
    return ids, labels


def _port_loss_and_grads(pm, ids, labels):
    pm.train()
    pm.zero_grad(set_to_none=True)
    loss = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


# -- the GPT training path -------------------------------------------------------

@pytest.mark.parametrize("recompute", [False, True])
def test_labelled_loss_and_gradients_match_jax(clip_embedding, recompute):
    """``forward(ids, labels=)`` (the chunked fused CE, labels of -100 not
    counted) within rtol 1e-5, and every parameter's gradient within 1e-4,
    against the JAX ``GPTForCausalLM(labels=)``, recompute on and off."""
    jm, pm, _ = make_pair(use_recompute=recompute)
    ids, labels = _batch()
    jm.train()
    jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    reset_counters()
    loss, grads = _port_loss_and_grads(pm, ids, labels)
    _close(loss, float(jloss))
    ref = gpt_state_from_numpy(jgrads, pm.config)
    assert set(ref) == set(grads)
    for name, g in grads.items():
        _close(g, ref[name], GRAD_TOL)
    L = pm.config.num_hidden_layers
    # recompute runs every layer's forward again in the backward
    assert counters()["flash_attention"]["plain_calls"] == \
        (2 * L if recompute else L)
    assert counters()["flash_attention_bwd_dq"]["plain_calls"] == L


def test_adamw_trainstep_curve_matches_jax(clip_embedding):
    """Ten AdamW steps (lr 3e-3, weight decay 0.1) of the port's
    ``TrainStep`` on ``m(x, labels=y)`` against the JAX ``jit.TrainStep``:
    each loss within rtol 1e-4."""
    jm, pm, _ = make_pair(seed=3, use_recompute=True)
    ids, labels = _batch(seed=4)
    jstep = jjit.TrainStep(
        jm, lambda m, x, y: m(x, labels=y),
        jopt.AdamW(learning_rate=3e-3, parameters=jm.parameters(),
                   weight_decay=0.1))
    pstep = TrainStep(pm, lambda m, x, y: m(x, labels=y),
                      AdamW(learning_rate=3e-3, parameters=pm.parameters(),
                            weight_decay=0.1))
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    px, py = torch.from_numpy(ids), torch.from_numpy(labels)
    ref = [float(jstep(jx, jy)) for _ in range(10)]
    got = [float(pstep(px, py)) for _ in range(10)]
    _close(got, ref, dict(rtol=1e-4, atol=0))
    assert got[-1] < got[0] - 0.5  # it learns the repeated batch


def test_converter_round_trips_with_dropout_fields(clip_embedding):
    """The dropout fields carry no weights: the converter gives the same
    tensors with them set as without, a model built with them loads them
    strictly, and its eval logits match the JAX model's."""
    drop = dict(attention_probs_dropout_prob=0.1, hidden_dropout_prob=0.2,
                use_recompute=True)
    jm, pm, state = make_pair(seed=5, **drop)
    assert pm.config.hidden_dropout_prob == 0.2
    plain = gpt_state_from_numpy(state, GPTConfig(**SMALL, dtype="float32"))
    for name, t in gpt_state_from_numpy(state, pm.config).items():
        assert torch.equal(t, plain[name]), name
        assert torch.equal(pm.state_dict()[name], t), name
    ids, _ = _batch(seed=6)
    jm.eval()
    pm.eval()
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    _close(got, ref)


def test_param_count_and_presets():
    for name in ("gpt2_small", "gpt2_xl", "gpt3_6_7b"):
        assert gpt_param_count(getattr(GPTConfig, name)()) == \
            jgpt_param_count(getattr(JGPTConfig, name)())
    cfg = GPTConfig.tiny()
    model = GPTForCausalLM(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == gpt_param_count(cfg)
    xl = GPTConfig.gpt2_xl()
    assert (xl.hidden_size, xl.num_hidden_layers, xl.num_attention_heads,
            xl.intermediate_size) == (1600, 48, 25, 6400)
    assert gpt_param_count(GPTConfig.gpt3_6_7b()) == 6_658_596_864


# -- dropout in the model ----------------------------------------------------------

DROP = dict(attention_probs_dropout_prob=0.1, hidden_dropout_prob=0.1)


def _dropout_run(recompute, dropout_seed=7, **cfg):
    model = GPTForCausalLM(GPTConfig.tiny(use_recompute=recompute,
                                          **{**DROP, **cfg}),
                           device="cpu", generator=pt_seed(1, "cpu"),
                           dropout_seed=dropout_seed)
    ids = torch.from_numpy(_batch(seed=8, vocab=256)[0])
    model.train()
    loss = model(ids, labels=ids)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(loss.detach()), grads, model.dropout_generator.get_state()


def test_recompute_with_dropout_equals_no_recompute():
    """p = 0.1 in attention and on the residuals, one generator state:
    with recompute the loss, every gradient and the generator's state
    afterwards equal the run without it bit for bit (the recompute replays
    the first run's masks). Without the replay the recompute draws new
    masks and the gradients differ."""
    l0, g0, s0 = _dropout_run(False)
    l1, g1, s1 = _dropout_run(True)
    assert l0 == l1
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert torch.equal(s0, s1)
    l2, g2, _ = _dropout_run(False, dropout_seed=8)
    assert l2 != l0  # the seed moves the masks


def test_recompute_without_the_tape_would_redraw(monkeypatch):
    """The check above is sensitive: without the rewind (the generator set
    back to where the layer's first run began) the recomputed layers draw
    fresh masks and the gradients move."""
    _l0, g0, _ = _dropout_run(False)
    monkeypatch.setattr("paddle_tpu_torch.models.gpt.rewinding",
                        lambda fn, gens: fn)
    _l1, g1, _ = _dropout_run(True)
    assert not all(torch.equal(g0[n], g1[n]) for n in g0)


def test_recompute_keeps_no_mask(monkeypatch):
    """Recompute holds no keep mask from the forward to the backward: with
    it only the embeddings' mask (drawn outside the checkpointed layers)
    is still alive after the forward; without it every layer's masks are,
    saved for the backward."""
    import gc
    import weakref

    alive = {}
    real = pcommon.keep_mask
    for recompute in (False, True):
        drawn = []

        def recording(*a):
            m = real(*a)
            drawn.append(weakref.ref(m))
            return m
        monkeypatch.setattr(pcommon, "keep_mask", recording)
        monkeypatch.setattr("paddle_tpu_torch.nn.functional.attention."
                            "keep_mask", recording)
        model = GPTForCausalLM(GPTConfig.tiny(use_recompute=recompute,
                                              **DROP),
                               device="cpu", generator=pt_seed(1, "cpu"))
        ids = torch.from_numpy(_batch(seed=8, vocab=256)[0])
        loss = model(ids, labels=ids)
        gc.collect()
        alive[recompute] = (sum(r() is not None for r in drawn), len(drawn))
        loss.backward()
    layers = GPTConfig.tiny().num_hidden_layers
    assert alive[False] == (1 + 3 * layers, 1 + 3 * layers)
    assert alive[True] == (1, 1 + 3 * layers)


def test_rewinding_draws_the_first_runs_numbers_again():
    """A wrapped function's later calls draw from the generator what its
    first call drew and leave the generator where it was; a region nested
    in a rewound one rewinds to that rewound state; no generator, no
    wrapper."""
    g = pt_seed(5, "cpu")

    def inner(x):
        return x + torch.rand(3, generator=g)

    def outer(x):
        a = x + torch.rand(4, generator=g)[:1]
        run = pcommon.rewinding(inner, [g])
        return a, run(a), run(a)

    wrapped = pcommon.rewinding(outer, [g])
    first = wrapped(torch.zeros(1))
    after = g.get_state()
    again = wrapped(torch.zeros(1))
    assert torch.equal(g.get_state(), after)
    for x, y in zip(first, again):
        assert torch.equal(x, y)
    assert torch.equal(first[1], first[2])
    assert not torch.equal(torch.rand(3, generator=g), first[1] - first[0])
    assert pcommon.rewinding(inner, []) is inner


def test_eval_mode_equals_p_zero():
    """In eval mode the dropouts do nothing: the logits of a model with p
    0.1 equal those of the same weights with p 0, and training mode draws
    masks that move them."""
    ids = torch.from_numpy(_batch(seed=9, vocab=256)[0])
    with_p = GPTForCausalLM(GPTConfig.tiny(**DROP), device="cpu",
                            generator=pt_seed(2, "cpu"))
    no_p = GPTForCausalLM(GPTConfig.tiny(), device="cpu",
                          generator=pt_seed(2, "cpu"))
    with_p.eval()
    no_p.eval()
    with torch.no_grad():
        a, b = with_p(ids), no_p(ids)
        assert torch.equal(a, b)
        with_p.train()
        assert not torch.equal(with_p(ids), b)


def test_accumulate_remat_replays_the_masks():
    """``TrainStep.accumulate(2, remat=True)`` checkpoints each microbatch's
    whole loss around the layers' own checkpoints: its window equals the
    one without remat bit for bit (nested rewinds draw the same masks)."""
    ids = torch.from_numpy(_batch(seed=10, rows=4, vocab=256)[0])
    out = []
    for remat in (False, True):
        model = GPTForCausalLM(GPTConfig.tiny(use_recompute=True, **DROP),
                               device="cpu", generator=pt_seed(3, "cpu"))
        step = TrainStep(model, lambda m, x, y: m(x, labels=y),
                         AdamW(learning_rate=1e-3,
                               parameters=model.parameters()))
        loss = step.accumulate(2, remat=remat)(ids, ids)
        out.append((float(loss), [p.detach().clone()
                                  for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# -- attention: the additive mask and dropout -------------------------------------

def _qkv(seed, b=2, sq=5, sk=7, h=3, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_shape", [(2, 3, 5, 7), (1, 1, 5, 7), (7,)])
def test_sdpa_with_an_additive_mask_matches_jax(causal, mask_shape):
    """The composition with an additive fp32 mask (broadcast from its
    shape), causal and not, against the JAX ``_sdpa_mask``: output and the
    gradients of q, k, v and the mask within rtol 1e-5."""
    q, k, v = _qkv(11)
    rng = np.random.default_rng(12)
    mask = np.where(rng.random(mask_shape) < 0.3, -1e4,
                    rng.standard_normal(mask_shape)).astype(np.float32)
    scale = 0.4
    w = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)

    def jfn(q_, k_, v_, m_):
        return jattn._sdpa_mask.fn(q_, k_, v_, m_, causal=causal, scale=scale)

    args = [jnp.asarray(a) for a in (q, k, v, mask)]
    ref = jfn(*args)
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                      argnums=(0, 1, 2, 3))(*args)
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, mask)]
    reset_counters()
    out = F.scaled_dot_product_attention(*targs[:3], attn_mask=targs[3],
                                         is_causal=causal, scale=scale)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach(), ref)
    for t, jg in zip(targs, jgrads):
        _close(t.grad, jg)
    # the composition, not the flash kernels' plain versions
    assert counters()["flash_attention"]["plain_calls"] == 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_sdpa_dropout_formula_matches_jax(causal, with_mask, monkeypatch):
    """The JAX ``_sdpa_dropout`` / ``_sdpa_mask_dropout`` against the port's
    composition given the keep mask that the JAX function draws from its
    key (``jax.random.bernoulli(key, 1 - p, probs.shape)``): output and the
    gradients of q, k and v within rtol 1e-5."""
    q, k, v = _qkv(13)
    p = 0.3
    key = jax.random.PRNGKey(5)
    mask = np.random.default_rng(14).standard_normal((1, 3, 5, 7)).astype(
        np.float32)
    w = np.random.default_rng(15).standard_normal((2, 5, 3, 8)).astype(
        np.float32)
    args = [jnp.asarray(a) for a in (q, k, v)]

    def jfn(q_, k_, v_):
        if with_mask:
            return jattn._sdpa_mask_dropout.fn(
                q_, k_, v_, jnp.asarray(mask), key, causal=causal,
                scale=0.35, dropout_p=p)
        return jattn._sdpa_dropout.fn(q_, k_, v_, key, causal=causal,
                                      scale=0.35, dropout_p=p)

    ref = jfn(*args)
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                      argnums=(0, 1, 2))(*args)
    keep = torch.from_numpy(np.asarray(
        jax.random.bernoulli(key, 1.0 - p, (2, 3, 5, 7))))
    drawn = []

    def jax_keep(shape, p_, generator, device):
        drawn.append((tuple(shape), p_))
        return keep

    monkeypatch.setattr(pattn, "keep_mask", jax_keep)
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = F.scaled_dot_product_attention(
        *targs, attn_mask=torch.from_numpy(mask) if with_mask else None,
        dropout_p=p, is_causal=causal, scale=0.35)
    (out * torch.from_numpy(w)).sum().backward()
    assert drawn == [((2, 3, 5, 7), p)]
    _close(out.detach(), ref)
    for t, jg in zip(targs, jgrads):
        _close(t.grad, jg)


def test_sdpa_takes_the_flash_route_without_mask_or_dropout():
    """No mask and no dropout in training (or dropout outside training):
    the flash kernels (their plain versions on the CPU), not the
    composition; ``flash_attention`` is the same function."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, sq=7))
    assert F.flash_attention is F.scaled_dot_product_attention
    for kw in ({}, {"dropout_p": 0.5, "training": False}):
        reset_counters()
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True, **kw)
        assert counters()["flash_attention"]["plain_calls"] == 1
    reset_counters()
    comp = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          attn_mask=torch.zeros(7))
    assert counters()["flash_attention"]["plain_calls"] == 0
    _close(comp, out)


# -- F.dropout and nn.Dropout ---------------------------------------------------------

@pytest.mark.parametrize("mode,upscale", [("upscale_in_train", True),
                                          ("downscale_in_infer", False)])
def test_dropout_formula_matches_jax(mode, upscale, monkeypatch):
    """The JAX ``_dropout`` against the port's ``F.dropout`` given the keep
    mask the JAX function draws from its key, in training; outside
    training the JAX ``dropout``'s identity or ``x * (1 - p)``."""
    x = np.random.default_rng(17).standard_normal((4, 6, 5)).astype(
        np.float32)
    p = 0.25
    key = jax.random.PRNGKey(9)
    ref = jcommon._dropout.fn(jnp.asarray(x), key, p=p, upscale=upscale)
    keep = torch.from_numpy(np.asarray(
        jax.random.bernoulli(key, 1.0 - p, x.shape)))
    monkeypatch.setattr(pcommon, "keep_mask", lambda *a: keep)
    got = F.dropout(torch.from_numpy(x), p, training=True, mode=mode)
    _close(got, ref)
    jeval = jcommon.dropout(paddle.to_tensor(x), p, training=False,
                            mode=mode)
    _close(F.dropout(torch.from_numpy(x), p, training=False, mode=mode),
           np.asarray(jeval.numpy()))


def test_dropout_layer_draws_from_its_generator():
    """``nn.Dropout`` draws from the generator it holds: one seed, one
    mask; the keep share is 1 - p within 4 sigma; eval, p = 0 and the
    argument checks."""
    x = torch.ones(64, 1000)
    a, b = Dropout(0.1, generator=pt_seed(4, "cpu")), \
        Dropout(0.1, generator=pt_seed(4, "cpu"))
    ya, yb = a(x), b(x)
    assert torch.equal(ya, yb)
    assert not torch.equal(a(x), ya)  # the generator moved on
    n = x.numel()
    share = float((ya != 0).float().mean())
    assert abs(share - 0.9) <= 4 * (0.9 * 0.1 / n) ** 0.5
    assert torch.allclose(ya[ya != 0], torch.tensor(1 / 0.9))
    a.eval()
    assert torch.equal(a(x), x)
    assert torch.equal(Dropout(0.0)(x), x)
    with pytest.raises(NotImplementedError, match="axis"):
        F.dropout(x, 0.5, axis=1)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.5, mode="nope")


def test_graph_registration_finds_the_active_generators(monkeypatch):
    """The graphed step registers the CUDA generators of the model's
    active dropouts (p > 0), each once; on a torch that cannot register a
    generator with a CUDA graph, a model with active dropout raises rather
    than replay one mask forever."""
    import types

    from paddle_tpu_torch.jit import _dropout_generators
    from paddle_tpu_torch.models import GPTAttention

    # this torch may be built without CUDA graphs: give it the call
    monkeypatch.setattr(torch.cuda.CUDAGraph, "register_generator_state",
                        lambda self, gen: None, raising=False)
    model = GPTForCausalLM(GPTConfig.tiny(**DROP), device="cpu")
    assert _dropout_generators(model) == []  # a CPU generator: no graph
    cuda_gen = types.SimpleNamespace(device=torch.device("cuda"))
    for m in model.modules():
        if isinstance(m, (Dropout, GPTAttention)):
            m.generator = cuda_gen
    assert _dropout_generators(model) == [cuda_gen]
    quiet = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    for m in quiet.modules():
        if isinstance(m, (Dropout, GPTAttention)):
            m.generator = cuda_gen
    assert _dropout_generators(quiet) == []  # p = 0 draws nothing
    monkeypatch.delattr(torch.cuda.CUDAGraph, "register_generator_state")
    with pytest.raises(RuntimeError, match="replay one mask"):
        _dropout_generators(model)
    assert _dropout_generators(quiet) == []
