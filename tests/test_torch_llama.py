"""The port's Llama training path against the JAX package's.

Weights are drawn with numpy, set into the JAX ``LlamaForCausalLM`` (its
scanned, stacked layer stack) and carried across by
``paddle_tpu_torch.models.llama_state_from_numpy``; the port runs on the CPU
(its kernels' plain versions), the JAX model on the CPU backend, both in
fp32.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.device import seed as pt_seed
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import counters, reset_counters
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_flops_per_token,
                                     llama_param_count,
                                     llama_state_from_numpy)
from paddle_tpu_torch.optimizer import AdamW

# three rows of 12 tokens: 33 next-token targets in 4 CE chunks of 9
# (3 padded rows), so the chunking and its padding mask are exercised
TINY = dict(ce_chunk=8)


@pytest.fixture
def jax_flags():
    """Eager ``F.embedding`` of the JAX package crashes under jax 0.9 with
    the default 'error' OOV policy; 'clip' takes the path that works. The
    fused-kernel gate is set per test. Both restored afterwards."""
    from paddle_tpu.framework import flags as flags_mod

    names = ["FLAGS_embedding_oov_policy", "FLAGS_fused_kernels"]
    prior = flags_mod.get_flags(names)
    paddle.set_flags({"FLAGS_embedding_oov_policy": "clip"})
    yield
    paddle.set_flags(prior)


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


def make_pair(seed=0, **cfg):
    """A JAX Llama and the port's Llama holding the same numpy weights."""
    cfg = {**TINY, **cfg}
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = _numpy_state(jm, np.random.default_rng(seed))
    jm.set_state_dict(state)
    pcfg = LlamaConfig.tiny(**cfg)
    pm = LlamaForCausalLM(pcfg, device="cpu")
    pm.load_state_dict(llama_state_from_numpy(state, pcfg))
    return jm, pm, state


def _batch(seed=1, vocab=256):
    ids = np.random.default_rng(seed).integers(0, vocab, size=(3, 12))
    labels = ids.copy()
    labels[1, 4:7] = -100  # not counted
    return ids, labels


def test_convert_splits_the_stacked_layers():
    jm, pm, state = make_pair()
    cfg = pm.config
    got = llama_state_from_numpy(state, cfg)
    assert set(got) == set(pm.state_dict())
    stacked = state["llama.layers.self_attn__k_proj__weight"]  # [L, in, out]
    assert stacked.shape == (2, 128, 64)
    for li in range(cfg.num_hidden_layers):
        np.testing.assert_array_equal(
            got[f"llama.layers.{li}.self_attn.k_proj.weight"].numpy(),
            stacked[li].T)
        np.testing.assert_array_equal(
            got[f"llama.layers.{li}.post_attention_layernorm.weight"]
            .numpy(), state["llama.layers.post_attention_layernorm__weight"]
            [li])
    np.testing.assert_array_equal(got["lm_head.weight"].numpy(),
                                  state["lm_head.weight"].T)
    np.testing.assert_array_equal(pm.llama.layers[1].mlp.down_proj.weight
                                  .detach().numpy(),
                                  state["llama.layers.mlp__down_proj__weight"]
                                  [1].T)
    with pytest.raises(KeyError, match="missing"):
        llama_state_from_numpy({}, cfg)
    bad = dict(state)
    bad["llama.norm.weight"] = np.zeros(127, np.float32)
    with pytest.raises(ValueError, match="llama.norm.weight"):
        llama_state_from_numpy(bad, cfg)
    with pytest.raises(KeyError, match="unexpected"):
        llama_state_from_numpy({**state, "extra": np.zeros(1)}, cfg)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_logits_and_loss_match_jax(jax_flags, fused):
    """fp32 logits and the labelled (chunked, masked) loss, with the JAX
    package's fused-kernel gate open and closed; tolerance 1e-5 (the two
    sum in different orders). GQA: 4 heads over 2 key/value heads."""
    paddle.set_flags({"FLAGS_fused_kernels": fused})
    jm, pm, _ = make_pair()
    ids, labels = _batch()
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    ref_loss = float(jm(paddle.to_tensor(ids),
                        labels=paddle.to_tensor(labels)))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
        loss = float(pm(torch.from_numpy(ids),
                        labels=torch.from_numpy(labels)))
        from_logits = float(pm.loss_from_logits(torch.from_numpy(got),
                                                torch.from_numpy(labels)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(from_logits, loss, rtol=1e-5)


def test_adamw_loss_curve_matches_jax_trainstep(jax_flags):
    """Ten AdamW steps (lr 3e-3, weight decay 0.1) of the port's
    ``TrainStep`` against the JAX ``jit.TrainStep`` on the same weights and
    batch: each step's fp32 loss within rtol 1e-4."""
    jm, pm, _ = make_pair(seed=3)
    ids, labels = _batch(seed=4)
    jopt_ = jopt.AdamW(learning_rate=3e-3, parameters=jm.parameters(),
                       weight_decay=0.1)
    jstep = jjit.TrainStep(jm, lambda m, x, y: m(x, labels=y), jopt_)
    popt = AdamW(learning_rate=3e-3, parameters=pm.parameters(),
                 weight_decay=0.1)
    pstep = TrainStep(pm, lambda m, x, y: m(x, labels=y), popt)
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    px, py = torch.from_numpy(ids), torch.from_numpy(labels)
    ref = [float(jstep(jx, jy)) for _ in range(10)]
    got = [float(pstep(px, py)) for _ in range(10)]
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[-1] < got[0] - 0.5  # it learns the repeated batch


def test_head_dim_256_with_one_kv_head_matches_jax(jax_flags):
    """Head dim 256 (hidden 512 over 2 heads) with one key/value head, which
    the attention repeats to both heads: the shape of the card's
    ``llama-d256`` step (Gemma 2B's attention) at tiny widths. On the same
    numpy weights the fp32 logits within 1e-4 (rows of 512 and logits up to
    ~10 summed in different orders: 2.8e-5 seen) and the labelled loss
    within rtol 1e-5 of the JAX Llama's, and every parameter's gradient
    within 1e-4 (rtol and atol); on the CPU the
    attention runs the flash kernels' plain versions, once a layer each."""
    jm, pm, _ = make_pair(seed=7, hidden_size=512, num_attention_heads=2,
                          num_key_value_heads=1)
    assert pm.llama.layers[0].self_attn.head_dim == 256
    ids, labels = _batch(seed=8)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    jm.train()
    jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    reset_counters()
    loss, grads = _loss_and_grads(pm, ids, labels)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = llama_state_from_numpy(jgrads, pm.config)
    assert set(want) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    c = counters()
    for kernel in ("flash_attention", "flash_attention_bwd_dkv",
                   "flash_attention_bwd_dq"):
        assert c[kernel] == {"launches": 0, "plain_calls": 2}, kernel


def _loss_and_grads(model, ids, labels):
    model.train()
    loss = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    return float(loss.detach()), grads


def test_recompute_equals_no_recompute():
    """Per-layer checkpointing changes what is kept, not what is computed:
    loss and every gradient agree, and the forward kernels run twice."""
    ids, labels = _batch()
    runs = []
    for remat in (False, True):
        cfg = LlamaConfig.tiny(use_recompute=remat, **TINY)
        model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=pt_seed(5, "cpu"))
        reset_counters()
        runs.append((_loss_and_grads(model, ids, labels), counters()))
    (l0, g0), c0 = runs[0]
    (l1, g1), c1 = runs[1]
    assert l0 == pytest.approx(l1, rel=1e-6)
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=1e-5, atol=1e-7)
    L = 2
    assert c0["rope"]["plain_calls"] == 2 * L
    assert c1["rope"]["plain_calls"] == 4 * L
    assert c1["rope_inverse"]["plain_calls"] == 2 * L
    assert c1["flash_attention"]["plain_calls"] == 2 * L
    assert c1["rms_norm"]["plain_calls"] == 2 * L + 1  # + the final norm
    assert c1["rms_norm_residual_bwd"]["plain_calls"] == L


def test_tie_word_embeddings():
    """A tied head is the embedding itself: logits = hidden @ E^T and the
    one parameter's gradient is the sum of its uses. (The JAX package's
    tied head multiplies by E without the transpose and fails unless vocab
    equals hidden, so the check is against the port's untied model.)"""
    ids, labels = _batch()
    tied = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=True,
                                             **TINY),
                            device="cpu", generator=pt_seed(6, "cpu"))
    assert tied.lm_head.weight is tied.llama.embed_tokens.weight
    assert len(list(tied.parameters())) == len(tied.state_dict()) - 1
    untied = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    sd = dict(tied.state_dict())
    sd["lm_head.weight"] = sd["lm_head.weight"].clone()
    untied.load_state_dict(sd)
    lt, gt = _loss_and_grads(tied, ids, labels)
    lu, gu = _loss_and_grads(untied, ids, labels)
    assert lt == pytest.approx(lu, rel=1e-6)
    np.testing.assert_allclose(
        gt["llama.embed_tokens.weight"].numpy(),
        (gu["llama.embed_tokens.weight"] + gu["lm_head.weight"]).numpy(),
        rtol=1e-5, atol=1e-7)
    # the converter reads a tied JAX state (no lm_head entry)
    state = {k: v.numpy() for k, v in untied.state_dict().items()}
    jstate = {"llama.embed_tokens.weight": state["llama.embed_tokens.weight"],
              "llama.norm.weight": state["llama.norm.weight"]}
    names = {"self_attn.q_proj.weight": True, "self_attn.k_proj.weight": True,
             "self_attn.v_proj.weight": True, "self_attn.o_proj.weight": True,
             "mlp.gate_proj.weight": True, "mlp.up_proj.weight": True,
             "mlp.down_proj.weight": True, "input_layernorm.weight": False,
             "post_attention_layernorm.weight": False}
    for leaf, linear in names.items():
        per = [state[f"llama.layers.{i}.{leaf}"] for i in range(2)]
        jstate["llama.layers." + leaf.replace(".", "__")] = np.stack(
            [a.T for a in per] if linear else per)
    back = llama_state_from_numpy(jstate, tied.config)
    assert back["lm_head.weight"] is back["llama.embed_tokens.weight"]
    for name, t in back.items():
        np.testing.assert_array_equal(t.numpy(), state[name])


def test_counts_and_device(monkeypatch):
    """Parameter and FLOP counts agree with the JAX package's formulas and
    with the model; the model raises without a card unless asked for the
    CPU."""
    big = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
               num_hidden_layers=20, num_attention_heads=16,
               num_key_value_heads=16, max_position_embeddings=2048)
    assert llama_param_count(LlamaConfig(**big)) == \
        jllama.llama_param_count(jllama.LlamaConfig(**big))
    assert llama_flops_per_token(LlamaConfig(**big), 2048) == \
        jllama.llama_flops_per_token(jllama.LlamaConfig(**big), 2048)
    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        llama_param_count(cfg)
    assert model.lm_head.weight.device.type == "cpu"
    assert float(model.llama.norm.weight.detach().min()) == 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(cfg)


def test_adamw_rule_and_decay_selection():
    """One step from zero moments against the JAX ``AdamW`` step on the
    same inputs (``Adam._rule``, bias corrections in fp32, plus the
    decoupled decay lr * wd * p_old), applied only where
    ``apply_decay_param_fun(name)`` says so; moments keep the parameter's
    dtype."""
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor as JTensor
    from paddle_tpu.nn.layer.layers import Parameter as JParameter

    p0 = np.array([1.0, -2.0, 0.5], np.float32)
    g = np.array([0.3, -0.1, 2.0], np.float32)
    ja, jb = (JParameter(jnp.asarray(p0), name=n) for n in ("w", "norm.w"))
    jo = jopt.AdamW(learning_rate=0.1, parameters=[ja, jb], weight_decay=0.5,
                    apply_decay_param_fun=lambda n: "norm" not in n)
    ja.grad, jb.grad = JTensor(jnp.asarray(g)), JTensor(jnp.asarray(g))
    jo.step()
    a = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    b = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    a.grad, b.grad = torch.from_numpy(g.copy()), torch.from_numpy(g.copy())
    opt = AdamW(learning_rate=0.1, parameters=[("w", a), ("norm.w", b)],
                weight_decay=0.5,
                apply_decay_param_fun=lambda n: "norm" not in n)
    opt.step()
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja.data),
                               rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb.data),
                               rtol=1e-6)
    # the decay went to "w" alone
    assert not np.allclose(np.asarray(ja.data), np.asarray(jb.data))
    st = opt._state[id(a)]
    assert st["moment1"].dtype == a.dtype
    np.testing.assert_allclose(
        st["moment1"].numpy(),
        np.asarray(jo._accumulators[id(ja)]["moment1"]), rtol=1e-6)
    opt.clear_grad()
    assert a.grad is None
    with pytest.raises(ValueError, match="names"):
        AdamW(parameters=[a], apply_decay_param_fun=lambda n: True)
