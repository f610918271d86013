"""Speculative decoding and weight swaps in the port's ``GenerationEngine``
against the JAX package's, on the same numpy-drawn weights (fp32, CPU).

The port's window step and draft prefill run their kernels' plain versions
on the CPU; the JAX engine runs its composed window step. The JAX draft
prefill is an eager forward, run under the ``clip_embedding`` workaround.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import speculative as jspec
from paddle_tpu.serving.generation import _extract_gpt_params
from paddle_tpu.serving.generation import \
    flatten_gpt_params as jflatten_gpt_params
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     gpt_engine_params, gpt_state_from_numpy)
from paddle_tpu_torch.serving import (GenerationConfig, GenerationEngine,
                                      flatten_gpt_params, greedy_accept,
                                      nest_gpt_params, rejection_sample)
from test_torch_gpt import SMALL, clip_embedding, make_pair  # noqa: F401

GEN_CFG = dict(max_slots=2, max_seq_len=48, page_len=8,
               prefill_buckets=(8, 16, 32))
K = 3  # draft proposals per round


def pair_from_state(state, **cfg):
    """A JAX GPT and the port's GPT holding ``state`` (JAX names, numpy)."""
    cfg = {**SMALL, **cfg}
    jm = JGPTForCausalLM(JGPTConfig(**cfg, dtype="float32"))
    jm.set_state_dict(state)
    pcfg = GPTConfig(**cfg, dtype="float32")
    pm = GPTForCausalLM(pcfg, device="cpu")
    pm.load_state_dict(gpt_state_from_numpy(state, pcfg))
    return jm, pm


def numpy_state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def noisy_draft(jm, scale, seed=11):
    """A draft pair: the target's weights plus normal noise of ``scale``
    (proposals that the target accepts often, but not always)."""
    rng = np.random.default_rng(seed)
    state = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in numpy_state(jm).items()}
    return pair_from_state(state)


def requests(seed=4):
    rng = np.random.default_rng(seed)
    vocab = SMALL["vocab_size"]
    base = rng.integers(0, vocab, size=19)
    shared = np.concatenate([base[:16], rng.integers(0, vocab, size=5)])
    return [(base, 9), (shared, 12), (rng.integers(0, vocab, size=7), 14),
            (rng.integers(0, vocab, size=30), 7)]


def serve(eng, reqs):
    """Run ``reqs`` through ``eng``; the first alone (its blocks are cached
    before the shared-prefix request joins)."""
    with eng:
        first = eng.submit(reqs[0][0], max_new_tokens=reqs[0][1],
                           return_logprobs=True).result(timeout=300)
        rest = [eng.submit(p, max_new_tokens=n, return_logprobs=True)
                for p, n in reqs[1:]]
        outs = [first] + [f.result(timeout=300) for f in rest]
        return outs, eng.stats()


# -- the numpy primitives -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_greedy_accept_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        k = int(rng.integers(0, 6))
        draft = rng.integers(0, 3, size=k)
        target = rng.integers(0, 3, size=k + 1)
        assert greedy_accept(draft, target) == \
            jspec.greedy_accept(draft, target)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rejection_sample_matches_jax_for_the_same_random_state(seed):
    rng = np.random.default_rng(seed)
    k, V = 4, 7
    for trial in range(20):
        dp = rng.dirichlet(np.ones(V), size=k)
        tp = rng.dirichlet(np.ones(V), size=k + 1)
        if trial % 5 == 0:
            tp[:k] = dp  # identical rows: the accept-all path
        toks = np.array([rng.choice(V, p=dp[i]) for i in range(k)])
        got = rejection_sample(dp, tp, toks, np.random.RandomState(trial))
        ref = jspec.rejection_sample(dp, tp, toks,
                                     np.random.RandomState(trial))
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0], ref[0])
        assert len(got[0]) == got[1] + 1


# -- the engine -----------------------------------------------------------------

def test_speculative_engine_matches_jax_engine(clip_embedding):  # noqa: F811
    """A noisy-draft engine: tokens exact and logprobs within 1e-5 of the
    JAX engine's, the same proposals and acceptances, and the tokens of the
    port's own engine without a draft."""
    jm, pm = make_pair()
    jdm, pdm = noisy_draft(jm, 0.05)
    reqs = requests()
    jouts, jst = serve(jserving.GenerationEngine(
        jm, jserving.GenerationConfig(**GEN_CFG, draft_model=jdm,
                                      spec_tokens=K), name="jax-spec"),
        reqs)
    pouts, pst = serve(GenerationEngine(
        pm, GenerationConfig(**GEN_CFG, draft_model=pdm, spec_tokens=K),
        device="cpu"), reqs)
    plain, _ = serve(GenerationEngine(pm, GenerationConfig(**GEN_CFG),
                                      device="cpu"), reqs)
    for (jt, jl), (pt, pl), (qt, _ql) in zip(jouts, pouts, plain):
        assert pt.tolist() == jt.tolist()
        assert pt.tolist() == qt.tolist()
        np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    for name in ("spec_proposed", "spec_accepted", "spec_rounds",
                 "tokens_total"):
        assert pst["counters"][name] == jst["counters"][name], name
    assert 0 < pst["spec_acceptance"] < (K - 1) / K
    assert pst["spec_acceptance"] == jst["spec_acceptance"]


def test_self_draft_accepts_every_proposal_but_the_capped_one():
    """The target as its own draft: every proposal is accepted, each round
    advances by the cap k (the all-accepted bonus is dropped so that the
    draft's cache stays in step), so acceptance reads (k - 1) / k."""
    _jm, pm = make_pair()
    reqs = requests()
    outs, st = serve(GenerationEngine(
        pm, GenerationConfig(**GEN_CFG, draft_model=pm, spec_tokens=K),
        device="cpu"), reqs)
    plain, _ = serve(GenerationEngine(pm, GenerationConfig(**GEN_CFG),
                                      device="cpu"), reqs)
    for (t, _l), (q, _m) in zip(outs, plain):
        assert t.tolist() == q.tolist()
    c = st["counters"]
    assert c["spec_accepted"] * K == c["spec_proposed"] * (K - 1)
    assert st["spec_acceptance"] == round((K - 1) / K, 4)


def test_set_speculative_off_runs_single_token_rounds():
    """Speculation switched off mid-stream: the later rounds are W = 1
    windows, and the tokens stay the greedy path's."""
    jm, pm = make_pair()
    _j, pdm = noisy_draft(jm, 0.05)
    eng = GenerationEngine(pm, GenerationConfig(**GEN_CFG, draft_model=pdm,
                                                spec_tokens=K), device="cpu")
    widths = []
    run = eng._run_window

    def recording(tables, tokens, lengths):
        widths.append(tokens.shape[1])
        return run(tables, tokens, lengths)

    eng._run_window = recording
    reqs = requests()
    with eng:
        assert eng.speculative_enabled()
        a = eng.submit(reqs[0][0], max_new_tokens=10).result(timeout=300)
        assert K + 1 in widths
        rounds = eng.metrics.counter("spec_rounds")
        eng.set_speculative(False)
        assert not eng.speculative_enabled()
        mark = len(widths)
        b = eng.submit(reqs[2][0], max_new_tokens=10).result(timeout=300)
        assert eng.metrics.counter("spec_rounds") == rounds
        assert widths[mark] == 8 and set(widths[mark + 1:]) == {1}
    plain, _ = serve(GenerationEngine(pm, GenerationConfig(**GEN_CFG),
                                      device="cpu"),
                     [(reqs[0][0], 10), (reqs[2][0], 10)])
    assert a.tolist() == plain[0][0].tolist()
    assert b.tolist() == plain[1][0].tolist()


def test_draft_model_is_validated():
    _jm, pm = make_pair()
    _j, short = make_pair(max_position_embeddings=32)
    with pytest.raises(ValueError, match="position table"):
        GenerationEngine(pm, GenerationConfig(**GEN_CFG, draft_model=short),
                         device="cpu")
    _j, other = make_pair(vocab_size=32)
    with pytest.raises(ValueError, match="vocab"):
        GenerationEngine(pm, GenerationConfig(**GEN_CFG, draft_model=other),
                         device="cpu")


# -- weight swaps ---------------------------------------------------------------

def test_flat_wire_names_equal_jax():
    jm, pm = make_pair()
    jflat = jflatten_gpt_params(_extract_gpt_params(jm))
    pflat = flatten_gpt_params(gpt_engine_params(pm))
    assert list(pflat) == list(jflat)
    nested = nest_gpt_params(pflat)
    assert len(nested["layers"]) == SMALL["num_hidden_layers"]
    assert nested["layers"][1]["qkv_w"] is pflat["layers.1.qkv_w"]
    with pytest.raises(ValueError, match="non-contiguous"):
        nest_gpt_params({"layers.1.qkv_w": 0})


@pytest.mark.parametrize("form", ["model", "nested", "flat"])
def test_swap_weights_gives_the_jax_engines_tokens(form):
    """After the same swap both engines answer with the new weights' tokens
    (and logprobs within 1e-5); the old weights' storage is untouched."""
    jm, pm = make_pair()
    jm2, pm2 = make_pair(seed=1)
    reqs = requests()[:2]
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    state = {"model": pm2, "nested": gpt_engine_params(pm2),
             "flat": {k: v.numpy() for k, v in flatten_gpt_params(
                 gpt_engine_params(pm2)).items()}}[form]
    jeng = jserving.GenerationEngine(jm, jserving.GenerationConfig(**GEN_CFG),
                                     name="jax-swap")
    peng = GenerationEngine(pm, GenerationConfig(**GEN_CFG), device="cpu")
    assert jeng.swap_weights(jm2) == 1
    assert peng.swap_weights(state) == 1
    assert peng.weight_version == 1
    jouts, _ = serve(jeng, reqs)
    pouts, pst = serve(peng, reqs)
    assert pst["weight_version"] == 1
    for (jt, jl), (pt, pl) in zip(jouts, pouts):
        assert pt.tolist() == jt.tolist()
        np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_swap_lands_between_requests_in_flight_and_later():
    """A swap staged while a request decodes waits for it: that request
    finishes on the old weights, one submitted after the swap runs the new
    ones, and the prefix cache is dropped at the boundary."""
    _jm, pm = make_pair()
    _jm2, pm2 = make_pair(seed=1)
    reqs = requests()
    long_p, short_p = reqs[0][0], reqs[1][0]
    old, _ = serve(GenerationEngine(pm, GenerationConfig(**GEN_CFG),
                                    device="cpu"), [(long_p, 25)])
    new, _ = serve(GenerationEngine(pm2, GenerationConfig(**GEN_CFG),
                                    device="cpu"), [(short_p, 6)])
    eng = GenerationEngine(pm, GenerationConfig(**GEN_CFG), device="cpu")
    with eng:
        inflight = eng.submit(long_p, max_new_tokens=25)
        t0 = time.monotonic()
        while not eng._active() and time.monotonic() - t0 < 60:
            time.sleep(0.0005)
        assert eng._active()
        result = {}
        swapper = threading.Thread(
            target=lambda: result.setdefault("v", eng.swap_weights(pm2)))
        swapper.start()
        t0 = time.monotonic()
        while eng._pending_swap is None and swapper.is_alive() and \
                time.monotonic() - t0 < 60:
            time.sleep(0.0005)
        later = eng.submit(short_p, max_new_tokens=6)
        a = inflight.result(timeout=300)
        b = later.result(timeout=300)
        swapper.join(timeout=300)
        assert result["v"] == 1 and eng.weight_version == 1
        assert eng.metrics.counter("weight_swaps") == 1
    assert a.tolist() == old[0][0].tolist()
    assert b.tolist() == new[0][0].tolist()
    # the trie holds only the later request's blocks (the swap dropped the
    # in-flight one's)
    assert eng.prefix_match_tokens(long_p) == 16  # shared 16-token prefix


def test_swap_weights_rejects_bad_shapes_and_layer_counts():
    _jm, pm = make_pair()
    eng = GenerationEngine(pm, GenerationConfig(**GEN_CFG), device="cpu")
    flat = {k: v.numpy() for k, v in flatten_gpt_params(
        gpt_engine_params(pm)).items()}
    bad = dict(flat, **{"layers.0.qkv_w": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        eng.swap_weights(bad)
    short = {k: v for k, v in flat.items() if not k.startswith("layers.1.")}
    with pytest.raises(ValueError, match="layers != live"):
        eng.swap_weights(short)
    missing = {k: v for k, v in flat.items() if k != "lnf_b"}
    with pytest.raises(ValueError, match="missing param"):
        eng.swap_weights(missing)
    _j, deeper = make_pair(num_hidden_layers=3)
    with pytest.raises(ValueError, match="layers != live"):
        eng.swap_weights(deeper)
    assert eng.weight_version == 0
