"""The port's serving path against the JAX package's, plus the port's own
rules: no JAX in the port, and no silent CPU fallback.

The window step and the engine run on the CPU (the paged-attention kernel's
plain version); the JAX step runs its Pallas kernel through the interpreter.
"""
import ast
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jserving
from paddle_tpu.serving.generation import (_build_window_step,
                                           _extract_gpt_params)
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.device import seed
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     LlamaConfig, LlamaForCausalLM,
                                     gpt_engine_params)
from paddle_tpu_torch.serving import (DeadlineExceeded, GenerationConfig,
                                      GenerationEngine, PagedKVPool,
                                      build_window_step)
from test_torch_gpt import SMALL, make_pair

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("W", [1, 3])
def test_window_step_matches_jax(monkeypatch, W):
    """Argmaxes exactly, logprobs within 1e-5 (fp32, summation order), and
    the arenas after the write within 1e-5 outside the scratch page (which
    takes duplicate writes whose winner is unspecified on both sides)."""
    monkeypatch.setenv("PT_PALLAS_INTERPRET", "1")
    jm, pm = make_pair()
    cfg = jm.config
    S, B, PL = 3, 4, 8
    P = S * B + 1
    nh = cfg.num_attention_heads
    hd = cfg.hidden_size // nh
    rng = np.random.default_rng(3)
    arenas = [rng.standard_normal((P, PL, nh, hd), dtype=np.float32) * 0.1
              for _ in range(2 * cfg.num_hidden_layers)]
    tables = np.arange(S * B, dtype=np.int32).reshape(S, B) + 1
    tables[2] = 0                       # an idle slot: scratch page only
    tokens = rng.integers(0, cfg.vocab_size, size=(S, W)).astype(np.int32)
    lengths = np.array([5, 11, 0], np.int32)
    L = cfg.num_hidden_layers
    jstep = _build_window_step(cfg, S, B, PL, W, donate=False,
                               label=f"torch-parity:{W}", fused=True)
    jn, jlp, jk, jv = jstep(_extract_gpt_params(jm),
                            [jnp.asarray(a) for a in arenas[:L]],
                            [jnp.asarray(a) for a in arenas[L:]],
                            jnp.asarray(tables), jnp.asarray(tokens),
                            jnp.asarray(lengths))
    pk = [torch.from_numpy(a.copy()) for a in arenas[:L]]
    pv = [torch.from_numpy(a.copy()) for a in arenas[L:]]
    step = build_window_step(pm.config, S, B, PL, W)
    pn, plp = step(gpt_engine_params(pm), pk, pv, torch.from_numpy(tables),
                   torch.from_numpy(tokens), torch.from_numpy(lengths))
    assert pn.dtype == torch.int32
    assert pn.numpy().tolist() == np.asarray(jn).tolist()
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)
    for got, ref in zip(pk + pv, list(jk) + list(jv)):
        np.testing.assert_allclose(got.numpy()[1:], np.asarray(ref)[1:],
                                   rtol=1e-5, atol=1e-5)


def _requests(rng, vocab):
    base = rng.integers(0, vocab, size=19)
    shared = np.concatenate([base[:16], rng.integers(0, vocab, size=5)])
    return [(base, 6), (shared, 8), (rng.integers(0, vocab, size=7), 10),
            (rng.integers(0, vocab, size=30), 5)]


def test_engine_matches_jax_engine():
    """Same weights, same requests (one reuses the other's two cached
    prefix pages): token-for-token equal outputs, logprobs within 1e-4."""
    jm, pm = make_pair()
    gen_cfg = dict(max_slots=2, max_seq_len=48, page_len=8,
                   prefill_buckets=(8, 16, 32))
    reqs = _requests(np.random.default_rng(4), SMALL["vocab_size"])
    outs = {}
    for side, eng in (
            ("jax", jserving.GenerationEngine(
                jm, jserving.GenerationConfig(**gen_cfg), name="jax-ref")),
            ("torch", GenerationEngine(pm, GenerationConfig(**gen_cfg),
                                       device="cpu"))):
        with eng:
            # the first request lands alone, so its blocks are cached
            # before the shared-prefix request joins
            first = eng.submit(reqs[0][0], max_new_tokens=reqs[0][1],
                               return_logprobs=True).result(timeout=300)
            rest = [eng.submit(p, max_new_tokens=n, return_logprobs=True)
                    for p, n in reqs[1:]]
            outs[side] = [first] + [f.result(timeout=300) for f in rest]
            assert eng.stats()["counters"]["prefix_hits"] >= 1, side
    for (jt, jl), (pt, pl) in zip(outs["jax"], outs["torch"]):
        assert pt.tolist() == jt.tolist()
        np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)


@pytest.fixture
def cpu_engine():
    model = GPTForCausalLM(GPTConfig(**SMALL, dtype="float32"),
                           device="cpu", generator=seed(5, "cpu"))
    eng = GenerationEngine(model, GenerationConfig(
        max_slots=2, max_seq_len=64, page_len=8,
        prefill_buckets=(8, 16, 32)), device="cpu")
    eng.start()
    yield eng
    eng.close()


def test_engine_edf_join_order_and_shedding(cpu_engine):
    """Queued requests join freed slots earliest-deadline-first (observed
    as the order of their first tokens), and a request whose deadline
    expires while queued is shed before prefill."""
    eng = cpu_engine
    prompt = np.arange(12) % SMALL["vocab_size"]
    busy = [eng.submit(prompt, max_new_tokens=40) for _ in range(2)]
    t0 = time.monotonic()
    while len(eng._active()) < 2 and time.monotonic() - t0 < 60:
        time.sleep(0.0005)
    assert len(eng._active()) == 2
    order = []

    def tag(name):
        def cb(_t):
            if name not in order:
                order.append(name)
        return cb

    no_dl = eng.submit(prompt[:10], max_new_tokens=2, on_token=tag("none"))
    late = eng.submit(prompt[:11], max_new_tokens=2, deadline_ms=60_000,
                      on_token=tag("late"))
    soon = eng.submit(prompt[:9], max_new_tokens=2, deadline_ms=30_000,
                      on_token=tag("soon"))
    doomed = eng.submit(prompt[:8], max_new_tokens=2, deadline_ms=0.5,
                        on_token=tag("doomed"))
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=60)
    for f in busy + [no_dl, late, soon]:
        f.result(timeout=300)
    assert eng.metrics.counter("shed_total") >= 1
    assert order == ["soon", "late", "none"]


def test_engine_clamps_eos_and_rejects_bad_requests(cpu_engine):
    eng = cpu_engine
    prompt = np.arange(20) % SMALL["vocab_size"]
    out = eng.submit(prompt, max_new_tokens=5).result(timeout=60)
    assert len(out) == 25
    eng.config.eos_token_id = int(out[20])  # stop at the first new token
    try:
        short = eng.submit(prompt, max_new_tokens=5).result(timeout=60)
    finally:
        eng.config.eos_token_id = None
    assert short.tolist() == out[:21].tolist()
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(prompt, max_new_tokens=60).result(timeout=60)
    with pytest.raises(ValueError, match="prefill bucket"):
        eng.submit(np.zeros(33, np.int64)).result(timeout=60)
    assert eng.kv_headroom() > 0
    assert eng.prefix_match_tokens(prompt) == 16


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "tools").glob("torch_*.py"))
    # the replica worker's module and the test builder a replica loads
    files.append(REPO / "tests" / "torch_fleet_builder.py")
    assert REPO / "paddle_tpu_torch" / "serving" / "fleet.py" in files
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "paddle_tpu")]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch):
    """``device=None`` means CUDA; with no card it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(**SMALL, dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVPool(1, 4, 2, 1, 2)
    model = GPTForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(model)
    assert resolve_device("cpu").type == "cpu"
    # the paddle surface: the expected place is the card until
    # set_device("cpu")
    import paddle_tpu_torch as P

    prior = P.get_device()
    P.set_device("gpu")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            P.nn.Linear(2, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            P.to_tensor([1])
        with pytest.raises(RuntimeError, match="CUDA"):
            P.seed(0)
        P.set_device("cpu")
        assert P.nn.Linear(2, 2).weight.device.type == "cpu"
        assert P.to_tensor([1]).device.type == "cpu"
    finally:
        P.set_device(prior)
