"""The port's Llama attention with a KV cache against the JAX package's,
on the CPU.

Weights, hidden states and caches are drawn with numpy; the JAX attention
runs on its CPU backend, the port its kernels' plain versions (RoPE at the
cache's length, the flash kernels). fp32, tolerance 1e-5 (rtol and atol).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.kernels import counters, reset_counters
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.llama import LlamaAttention

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("q_proj", "k_proj", "v_proj", "o_proj")


def _pair(seed=0, **cfg):
    """The JAX and the port's attention (tiny Llama: hidden 128, 4 heads
    over 2 key/value heads) with the same numpy weights."""
    rng = np.random.default_rng(seed)
    paddle.seed(seed)
    ja = jllama.LlamaAttention(jllama.LlamaConfig.tiny(**cfg))
    pa = LlamaAttention(LlamaConfig.tiny(**cfg))
    state = {f"{n}.weight": (0.1 * rng.standard_normal(
        tuple(ja.state_dict()[f"{n}.weight"].shape))).astype(np.float32)
        for n in NAMES}
    ja.set_state_dict(state)
    pa.load_state_dict({k: torch.from_numpy(v.T.copy())
                        for k, v in state.items()})
    return ja, pa


@pytest.mark.parametrize("new", [1, 3])
@pytest.mark.parametrize("kv_heads", [2, 4])
def test_cached_attention_matches_jax(new, kv_heads):
    """``forward(hidden, cache=(k, v))`` with a 5-token cache and 1 or 3
    new tokens, GQA (2 key/value heads) and not: the output and the new
    cache (before the GQA repeat) against the JAX attention's."""
    ja, pa = _pair(num_key_value_heads=kv_heads)
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, new, 128)).astype(np.float32)
    k0, v0 = (rng.standard_normal((2, 5, kv_heads, 32)).astype(np.float32)
              for _ in range(2))
    jout, (jk, jv) = ja(paddle.to_tensor(hidden),
                        cache=(paddle.to_tensor(k0), paddle.to_tensor(v0)))
    reset_counters()
    with torch.no_grad():
        out, (k, v) = pa(torch.from_numpy(hidden),
                         cache=(torch.from_numpy(k0), torch.from_numpy(v0)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout.numpy()), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk.numpy()), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv.numpy()), **TOL)
    assert k.shape == (2, 5 + new, kv_heads, 32)
    np.testing.assert_array_equal(k[:, :5].numpy(), k0)
    c = counters()
    assert c["rope"]["plain_calls"] == 2
    # one new row: the single-row decode route; more: the flash forward
    name = "flash_attention_decode" if new == 1 else "flash_attention"
    assert c[name]["plain_calls"] == 1


def test_one_cached_token_equals_the_last_causal_row():
    """A decode step over a cache built by the uncached projections equals
    the last row of the causal call over the whole sequence (the check the
    card repeats at full width)."""
    _ja, pa = _pair(seed=4)
    hidden = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 9, 128)).astype(np.float32))
    with torch.no_grad():
        full = pa(hidden)
        _, cache = pa(hidden[:, :1], cache=(torch.zeros(2, 0, 2, 32),
                                            torch.zeros(2, 0, 2, 32)))
        for i in range(1, 8):
            _, cache = pa(hidden[:, i:i + 1], cache=cache)
        last, cache = pa(hidden[:, 8:], cache=cache)
    assert cache[0].shape == (2, 9, 2, 32)
    np.testing.assert_allclose(last.numpy(), full[:, 8:].numpy(), **TOL)
