"""The port's GPT against the JAX package's on the same weights.

Weights are drawn with numpy, set into the JAX ``GPTForCausalLM`` and
carried across by ``paddle_tpu_torch.models.convert``; the port runs on the
CPU (its flash kernel's plain version) and the JAX model on the CPU backend.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu_torch.device import seed as pt_seed
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     gpt_engine_params, gpt_state_from_numpy)

SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, max_position_embeddings=64)


def make_pair(seed=0, **cfg):
    """A JAX GPT and the port's GPT holding the same numpy-drawn weights
    (fp32). Scales are large enough that the greedy argmax is decisive."""
    cfg = {**SMALL, **cfg}
    rng = np.random.default_rng(seed)
    paddle.seed(seed)
    jm = JGPTForCausalLM(JGPTConfig(**cfg, dtype="float32"))
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
    jm.set_state_dict(state)
    pcfg = GPTConfig(**cfg, dtype="float32")
    pm = GPTForCausalLM(pcfg, device="cpu")
    pm.load_state_dict(gpt_state_from_numpy(state, pcfg))
    return jm, pm


@pytest.fixture
def clip_embedding():
    """Eager ``F.embedding`` of the JAX package crashes under jax 0.9 with
    the default 'error' OOV policy (it calls a removed jax API); 'clip'
    takes the path that works. Restored afterwards."""
    from paddle_tpu.framework import flags as flags_mod

    prior = flags_mod.get_flags(["FLAGS_embedding_oov_policy"])
    paddle.set_flags({"FLAGS_embedding_oov_policy": "clip"})
    yield
    paddle.set_flags(prior)


def test_convert_transposes_linear_weights():
    jm, pm = make_pair()
    jsd = jm.state_dict()
    psd = pm.state_dict()
    assert set(jsd) == set(psd)
    name = "gpt.layers.0.attn.qkv_proj.weight"
    np.testing.assert_array_equal(np.asarray(jsd[name]).T,
                                  psd[name].numpy())
    name = "gpt.embed_tokens.weight"
    np.testing.assert_array_equal(np.asarray(jsd[name]), psd[name].numpy())
    params = gpt_engine_params(pm)
    assert params["layers"][1]["qkv_w"].shape == (96, 32)  # [out, in]
    with pytest.raises(KeyError, match="missing"):
        gpt_state_from_numpy({}, pm.config)


def test_logits_match_jax(clip_embedding):
    """fp32 logits on both sides; tolerance 1e-5 absolute and relative
    (the two sum in different orders)."""
    jm, pm = make_pair()
    ids = np.random.default_rng(1).integers(0, 64, size=(2, 13))
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_cache", [True, False])
def test_generate_matches_jax(clip_embedding, use_cache):
    """Greedy tokens are equal, token for token."""
    jm, pm = make_pair()
    ids = np.random.default_rng(2).integers(0, 64, size=(2, 9))
    ref = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=8,
                                 use_cache=use_cache).numpy())
    got = pm.generate(torch.from_numpy(ids), max_new_tokens=8,
                      use_cache=use_cache).numpy()
    assert got.tolist() == ref.tolist()


def test_random_init_is_seeded_and_on_the_asked_device():
    cfg = GPTConfig.tiny()
    a = GPTForCausalLM(cfg, device="cpu", generator=pt_seed(3, "cpu"))
    b = GPTForCausalLM(cfg, device="cpu", generator=pt_seed(3, "cpu"))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert p.device.type == "cpu" and p.dtype == torch.float32
        assert torch.equal(p, q), n
    assert float(a.gpt.ln_f.weight.detach().min()) == 1.0
    assert float(a.gpt.layers[0].fc_in.bias.detach().abs().max()) == 0.0
    assert GPTConfig.gpt3_6_7b().hidden_size == 4096
    assert GPTConfig.gpt3_6_7b().torch_dtype == torch.bfloat16
