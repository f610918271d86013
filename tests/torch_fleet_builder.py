"""Replica builder for the port's multi-process fleet tests: a tiny fp32
GPT on the CPU with weights drawn from a fixed numpy seed, so every
replica process (and the test itself) holds the same weights. The
recipe is ``test_torch_gpt.make_pair``'s, keyed by the port's names: its
scales make the greedy argmax decisive. Imports only the port and numpy,
as a replica worker must.

Run a replica with it::

    PT_REPLICA_BUILDER=tests/torch_fleet_builder.py:build_replica \\
        python -m paddle_tpu_torch.serving.fleet
"""
import numpy as np

from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.serving import GenerationConfig, GenerationEngine

CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=64)
ENGINE = dict(max_slots=2, max_seq_len=48, page_len=8,
              prefill_buckets=(8, 16, 32))
SEED = 3
# the port's Linear weights are [out, in]; the recipe draws them [in, out]
_LINEARS = ("qkv_proj", "out_proj", "fc_in", "fc_out")


def build_model():
    cfg = GPTConfig(**CFG, dtype="float32")
    model = GPTForCausalLM(cfg, device="cpu")
    rng = np.random.default_rng(SEED)
    state = {}
    for name, v in model.state_dict().items():
        shape = tuple(v.shape)
        if name.endswith(".weight") and any(f".{n}." in name
                                            for n in _LINEARS):
            shape = shape[::-1]
        if ".ln_" in name and name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = 0.3 * rng.standard_normal(shape)
        state[name] = a.astype(np.float32)
    model.load_state_dict(gpt_state_from_numpy(state, cfg))
    model.eval()
    return model


def build_replica():
    return GenerationEngine(build_model(), GenerationConfig(**ENGINE),
                            device="cpu")
