"""GPT-2/3-family causal LM (port of ``paddle_tpu/models/gpt.py``).

Pre-LN blocks with biases, learned absolute position embeddings, a
tanh-approximated GELU MLP and a head tied to the token embedding.
Parameter names follow the JAX package (``gpt.layers.0.attn.qkv_proj.weight``)
but Linear weights are PyTorch's ``[out, in]``; ``models.convert`` transposes
the JAX package's ``[in, out]``. The qkv projection's output columns are
ordered ``[3][heads][head_dim]``. Attention goes through
``nn.functional.scaled_dot_product_attention``, i.e. the flash kernel on CUDA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ..device import resolve_device, seed
from ..nn.functional import scaled_dot_product_attention

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0  # 0 = 4*hidden
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    dtype: str = "bfloat16"

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {sorted(_DTYPES)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @staticmethod
    def gpt2_small(**overrides):
        return GPTConfig(**{**dict(hidden_size=768, num_hidden_layers=12,
                                   num_attention_heads=12), **overrides})

    @staticmethod
    def gpt3_6_7b(**overrides):
        """GPT-3 6.7B (Brown et al. 2020, Table 2.1)."""
        return GPTConfig(**{**dict(hidden_size=4096, num_hidden_layers=32,
                                   num_attention_heads=32,
                                   max_position_embeddings=2048), **overrides})

    @staticmethod
    def tiny(**overrides):
        return GPTConfig(**{**dict(vocab_size=256, hidden_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   max_position_embeddings=128,
                                   dtype="float32"), **overrides})


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        self.qkv_proj = nn.Linear(h, 3 * h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, hidden, cache=None, use_cache=False):
        b, s = hidden.shape[0], hidden.shape[1]
        qkv = self.qkv_proj(hidden).view(b, s, 3, self.num_heads,
                                         self.head_dim)
        q, k, v = qkv.unbind(2)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        # bottom-right aligned causal mask: cache-safe
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
        out = self.out_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        if use_cache:
            return out, (k, v)
        return out


class GPTBlock(nn.Module):
    """Pre-LN transformer block (GPT-2 recipe)."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(h, eps)
        self.attn = GPTAttention(config)
        self.ln_2 = nn.LayerNorm(h, eps)
        self.fc_in = nn.Linear(h, config.intermediate_size)
        self.fc_out = nn.Linear(config.intermediate_size, h)

    def forward(self, hidden, cache=None, use_cache=False):
        attn_out = self.attn(self.ln_1(hidden), cache=cache,
                             use_cache=use_cache)
        if use_cache:
            attn_out, new_cache = attn_out
        hidden = hidden + attn_out
        hidden = hidden + self.fc_out(
            TF.gelu(self.fc_in(self.ln_2(hidden)), approximate="tanh"))
        if use_cache:
            return hidden, new_cache
        return hidden


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.embed_positions = nn.Embedding(config.max_position_embeddings,
                                            config.hidden_size)
        self.layers = nn.ModuleList(
            [GPTBlock(config) for _ in range(config.num_hidden_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 config.layer_norm_epsilon)

    def forward(self, input_ids, position_offset=0, caches=None,
                use_cache=False):
        s = input_ids.shape[1]
        pos = torch.arange(position_offset, position_offset + s,
                           device=input_ids.device)
        hidden = self.embed_tokens(input_ids) + self.embed_positions(pos)
        new_caches = []
        for i, layer in enumerate(self.layers):
            if use_cache:
                hidden, c = layer(hidden, cache=None if caches is None
                                  else caches[i], use_cache=True)
                new_caches.append(c)
            else:
                hidden = layer(hidden)
        hidden = self.ln_f(hidden)
        if use_cache:
            return hidden, new_caches
        return hidden


class GPTForCausalLM(nn.Module):
    """Tied-embedding LM head. Built on ``device`` (``None`` = CUDA) in
    ``config.dtype``, with random weights drawn from ``generator`` (a
    ``torch.Generator`` on that device; ``None`` = seed 0): normal(0, 0.02)
    matrices and embeddings, zero biases, unit LayerNorm scales."""

    def __init__(self, config: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.gpt = GPTModel(config)
        self.to_empty(device=dev)
        self.to(config.torch_dtype)
        self._init_weights(generator if generator is not None
                           else seed(0, dev))

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator):
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)

    def forward(self, input_ids):
        """``input_ids`` [b, s] int64 -> logits [b, s, vocab]."""
        hidden = self.gpt(input_ids)
        return TF.linear(hidden, self.gpt.embed_tokens.weight)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=16, use_cache=True):
        """Greedy decode (argmax takes the first maximum). With use_cache
        the prefill runs once and each new token reuses the per-layer KV
        cache."""
        w = self.gpt.embed_tokens.weight
        out = input_ids
        if not use_cache:
            for _ in range(max_new_tokens):
                nxt = self.forward(out)[:, -1, :].argmax(dim=-1)
                out = torch.cat([out, nxt.view(-1, 1).to(out.dtype)], dim=1)
            return out
        hidden, caches = self.gpt(out, use_cache=True)
        for step in range(max_new_tokens):
            logits = TF.linear(hidden[:, -1, :], w)
            nxt = logits.argmax(dim=-1).view(-1, 1).to(out.dtype)
            out = torch.cat([out, nxt], dim=1)
            if step + 1 < max_new_tokens:  # last token needs no lookahead
                hidden, caches = self.gpt(nxt,
                                          position_offset=out.shape[1] - 1,
                                          caches=caches, use_cache=True)
        return out
