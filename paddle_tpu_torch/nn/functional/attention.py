"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

Layout convention (paddle's): q/k/v are [batch, seq, num_heads, head_dim].

Two routes, chosen by the call's arguments alone, never by a failure:

- no ``attn_mask`` and no dropout in training: the hand-written flash
  kernels, forward and backward. On CUDA a call launches them or raises;
  the JAX package's ``attention_backend`` gate encodes TPU tile rules
  (block-divisible sequences, MXU head dims) and has no counterpart here,
  since the kernels mask ragged edges. On the CPU their plain versions run.
- an additive ``attn_mask`` or ``dropout_p > 0`` in training: the plain
  PyTorch composition ``_sdpa_composition``, on the card too. It is not a
  fallback: the JAX package sends these two cases to its XLA composition
  ``_sdpa_xla`` (``paddle_tpu/nn/functional/attention.py:24-38``) and never
  to a Pallas kernel, so there is no kernel to port for them. It follows
  that composition's order of operations step for step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...kernels.flash_attention import flash_attention as _flash
from .common import _scalar, keep_mask

__all__ = ["scaled_dot_product_attention", "flash_attention"]


def _sdpa_composition(q, k, v, mask, *, causal, scale, dropout_p,
                      generator):
    """The JAX ``_sdpa_xla``: ``q.k * scale`` in q's dtype, cast to fp32,
    the bottom-right aligned causal ``-1e30``, the additive fp32 mask, fp32
    softmax cast to q's dtype, ``where(keep, p / (1 - p), 0)`` with a keep
    mask of the probabilities' shape [b, h, sq, sk], then the product with
    V."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * _scalar(scale, q.dtype)
    logits = logits.float()
    if causal:
        qs, ks = q.shape[1], k.shape[1]
        seen = torch.ones(qs, ks, dtype=torch.bool,
                          device=q.device).tril(ks - qs)
        logits = logits.masked_fill(~seen, -1e30)
    if mask is not None:
        logits = logits + mask.to(torch.float32)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = keep_mask(probs.shape, dropout_p, generator, probs.device)
        probs = torch.where(keep, probs / _scalar(1.0 - dropout_p, q.dtype),
                            probs.new_zeros(()))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None,
                                 generator: Optional[torch.Generator] = None):
    """q/k/v: [batch, seq, heads, head_dim]; ``attn_mask`` an additive
    float mask broadcastable to [b, h, sq, sk]; ``generator`` draws the
    dropout's keep mask (``None``: torch's default one). Under ``is_causal``
    the mask is bottom-right aligned (row i sees keys up to ``i + sk -
    sq``), so a KV-cached decode step attends its whole cache. With more
    queries than keys the first ``sq - sk`` rows see no key; as in the JAX
    package's softmax over an all-masked row, each of them is the mean of
    V over the keys (plain PyTorch, so its gradient is 1/sk to every V row
    and none to q or k). The flash kernels keep o = 0 on such rows, which
    ring attention relies on."""
    drop = float(dropout_p) if (dropout_p > 0.0 and training) else 0.0
    if attn_mask is not None or drop:
        s = float(scale) if scale is not None else \
            1.0 / math.sqrt(query.shape[-1])
        return _sdpa_composition(query, key, value, attn_mask,
                                 causal=bool(is_causal), scale=s,
                                 dropout_p=drop, generator=generator)
    sq, sk = query.shape[1], key.shape[1]
    if not is_causal or sq <= sk or sk == 0:
        return _flash(query, key, value, causal=bool(is_causal), scale=scale)
    blind = sq - sk
    mean_v = value.float().mean(dim=1, keepdim=True).to(value.dtype)
    seen = _flash(query[:, blind:], key, value, causal=True, scale=scale)
    return torch.cat([mean_v.expand(-1, blind, -1, -1), seen], dim=1)


# paddle.nn.functional.flash_attention, the JAX package's alias (:128)
flash_attention = scaled_dot_product_attention
