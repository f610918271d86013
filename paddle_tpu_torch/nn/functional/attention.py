"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

Layout convention (paddle's): q/k/v are [batch, seq, num_heads, head_dim].
On CUDA ``scaled_dot_product_attention`` always goes to the hand-written
flash kernels, forward and backward: the JAX package's ``attention_backend``
gate encodes TPU tile rules (block-divisible sequences, MXU head dims) and
has no counterpart here, since the kernels mask ragged edges. On CPU the
kernels' plain versions run.
"""
from __future__ import annotations

import torch

from ...kernels.flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """q/k/v: [batch, seq, heads, head_dim]. Under ``is_causal`` the mask is
    bottom-right aligned (row i sees keys up to ``i + sk - sq``), so a
    KV-cached decode step attends its whole cache. With more queries than
    keys the first ``sq - sk`` rows see no key; as in the JAX package's
    softmax over an all-masked row, each of them is the mean of V over the
    keys (plain PyTorch, so its gradient is 1/sk to every V row and none to
    q or k). The flash kernels keep o = 0 on such rows, which ring
    attention relies on."""
    if attn_mask is not None:
        raise NotImplementedError(
            "attn_mask is not ported yet (serving and the Llama step need "
            "none); see ROADMAP.md, Queue 1")
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (serving and the Llama "
            "step need none); see ROADMAP.md, Queue 1")
    sq, sk = query.shape[1], key.shape[1]
    if not is_causal or sq <= sk or sk == 0:
        return flash_attention(query, key, value, causal=bool(is_causal),
                               scale=scale)
    blind = sq - sk
    mean_v = value.float().mean(dim=1, keepdim=True).to(value.dtype)
    seen = flash_attention(query[:, blind:], key, value, causal=True,
                           scale=scale)
    return torch.cat([mean_v.expand(-1, blind, -1, -1), seen], dim=1)
