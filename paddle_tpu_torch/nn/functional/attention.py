"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

Layout convention (paddle's): q/k/v are [batch, seq, num_heads, head_dim].
On CUDA ``scaled_dot_product_attention`` always goes to the hand-written
flash kernel: the JAX package's ``attention_backend`` gate encodes TPU tile
rules (block-divisible sequences, MXU head dims) and has no counterpart
here, since the kernel masks ragged edges. On CPU the kernel's plain
version runs.
"""
from __future__ import annotations

from ...kernels.flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """q/k/v: [batch, seq, heads, head_dim]. Under ``is_causal`` the mask is
    bottom-right aligned (row i sees keys up to ``i + sk - sq``), so a
    KV-cached decode step attends its whole cache."""
    if attn_mask is not None:
        raise NotImplementedError(
            "attn_mask is not ported yet (serving needs none); see "
            "ROADMAP.md, Queue 1")
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (serving needs none); see "
            "ROADMAP.md, Queue 1")
    return flash_attention(query, key, value, causal=bool(is_causal),
                           scale=scale)
