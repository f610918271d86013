"""Weights across the two packages.

``gpt_state_from_numpy`` turns the JAX model's ``state_dict()`` (as numpy
arrays) into this package's ``state_dict``: the names are the same, and the
Linear weights are transposed, since the JAX package stores them ``[in,
out]`` and computes ``x @ W`` while ``nn.Linear`` stores ``[out, in]``.

``gpt_engine_params`` reads a model's live weights into the nested dict the
serving window step takes (the counterpart of the JAX engine's
``_extract_gpt_params``), with Linear weights in ``[out, in]`` for
``F.linear``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .gpt import GPTConfig

__all__ = ["gpt_state_from_numpy", "gpt_engine_params"]

_LINEARS = ("attn.qkv_proj", "attn.out_proj", "fc_in", "fc_out")


def _expected_shapes(config: GPTConfig) -> Dict[str, tuple]:
    h, i = config.hidden_size, config.intermediate_size
    shapes = {"gpt.embed_tokens.weight": (config.vocab_size, h),
              "gpt.embed_positions.weight": (config.max_position_embeddings,
                                             h),
              "gpt.ln_f.weight": (h,), "gpt.ln_f.bias": (h,)}
    per_layer = {"ln_1.weight": (h,), "ln_1.bias": (h,),
                 "attn.qkv_proj.weight": (3 * h, h),
                 "attn.qkv_proj.bias": (3 * h,),
                 "attn.out_proj.weight": (h, h), "attn.out_proj.bias": (h,),
                 "ln_2.weight": (h,), "ln_2.bias": (h,),
                 "fc_in.weight": (i, h), "fc_in.bias": (i,),
                 "fc_out.weight": (h, i), "fc_out.bias": (h,)}
    for li in range(config.num_hidden_layers):
        for k, s in per_layer.items():
            shapes[f"gpt.layers.{li}.{k}"] = s
    return shapes


def gpt_state_from_numpy(flat: Mapping[str, Any],
                         config: GPTConfig) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` of the JAX ``GPTForCausalLM`` -> a
    ``state_dict`` for :class:`GPTForCausalLM` (CPU tensors; loading casts
    them to the model's device and dtype)."""
    want = _expected_shapes(config)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    out = {}
    for name, arr in flat.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)  # numpy has no bf16 torch can read
        if name.endswith(".weight") and \
                any(f".{lin}." in name for lin in _LINEARS):
            a = a.T
        if a.shape != want[name]:
            raise ValueError(f"{name}: shape {a.shape} after conversion, "
                             f"expected {want[name]}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def gpt_engine_params(module) -> Dict[str, Any]:
    """The live weights of a ``GPTForCausalLM`` as the window step's
    nested dict (tensors share storage with the module's parameters)."""
    g = module.gpt

    def a(p):
        return p.detach()

    return {
        "embed": a(g.embed_tokens.weight),          # [vocab, h]
        "pos": a(g.embed_positions.weight),         # [P, h]
        "lnf_w": a(g.ln_f.weight), "lnf_b": a(g.ln_f.bias),
        "layers": [
            {"ln1_w": a(L.ln_1.weight), "ln1_b": a(L.ln_1.bias),
             "qkv_w": a(L.attn.qkv_proj.weight),    # [3h, h]
             "qkv_b": a(L.attn.qkv_proj.bias),
             "out_w": a(L.attn.out_proj.weight),
             "out_b": a(L.attn.out_proj.bias),
             "ln2_w": a(L.ln_2.weight), "ln2_b": a(L.ln_2.bias),
             "fc_in_w": a(L.fc_in.weight), "fc_in_b": a(L.fc_in.bias),
             "fc_out_w": a(L.fc_out.weight), "fc_out_b": a(L.fc_out.bias)}
            for L in g.layers],
    }
