"""Weights across the two packages.

``gpt_state_from_numpy`` turns the JAX model's ``state_dict()`` (as numpy
arrays) into this package's ``state_dict``: the names are the same, and the
Linear weights are transposed, since the JAX package stores them ``[in,
out]`` and computes ``x @ W`` while ``nn.Linear`` stores ``[out, in]``.

``llama_state_from_numpy`` does the same for the JAX ``LlamaForCausalLM``,
whose decoder stack is one scan over STACKED per-layer parameters
(``llama.layers.self_attn__q_proj__weight`` [L, in, out]): each stacked
array is split into per-layer entries (``llama.layers.{i}.self_attn.q_proj
.weight`` [out, in]), and ``lm_head.weight`` [h, vocab] is transposed.

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
from .llama import LlamaConfig

__all__ = ["gpt_state_from_numpy", "gpt_engine_params",
           "llama_state_from_numpy"]

_LINEARS = ("attn.qkv_proj", "attn.out_proj", "fc_in", "fc_out")


def _as_f32(arr):
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)  # numpy has no bf16 torch can read
    return a


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
        a = _as_f32(arr)
        if name.endswith(".weight") and \
                any(f".{lin}." in name for lin in _LINEARS):
            a = a.T
        if a.shape != want[name]:
            raise ValueError(f"{name}: shape {a.shape} after conversion, "
                             f"expected {want[name]}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def _llama_stacked_shapes(config: LlamaConfig) -> Dict[str, tuple]:
    """Per-layer shapes of the JAX stack, by stacked name, as the JAX
    package stores them (Linear [in, out])."""
    h, i = config.hidden_size, config.intermediate_size
    kv = config.num_key_value_heads * (h // config.num_attention_heads)
    return {"self_attn__q_proj__weight": (h, h),
            "self_attn__k_proj__weight": (h, kv),
            "self_attn__v_proj__weight": (h, kv),
            "self_attn__o_proj__weight": (h, h),
            "mlp__gate_proj__weight": (h, i),
            "mlp__up_proj__weight": (h, i),
            "mlp__down_proj__weight": (i, h),
            "input_layernorm__weight": (h,),
            "post_attention_layernorm__weight": (h,)}


def llama_state_from_numpy(flat: Mapping[str, Any],
                           config: LlamaConfig) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` of the JAX ``LlamaForCausalLM`` (scanned,
    stacked layers) -> a ``state_dict`` for the port's
    :class:`~paddle_tpu_torch.models.LlamaForCausalLM` (CPU tensors).
    Raises on a missing, unexpected or misshapen entry."""
    h, v, L = (config.hidden_size, config.vocab_size,
               config.num_hidden_layers)
    stacked = {f"llama.layers.{k}": (L, *s)
               for k, s in _llama_stacked_shapes(config).items()}
    want = {"llama.embed_tokens.weight": (v, h), "llama.norm.weight": (h,),
            **stacked}
    if not config.tie_word_embeddings:
        want["lm_head.weight"] = (h, v)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    out = {}
    for name, arr in flat.items():
        a = _as_f32(arr)
        if a.shape != want[name]:
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{want[name]}")
        if name in stacked:
            leaf = name[len("llama.layers."):].replace("__", ".")
            for li in range(L):
                part = a[li].T if a.ndim == 3 else a[li]  # Linear [out, in]
                out[f"llama.layers.{li}.{leaf}"] = torch.from_numpy(
                    np.ascontiguousarray(part))
        elif name == "lm_head.weight":
            out[name] = torch.from_numpy(np.ascontiguousarray(a.T))
        else:
            out[name] = torch.from_numpy(np.ascontiguousarray(a))
    if config.tie_word_embeddings:
        out["lm_head.weight"] = out["llama.embed_tokens.weight"]
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
