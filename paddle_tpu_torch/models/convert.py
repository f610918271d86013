"""Weights across the two packages.

``gpt_state_from_numpy`` turns the JAX model's ``state_dict()`` (as numpy
arrays) into this package's ``state_dict``: the names are the same, and the
Linear weights are transposed, since the JAX package stores them ``[in,
out]`` and computes ``x @ W`` while ``nn.Linear`` stores ``[out, in]``.

``llama_state_from_numpy`` does the same for the JAX ``LlamaForCausalLM``
(dense or MoE) in either of its layouts. With ``scan_layers=True`` (the
default) the decoder stack is one scan over STACKED per-layer parameters
(``llama.layers.self_attn__q_proj__weight`` [L, in, out]); each is split
into per-layer entries (``llama.layers.{i}.self_attn.q_proj.weight``).
With ``scan_layers=False`` the entries are per layer already
(``llama.layers.{i}.self_attn.q_proj.weight`` [in, out]). Linear weights
are transposed to ``[out, in]``, ``lm_head.weight`` [h, vocab] too. The MoE
router ``mlp.gate_weight`` [h, e] is a raw parameter used as ``x @ w`` and
the expert stacks ``mlp.experts.{gate,up,down}`` ([e, h, i], [e, i, h])
keep the JAX layout: neither is transposed.

``shard_llama_state`` turns such a full state into one rank's slices under
a mesh (tensor-parallel rows or columns, vocabulary rows, and under ZeRO-3
each parameter's sdp shard); ``gather_llama_state`` is its inverse over
every rank's state.

``shard_gpt_state`` and ``gather_gpt_state`` do the same for GPT, whose
fused ``qkv_proj`` is split per head (``models.gpt.gpt_shard``: a rank
holds the q, k and v rows of its heads, not a contiguous third).

``bert_state_from_numpy`` does it for the JAX BERT models
(``BertModel``, ``BertForPretraining``, ``BertForSequenceClassification``):
only the tensor-parallel layers' weights (each layer's ``qkv``,
``attn_out``, ``ffn_in``, ``ffn_out``) are transposed to ``[out, in]``;
the paddle ``nn.Linear`` weights (pooler, heads) stay ``[in, out]``, as the
port's ``nn.Linear`` holds them.

``dit_state_from_numpy`` does it for the JAX ``DiT``: each block's
tensor-parallel ``qkv``, ``proj``, ``fc1`` and ``fc2`` weights are
transposed to ``[out, in]``; the ``nn.Linear`` ones (``patch_proj``, the
timestep MLP, ``ada``, ``final_ada``, ``final_proj``) stay ``[in, out]``.

``resnet_state_from_numpy`` does it for the JAX vision ``ResNet``: the
names and layouts are the same in both packages (conv kernels OIHW, the
head's ``nn.Linear`` ``[in, out]``, each BatchNorm's ``_mean`` and
``_variance`` buffers beside its weight and bias), so it only checks the
entries and makes tensors.

``gpt_engine_params`` reads a model's live weights into the nested dict the
serving window step takes (the counterpart of the JAX engine's
``_extract_gpt_params``), with Linear weights in ``[out, in]`` for
``F.linear``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..distributed.meta_parallel.mp_layers import mp_unshard
from .gpt import GPTConfig, gpt_mp_dim, gpt_shard
from .llama import LlamaConfig

__all__ = ["gpt_state_from_numpy", "gpt_engine_params",
           "bert_state_from_numpy", "dit_state_from_numpy",
           "resnet_state_from_numpy",
           "llama_state_from_numpy", "llama_mp_dim", "llama_ep_dim",
           "shard_llama_state", "gather_llama_state", "shard_gpt_state",
           "gather_gpt_state"]

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


_BERT_MP = ("qkv", "attn_out", "ffn_in", "ffn_out")


def bert_state_from_numpy(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` of a JAX BERT model -> a ``state_dict`` for
    the port's model of the same class (CPU tensors; the names are the
    same; ``set_state_dict`` / ``load_state_dict`` cast them to the
    model's device and dtype)."""
    out = {}
    for name, arr in flat.items():
        a = _as_f32(arr)
        parts = name.split(".")
        if name.endswith(".weight") and len(parts) >= 3 and \
                parts[-2] in _BERT_MP and ".layers." in name:
            a = a.T
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


_DIT_MP = ("qkv", "proj", "fc1", "fc2")


def dit_state_from_numpy(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` of a JAX ``DiT`` -> a ``state_dict`` for the
    port's (CPU tensors, the same names; loading casts them to the
    model's device and dtype)."""
    out = {}
    for name, arr in flat.items():
        a = _as_f32(arr)
        parts = name.split(".")
        if parts[0] == "blocks" and len(parts) == 4 and \
                parts[2] in _DIT_MP and parts[3] == "weight":
            a = a.T
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def resnet_state_from_numpy(flat: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` of a JAX vision ``ResNet`` (parameters and
    the BatchNorm buffers ``_mean`` / ``_variance``) -> a ``state_dict``
    for the port's (CPU tensors; nothing is transposed). Raises on an
    entry that is neither a parameter nor a BatchNorm buffer."""
    out = {}
    for name, arr in flat.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf not in ("weight", "bias", "_mean", "_variance"):
            raise KeyError(f"resnet_state_from_numpy: unexpected entry "
                           f"{name!r}")
        out[name] = torch.from_numpy(np.ascontiguousarray(_as_f32(arr)))
    return out


def _llama_layer_entries(config: LlamaConfig) -> Dict[str, tuple]:
    """Per-layer entries of the JAX Llama by the port's dotted name: (shape
    as the JAX package stores it, whether it is a Linear weight stored [in,
    out])."""
    h = config.hidden_size
    kv = config.num_key_value_heads * (h // config.num_attention_heads)
    out = {"self_attn.q_proj.weight": ((h, h), True),
           "self_attn.k_proj.weight": ((h, kv), True),
           "self_attn.v_proj.weight": ((h, kv), True),
           "self_attn.o_proj.weight": ((h, h), True),
           "input_layernorm.weight": ((h,), False),
           "post_attention_layernorm.weight": ((h,), False)}
    e = getattr(config, "num_experts", 0)
    if e > 1:
        i = config.moe_intermediate_size or config.intermediate_size
        out.update({"mlp.gate_weight": ((h, e), False),
                    "mlp.experts.gate": ((e, h, i), False),
                    "mlp.experts.up": ((e, h, i), False),
                    "mlp.experts.down": ((e, i, h), False)})
    else:
        i = config.intermediate_size
        out.update({"mlp.gate_proj.weight": ((h, i), True),
                    "mlp.up_proj.weight": ((h, i), True),
                    "mlp.down_proj.weight": ((i, h), True)})
    return out


def _per_layer_layout(flat: Mapping[str, Any]) -> bool:
    """True for the JAX ``scan_layers=False`` layout (``llama.layers.0.``
    entries), False for the stacked one."""
    return any(k.startswith("llama.layers.") and
               k[len("llama.layers."):].split(".", 1)[0].isdigit()
               for k in flat)


def llama_state_from_numpy(flat: Mapping[str, Any],
                           config: LlamaConfig) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` of the JAX ``LlamaForCausalLM``, dense or MoE,
    stacked (``scan_layers=True``) or per layer -> a ``state_dict`` for
    the port's :class:`~paddle_tpu_torch.models.LlamaForCausalLM` (CPU
    tensors). Raises on a missing, unexpected or misshapen entry."""
    h, v, L = (config.hidden_size, config.vocab_size,
               config.num_hidden_layers)
    entries = _llama_layer_entries(config)
    per_layer = _per_layer_layout(flat)
    # JAX name -> (shape, port leaf, Linear?, layer index or None: stacked)
    want = {"llama.embed_tokens.weight": ((v, h), None, False, None),
            "llama.norm.weight": ((h,), None, False, None)}
    if not config.tie_word_embeddings:
        want["lm_head.weight"] = ((h, v), None, True, None)
    for leaf, (shape, linear) in entries.items():
        if per_layer:
            for li in range(L):
                want[f"llama.layers.{li}.{leaf}"] = (shape, leaf, linear, li)
        else:
            want["llama.layers." + leaf.replace(".", "__")] = (
                (L, *shape), leaf, linear, None)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    out = {}

    def put(name, a, linear):  # a copy: the source may be read-only
        out[name] = torch.from_numpy(np.array(a.T if linear else a,
                                              order="C"))

    for name, arr in flat.items():
        a = _as_f32(arr)
        shape, leaf, linear, li = want[name]
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        if leaf is None:
            put(name, a, linear)
        elif li is not None:
            put(f"llama.layers.{li}.{leaf}", a, linear)
        else:
            for i in range(L):
                put(f"llama.layers.{i}.{leaf}", a[i], linear)
    if config.tie_word_embeddings:
        out["lm_head.weight"] = out["llama.embed_tokens.weight"]
    return out


# the dim of the torch-layout tensor that tensor parallelism splits
_MP_DIMS = {"llama.embed_tokens.weight": 0, "lm_head.weight": 0,
            "self_attn.q_proj.weight": 0, "self_attn.k_proj.weight": 0,
            "self_attn.v_proj.weight": 0, "self_attn.o_proj.weight": 1,
            "mlp.gate_proj.weight": 0, "mlp.up_proj.weight": 0,
            "mlp.down_proj.weight": 1, "mlp.experts.gate": 2,
            "mlp.experts.up": 2, "mlp.experts.down": 1}
# the dim expert parallelism splits: the MoE layer's expert stacks
_EP_DIMS = {"mlp.experts.gate": 0, "mlp.experts.up": 0,
            "mlp.experts.down": 0}
_MESH_ORDER = ("pp", "dp", "sdp", "ep", "cp", "mp")


def _dim_of(table, name):
    for suffix, dim in table.items():
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


def llama_mp_dim(name: str):
    """The dim of the port Llama's parameter ``name`` split over mp (column
    layers their rows, row layers their columns, the vocabulary its rows,
    the experts their intermediate dim), None for a replicated one."""
    return _dim_of(_MP_DIMS, name)


def llama_ep_dim(name: str):
    """The dim of the port MoE Llama's parameter ``name`` split over ep
    (the expert stacks' first), None for one every ep rank holds whole."""
    return _dim_of(_EP_DIMS, name)


def _coords(rank: int, degrees: Mapping[str, int]) -> Dict[str, int]:
    """A rank's coordinate on each axis of the row-major mesh grid."""
    out = {}
    for ax in reversed(_MESH_ORDER):
        n = int(degrees.get(ax, 1))
        out[ax] = rank % n
        rank //= n
    return out


def _zero3_dim(shape, n):
    """The dim ZeRO splits over ``n`` ranks: the largest that divides (the
    first of equals), None where none does or n is 1."""
    if n <= 1:
        return None
    best = None
    for i, s in enumerate(shape):
        if s % n == 0 and (best is None or s > shape[best]):
            best = i
    return best


def _zero3_name(name: str) -> str:
    mod, leaf = name.rsplit(".", 1)
    return f"{mod}.parametrizations.{leaf}.original"


def llama_stage_of(name: str, num_layers: int, pp: int):
    """The pp stages that hold the port Llama's parameter ``name``: a
    decoder layer's ``L / pp`` block, the embedding the first, the final
    norm and the head the last (a tied head: both)."""
    if pp <= 1:
        return [0]
    if name.startswith("llama.layers."):
        return [int(name.split(".")[2]) // (num_layers // pp)]
    if name.startswith("llama.embed_tokens."):
        return [0]
    return [pp - 1]


def _num_layers(state) -> int:
    return 1 + max((int(k.split(".")[2]) for k in state
                    if k.startswith("llama.layers.")), default=-1)


def shard_llama_state(state: Mapping[str, torch.Tensor], env=None, *,
                      degrees: Mapping[str, int] = None, rank: int = None,
                      stage3: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full port Llama ``state`` (as
    ``llama_state_from_numpy`` gives it) under ``env`` (a ``MeshEnv``) or
    ``degrees`` and ``rank``: under pp > 1 the tensors of this rank's
    stage only (:func:`llama_stage_of`; a tied head, ``lm_head.weight``
    equal to the embedding, also on the last stage), under their global
    names; expert stacks cut on :func:`llama_ep_dim` over ep, then
    tensor-parallel parameters on :func:`llama_mp_dim`; and
    with ``stage3`` every parameter that splits cut again over sdp, under
    the name its ZeRO-3 parametrization takes
    (``...parametrizations.weight.original``)."""
    if env is not None:
        degrees, rank = env.degrees, env.rank
    c = _coords(rank, degrees)
    mp, sdp = int(degrees.get("mp", 1)), int(degrees.get("sdp", 1))
    pp, L = int(degrees.get("pp", 1)), _num_layers(state)
    ep = int(degrees.get("ep", 1))
    out = {}
    for name, t in state.items():
        if c["pp"] not in llama_stage_of(name, L, pp):
            continue
        edim = llama_ep_dim(name)
        if edim is not None and ep > 1:
            t = t.chunk(ep, dim=edim)[c["ep"]]
        dim = llama_mp_dim(name)
        if dim is not None and mp > 1:
            t = t.chunk(mp, dim=dim)[c["mp"]]
        zdim = _zero3_dim(t.shape, sdp) if stage3 else None
        if zdim is not None:
            t = t.chunk(sdp, dim=zdim)[c["sdp"]]
            name = _zero3_name(name)
        out[name] = t.contiguous().clone()
    return out


def _llama_shapes(config: LlamaConfig) -> Dict[str, tuple]:
    """The port Llama's parameter shapes (torch layout), per layer leaf or
    top-level name."""
    h, v = config.hidden_size, config.vocab_size
    out = {"llama.embed_tokens.weight": (v, h), "llama.norm.weight": (h,),
           "lm_head.weight": (v, h)}
    for leaf, (shape, linear) in _llama_layer_entries(config).items():
        out[leaf] = tuple(reversed(shape)) if linear else shape
    return out


def gather_llama_state(states, config: LlamaConfig,
                       degrees: Mapping[str, int],
                       stage3: bool = False) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_llama_state` over ``states``, every
    rank's state in rank order: the full state under the plain names,
    each tensor from the pp stage that holds it (a tied head under pp from
    the last stage's copy), the expert stacks joined over ep."""
    mp, sdp = int(degrees.get("mp", 1)), int(degrees.get("sdp", 1))
    pp, ep = int(degrees.get("pp", 1)), int(degrees.get("ep", 1))
    coords = [_coords(r, degrees) for r in range(len(states))]
    shapes = _llama_shapes(config)
    stage_of = {}

    def rank_at(x, m, z, s=0):
        return next(r for r, c in enumerate(coords)
                    if c["ep"] == x and c["mp"] == m and c["sdp"] == z and
                    c["pp"] == s and
                    all(c[a] == 0 for a in _MESH_ORDER
                        if a not in ("ep", "mp", "sdp", "pp")))

    for s in range(pp):
        for key in states[rank_at(0, 0, 0, s)]:
            stage_of.setdefault(key, s)
    out = {}
    for key, s in stage_of.items():
        name = key.replace(".parametrizations.", ".")
        if name.endswith(".original"):
            name = name[:-len(".original")]
        dim, edim = llama_mp_dim(name), llama_ep_dim(name)
        experts = []
        for x in range(ep if edim is not None else 1):
            parts = []
            for m in range(mp if dim is not None else 1):
                shards = [states[rank_at(x, m, z, s)][key]
                          for z in range(sdp)]
                if stage3 and key != name:
                    local = list(shapes.get(name) or
                                 shapes[name.split(".", 3)[-1]])
                    if dim is not None:
                        local[dim] //= mp
                    if edim is not None:
                        local[edim] //= ep
                    parts.append(torch.cat(shards,
                                           dim=_zero3_dim(local, sdp)))
                else:
                    parts.append(shards[0])
            experts.append(torch.cat(parts, dim=dim) if len(parts) > 1
                           else parts[0])
        out[name] = torch.cat(experts, dim=edim) if len(experts) > 1 \
            else experts[0]
    return out


def shard_gpt_state(state: Mapping[str, torch.Tensor], env=None, *,
                    degrees: Mapping[str, int] = None, rank: int = None,
                    stage3: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full port GPT ``state`` (as
    ``gpt_state_from_numpy`` gives it) under ``env`` or ``degrees`` and
    ``rank``: tensor-parallel parameters cut on ``models.gpt.gpt_mp_dim``
    (the q/k/v projection per head), and with ``stage3`` every parameter
    that splits cut again over sdp, under its ZeRO-3 name."""
    if env is not None:
        degrees, rank = env.degrees, env.rank
    c = _coords(rank, degrees)
    mp, sdp = int(degrees.get("mp", 1)), int(degrees.get("sdp", 1))
    out = {}
    for name, t in state.items():
        t = gpt_shard(name, t, mp, c["mp"])
        zdim = _zero3_dim(t.shape, sdp) if stage3 else None
        if zdim is not None:
            t = t.chunk(sdp, dim=zdim)[c["sdp"]]
            name = _zero3_name(name)
        out[name] = t.contiguous().clone()
    return out


def gather_gpt_state(states, config: GPTConfig, degrees: Mapping[str, int],
                     stage3: bool = False) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_gpt_state` over ``states``, every rank's
    state in rank order: the full state under the plain names."""
    mp, sdp = int(degrees.get("mp", 1)), int(degrees.get("sdp", 1))
    shapes = _expected_shapes(config)
    coords = [_coords(r, degrees) for r in range(len(states))]

    def rank_at(m, z):
        return next(r for r, c in enumerate(coords)
                    if c["mp"] == m and c["sdp"] == z and
                    all(c[a] == 0 for a in _MESH_ORDER
                        if a not in ("mp", "sdp")))

    out = {}
    for key in states[0]:
        name = key.replace(".parametrizations.", ".")
        if name.endswith(".original"):
            name = name[:-len(".original")]
        dim = gpt_mp_dim(name)
        parts = []
        for m in range(mp if dim is not None else 1):
            shards = [states[rank_at(m, z)][key] for z in range(sdp)]
            if stage3 and key != name:
                local = list(shapes[name])
                if dim is not None:
                    local[dim] //= mp
                parts.append(torch.cat(shards,
                                       dim=_zero3_dim(local, sdp)))
            else:
                parts.append(shards[0])
        blocks = 3 if ".attn.qkv_proj." in name else 1
        out[name] = mp_unshard(parts, dim, blocks) if len(parts) > 1 \
            else parts[0]
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
