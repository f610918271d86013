"""Llama-family causal LM (port of ``paddle_tpu/models/llama.py``).

Pre-norm decoder layers with RMSNorm, rotate-half RoPE, grouped-query
attention (``num_key_value_heads`` < ``num_attention_heads``) and a SwiGLU
MLP, no biases. The layer takes the fused form the TPU runs with the
JAX package's fused-kernel gate open: ``input_layernorm`` -> attention ->
``rms_norm_residual`` (residual add and post-attention norm in one kernel)
-> MLP. On CUDA the norms, RoPE and attention (forward and backward) run the
hand-written kernels of ``paddle_tpu_torch.kernels``.

Parameter names follow the JAX package with its scanned layer stack
unrolled (``llama.layers.3.self_attn.q_proj.weight``); Linear weights are
PyTorch's ``[out, in]``. ``models.convert.llama_state_from_numpy`` moves a
JAX state dict across. ``LlamaAttention`` takes the JAX attention's KV
cache; the decoder layers do not (as there).

The projections, the embedding and the head are the tensor-parallel layers
of ``distributed.meta_parallel`` (at mp = 1 exactly ``F.linear`` /
``F.embedding``). Under an installed mesh (``distributed.init_mesh``),
each rank holds ``num_heads / mp`` query and ``num_key_value_heads / mp``
key/value heads, its column and row shards of the MLP and its rows of the
vocabulary, embedding and head. Under cp > 1 (no cache) the sequence is
split over cp: RoPE rotates at global positions (``pos_offset = cp_rank *
s_local``) and attention goes to ``ring_attention``, or to
``ulysses_attention`` with ``cp_impl="ulysses"``. The labelled loss is
then the global mean over the counted tokens: the labels are shifted over
the global sequence (each cp rank takes its successor's first label, the
last position of the last rank gets -100), each rank returns ``local sum
/ global count``, its share (``loss_reduction = "sum"``: the
``ShardedTrainStep`` sums the gradients over the data ranks), and under mp
> 1 the softmax runs over the vocabulary split (``vocab_parallel_cross_
entropy``). An MoE model under a mesh of more than one rank raises
(expert parallelism is not ported).

``LlamaMoEConfig`` (the DeepSeekMoE/Qwen2-MoE-style recipe) makes every MLP
an ``nn.MoELayer`` (top-k routed experts, ``FLAGS_moe_dispatch`` picks the
dispatch). Each MoE layer returns its load-balancing aux loss beside its
output; the stack threads the per-layer values out of the (checkpointed)
layers and sums them, so a recomputed layer counts once, and the labelled
loss is ``ce + aux_loss_weight * sum(aux)``, as in the JAX model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as TF
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device, seed
from ..distributed.collective import permute_ranks
from ..distributed.context_parallel import ring_attention, ulysses_attention
from ..distributed.mesh import get_mesh_env
from ..distributed.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    copy_to_group, gather_from_group, mark_parameters, mp_info,
    vocab_parallel_cross_entropy)
from ..distributed.parallel import DATA_AXES
from ..kernels.rope import rope_apply
from ..nn import MoELayer, RMSNorm
from ..nn.layer.moe import moe_mesh
from ..nn.functional import rms_norm_residual, scaled_dot_product_attention

__all__ = ["LlamaConfig", "LlamaMoEConfig", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "apply_rotary_pos_emb", "llama_flops_per_token",
           "llama_param_count", "llama_moe_param_counts",
           "llama_moe_flops_per_token"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
IGNORE_INDEX = -100


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_recompute: bool = False
    ce_chunk: int = 2048  # fused lm_head + CE token-chunk size
    cp_impl: str = "ring"  # context-parallel attention: 'ring' | 'ulysses'
    pp_microbatches: int = 0  # microbatches for the pp pipeline (0 = 2*pp)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {sorted(_DTYPES)}")
        if self.cp_impl not in ("ring", "ulysses"):
            raise ValueError(f"cp_impl {self.cp_impl!r}: 'ring' or "
                             f"'ulysses'")
        if self.hidden_size % self.num_attention_heads or \
                self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("hidden_size must divide into the heads and the "
                             "heads into the key/value heads")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @staticmethod
    def llama2_7b(**overrides):
        return LlamaConfig(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=32, max_position_embeddings=4096),
            **overrides})

    @staticmethod
    def llama3_8b(**overrides):
        return LlamaConfig(**{**dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=8192,
            rope_theta=500000.0), **overrides})

    @staticmethod
    def tiny(**overrides):
        return LlamaConfig(**{**dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256,
            dtype="float32"), **overrides})


@dataclass
class LlamaMoEConfig(LlamaConfig):
    """DeepSeekMoE/Qwen2-MoE-style config: every MLP is a top-k routed
    expert layer (``capacity_factor`` applies to the ``index`` dispatch
    only)."""
    num_experts: int = 8
    top_k: int = 2
    moe_intermediate_size: int = 0  # 0 = intermediate_size
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    @staticmethod
    def tiny(**overrides):
        return LlamaMoEConfig(**{**dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256,
            dtype="float32", num_experts=4, top_k=2), **overrides})


def apply_rotary_pos_emb(x, theta: float = 10000.0, pos_offset: int = 0):
    """Rotate-half RoPE on [b, s, h, d] through the RoPE kernel."""
    return rope_apply(x, theta, pos_offset)


def _cp_degree():
    env = get_mesh_env()
    return 1 if env is None else env.get_dim("cp")


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        _, mp, _ = mp_info()
        for what, n in (("num_attention_heads", config.num_attention_heads),
                        ("num_key_value_heads",
                         config.num_key_value_heads)):
            if n % mp:
                raise ValueError(f"{what} ({n}) must divide by the mp "
                                 f"degree {mp}")
        self.num_heads = config.num_attention_heads // mp  # this rank's
        self.num_kv_heads = config.num_key_value_heads // mp
        self.head_dim = config.hidden_size // config.num_attention_heads
        h, hd = config.hidden_size, self.head_dim
        nh, nkv = config.num_attention_heads, config.num_key_value_heads
        self.q_proj = ColumnParallelLinear(h, nh * hd, has_bias=False,
                                           gather_output=False)
        self.k_proj = ColumnParallelLinear(h, nkv * hd, has_bias=False,
                                           gather_output=False)
        self.v_proj = ColumnParallelLinear(h, nkv * hd, has_bias=False,
                                           gather_output=False)
        self.o_proj = RowParallelLinear(nh * hd, h, has_bias=False,
                                        input_is_parallel=True)

    def forward(self, hidden, cache=None):
        """``hidden`` [b, s, h] -> [b, s, h]. With ``cache`` ``(k, v)``
        [b, past, kv_heads, hd] (before the GQA repeat), as the JAX
        attention: the new rows are rotated at positions ``past ...``, K
        and V are appended to the cache, and ``(out, (k, v))`` is returned.
        Like the reference (``is_causal = cache is None``), a cached call
        is not causal: each of several new rows sees every new key."""
        b, s = hidden.shape[0], hidden.shape[1]
        hd, theta = self.head_dim, self.config.rope_theta
        q = self.q_proj(hidden).view(b, s, self.num_heads, hd)
        k = self.k_proj(hidden).view(b, s, self.num_kv_heads, hd)
        v = self.v_proj(hidden).view(b, s, self.num_kv_heads, hd)
        cp = _cp_degree() if cache is None else 1
        pos = cache[0].shape[1] if cache is not None else \
            (get_mesh_env().coord("cp") * s if cp > 1 else 0)
        q = apply_rotary_pos_emb(q, theta, pos)
        k = apply_rotary_pos_emb(k, theta, pos)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            new_cache = (k, v)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if cp > 1:
            cp_attention = ulysses_attention \
                if self.config.cp_impl == "ulysses" else ring_attention
            out = cp_attention(q, k, v, causal=True)
        else:
            out = scaled_dot_product_attention(q, k, v,
                                               is_causal=cache is None,
                                               training=self.training)
        out = self.o_proj(out.reshape(b, s, self.num_heads * hd))
        return out if cache is None else (out, new_cache)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = ColumnParallelLinear(h, i, has_bias=False,
                                              gather_output=False)
        self.up_proj = ColumnParallelLinear(h, i, has_bias=False,
                                            gather_output=False)
        self.down_proj = RowParallelLinear(i, h, has_bias=False,
                                           input_is_parallel=True)

    def forward(self, x):
        return self.down_proj(TF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    """Returns the new hidden state; an MoE layer (``num_experts`` > 1)
    returns ``(hidden, aux)``."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(config)
        self.is_moe = getattr(config, "num_experts", 0) > 1
        if self.is_moe:
            self.mlp = MoELayer(
                config.hidden_size, config.num_experts,
                intermediate_size=config.moe_intermediate_size
                or config.intermediate_size,
                top_k=config.top_k, capacity_factor=config.capacity_factor)
        else:
            self.mlp = LlamaMLP(config)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps)

    def forward(self, hidden):
        attn_out = self.self_attn(self.input_layernorm(hidden))
        norm = self.post_attention_layernorm
        mlp_in, hidden = rms_norm_residual(attn_out, hidden, norm.weight,
                                           norm.epsilon)
        if self.is_moe:
            out, aux = self.mlp.forward_with_aux(mlp_in)
            return hidden + out, aux
        return hidden + self.mlp(mlp_in)


class LlamaModel(nn.Module):
    """The decoder stack, or with ``stage = (r, pp)`` stage r of a pp-stage
    pipeline: its ``L / pp`` decoder layers under their global names
    (``layers.{i}``), the embedding on the first stage, the final norm on
    the last."""

    def __init__(self, config: LlamaConfig, stage=None):
        super().__init__()
        self.config = config
        r, pp = stage if stage is not None else (0, 1)
        L = config.num_hidden_layers
        if L % pp:
            raise ValueError(f"num_hidden_layers ({L}) must divide by the "
                             f"pp degree {pp}")
        self.first, self.last = r == 0, r == pp - 1
        if self.first:
            self.embed_tokens = VocabParallelEmbedding(config.vocab_size,
                                                       config.hidden_size)
        if pp == 1:
            self.layers = nn.ModuleList(
                [LlamaDecoderLayer(config) for _ in range(L)])
        else:
            per = L // pp
            self.layers = nn.ModuleDict(
                {str(i): LlamaDecoderLayer(config)
                 for i in range(r * per, (r + 1) * per)})
        if self.last:
            self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def stage_layers(self):
        return list(self.layers.values()) \
            if isinstance(self.layers, nn.ModuleDict) else list(self.layers)

    def forward_with_aux(self, input_ids):
        """-> (final hidden [b, s, h], summed MoE aux loss or None)."""
        hidden, aux = self.run_layers(self.embed_tokens(input_ids))
        return self.norm(hidden), aux

    def run_layers(self, hidden):
        """This model's (or stage's) decoder layers over ``hidden`` ->
        (hidden, summed MoE aux loss or None)."""
        remat = self.config.use_recompute and self.training and \
            torch.is_grad_enabled()
        aux = None
        for layer in self.stage_layers():
            if remat:
                # the layer's forward runs again in the backward; the model
                # draws no random numbers, so no RNG state is stashed
                out = checkpoint(layer, hidden, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = layer(hidden)
            if layer.is_moe:
                hidden, a = out
                aux = a if aux is None else aux + a
            else:
                hidden = out
        return hidden, aux

    def forward(self, input_ids):
        return self.forward_with_aux(input_ids)[0]


def _ce_chunk_sum(h, w, lab):
    """Summed CE of one token chunk: logits [c, vocab] in fp32 live only
    inside this call (and again in its backward, under checkpoint)."""
    logits = torch.matmul(h, w.t()).float()
    logp = torch.log_softmax(logits, dim=-1)
    mask = lab != IGNORE_INDEX
    safe = torch.where(mask, lab, 0)
    picked = logp.gather(1, safe[:, None])[:, 0]
    return -torch.where(mask, picked, 0.0).sum()


def _ce_chunk_sum_split(h, w, lab, pg, start):
    """The same over this rank's columns ``[start, start + vocab/mp)`` of
    the vocabulary, the softmax all-reduced over ``pg``."""
    logits = torch.matmul(h, w.t())
    return vocab_parallel_cross_entropy(logits, lab, pg, start,
                                        IGNORE_INDEX).sum()


def fused_linear_ce(hidden2d, w, labels1d, chunk):
    """lm_head product + softmax cross entropy over token chunks (the JAX
    ``_fused_linear_ce``): ``n_chunks = max(n // chunk, 1)`` chunks of
    ``ceil(n / n_chunks)`` tokens, padded rows masked with -100 (the
    ignored label), mean over the counted tokens. ``w`` is the head weight
    [vocab, h]. The fp32 [N, vocab] logits never exist at once: each chunk
    is checkpointed, so its logits are recomputed in the backward, one
    chunk at a time."""
    total, count = fused_linear_ce_sum(hidden2d, w, labels1d, chunk)
    return total / count.clamp_min(1)


def fused_linear_ce_sum(hidden2d, w, labels1d, chunk, pg=None, start=0):
    """(summed CE fp32, count of counted tokens) of :func:`fused_linear_ce`;
    with ``pg`` the head ``w`` holds the vocabulary rows ``[start, start +
    vocab/mp)`` of a split over ``pg``."""
    if pg is not None:
        hidden2d = copy_to_group(hidden2d, pg)
    n = hidden2d.shape[0]
    n_chunks = max(n // chunk, 1)
    c = -(-n // n_chunks)
    pad = n_chunks * c - n
    if pad:
        hidden2d = TF.pad(hidden2d, (0, 0, 0, pad))
        labels1d = TF.pad(labels1d, (0, pad), value=IGNORE_INDEX)
    total = hidden2d.new_zeros((), dtype=torch.float32)
    grad = torch.is_grad_enabled() and (hidden2d.requires_grad
                                        or w.requires_grad)
    for i in range(n_chunks):
        h, lab = hidden2d[i * c:(i + 1) * c], labels1d[i * c:(i + 1) * c]
        args = (h, w, lab) if pg is None else (h, w, lab, pg, start)
        fn = _ce_chunk_sum if pg is None else _ce_chunk_sum_split
        if grad:
            total = total + checkpoint(fn, *args, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + fn(*args)
    return total, (labels1d != IGNORE_INDEX).sum()


class LlamaForCausalLM(nn.Module):
    """Built on ``device`` (``None`` = CUDA) in ``config.dtype``, with
    random weights drawn from ``generator`` (a ``torch.Generator`` on that
    device; ``None`` = seed 0): normal(0, 0.02) matrices and embeddings,
    unit RMSNorm weights. Under a mesh with mp > 1 each rank draws every
    full tensor and keeps its shard, so the model equals the one built at
    mp = 1 from the same generator.

    **Pipeline.** Under a mesh with pp > 1 (or with ``stage = (r, pp)``
    given, which one process may build for every r: ``pipeline_local``)
    the model is stage r (``pipelined``): its ``L / pp`` decoder layers,
    the embedding on the first stage, the final norm and the head on the
    last; every tensor is drawn as the pp = 1 model draws it and the
    stage keeps its own, so the stages together equal the pp = 1 model
    from the same generator. A tied head under pp is a copy of the
    embedding on the last stage (both marked ``pp_shared = "embed"``: the
    step all-reduces their gradients). The stage runs through
    ``pipeline_forward`` (``ShardedTrainStep``, ``pipeline_local``):
    the last stage's loss of a microbatch is its summed CE over the
    step's count of counted tokens (all microbatches, all data ranks,
    ``pipeline_prepare``), its share of the step's loss. An MoE model
    under pp raises (expert parallelism is not ported)."""

    loss_reduction = "sum"  # the labelled loss is this rank's share

    def __init__(self, config: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None, stage=None):
        super().__init__()
        dev = resolve_device(device)
        env = get_mesh_env()
        if stage is None and env is not None and env.get_dim("pp") > 1:
            stage = (env.coord("pp"), env.get_dim("pp"))
        self.pipelined = stage is not None and stage[1] > 1
        self.pp_stage = tuple(stage) if self.pipelined else (0, 1)
        self.pp_microbatches = config.pp_microbatches
        self.is_moe = getattr(config, "num_experts", 0) > 1
        if self.is_moe:
            moe_mesh()  # its groups, made by every rank before the layers
        self.config = config
        with torch.device("meta"):
            self.llama = LlamaModel(config, self.pp_stage)
            if self.llama.last:
                self.lm_head = ColumnParallelLinear(
                    config.hidden_size, config.vocab_size, has_bias=False,
                    gather_output=False)
        self.to_empty(device=dev)
        self.to(config.torch_dtype)
        if config.tie_word_embeddings:
            if not self.pipelined:
                # after materialising: to_empty gives every module its copy
                self.lm_head.weight = self.llama.embed_tokens.weight
            else:
                for held in (self.llama.first and
                             self.llama.embed_tokens.weight,
                             self.llama.last and self.lm_head.weight):
                    if held is not False:
                        held.pp_shared = "embed"
                if self.llama.last:  # saved once, as the embedding
                    self.lm_head.weight.ckpt_name = \
                        "llama.embed_tokens.weight"
                    self.lm_head.weight.ckpt_copy = True
        mark_parameters(self)  # on the parameters to_empty made
        self._pp_count = None
        self._pp_batch = None
        self._init_weights(generator if generator is not None
                           else seed(0, dev))

    def _full_order(self):
        """(name, mp_dim, ep_dim, local shape) of every parameter of the pp
        = 1 model, in its ``named_parameters`` order (shapes on meta)."""
        if not self.pipelined:
            return [(n, getattr(p, "mp_dim", None), getattr(p, "ep_dim", None),
                     tuple(p.shape)) for n, p in self.named_parameters()]
        cfg = self.config
        with torch.device("meta"):
            full = nn.Module()
            full.llama = LlamaModel(cfg)
            if not cfg.tie_word_embeddings:
                full.lm_head = ColumnParallelLinear(
                    cfg.hidden_size, cfg.vocab_size, has_bias=False,
                    gather_output=False)
        mark_parameters(full)
        return [(n, getattr(p, "mp_dim", None), getattr(p, "ep_dim", None),
                 tuple(p.shape)) for n, p in full.named_parameters()]

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator):
        _, mp, r = mp_info()
        env = get_mesh_env()
        ep, er = (env.get_dim("ep"), env.coord("ep")) if env is not None \
            else (1, 0)
        mine = dict(self.named_parameters())
        tied_head = self.pipelined and self.config.tie_word_embeddings and \
            self.llama.last
        for name, mp_dim, ep_dim, shape in self._full_order():
            if name.endswith("layernorm.weight") or name == "llama.norm.weight":
                if name in mine:
                    mine[name].fill_(1.0)
                continue
            p = mine.get(name)
            dtype, dev = self.config.torch_dtype, next(
                iter(mine.values())).device
            full = list(shape)
            if mp_dim is not None:
                full[mp_dim] *= mp
            if ep_dim is not None:
                full[ep_dim] *= ep
            t = torch.empty(full, dtype=dtype, device=dev)
            t.normal_(0.0, 0.02, generator=g)
            if ep_dim is not None:
                t = t.chunk(ep, dim=ep_dim)[er]
            if mp_dim is not None:
                t = t.chunk(mp, dim=mp_dim)[r]
            if p is not None:
                p.copy_(t)
            if tied_head and name == "llama.embed_tokens.weight":
                self.lm_head.weight.copy_(t)

    def pp_shared_shapes(self):
        """{key: local shape} of the weights tied across stages."""
        if not (self.pipelined and self.config.tie_word_embeddings):
            return {}
        _, mp, _ = mp_info()
        return {"embed": (self.config.vocab_size // mp,
                          self.config.hidden_size)}

    def pipeline_prepare(self, input_ids, labels=None):
        """Before a step's microbatches: the last stage counts the counted
        tokens of the step (this rank's batch, all-reduced over the data
        ranks under a mesh), each microbatch's loss is its summed CE over
        that count; every stage notes the local batch, whose microbatches
        it counts for an MoE stage's aux share."""
        self._pp_batch = input_ids.shape[0]
        if not self.llama.last or labels is None:
            return
        count = (labels[:, 1:] != IGNORE_INDEX).sum()
        env = get_mesh_env()
        if env is not None and env.nranks > 1:
            dist.all_reduce(count, group=env.group_over(DATA_AXES))
        self._pp_count = count

    def pipeline_forward(self, inp, input_ids, labels=None):
        """One microbatch through this stage: the first stage embeds
        ``input_ids``, the others take ``inp``; the last returns the loss
        share (with ``labels``) or the logits, the others the hidden state
        [b, s, h] to send on. An MoE stage with ``labels`` returns
        ``(that, aux share)``: ``aux_loss_weight`` times its layers' aux
        over the step's microbatches and data ranks, the JAX stage stack's
        ``aux / M`` (``stage_stack.py:242-259``), seeded by the stage
        itself."""
        llama = self.llama
        hidden = llama.embed_tokens(input_ids) if llama.first else inp
        hidden, aux = llama.run_layers(hidden)
        if aux is not None and labels is not None:
            m = max(self._pp_batch or input_ids.shape[0], 1) // \
                input_ids.shape[0]
            share = self.config.aux_loss_weight * aux / (m * _n_data())
            out = self.pipeline_forward_head(hidden, labels) if llama.last \
                else hidden
            return out, share
        if not llama.last:
            return hidden
        return self.pipeline_forward_head(hidden, labels)

    def pipeline_forward_head(self, hidden, labels):
        """The last stage's norm and head: the loss share, or the logits
        without ``labels``."""
        llama = self.llama
        hidden = llama.norm(hidden)
        pg, _, _ = mp_info()
        if labels is None:
            return gather_from_group(self.lm_head(hidden), pg)
        env = get_mesh_env()
        start = 0 if pg is None else \
            env.coord("mp") * self.lm_head.weight.shape[0]
        total, _ = fused_linear_ce_sum(
            hidden[:, :-1, :].reshape(-1, self.config.hidden_size),
            self.lm_head.weight, labels[:, 1:].reshape(-1),
            self.config.ce_chunk, pg, start)
        return total / self._pp_count.clamp_min(1)

    def forward(self, input_ids, labels=None):
        """``input_ids`` [b, s] -> logits [b, s, vocab]; with ``labels``
        [b, s], the mean next-token CE (fp32 scalar) through the chunked
        fused head, labels equal to -100 not counted, plus
        ``aux_loss_weight`` times the summed aux of an MoE model."""
        if self.pipelined:
            raise RuntimeError(
                "LlamaForCausalLM: this model is one stage of a pipeline; "
                "run it through ShardedTrainStep or pipeline_local "
                "(pipeline_forward)")
        hidden, aux = self.llama.forward_with_aux(input_ids)
        pg, _, _ = mp_info()
        if labels is None:
            return gather_from_group(self.lm_head(hidden), pg)
        env = get_mesh_env()
        if env is None or env.nranks == 1:
            h = hidden[:, :-1, :].reshape(-1, self.config.hidden_size)
            lab = labels[:, 1:].reshape(-1)
            loss = fused_linear_ce(h, self.lm_head.weight, lab,
                                   self.config.ce_chunk)
        else:
            loss = self._share_of_loss(hidden, labels, env, pg)
        if aux is not None:
            # the aux is over the global tokens on every data rank: each
            # adds its share, and the step's sum over them counts it once
            loss = loss + self.config.aux_loss_weight * aux / _n_data()
        return loss

    def _share_of_loss(self, hidden, labels, env, pg):
        """This rank's share of the global mean CE: its summed CE over the
        global count of counted tokens (all-reduced over the data ranks);
        under cp the labels shift over the global sequence."""
        cp = env.get_dim("cp")
        if cp > 1:
            me = env.coord("cp")
            nxt = permute_ranks(labels[:, :1].contiguous(), env.group("cp"),
                                me, [(i, i - 1) for i in range(1, cp)])
            if me == cp - 1:
                nxt = torch.full_like(nxt, IGNORE_INDEX)
            lab = torch.cat([labels[:, 1:], nxt], dim=1)
            h = hidden
        else:
            lab, h = labels[:, 1:], hidden[:, :-1, :]
        start = 0 if pg is None else \
            env.coord("mp") * self.lm_head.weight.shape[0]
        total, count = fused_linear_ce_sum(
            h.reshape(-1, self.config.hidden_size), self.lm_head.weight,
            lab.reshape(-1), self.config.ce_chunk, pg, start)
        dist.all_reduce(count, group=env.group_over(DATA_AXES))
        return total / count.clamp_min(1)

    def loss_from_logits(self, logits, labels):
        v = self.config.vocab_size
        return TF.cross_entropy(logits[:, :-1, :].reshape(-1, v).float(),
                                labels[:, 1:].reshape(-1),
                                ignore_index=IGNORE_INDEX)


def _n_data() -> int:
    """The data ranks of the installed mesh (dp x sdp x cp: each sees
    other tokens), 1 without one."""
    env = get_mesh_env()
    return 1 if env is None else env.size_over(DATA_AXES)


def llama_param_count(config: LlamaConfig) -> int:
    h, i, v, L = (config.hidden_size, config.intermediate_size,
                  config.vocab_size, config.num_hidden_layers)
    kvh = config.num_key_value_heads * (h // config.num_attention_heads)
    per_layer = h * h + 2 * h * kvh + h * h + 3 * h * i + 2 * h
    return L * per_layer + 2 * v * h + h


def llama_flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Model FLOPs per token (forward + backward, 6N plus the attention
    term), for MFU."""
    attn = 12 * config.num_hidden_layers * config.hidden_size * seq_len
    return 6 * llama_param_count(config) + attn


def llama_moe_param_counts(config: LlamaMoEConfig):
    """(total, activated per token) parameter counts of the MoE model: every
    token runs attention, embeddings and the router but only ``top_k`` of
    the ``num_experts`` expert FFNs."""
    h, v, L = (config.hidden_size, config.vocab_size,
               config.num_hidden_layers)
    i = config.moe_intermediate_size or config.intermediate_size
    kvh = config.num_key_value_heads * (h // config.num_attention_heads)
    attn_layer = h * h + 2 * h * kvh + h * h + 2 * h
    expert = 3 * h * i
    gate = h * config.num_experts
    shared = L * (attn_layer + gate) + 2 * v * h + h
    total = shared + L * config.num_experts * expert
    activated = shared + L * config.top_k * expert
    return total, activated


def llama_moe_flops_per_token(config: LlamaMoEConfig, seq_len: int) -> float:
    """Model FLOPs per token for MFU on the MoE model: 6 x the ACTIVATED
    parameters plus the attention term (capacity overcompute counts as
    overhead, not useful work)."""
    _, activated = llama_moe_param_counts(config)
    attn = 12 * config.num_hidden_layers * config.hidden_size * seq_len
    return 6 * activated + attn
