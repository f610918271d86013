"""GPT-2/3-family causal LM (port of ``paddle_tpu/models/gpt.py``).

Pre-LN blocks with biases, learned absolute position embeddings, a
tanh-approximated GELU MLP and a head tied to the token embedding.
Parameter names follow the JAX package (``gpt.layers.0.attn.qkv_proj.weight``)
but Linear weights are PyTorch's ``[out, in]``; ``models.convert`` transposes
the JAX package's ``[in, out]``. The qkv projection's output columns are
ordered ``[3][heads][head_dim]``. Attention goes through
``nn.functional.scaled_dot_product_attention``: the flash kernels on CUDA,
or, with attention dropout in training, the JAX package's plain composition.

Under a mesh with mp > 1 the layers are the tensor-parallel ones of
``distributed.meta_parallel`` as in the JAX model (``gpt.py:71-73,
105-108, 130``): ``qkv_proj`` and ``fc_in`` column-parallel, ``out_proj``
and ``fc_out`` row-parallel, the token embedding vocabulary-parallel, and
the tied head the vocabulary-split product with the parallel cross
entropy. The fused ``qkv_proj`` is split per head: a rank holds the q, k
and v rows of heads ``[r nh/mp, (r + 1) nh/mp)`` (``mp_blocks`` 3,
:func:`gpt_shard`), so its output views as ``[3][its heads][head_dim]``.
At mp = 1 those layers are exactly ``nn.Linear`` / ``nn.Embedding``.

Training follows the JAX model: dropout after the embeddings, in
attention and after each residual branch (``hidden_dropout_prob``,
``attention_probs_dropout_prob``; active only in ``train()``), each layer
under ``torch.utils.checkpoint`` with ``use_recompute``, and
``forward(ids, labels=)`` returning the chunked fused lm-head CE. Every
dropout draws its keep mask from the one ``torch.Generator`` the model
owns (``dropout_generator``); a recomputed layer draws the masks its
first run drew, from the generator set back to where that run began
(``nn.functional.common.rewinding``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..device import resolve_device, seed
from ..distributed.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    copy_to_group, gather_from_group, mark_parameters, mp_info, mp_shard)
from ..nn import Dropout
from ..nn.functional import scaled_dot_product_attention
from ..nn.functional.common import drawing_generator, rewinding
from .llama import fused_linear_ce, fused_linear_ce_sum

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTForCausalLMPipe", "gpt_param_count",
           "gpt_mp_dim", "gpt_shard"]

# the dim each tensor-parallel parameter is split on over mp, by name suffix
_MP_DIMS = {"embed_tokens.weight": 0, "attn.qkv_proj.weight": 0,
            "attn.qkv_proj.bias": 0, "attn.out_proj.weight": 1,
            "fc_in.weight": 0, "fc_in.bias": 0, "fc_out.weight": 1}
_QKV = ("attn.qkv_proj.weight", "attn.qkv_proj.bias")


def _suffix_of(name, table):
    for suffix in table:
        if name == suffix or name.endswith("." + suffix):
            return suffix
    return None


def gpt_mp_dim(name: str):
    """The dim of GPT's parameter ``name`` split over mp (column layers
    their rows, row layers their columns, the vocabulary its rows), None
    for a replicated one."""
    suffix = _suffix_of(name, _MP_DIMS)
    return None if suffix is None else _MP_DIMS[suffix]


def gpt_shard(name: str, full: torch.Tensor, mp: int, r: int):
    """Rank ``r``'s shard over ``mp`` of GPT's full parameter ``name``: the
    q/k/v projection's rows per head (``[3][heads][head_dim]``, each of q,
    k, v cut alike), every other split tensor a contiguous chunk."""
    dim = gpt_mp_dim(name)
    if dim is None or mp == 1:
        return full
    blocks = 3 if _suffix_of(name, _QKV) else 1
    return mp_shard(full, mp, r, dim, blocks)


class _QKVColumn(ColumnParallelLinear):
    """The fused q/k/v projection: column-parallel by head (``mp_blocks``
    3: a rank's rows are its heads' rows of each of q, k, v)."""

    def _mark_params(self):
        super()._mark_params()
        for p in (self.weight, self.bias):
            if p is not None:
                p.mp_blocks = 3

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
    attention_probs_dropout_prob: float = 0.0
    hidden_dropout_prob: float = 0.0
    use_recompute: bool = False
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
    def gpt2_xl(**overrides):
        return GPTConfig(**{**dict(hidden_size=1600, num_hidden_layers=48,
                                   num_attention_heads=25), **overrides})

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
        _, mp, _ = mp_info()
        if config.num_attention_heads % mp:
            raise ValueError(f"num_attention_heads "
                             f"({config.num_attention_heads}) must divide by "
                             f"the mp degree {mp}")
        self.num_heads = config.num_attention_heads // mp  # this rank's
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        self.qkv_proj = _QKVColumn(h, 3 * h, has_bias=True,
                                   gather_output=False)
        self.out_proj = RowParallelLinear(h, h, has_bias=True,
                                          input_is_parallel=True)
        self.dropout_p = config.attention_probs_dropout_prob
        self.generator: Optional[torch.Generator] = None

    def forward(self, hidden, cache=None, use_cache=False):
        b, s = hidden.shape[0], hidden.shape[1]
        qkv = self.qkv_proj(hidden).view(b, s, 3, self.num_heads,
                                         self.head_dim)
        q, k, v = qkv.unbind(2)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        # bottom-right aligned causal mask: cache-safe
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout_p if self.training else 0.0,
            generator=self.generator)
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
        self.fc_in = ColumnParallelLinear(h, config.intermediate_size,
                                          has_bias=True, gather_output=False)
        self.fc_out = RowParallelLinear(config.intermediate_size, h,
                                        has_bias=True, input_is_parallel=True)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, hidden, cache=None, use_cache=False):
        attn_out = self.attn(self.ln_1(hidden), cache=cache,
                             use_cache=use_cache)
        if use_cache:
            attn_out, new_cache = attn_out
        hidden = hidden + self.dropout(attn_out)
        mlp = self.fc_out(
            TF.gelu(self.fc_in(self.ln_2(hidden)), approximate="tanh"))
        hidden = hidden + self.dropout(mlp)
        if use_cache:
            return hidden, new_cache
        return hidden


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(config.vocab_size,
                                                   config.hidden_size)
        self.embed_positions = nn.Embedding(config.max_position_embeddings,
                                            config.hidden_size)
        self.drop = Dropout(config.hidden_dropout_prob)
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
        hidden = self.drop(hidden)
        remat = self.config.use_recompute and self.training and \
            torch.is_grad_enabled()
        # a recomputed layer rewinds the generator its dropouts draw from
        gens = []
        if remat and (self.drop.p > 0 or any(
                layer.dropout.p > 0 or layer.attn.dropout_p > 0
                for layer in self.layers)):
            gens = [drawing_generator(self.drop.generator, hidden.device)]
        new_caches = []
        for i, layer in enumerate(self.layers):
            if use_cache:
                hidden, c = layer(hidden, cache=None if caches is None
                                  else caches[i], use_cache=True)
                new_caches.append(c)
            elif remat:
                # the forward runs again in the backward and draws its
                # first run's keep masks again
                hidden = checkpoint(rewinding(layer, gens), hidden,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                hidden = layer(hidden)
        hidden = self.ln_f(hidden)
        if use_cache:
            return hidden, new_caches
        return hidden


def _draw(name, shape, mp, r, g, dtype, dev):
    """GPT's initial value of parameter ``name`` (local ``shape``): zero
    biases, unit LayerNorm scales, normal(0, 0.02) otherwise, drawn at its
    full shape from ``g`` and cut to this rank's shard over ``mp``."""
    if name.endswith("bias"):
        return torch.zeros(shape, dtype=dtype, device=dev)
    if ".ln_" in name:
        return torch.ones(shape, dtype=dtype, device=dev)
    full = list(shape)
    dim = gpt_mp_dim(name)
    if dim is not None:
        full[dim] *= mp
    w = torch.empty(full, dtype=dtype, device=dev)
    w.normal_(0.0, 0.02, generator=g)
    return gpt_shard(name, w, mp, r)


def _tied_logits(hidden, w):
    """Logits of the tied head ``w`` (this rank's vocabulary rows under
    mp), gathered to the whole vocabulary."""
    pg, _, _ = mp_info()
    return gather_from_group(TF.linear(copy_to_group(hidden, pg), w), pg)


class GPTForCausalLM(nn.Module):
    """Tied-embedding LM head. Built on ``device`` (``None`` = CUDA) in
    ``config.dtype``, with random weights drawn from ``generator`` (a
    ``torch.Generator`` on that device; ``None`` = seed 0): normal(0, 0.02)
    matrices and embeddings, zero biases, unit LayerNorm scales. Its
    dropouts draw from ``dropout_generator``, seeded with
    ``dropout_seed``. Under a mesh with mp > 1 each rank draws every full
    tensor and keeps its shard, so the model equals the one built at mp =
    1 from the same generator."""

    def __init__(self, config: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.gpt = GPTModel(config)
        self.to_empty(device=dev)
        self.to(config.torch_dtype)
        mark_parameters(self)  # on the parameters to_empty made
        self._init_weights(generator if generator is not None
                           else seed(0, dev))
        self.dropout_generator = seed(dropout_seed, dev)
        for m in self.modules():
            if isinstance(m, (Dropout, GPTAttention)):
                m.generator = self.dropout_generator

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator):
        _, mp, r = mp_info()
        for name, p in self.named_parameters():
            p.copy_(_draw(name, p.shape, mp, r, g, p.dtype, p.device))

    def forward(self, input_ids, labels=None):
        """``input_ids`` [b, s] int64 -> logits [b, s, vocab]; with
        ``labels`` [b, s], the mean next-token CE (fp32 scalar) through the
        chunked fused head (chunks of 2048 tokens), labels equal to -100
        not counted; under mp the softmax runs over the vocabulary split
        (``vocab_parallel_cross_entropy``)."""
        hidden = self.gpt(input_ids)
        w = self.gpt.embed_tokens.weight
        if labels is None:
            return _tied_logits(hidden, w)
        h = hidden[:, :-1, :].reshape(-1, self.config.hidden_size)
        lab = labels[:, 1:].reshape(-1)
        pg, _, r = mp_info()
        if pg is None:
            return fused_linear_ce(h, w, lab, 2048)
        total, count = fused_linear_ce_sum(h, w, lab, 2048, pg,
                                           r * w.shape[0])
        return total / count.clamp_min(1)

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
            logits = _tied_logits(hidden[:, -1, :], w)
            nxt = logits.argmax(dim=-1).view(-1, 1).to(out.dtype)
            out = torch.cat([out, nxt], dim=1)
            if step + 1 < max_new_tokens:  # last token needs no lookahead
                hidden, caches = self.gpt(nxt,
                                          position_offset=out.shape[1] - 1,
                                          caches=caches, use_cache=True)
        return out


def gpt_param_count(config: GPTConfig) -> int:
    h, L = config.hidden_size, config.num_hidden_layers
    i = config.intermediate_size
    # qkv (3h^2+3h) + out_proj (h^2+h) + mlp (2hi+i+h) + 2 LN (4h)
    per_layer = 4 * h * h + 2 * h * i + i + 9 * h
    return (L * per_layer + config.vocab_size * h
            + config.max_position_embeddings * h + 2 * h)


# -- the pipeline preset ---------------------------------------------------------
# Reference: fleetx GPTForPretrainingPipe (a PipelineLayer of the
# SharedLayerDesc embedding, GPTBlock LayerDescs and the tied head), run by
# PipelineParallel.train_batch; JAX models/gpt.py:218-283.

class _GPTEmbeddingPipe(nn.Module):
    """ids -> token + learned position embeddings (with dropout); the tied
    head too, through ``SharedLayerDesc``'s ``forward_func``."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(config.vocab_size,
                                                   config.hidden_size)
        self.embed_positions = nn.Embedding(config.max_position_embeddings,
                                            config.hidden_size)
        self.drop = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        return self.drop(self.embed_tokens(input_ids)
                         + self.embed_positions(pos))


def _gpt_tied_logits(embed: _GPTEmbeddingPipe, hidden):
    return _tied_logits(hidden, embed.embed_tokens.weight)


class _GPTFinalNormPipe(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 config.layer_norm_epsilon)

    def forward(self, hidden):
        return self.ln_f(hidden)


def _gpt_shifted_ce(logits, labels):
    v = logits.shape[-1]
    return TF.cross_entropy(logits[:, :-1, :].reshape(-1, v).float(),
                            labels[:, 1:].reshape(-1), ignore_index=-100)


def GPTForCausalLMPipe(config: GPTConfig, device=None,
                       generator: Optional[torch.Generator] = None,
                       dropout_seed: int = 0, **pipeline_kwargs):
    """``GPTForCausalLM`` as a ``PipelineLayer`` (JAX ``models/gpt.py:
    218-283``): the ``SharedLayerDesc`` embedding, a ``GPTBlock``
    ``LayerDesc`` per layer, the final LayerNorm and the tied head (the
    embedding again), the shifted cross entropy as its loss. Built on
    ``device`` in ``config.dtype``; every stage draws the weights as
    ``GPTForCausalLM`` draws them from ``generator`` and keeps its own (so
    at pp = 1 the two models are equal from the same generator), and a
    stage's dropouts draw from a generator of its own (``dropout_seed``
    plus the stage). Under a mesh with pp > 1 a rank builds its stage: the
    embedding on the first, the head on the last, tied across them
    (``pp_shared``). ``use_recompute`` recomputes every block. Under mp
    > 1 its layers are split as ``GPTForCausalLM``'s, each rank keeping its
    shard of every tensor drawn; the head's logits are gathered over mp
    before the loss."""
    from ..distributed.meta_parallel import (LayerDesc, PipelineLayer,
                                             SharedLayerDesc)
    from ..distributed.meta_parallel.pp_layers import _SharedProxy

    dev = resolve_device(device)
    descs = [SharedLayerDesc("embed", _GPTEmbeddingPipe, None,
                             "embed_tokens.weight", config),
             *[LayerDesc(GPTBlock, config)
               for _ in range(config.num_hidden_layers)],
             LayerDesc(_GPTFinalNormPipe, config),
             SharedLayerDesc("embed", _GPTEmbeddingPipe, _gpt_tied_logits,
                             "embed_tokens.weight", config)]
    if config.use_recompute:
        pipeline_kwargs.setdefault("recompute_interval", 1)
    pipe = PipelineLayer(layers=descs, loss_fn=_gpt_shifted_ce,
                         build_device="meta", **pipeline_kwargs)
    pipe.to_empty(device=dev)
    pipe.to(config.torch_dtype)
    mark_parameters(pipe)
    pipe.mark_shared()  # on the parameters to_empty made
    mine = dict(pipe.named_parameters())
    alias = {}  # a stage's copy of a weight tied to another stage's
    for key, layer in pipe.run_function.items():
        if isinstance(layer, _SharedProxy) and "shared" in layer._modules:
            j = pipe.shared_first["embed"]
            for n, _ in layer.shared.named_parameters():
                alias[f"run_function.{j}.{n}"] = \
                    f"run_function.{key}.shared.{n}"
    g = generator if generator is not None else seed(0, dev)
    _, mp, r = mp_info()
    with torch.no_grad():
        for name, shape in pipe.full_param_shapes:
            targets = [t for t in (mine.get(name), mine.get(alias.get(name)))
                       if t is not None]
            w = _draw(name, shape, mp, r, g, config.torch_dtype, dev)
            for t in targets:
                t.copy_(w)
    pipe.dropout_generator = seed(dropout_seed + pipe.stage_id, dev)
    for m in pipe.modules():
        if isinstance(m, (Dropout, GPTAttention)):
            m.generator = pipe.dropout_generator
    if config.hidden_dropout_prob > 0 or \
            config.attention_probs_dropout_prob > 0:
        pipe.recompute_generators = [pipe.dropout_generator]
    return pipe
