"""BERT (port of ``paddle_tpu/models/bert.py``), written on the port's
paddle surface: ``nn.Layer``, ``nn.Embedding``/``LayerNorm``/``Dropout``/
``Linear``/``LayerList``, ``ParamAttr`` with ``TruncatedNormal``, the op
functions, ``F.gelu``/``F.tanh``/``F.cross_entropy`` and
``F.scaled_dot_product_attention``, and the tensor-parallel layers for the
fused q/k/v projection, the attention output and the FFN (as the JAX
model builds them).

Parameter names are the JAX model's. Its weights are paddle's ``[in, out]``
everywhere; here the ``nn.Linear`` ones (pooler, MLM transform, NSP and
classifier heads) keep that layout and the tensor-parallel ones hold
torch's ``[out, in]``, so ``models/convert.py``'s ``bert_state_from_numpy``
transposes those four per layer and nothing else. The layers are made on
the expected place (``framework.place``: the card unless
``set_device("cpu")``).

Without ``attention_mask`` and without attention dropout (``eval()``, or
``attention_probs_dropout_prob`` 0) attention runs the flash kernels
(forward and, in training, both backward kernels), one forward launch a
layer; with a mask or an active attention dropout it runs the JAX
``_sdpa_xla`` composition in plain PyTorch, as the JAX package does.
Every dropout draws from the default generator of the model's device
(``framework.random``); under ``use_recompute`` a recomputed layer draws
the masks its first run drew (``nn.functional.common.rewinding``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from .. import nn
from ..distributed.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                   RowParallelLinear,
                                                   VocabParallelEmbedding)
from ..framework.place import current_device
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.functional.common import drawing_generator, rewinding
from ..ops import astype, matmul, reshape, slice, squeeze, transpose, unsqueeze

__all__ = ["BertConfig", "BertEmbeddings", "BertLayer", "BertModel",
           "BertForPretraining", "BertForSequenceClassification",
           "bert_param_count"]


@dataclass
class BertConfig:
    """BERT_BASE by default (Devlin et al. 2019: L 12, H 768, A 12, FFN
    3072, 30522 word pieces, 512 positions, 2 segments)."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    use_recompute: bool = False
    dtype: str = "float32"

    @staticmethod
    def bert_base(**overrides):
        return BertConfig(**overrides)

    @staticmethod
    def bert_large(**overrides):
        return BertConfig(**{**dict(hidden_size=1024, num_hidden_layers=24,
                                    num_attention_heads=16,
                                    intermediate_size=4096), **overrides})

    @staticmethod
    def tiny(**overrides):
        return BertConfig(**{**dict(vocab_size=256, hidden_size=64,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    intermediate_size=128,
                                    max_position_embeddings=64,
                                    hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0),
                             **overrides})


def _xavier():
    return nn.ParamAttr(initializer=I.XavierUniform())


def _zeros():
    return nn.ParamAttr(initializer=I.Constant(0.0))


class BertEmbeddings(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        # the three tables share truncated-normal(initializer_range), the
        # BERT recipe (the JAX model's note: mixed scales drown the word
        # signal at vocab 30522)
        emb_init = nn.ParamAttr(initializer=I.TruncatedNormal(
            0.0, config.initializer_range))
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, weight_attr=emb_init,
            device=current_device())
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=emb_init)
        self.token_type_embeddings = nn.Embedding(
            config.type_vocab_size, config.hidden_size, weight_attr=emb_init)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, dtype=torch.int64, device=input_ids.device)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids, dtype=torch.int64)
        emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertLayer(nn.Layer):
    """Post-LN encoder block (the original BERT recipe)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        h = config.hidden_size
        dev = current_device()
        self.num_heads = config.num_attention_heads
        self.head_dim = h // config.num_attention_heads
        self.qkv = ColumnParallelLinear(
            h, 3 * h, weight_attr=_xavier(), has_bias=True,
            gather_output=False, device=dev, bias_attr=_zeros())
        self.attn_out = RowParallelLinear(
            h, h, weight_attr=_xavier(), has_bias=True,
            input_is_parallel=True, device=dev, bias_attr=_zeros())
        self.attn_norm = nn.LayerNorm(h, config.layer_norm_eps)
        self.ffn_in = ColumnParallelLinear(
            h, config.intermediate_size, weight_attr=_xavier(),
            has_bias=True, gather_output=False, device=dev,
            bias_attr=_zeros())
        self.ffn_out = RowParallelLinear(
            config.intermediate_size, h, weight_attr=_xavier(),
            has_bias=True, input_is_parallel=True, device=dev,
            bias_attr=_zeros())
        self.ffn_norm = nn.LayerNorm(h, config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.attn_dropout_p = config.attention_probs_dropout_prob

    def forward(self, hidden, attn_mask=None):
        b, s = hidden.shape[0], hidden.shape[1]
        qkv = reshape(self.qkv(hidden), [b, s, 3, self.num_heads,
                                         self.head_dim])
        q = squeeze(slice(qkv, [2], [0], [1]), [2])
        k = squeeze(slice(qkv, [2], [1], [2]), [2])
        v = squeeze(slice(qkv, [2], [2], [3]), [2])
        attn = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False,
            dropout_p=self.attn_dropout_p if self.training else 0.0)
        attn = reshape(attn, [b, s, self.num_heads * self.head_dim])
        hidden = self.attn_norm(hidden + self.dropout(self.attn_out(attn)))
        mlp = self.ffn_out(F.gelu(self.ffn_in(hidden)))
        return self.ffn_norm(hidden + self.dropout(mlp))


class BertModel(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.layers = nn.LayerList(
            [BertLayer(config) for _ in range(config.num_hidden_layers)])
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """-> (hidden [b, s, h], pooled [b, h]); ``attention_mask`` [b, s]
        of 1 (attend) / 0 becomes the additive ``(1 - m) * -1e4``."""
        mask = None
        if attention_mask is not None:
            m = unsqueeze(attention_mask, [1, 2])
            mask = (1.0 - astype(m, "float32")) * -1e4
        hidden = self.embeddings(input_ids, token_type_ids)
        recompute = self.config.use_recompute and self.training
        gens = [drawing_generator(None, hidden.device)] if recompute else []
        for layer in self.layers:
            if recompute:
                hidden = checkpoint(rewinding(layer, gens), hidden, mask,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                hidden = layer(hidden, mask)
        pooled = F.tanh(self.pooler(hidden[:, 0]))
        return hidden, pooled


class BertForPretraining(nn.Layer):
    """The masked-LM head (decoder tied to the word embeddings) and the
    next-sentence head."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.bert = BertModel(config)
        self.mlm_transform = nn.Linear(config.hidden_size, config.hidden_size)
        self.mlm_norm = nn.LayerNorm(config.hidden_size,
                                     config.layer_norm_eps)
        self.mlm_bias = self.create_parameter([config.vocab_size],
                                              is_bias=True)
        self.nsp_head = nn.Linear(config.hidden_size, 2)
        if config.dtype == "bfloat16":
            self.to(dtype="bfloat16")

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_labels=None):
        """(MLM logits, NSP logits), or with labels the summed loss (MLM
        labels of -100 are ignored)."""
        hidden, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(hidden)))
        w = self.bert.embeddings.word_embeddings.weight
        logits = matmul(h, transpose(w, [1, 0])) + self.mlm_bias
        nsp_logits = self.nsp_head(pooled)
        if masked_lm_labels is None:
            return logits, nsp_logits
        v = self.config.vocab_size
        loss = F.cross_entropy(reshape(logits, [-1, v]),
                               reshape(masked_lm_labels, [-1]),
                               ignore_index=-100)
        if next_sentence_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits, next_sentence_labels)
        return loss


class BertForSequenceClassification(nn.Layer):
    def __init__(self, config: BertConfig, num_classes=2):
        super().__init__()
        self.bert = BertModel(config)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.classifier = nn.Linear(config.hidden_size, num_classes)
        if config.dtype == "bfloat16":
            self.to(dtype="bfloat16")

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits


def bert_param_count(config: BertConfig, num_classes=2):
    """(all parameters, those outside the embedding tables) of
    ``BertForSequenceClassification(config, num_classes)``."""
    h, i, L = config.hidden_size, config.intermediate_size, \
        config.num_hidden_layers
    emb = (config.vocab_size + config.max_position_embeddings +
           config.type_vocab_size) * h
    layer = 3 * h * h + 3 * h + h * h + h + 2 * h * i + i + h + 4 * h
    rest = L * layer + 2 * h + (h * h + h) + (h * num_classes + num_classes)
    return emb + rest, rest
