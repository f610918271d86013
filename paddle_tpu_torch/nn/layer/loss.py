"""Loss layers (port of ``paddle_tpu/nn/layer/loss.py``): each holds its
arguments and calls its functional."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax)


class _Reduced(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction


class MSELoss(_Reduced):
    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(_Reduced):
    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class KLDivLoss(_Reduced):
    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, weight=self.weight,
                          ignore_index=self.ignore_index,
                          reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class _Margin(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction


class MarginRankingLoss(_Margin):
    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(_Margin):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin, reduction)

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(_Margin):
    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)
