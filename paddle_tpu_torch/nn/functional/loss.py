"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``: the
cross entropy and the functionals of the loss layers).

``cross_entropy`` follows the JAX ``_ce_core`` step for step: the log
softmax (or, with ``use_softmax=False``, the log of the given
probabilities floored at 1e-30) along ``axis``; hard labels of shape
``[N]`` or ``[N, 1]`` (the class dim squeezed), each label equal to
``ignore_index`` giving 0 and counting for nothing in the mean; class
``weight`` gathered per label (per soft label, its weighted sum), the
weighted mean dividing by the summed weights.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "square_error_cost"]


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    if reduction == "none":
        return out
    raise ValueError(f"reduction must be mean, sum or none, got "
                     f"{reduction!r}")


def _ce_core(logits, labels, axis, soft_label, ignore_index, use_softmax):
    """(per-sample loss, kept mask, safe labels); the last two None for
    soft labels."""
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp(logits, min=1e-30))
    if soft_label:
        return -torch.sum(labels * logp, dim=axis), None, None
    lab = labels
    if lab.dim() == logits.dim():
        lab = lab.squeeze(axis)
    mask = lab != ignore_index
    safe = torch.where(mask, lab, torch.zeros_like(lab)).long()
    picked = torch.take_along_dim(logp, safe.unsqueeze(axis), axis)
    loss = torch.where(mask, -picked.squeeze(axis),
                       torch.zeros((), dtype=logp.dtype, device=logp.device))
    return loss, mask, safe


def _weighted_mean(loss, wg):
    denom = torch.sum(wg)
    return torch.sum(loss) / (denom + (denom == 0.0).to(denom.dtype))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    axis = int(axis)
    loss, mask, safe = _ce_core(input, label, axis, bool(soft_label),
                                int(ignore_index), bool(use_softmax))
    if weight is not None:
        if soft_label:
            wg = torch.tensordot(label.to(weight.dtype), weight,
                                 dims=([axis % label.dim()], [0]))
        else:
            wg = weight[safe] * mask.to(weight.dtype)
        loss = loss * wg
        if reduction == "mean":
            return _weighted_mean(loss, wg)
        return _reduce(loss, reduction)
    if mask is not None and reduction == "mean":
        return torch.sum(loss) / torch.clamp(torch.sum(mask), min=1)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, ignore_index=ignore_index,
                         reduction="none", soft_label=soft_label, axis=axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=int(axis))
    return loss


def _nll_core(logp, labels, ignore_index):
    """The class dim is 1 for an input of more than 2 dims."""
    if logp.dim() > 2:
        logp = logp.movedim(1, -1)
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    picked = torch.take_along_dim(logp, safe[..., None], -1)[..., 0]
    loss = torch.where(mask, -picked,
                       torch.zeros((), dtype=logp.dtype, device=logp.device))
    return loss, mask, safe


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    loss, mask, safe = _nll_core(input, label, int(ignore_index))
    if weight is not None:
        wg = weight[safe] * mask.to(weight.dtype)
        loss = loss * wg
        if reduction == "mean":
            return _weighted_mean(loss, wg)
        return _reduce(loss, reduction)
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp(torch.sum(mask), min=1)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 d^2 / delta`` below ``delta``, ``d - 0.5 delta`` above."""
    delta = float(delta)
    d = torch.abs(input - label)
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)


def _bce(p, y, eps=1e-12):
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    loss = _bce(input, label)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``max(x, 0) - x y + log1p(exp(-|x|))``; with ``pos_weight``
    ``-(pw y logsigmoid(x) + (1 - y) logsigmoid(-x))``; times ``weight``."""
    x, y = logit, label
    if pos_weight is not None:
        loss = -(pos_weight * y * torch.nn.functional.logsigmoid(x) +
                 (1 - y) * torch.nn.functional.logsigmoid(-x))
    else:
        loss = torch.clamp(x, min=0) - x * y + \
            torch.log1p(torch.exp(-torch.abs(x)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log(max(label, 1e-12)) - input)``; ``batchmean`` divides
    the sum by the batch."""
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + float(margin),
                               min=0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input,
                       torch.clamp(float(margin) - input, min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    """``1 - cos`` for label 1, ``max(0, cos - margin)`` otherwise; the
    norms' product floored at 1e-12."""
    cos = torch.sum(input1 * input2, -1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1) *
        torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1 - cos,
                       torch.clamp(cos - float(margin), min=0.0))
    return _reduce(loss, reduction)


def square_error_cost(input, label):
    return torch.square(input - label)
