"""Validation metrics: AUC-ROC, AUC-PR, peak F1, RMSE, mean losses and
precision@k (port of photon_tpu/evaluation/evaluators.py).

The metrics run on the tensors' device; only final scalars come back. Ties
are handled exactly as the reference does: samples with equal scores form
one tie group, AUC-ROC counts a tied negative as half, and AUC-PR and peak
F1 take cut points only at the ends of tie groups. Group sums are read off
one cumulative sum at the group ends, so they do not depend on the order of
atomic adds. The grouped ("multi") evaluators come with the GAME slice.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

from photon_tpu_torch.ops.losses import LogisticLoss, PoissonLoss, SquaredLoss

Tensor = torch.Tensor


class EvaluatorType(enum.Enum):
    AUC = "AUC"
    AUPR = "AUPR"
    RMSE = "RMSE"
    SQUARED_LOSS = "SQUARED_LOSS"
    LOGISTIC_LOSS = "LOGISTIC_LOSS"
    POISSON_LOSS = "POISSON_LOSS"
    PRECISION_AT_K = "PRECISION_AT_K"


_LARGER_IS_BETTER = {
    EvaluatorType.AUC: True,
    EvaluatorType.AUPR: True,
    EvaluatorType.PRECISION_AT_K: True,
    EvaluatorType.RMSE: False,
    EvaluatorType.SQUARED_LOSS: False,
    EvaluatorType.LOGISTIC_LOSS: False,
    EvaluatorType.POISSON_LOSS: False,
}


def metric_is_better(etype: EvaluatorType) -> Callable[[float, float], bool]:
    if _LARGER_IS_BETTER[etype]:
        return lambda new, old: new > old
    return lambda new, old: new < old


def _default_weight(scores: Tensor, weight: Optional[Tensor]) -> Tensor:
    return torch.ones_like(scores) if weight is None else weight


def _group_ends(sorted_scores: Tensor) -> Tensor:
    """True at the last element of each run of equal scores."""
    end = torch.ones_like(sorted_scores, dtype=torch.bool)
    end[:-1] = sorted_scores[1:] != sorted_scores[:-1]
    return end


def _tie_groups(sorted_scores: Tensor) -> Tensor:
    """Dense group id per sorted element; equal scores share a group."""
    new_group = torch.ones_like(sorted_scores, dtype=torch.int64)
    new_group[1:] = sorted_scores[1:] != sorted_scores[:-1]
    return torch.cumsum(new_group, 0) - 1


def auc_roc(scores: Tensor, labels: Tensor, weight: Optional[Tensor] = None) -> Tensor:
    """Weighted ROC AUC with exact ties:
    Σ_pos w_p · (W_neg below p + ½·W_neg tied with p) / (W_pos · W_neg)."""
    w = _default_weight(scores, weight)
    order = torch.argsort(scores, stable=True)
    s, y, ww = scores[order], labels[order], w[order]
    pos_w = torch.where(y > 0, ww, torch.zeros_like(ww))
    neg_w = torch.where(y > 0, torch.zeros_like(ww), ww)
    gid = _tie_groups(s)
    # Inclusive cumulative negative weight at each tie group's end.
    at_end = torch.cumsum(neg_w, 0)[_group_ends(s)]
    below = torch.cat([at_end.new_zeros(1), at_end[:-1]])  # exclusive, per group
    group_neg = at_end - below
    frac = below[gid] + 0.5 * group_neg[gid]
    return torch.sum(pos_w * frac) / torch.clamp(torch.sum(pos_w) * torch.sum(neg_w), min=1e-30)


def auc_pr(scores: Tensor, labels: Tensor, weight: Optional[Tensor] = None) -> Tensor:
    """Weighted area under the precision-recall curve: trapezoids between
    the cut points at the ends of tie groups."""
    w = _default_weight(scores, weight)
    n = scores.shape[0]
    order = torch.argsort(-scores, stable=True)
    s, y, ww = scores[order], labels[order], w[order]
    pos_w = torch.where(y > 0, ww, torch.zeros_like(ww))
    neg_w = torch.where(y > 0, torch.zeros_like(ww), ww)
    Wp = torch.clamp(torch.sum(pos_w), min=1e-30)
    cum_tp, cum_fp = torch.cumsum(pos_w, 0), torch.cumsum(neg_w, 0)
    is_end = _group_ends(s)
    recall = cum_tp / Wp
    precision = cum_tp / torch.clamp(cum_tp + cum_fp, min=1e-30)
    # The previous group end of each position, by a running max over ends.
    idx = torch.arange(n, device=scores.device)
    prev_end = torch.cummax(torch.where(is_end, idx, torch.full_like(idx, -1)), 0).values
    prev_prev = torch.cat([prev_end.new_full((1,), -1), prev_end[:-1]])
    has_prev = prev_prev >= 0
    safe = torch.clamp(prev_prev, min=0)
    r_prev = torch.where(has_prev, recall[safe], torch.zeros_like(recall))
    p_prev = torch.where(has_prev, precision[safe], torch.ones_like(precision))
    contrib = torch.where(is_end, (recall - r_prev) * 0.5 * (precision + p_prev), torch.zeros_like(recall))
    return torch.sum(contrib)


def peak_f1(scores: Tensor, labels: Tensor, weight: Optional[Tensor] = None) -> Tensor:
    """max over thresholds t of F1(score ≥ t), every distinct score a
    candidate; tied scores share one threshold."""
    w = _default_weight(scores, weight)
    order = torch.argsort(-scores, stable=True)
    s, y, ww = scores[order], labels[order], w[order]
    pos_w = torch.where(y > 0, ww, torch.zeros_like(ww))
    tp, pp = torch.cumsum(pos_w, 0), torch.cumsum(ww, 0)
    f1 = 2.0 * tp / torch.clamp(pp + torch.sum(pos_w), min=1e-30)
    return torch.max(torch.where(_group_ends(s), f1, torch.full_like(f1, -torch.inf)))


def rmse(scores: Tensor, labels: Tensor, weight: Optional[Tensor] = None) -> Tensor:
    w = _default_weight(scores, weight)
    return torch.sqrt(torch.sum(w * (scores - labels) ** 2) / torch.clamp(torch.sum(w), min=1e-30))


def _mean_pointwise(loss_fn, scores, labels, weight):
    w = _default_weight(scores, weight)
    return torch.sum(w * loss_fn(scores, labels)) / torch.clamp(torch.sum(w), min=1e-30)


def squared_loss_metric(scores, labels, weight=None):
    return _mean_pointwise(SquaredLoss.value, scores, labels, weight)


def logistic_loss_metric(scores, labels, weight=None):
    return _mean_pointwise(LogisticLoss.value, scores, labels, weight)


def poisson_loss_metric(scores, labels, weight=None):
    return _mean_pointwise(PoissonLoss.value, scores, labels, weight)


def precision_at_k(scores: Tensor, labels: Tensor, k: int) -> Tensor:
    """Unweighted fraction of positives among the top-k scores."""
    k = min(k, scores.shape[0])
    top = torch.topk(scores, k).indices
    return torch.mean((labels[top] > 0).to(torch.float32))


def evaluate(
    etype: EvaluatorType,
    scores: Tensor,
    labels: Tensor,
    weight: Optional[Tensor] = None,
    k: int = 10,
) -> Tensor:
    """Single-evaluator dispatch."""
    if etype == EvaluatorType.AUC:
        return auc_roc(scores, labels, weight)
    if etype == EvaluatorType.AUPR:
        return auc_pr(scores, labels, weight)
    if etype == EvaluatorType.RMSE:
        return rmse(scores, labels, weight)
    if etype == EvaluatorType.SQUARED_LOSS:
        return squared_loss_metric(scores, labels, weight)
    if etype == EvaluatorType.LOGISTIC_LOSS:
        return logistic_loss_metric(scores, labels, weight)
    if etype == EvaluatorType.POISSON_LOSS:
        return poisson_loss_metric(scores, labels, weight)
    if etype == EvaluatorType.PRECISION_AT_K:
        return precision_at_k(scores, labels, k)
    raise ValueError(f"unknown evaluator {etype}")
