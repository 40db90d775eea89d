"""Validation metrics: AUC-ROC, AUC-PR, peak F1, RMSE, mean losses and
precision@k (port of photon_tpu/evaluation/evaluators.py).

The metrics run on the tensors' device; only final scalars come back. Ties
are handled exactly as the reference does: samples with equal scores form
one tie group, AUC-ROC counts a tied negative as half, and AUC-PR and peak
F1 take cut points only at the ends of tie groups. Group sums are read off
one cumulative sum at the group ends, so they do not depend on the order of
atomic adds. The grouped ("multi") evaluators average a metric over the
groups of an id column (samples with an id < 0 or ≥ the group count are
left out).
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


def _group_sorted(scores: Tensor, group_ids: Tensor, descending: bool) -> Tensor:
    """Order by (group ascending, score ascending or descending), stable."""
    order1 = torch.argsort(-scores if descending else scores, stable=True)
    return order1[torch.argsort(group_ids[order1], stable=True)]


def _sums_at_ends(values: Tensor, ends: Tensor) -> Tensor:
    """Sums of ``values`` over the runs that end where ``ends`` is True."""
    at_end = torch.cumsum(values, 0)[ends]
    return at_end - torch.cat([at_end.new_zeros(1), at_end[:-1]])


def grouped_auc(scores: Tensor, labels: Tensor, group_ids: Tensor, num_groups: int,
                weight: Optional[Tensor] = None) -> Tensor:
    """Mean weighted AUC over the groups that hold both classes."""
    keep = (group_ids >= 0) & (group_ids < num_groups)
    w = torch.where(keep, _default_weight(scores, weight), 0.0)
    gids = torch.where(keep, group_ids, 0)
    order = _group_sorted(scores, gids, descending=False)
    s, y, ww, g = scores[order], labels[order], w[order], gids[order]
    pos_w = torch.where(y > 0, ww, torch.zeros_like(ww))
    neg_w = torch.where(y > 0, torch.zeros_like(ww), ww)
    # Tie groups are runs of equal (group, score); the negatives below an
    # element are those of the earlier tie groups of its own group.
    tie_end = torch.ones_like(s, dtype=torch.bool)
    tie_end[:-1] = (s[1:] != s[:-1]) | (g[1:] != g[:-1])
    grp_end = torch.ones_like(s, dtype=torch.bool)
    grp_end[:-1] = g[1:] != g[:-1]
    tid = torch.cumsum(tie_end.long(), 0) - tie_end.long()
    grp = torch.cumsum(grp_end.long(), 0) - grp_end.long()
    cum_tie = torch.cumsum(neg_w, 0)[tie_end]
    tie_neg = cum_tie - torch.cat([cum_tie.new_zeros(1), cum_tie[:-1]])
    cum_grp = torch.cumsum(neg_w, 0)[grp_end]
    grp_start = torch.cat([cum_grp.new_zeros(1), cum_grp[:-1]])
    below = (cum_tie - tie_neg)[tid] - grp_start[grp]
    frac = below + 0.5 * tie_neg[tid]
    num = _sums_at_ends(pos_w * frac, grp_end)
    Wp, Wn = _sums_at_ends(pos_w, grp_end), _sums_at_ends(neg_w, grp_end)
    valid = (Wp > 0) & (Wn > 0)
    auc_g = torch.where(valid, num / torch.clamp(Wp * Wn, min=1e-30), 0.0)
    return torch.sum(auc_g) / torch.clamp(torch.sum(valid), min=1)


def grouped_precision_at_k(scores: Tensor, labels: Tensor, group_ids: Tensor, num_groups: int,
                           k: int) -> Tensor:
    """Mean unweighted P@k over the groups present (a group smaller than k
    uses all its samples)."""
    keep = (group_ids >= 0) & (group_ids < num_groups)
    scores, labels, group_ids = scores[keep], labels[keep], group_ids[keep]
    if scores.shape[0] == 0:
        return torch.zeros((), dtype=scores.dtype, device=scores.device)
    order = _group_sorted(scores, group_ids, descending=True)
    y, g = labels[order], group_ids[order]
    n = g.shape[0]
    idx = torch.arange(n, device=g.device)
    is_start = torch.ones(n, dtype=torch.bool, device=g.device)
    is_start[1:] = g[1:] != g[:-1]
    grp_end = torch.ones(n, dtype=torch.bool, device=g.device)
    grp_end[:-1] = is_start[1:]
    start = torch.cummax(torch.where(is_start, idx, torch.full_like(idx, -1)), 0).values
    in_top = (idx - start) < k
    hits = _sums_at_ends((in_top & (y > 0)).to(scores.dtype), grp_end)
    cnt = _sums_at_ends(in_top.to(scores.dtype), grp_end)
    return torch.sum(hits / cnt) / cnt.shape[0]


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
