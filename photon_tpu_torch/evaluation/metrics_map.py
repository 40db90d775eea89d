"""Per-model validation MetricsMap of the legacy driver (port of
photon_tpu/evaluation/metrics_map.py).

Metric facets by task, with the reference's exact metric names:
- regression (linear, Poisson): mean absolute, mean square and root mean
  square error of the mean-function predictions;
- binary classifiers (logistic, smoothed hinge): area under PR, area under
  ROC and peak F1, ranked on the margins (an f32 sigmoid saturates to 0/1
  and would invent ties);
- per-datum log-likelihood for logistic and Poisson, and AIC with the
  small-sample correction wherever a log-likelihood exists, counting the
  coefficients with |w| > 1e-9.
Like the reference the map is unweighted, and it is computed in float32
whatever the input type.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from photon_tpu_torch.evaluation.evaluators import auc_pr, auc_roc, peak_f1
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor

MEAN_ABSOLUTE_ERROR = "Mean absolute error"
MEAN_SQUARE_ERROR = "Mean square error"
ROOT_MEAN_SQUARE_ERROR = "Root mean square error"
AREA_UNDER_PRECISION_RECALL = "Area under precision/recall"
AREA_UNDER_ROC = "Area under ROC"
PEAK_F1_SCORE = "Peak F1 score"
DATA_LOG_LIKELIHOOD = "Per-datum log likelihood"
AKAIKE_INFORMATION_CRITERION = "Akaike information criterion"
EPSILON = 1e-9

_REGRESSION_TASKS = (TaskType.LINEAR_REGRESSION, TaskType.POISSON_REGRESSION)
_BINARY_TASKS = (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def mean_function(task: TaskType, margins: Tensor) -> Tensor:
    """Margins (x·w + offset) → predictions on the label scale."""
    if task == TaskType.LOGISTIC_REGRESSION:
        return 1.0 / (1.0 + torch.exp(-margins))
    if task == TaskType.POISSON_REGRESSION:
        return torch.exp(margins)
    # Linear regression and the smoothed-hinge SVM score on the margin.
    return margins


def _log_likelihood_per_datum(task: TaskType, margins: Tensor, predictions: Tensor,
                              labels: Tensor) -> Optional[Tensor]:
    if task == TaskType.LOGISTIC_REGRESSION:
        p = predictions.to(torch.float32)
        log_p = torch.log(torch.clamp(p, min=EPSILON))
        log_1mp = torch.where(p > 1.0 - EPSILON, torch.full_like(p, math.log(EPSILON)), torch.log1p(-p))
        ll = labels * log_p + (1.0 - labels) * log_1mp
    elif task == TaskType.POISSON_REGRESSION:
        z = margins.to(torch.float32)
        # y·wᵀx − e^{wᵀx} − log Γ(1 + y)
        ll = labels * z - torch.exp(z) - torch.special.gammaln(1.0 + labels)
    else:
        return None
    return torch.mean(ll)  # one count per datum


def metrics_map(
    task: TaskType,
    margins: Tensor,
    labels: Tensor,
    coefficients: Optional[Tensor] = None,
) -> Dict[str, float]:
    """The reference's per-model MetricsMap from the validation margins."""
    labels = torch.as_tensor(labels).to(torch.float32)
    margins = torch.as_tensor(margins).to(torch.float32)
    preds = mean_function(task, margins)
    out: Dict[str, float] = {}

    if task in _REGRESSION_TASKS:
        err = preds - labels
        mse = torch.mean(err * err)
        out[MEAN_ABSOLUTE_ERROR] = float(torch.mean(torch.abs(err)))
        out[MEAN_SQUARE_ERROR] = float(mse)
        out[ROOT_MEAN_SQUARE_ERROR] = float(torch.sqrt(mse))

    if task in _BINARY_TASKS:
        out[AREA_UNDER_PRECISION_RECALL] = float(auc_pr(margins, labels))
        out[AREA_UNDER_ROC] = float(auc_roc(margins, labels))
        out[PEAK_F1_SCORE] = float(peak_f1(margins, labels))

    ll = _log_likelihood_per_datum(task, margins, preds, labels)
    if ll is not None:
        ll = float(ll)
        out[DATA_LOG_LIKELIHOOD] = ll
        if coefficients is not None:
            n = labels.shape[0]
            k = int(torch.sum(torch.abs(torch.as_tensor(coefficients)) > 1e-9))
            base_aic = 2.0 * (k - n * ll)
            den = n - k - 1.0
            # The reference's doubles give ±Infinity at den == 0.
            corr = math.inf if den == 0 else 2.0 * k * (k + 1) / den
            out[AKAIKE_INFORMATION_CRITERION] = base_aic + corr
    return out


def sanitize_for_json(obj):
    """Replace non-finite floats with None, recursively: ``json.dump`` would
    write the non-RFC token ``Infinity`` (AIC at the n − k − 1 = 0 pole)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize_for_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_for_json(v) for v in obj]
    return obj


# (metric name, larger is better) per task (ModelSelection.scala:36-63).
_SELECTION: Dict[TaskType, Tuple[str, bool]] = {
    TaskType.LOGISTIC_REGRESSION: (AREA_UNDER_ROC, True),
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: (AREA_UNDER_ROC, True),
    TaskType.LINEAR_REGRESSION: (ROOT_MEAN_SQUARE_ERROR, False),
    TaskType.POISSON_REGRESSION: (DATA_LOG_LIKELIHOOD, True),
}


def selection_metric(task: TaskType) -> Tuple[str, bool]:
    return _SELECTION[task]
