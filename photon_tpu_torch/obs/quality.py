"""Copy of photon_tpu/obs/quality.py (framework-free; the port does not import it).

Online model-quality plane: streaming AUC/calibration per model version.

The SLO plane (obs/slo.py) answers "is serving healthy"; nothing in the
repo answered "is the MODEL getting better or worse in production". This
module closes that gap with a streaming evaluator over the (score, label)
pairs the feedback spool already joins: mergeable, windowed accumulators
keyed by ``(model_version, tenant, re_type)`` —

- fixed-bin score histograms per label class → online AUC whose error vs
  the exact ``evaluation/evaluators.py::auc_roc`` is bounded by bin width
  (records falling in the same bin are treated as ties, so the rank error
  per pair is at most one bin);
- logloss (logistic) or deviance (Poisson) keyed by task type;
- calibration bins (predicted mean vs observed mean) + ECE;
- label-delay distribution (labelTs − scoreTs) over fixed log buckets.

Everything is plain host-side float math — safe to call from serve
completion callbacks, and every accumulator merges associatively
(``merge(a, b) == accumulate(a ++ b)`` exactly, element-wise adds only),
which is what lets per-replica planes roll up in the fleet scrape the same
way every other per-replica instrument does: each replica publishes its
own ``quality_*`` series with its replica label, one cheap merge at scrape
(the Snap ML hierarchical-aggregation shape).

Windows rotate on a fixed wall-clock grid (``window_s``) and the plane
retains the last ``num_windows`` of them; reported numbers always come
from the retained-window merge, so a version that WAS bad and recovered
stops paging once the bad windows age out. Rotation is monotone under
clock skew: a clock that jumps backwards never reopens (or double-counts
into) an already-rotated window — observations clamp into the newest one.

The frozen-baseline lane is just a second key: the serving engine
re-scores labeled traffic on a pinned baseline generation and feeds those
pairs under the baseline's version key, so "lift" is the difference of two
MEASURED online AUCs over the same requests — never a modeled number.

SLO feed: per label observation the plane emits one good/bad event each
for the ``auc_drop`` and ``calibration_drift`` objectives (good = windowed
AUC within ``auc_drop_bound`` of the baseline's; good = windowed ECE under
``ece_bound``), into whatever SLOTracker the caller passes. Quality burn
then drives the SAME multi-window burn-rate machinery — and, through the
rollout watcher's ``--slo-gate``, the same abort/rollback/freeze actuation
path — as availability or latency burn.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

SLO_AUC_DROP = "auc_drop"
SLO_CALIBRATION = "calibration_drift"

# Label-delay histogram bucket upper bounds (seconds); the last bucket is
# open-ended. Log-spaced so sub-second joins and hour-late labels both
# resolve; mergeable by construction (fixed bounds, counts add).
DELAY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0, 300.0, 1800.0,
)


def task_name(task) -> str:
    """TaskType (or string) → the quality plane's task family:
    ``logistic`` | ``poisson`` | ``linear``. Unknown tasks score as
    ``linear`` (identity link, no calibration claim)."""
    name = str(getattr(task, "value", task) or "").upper()
    if "LOGISTIC" in name or "HINGE" in name:
        return "logistic"
    if "POISSON" in name:
        return "poisson"
    return "linear"


def predict(score: float, task: str) -> float:
    """Raw serving score (margin) → mean prediction under the task's
    inverse link. Serving scores are link-scale (``score_with_offset``),
    so AUC binning and calibration both need the mean scale."""
    s = float(score)
    if task == "logistic":
        if s >= 0:
            return 1.0 / (1.0 + math.exp(-s))
        e = math.exp(s)
        return e / (1.0 + e)
    if task == "poisson":
        return math.exp(min(s, 50.0))
    return s


@dataclasses.dataclass
class QualityConfig:
    """Knobs for one quality plane. ``score_bins`` bounds the online-AUC
    error (ties within a bin); ``window_s`` × ``num_windows`` is the
    horizon every reported number covers."""

    task: str = "logistic"
    score_bins: int = 64
    calibration_bins: int = 10
    window_s: float = 30.0
    num_windows: int = 4
    # Below this many (score, label) pairs in the retained windows a key
    # reports no AUC/ECE (and its SLO events default to good) — an idle
    # version is not in violation.
    min_events: int = 20
    baseline_version: Optional[str] = None
    # SLO event bars: good iff windowed AUC ≥ baseline AUC − auc_drop_bound
    # and windowed ECE ≤ ece_bound.
    auc_drop_bound: float = 0.05
    ece_bound: float = 0.15


class QualityAccumulator:
    """One key's mergeable quality state. Every field is a sum (or a
    fixed-size vector of sums), so ``merge`` is element-wise addition and
    exactly associative/commutative — the property the merge-equivalence
    test pins and the fleet rollup relies on."""

    __slots__ = (
        "score_bins", "calibration_bins", "pos", "neg", "count", "weight",
        "loss_sum", "calib_w", "calib_p", "calib_y", "delay_counts",
        "delay_sum",
    )

    def __init__(self, score_bins: int = 64, calibration_bins: int = 10):
        self.score_bins = int(score_bins)
        self.calibration_bins = int(calibration_bins)
        self.pos = [0.0] * self.score_bins  # weighted counts, label == 1
        self.neg = [0.0] * self.score_bins  # weighted counts, label == 0
        self.count = 0
        self.weight = 0.0
        self.loss_sum = 0.0  # weighted logloss or Poisson deviance
        self.calib_w = [0.0] * self.calibration_bins
        self.calib_p = [0.0] * self.calibration_bins  # Σ w·prediction
        self.calib_y = [0.0] * self.calibration_bins  # Σ w·label
        self.delay_counts = [0] * (len(DELAY_BUCKETS_S) + 1)
        self.delay_sum = 0.0

    # -- accumulate --------------------------------------------------------

    def _bin(self, pred: float, bins: int) -> int:
        # Predictions clamp into [0, 1] for binning (logistic predictions
        # already live there; other tasks rank fine after clamping because
        # AUC only needs a monotone transform).
        p = min(1.0, max(0.0, pred))
        return min(bins - 1, int(p * bins))

    def observe(
        self,
        pred: float,
        label: float,
        task: str = "logistic",
        weight: float = 1.0,
        delay_s: Optional[float] = None,
    ) -> None:
        w = float(weight)
        y = float(label)
        self.count += 1
        self.weight += w
        b = self._bin(pred, self.score_bins)
        if y > 0.5:
            self.pos[b] += w
        else:
            self.neg[b] += w
        c = self._bin(pred, self.calibration_bins)
        self.calib_w[c] += w
        self.calib_p[c] += w * min(1.0, max(0.0, pred))
        self.calib_y[c] += w * y
        eps = 1e-7
        if task == "poisson":
            # Poisson deviance: 2·(y·log(y/μ) − (y − μ)), y·log(y/μ)=0 at y=0.
            mu = max(pred, eps)
            term = y * math.log(y / mu) if y > 0 else 0.0
            self.loss_sum += w * 2.0 * (term - (y - mu))
        elif task == "linear":
            # Squared error — the identity-link prediction is unbounded and
            # the label is real-valued, so the logloss clamp below would
            # destroy both.
            self.loss_sum += w * (pred - y) ** 2
        else:
            p = min(1.0 - eps, max(eps, pred))
            self.loss_sum += w * -(y * math.log(p) + (1.0 - y) * math.log(1.0 - p))
        if delay_s is not None:
            d = max(0.0, float(delay_s))
            self.delay_sum += d
            for i, bound in enumerate(DELAY_BUCKETS_S):
                if d <= bound:
                    self.delay_counts[i] += 1
                    break
            else:
                self.delay_counts[-1] += 1

    def merge(self, other: "QualityAccumulator") -> "QualityAccumulator":
        if (other.score_bins != self.score_bins
                or other.calibration_bins != self.calibration_bins):
            raise ValueError("cannot merge accumulators with different bins")
        self.count += other.count
        self.weight += other.weight
        self.loss_sum += other.loss_sum
        self.delay_sum += other.delay_sum
        for i in range(self.score_bins):
            self.pos[i] += other.pos[i]
            self.neg[i] += other.neg[i]
        for i in range(self.calibration_bins):
            self.calib_w[i] += other.calib_w[i]
            self.calib_p[i] += other.calib_p[i]
            self.calib_y[i] += other.calib_y[i]
        for i in range(len(self.delay_counts)):
            self.delay_counts[i] += other.delay_counts[i]
        return self

    # -- derived metrics ---------------------------------------------------

    def auc(self) -> Optional[float]:
        """Histogram AUC: P(score_pos > score_neg) + ½·P(tie), where "tie"
        means "same bin". Identical to the exact ``auc_roc`` when no
        opposite-class pair shares a bin; otherwise off by at most the
        within-bin tie mass — |err| ≤ ½·Σ_b (pos_b·neg_b)/(P·N) ≤ ½ · max
        bin co-occupancy, which shrinks as 1/score_bins for continuous
        score distributions. None for single-class windows (undefined)."""
        p_tot = sum(self.pos)
        n_tot = sum(self.neg)
        if p_tot <= 0.0 or n_tot <= 0.0:
            return None
        cum_neg = 0.0
        s = 0.0
        for b in range(self.score_bins):
            s += self.pos[b] * (cum_neg + 0.5 * self.neg[b])
            cum_neg += self.neg[b]
        return s / (p_tot * n_tot)

    def ece(self) -> Optional[float]:
        """Expected calibration error: Σ_b (w_b/W)·|ȳ_b − p̄_b|."""
        if self.weight <= 0.0:
            return None
        out = 0.0
        for b in range(self.calibration_bins):
            w = self.calib_w[b]
            if w <= 0.0:
                continue
            out += (w / self.weight) * abs(
                self.calib_y[b] / w - self.calib_p[b] / w
            )
        return out

    def mean_loss(self) -> Optional[float]:
        return self.loss_sum / self.weight if self.weight > 0.0 else None

    def delay_percentile(self, q: float) -> Optional[float]:
        """Bucket-resolution percentile of the label delay (upper bound of
        the bucket the q-th observation falls in; the open tail reports the
        running mean as its best available estimate)."""
        total = sum(self.delay_counts)
        if total <= 0:
            return None
        rank = q * total
        seen = 0
        for i, c in enumerate(self.delay_counts):
            seen += c
            if seen >= rank:
                if i < len(DELAY_BUCKETS_S):
                    return DELAY_BUCKETS_S[i]
                break
        n_delay = total
        return self.delay_sum / n_delay

    def snapshot(self, task: str = "logistic") -> dict:
        out = dict(
            count=self.count,
            weight=self.weight,
            auc=self.auc(),
            ece=self.ece(),
            label_delay_p50_s=self.delay_percentile(0.5),
            label_delay_p95_s=self.delay_percentile(0.95),
        )
        loss = self.mean_loss()
        out["deviance" if task == "poisson" else "logloss"] = loss
        return out


def _key(
    model_version: Optional[str],
    tenant: Optional[str],
    re_type: Optional[str],
) -> Tuple[str, str, str]:
    import os

    v = os.path.basename(str(model_version or "unknown").rstrip("/"))
    return (v, str(tenant or ""), str(re_type or ""))


class QualityPlane:
    """Keyed, windowed quality accumulators + the registry/SLO surfaces.

    Thread-safe; all math host-side. One plane lives on the serving engine
    (fed by the feedback-spool label join and the frozen-baseline lane) and
    one on each streaming updater (fed by the deterministic holdout
    split)."""

    def __init__(
        self,
        config: Optional[QualityConfig] = None,
        clock=time.time,
    ):
        self.config = config or QualityConfig()
        self._clock = clock
        self._lock = threading.Lock()
        # window grid index -> {key: accumulator}; ordered oldest-first.
        self._windows: "OrderedDict[int, Dict[Tuple[str, str, str], QualityAccumulator]]" = OrderedDict()
        self._max_idx: Optional[int] = None  # monotone rotation floor

    # -- windowing ---------------------------------------------------------

    def _window_locked(self, now: float) -> Dict:
        idx = int(now // max(self.config.window_s, 1e-6))
        if self._max_idx is None or idx > self._max_idx:
            self._max_idx = idx
            self._windows[idx] = {}
            while len(self._windows) > max(1, int(self.config.num_windows)):
                self._windows.popitem(last=False)
        # Clock skew (idx < _max_idx): clamp into the newest window — never
        # reopen an aged-out one, never count an event twice.
        return self._windows[self._max_idx]

    def _acc_for(self, window: Dict, key) -> QualityAccumulator:
        acc = window.get(key)
        if acc is None:
            acc = QualityAccumulator(
                self.config.score_bins, self.config.calibration_bins
            )
            window[key] = acc
        return acc

    def window_totals(self) -> Dict[Tuple[str, str, str], QualityAccumulator]:
        """Retained windows merged into one accumulator per key — the
        number every surface (metrics, SLO events, CLI) reports."""
        with self._lock:
            out: Dict[Tuple[str, str, str], QualityAccumulator] = {}
            for window in self._windows.values():
                for key, acc in window.items():
                    tot = out.get(key)
                    if tot is None:
                        tot = QualityAccumulator(
                            acc.score_bins, acc.calibration_bins
                        )
                        out[key] = tot
                    tot.merge(acc)
            return out

    # -- feed --------------------------------------------------------------

    def observe(
        self,
        score: float,
        label: float,
        model_version: Optional[str] = None,
        tenant: Optional[str] = None,
        re_type: Optional[str] = None,
        ts: Optional[float] = None,
        label_ts: Optional[float] = None,
        weight: float = 1.0,
        trace_id: Optional[str] = None,
        slo=None,
        now: Optional[float] = None,
    ) -> None:
        """One joined (score, label) pair. ``slo`` (an SLOTracker) receives
        the per-event ``auc_drop``/``calibration_drift`` good/bad feed —
        skipped for the baseline lane itself (the baseline decaying is the
        measurement, not a violation)."""
        from photon_tpu_torch.obs.metrics import registry

        cfg = self.config
        t = self._clock() if now is None else now
        key = _key(model_version, tenant, re_type)
        pred = predict(score, cfg.task)
        delay = None
        if ts is not None and label_ts is not None:
            delay = max(0.0, float(label_ts) - float(ts))
        with self._lock:
            window = self._window_locked(t)
            self._acc_for(window, key).observe(
                pred, label, task=cfg.task, weight=weight, delay_s=delay
            )
        labels = dict(
            model_version=key[0], tenant=key[1], re_type=key[2]
        )
        reg = registry()
        reg.counter("quality_observations_total", **labels).inc()
        if delay is not None:
            reg.histogram(
                "quality_label_delay_s", **labels
            ).observe(delay, trace_id=trace_id)
        if slo is not None and key[0] != (cfg.baseline_version or ""):
            self._record_slo(slo, key)

    def _record_slo(self, slo, key: Tuple[str, str, str]) -> None:
        """One good/bad event per objective for this observation. Both
        default to good below ``min_events`` — a cold window is not a
        violation, and the burn only starts once the windowed estimate is
        statistically meaningful."""
        cfg = self.config
        totals = self.window_totals()
        acc = totals.get(key)
        good_auc = True
        good_ece = True
        if acc is not None and acc.count >= cfg.min_events:
            auc = acc.auc()
            base_auc = None
            if cfg.baseline_version:
                base = totals.get(
                    (cfg.baseline_version, key[1], key[2])
                )
                if base is not None and base.count >= cfg.min_events:
                    base_auc = base.auc()
            if auc is not None and base_auc is not None:
                good_auc = auc >= base_auc - cfg.auc_drop_bound
            ece = acc.ece()
            if ece is not None:
                good_ece = ece <= cfg.ece_bound
        slo.record_event(SLO_AUC_DROP, good_auc)
        slo.record_event(SLO_CALIBRATION, good_ece)

    # -- surfaces ----------------------------------------------------------

    def set_baseline(self, model_version: Optional[str]) -> None:
        import os

        self.config.baseline_version = (
            os.path.basename(str(model_version).rstrip("/"))
            if model_version else None
        )

    def publish(self, reg=None) -> None:
        """Mirror windowed per-key quality into gauges so the ``/metrics``
        scrape (and through it the fleet merge and the OTLP metrics export)
        carries model quality alongside every operational series."""
        from photon_tpu_torch.obs.metrics import registry

        reg = reg or registry()
        cfg = self.config
        totals = self.window_totals()
        loss_name = (
            "quality_deviance" if cfg.task == "poisson" else "quality_logloss"
        )
        for key, acc in totals.items():
            if acc.count < cfg.min_events:
                continue
            labels = dict(
                model_version=key[0], tenant=key[1], re_type=key[2]
            )
            auc = acc.auc()
            if auc is not None:
                reg.gauge("quality_auc", **labels).set(auc)
            ece = acc.ece()
            if ece is not None:
                reg.gauge("quality_ece", **labels).set(ece)
            loss = acc.mean_loss()
            if loss is not None:
                reg.gauge(loss_name, **labels).set(loss)
            if cfg.baseline_version and key[0] != cfg.baseline_version:
                base = totals.get((cfg.baseline_version, key[1], key[2]))
                if (base is not None and base.count >= cfg.min_events
                        and auc is not None):
                    base_auc = base.auc()
                    if base_auc is not None:
                        reg.gauge("quality_auc_lift", **labels).set(
                            auc - base_auc
                        )

    def snapshot(self) -> dict:
        """The ``stats()``/healthz quality block: per-key windowed metrics
        plus lift vs the baseline lane (measured, same horizon)."""
        cfg = self.config
        totals = self.window_totals()
        versions: List[dict] = []
        for key in sorted(totals):
            acc = totals[key]
            entry = dict(
                model_version=key[0], tenant=key[1], re_type=key[2],
                **acc.snapshot(cfg.task),
            )
            if cfg.baseline_version and key[0] != cfg.baseline_version:
                base = totals.get((cfg.baseline_version, key[1], key[2]))
                auc = acc.auc()
                base_auc = base.auc() if base is not None else None
                if auc is not None and base_auc is not None:
                    entry["auc_lift"] = auc - base_auc
            versions.append(entry)
        return dict(
            task=cfg.task,
            baseline=cfg.baseline_version,
            window_s=cfg.window_s,
            num_windows=cfg.num_windows,
            versions=versions,
        )
