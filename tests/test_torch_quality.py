"""The port's quality plane (photon_tpu_torch/obs/quality.py), held to the
cases of tests/test_quality.py, and to the reference's plane on the same
records (equal snapshots). The three properties everything downstream
leans on:

1. The streaming histogram AUC tracks the exact ``auc_roc`` within its
   stated bound — records in the same score bin are ties, so the error is
   at most the within-bin opposite-class pair mass, ½·Σ_b pos_b·neg_b/(P·N)
   (and shrinks as 1/score_bins for continuous scores). Includes tied
   scores and single-class windows.
2. Accumulator merge is EXACTLY accumulate-equivalence: merge(a, b) ==
   accumulate(a ++ b) field by field, and associative/commutative — the
   property that makes per-replica quality blocks roll up in the fleet
   scrape like every other instrument.
3. Window rotation is monotone under clock skew: a backwards clock clamps
   into the newest window (never reopens a rotated one), forward jumps
   rotate, and only the last ``num_windows`` windows are retained.
"""

import math

import numpy as np
import pytest
import torch

from photon_tpu_torch.evaluation.evaluators import auc_roc
from photon_tpu_torch.obs.quality import (
    QualityAccumulator,
    QualityConfig,
    QualityPlane,
    predict,
)

rng = np.random.default_rng(17)


def _fill(acc, preds, labels, weights=None, task="logistic", delays=None):
    n = len(preds)
    for i in range(n):
        acc.observe(
            float(preds[i]), float(labels[i]), task=task,
            weight=1.0 if weights is None else float(weights[i]),
            delay_s=None if delays is None else float(delays[i]),
        )
    return acc


def _exact_auc(preds, labels, weights=None):
    return float(auc_roc(
        torch.as_tensor(preds, dtype=torch.float64), torch.as_tensor(labels, dtype=torch.float64),
        None if weights is None else torch.as_tensor(weights, dtype=torch.float64),
    ))


def _tie_bound(acc):
    """½·Σ_b pos_b·neg_b / (P·N): the worst-case rank error from treating
    same-bin opposite-class pairs as ties."""
    p_tot, n_tot = sum(acc.pos), sum(acc.neg)
    pair_mass = sum(p * n for p, n in zip(acc.pos, acc.neg))
    return 0.5 * pair_mass / (p_tot * n_tot)


# -- 1. histogram AUC vs exact auc_roc ------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("bins", [16, 64, 256])
def test_histogram_auc_within_tie_bound(seed, bins):
    r = np.random.default_rng(seed)
    n = 400
    labels = (r.random(n) < 0.4).astype(np.float64)
    # Overlapping score distributions → a real, non-degenerate AUC.
    scores = r.normal(size=n) + 1.2 * labels
    preds = np.array([predict(s, "logistic") for s in scores])
    acc = _fill(QualityAccumulator(score_bins=bins), preds, labels)
    # Sigmoid is monotone, so the exact AUC of preds equals that of scores.
    exact = _exact_auc(preds, labels)
    assert abs(acc.auc() - exact) <= _tie_bound(acc) + 1e-12


def test_histogram_auc_bound_shrinks_with_bins():
    r = np.random.default_rng(5)
    n = 2000
    labels = (r.random(n) < 0.5).astype(np.float64)
    preds = np.clip(r.random(n) * 0.6 + 0.3 * labels, 0.0, 1.0)
    exact = _exact_auc(preds, labels)
    errs = []
    for bins in (8, 64, 512):
        acc = _fill(QualityAccumulator(score_bins=bins), preds, labels)
        errs.append(abs(acc.auc() - exact))
    assert errs[2] <= errs[0] + 1e-12  # finer bins never rank worse
    assert errs[2] < 5e-3  # 512 bins on continuous scores: tight


def test_histogram_auc_exact_on_tied_bin_centers():
    """All ties land on bin centers → same-bin ties ARE exact-score ties,
    and the histogram AUC must equal ``auc_roc``'s ½-credit exactly."""
    r = np.random.default_rng(7)
    bins = 16
    n = 300
    # Predictions quantized to the 16 bin centers: (k + 0.5) / 16.
    preds = (r.integers(0, bins, size=n) + 0.5) / bins
    labels = (r.random(n) < preds).astype(np.float64)  # heavy ties, both classes
    w = r.integers(1, 4, size=n).astype(np.float64)
    acc = _fill(QualityAccumulator(score_bins=bins), preds, labels, weights=w)
    # Tolerance is the float32 precision of the JAX reference, not the
    # histogram's — the tie handling itself is exact here.
    assert acc.auc() == pytest.approx(_exact_auc(preds, labels, w), abs=1e-6)


def test_single_class_window_has_no_auc():
    acc = _fill(QualityAccumulator(), [0.2, 0.7, 0.9], [1.0, 1.0, 1.0])
    assert acc.auc() is None
    acc = _fill(QualityAccumulator(), [0.2, 0.7], [0.0, 0.0])
    assert acc.auc() is None
    assert acc.ece() is not None  # calibration is still defined


# -- 2. merge == accumulate, associative ----------------------------------


def _stream(r, n):
    """A stream whose per-record contributions are dyadic rationals, so
    field sums are exact in binary float regardless of add order — except
    loss_sum, whose log() terms are irrational by nature."""
    preds = r.integers(0, 64, size=n) / 64.0 + 1.0 / 128.0
    labels = (r.random(n) < 0.5).astype(np.float64)
    weights = r.integers(1, 8, size=n) / 4.0
    delays = r.choice([0.25, 0.5, 4.0, 120.0], size=n)
    return list(zip(preds, labels, weights, delays))


def _accumulate(stream, task="logistic"):
    acc = QualityAccumulator()
    for p, y, w, d in stream:
        acc.observe(float(p), float(y), task=task, weight=float(w),
                    delay_s=float(d))
    return acc


def _assert_fields_equal(a, b):
    assert a.count == b.count
    assert a.weight == b.weight
    assert a.pos == b.pos and a.neg == b.neg
    assert a.calib_w == b.calib_w
    assert a.calib_p == b.calib_p and a.calib_y == b.calib_y
    assert a.delay_counts == b.delay_counts
    assert a.delay_sum == b.delay_sum
    assert math.isclose(a.loss_sum, b.loss_sum, rel_tol=1e-12)


@pytest.mark.parametrize("task", ["logistic", "poisson"])
def test_merge_equals_accumulate_concat(task):
    r = np.random.default_rng(11)
    sa, sb = _stream(r, 157), _stream(r, 83)
    merged = _accumulate(sa, task).merge(_accumulate(sb, task))
    _assert_fields_equal(merged, _accumulate(sa + sb, task))


def test_merge_associative_and_commutative():
    r = np.random.default_rng(13)
    sa, sb, sc = _stream(r, 60), _stream(r, 90), _stream(r, 45)
    a1, b1, c1 = map(_accumulate, (sa, sb, sc))
    a2, b2, c2 = map(_accumulate, (sa, sb, sc))
    left = a1.merge(b1).merge(c1)  # (a ⊕ b) ⊕ c
    right = _accumulate(sc).merge(_accumulate(sb)).merge(_accumulate(sa))
    _assert_fields_equal(left, right)  # order-free up to loss_sum ulps
    _assert_fields_equal(left, _accumulate(sa + sb + sc))
    # Derived metrics agree too.
    assert left.auc() == pytest.approx(right.auc(), abs=1e-12)
    assert left.ece() == pytest.approx(right.ece(), abs=1e-12)
    assert a2.merge(b2.merge(c2)).auc() == pytest.approx(left.auc(), abs=1e-12)


def test_merge_rejects_mismatched_bins():
    with pytest.raises(ValueError):
        QualityAccumulator(score_bins=64).merge(
            QualityAccumulator(score_bins=32))


# -- 3. window rotation under clock skew ----------------------------------


def _plane(window_s=10.0, num_windows=2):
    t = [100.0]
    plane = QualityPlane(
        QualityConfig(task="logistic", window_s=window_s,
                      num_windows=num_windows, min_events=1),
        clock=lambda: t[0],
    )
    return plane, t


def _count(plane):
    totals = plane.window_totals()
    return sum(acc.count for acc in totals.values())


def test_backwards_clock_clamps_into_newest_window():
    plane, t = _plane()
    plane.observe(0.3, 1.0, model_version="gen-1")
    t[0] = 95.0  # clock jumps backwards past the window boundary
    plane.observe(-0.3, 0.0, model_version="gen-1")
    # Both land in the one open window — nothing reopened, nothing lost.
    assert _count(plane) == 2
    t[0] = 112.0  # forward: rotates; both windows retained (num_windows=2)
    plane.observe(0.5, 1.0, model_version="gen-1")
    assert _count(plane) == 3


def test_rotation_retains_only_num_windows():
    """Windows materialize on observation and the plane keeps the last
    ``num_windows`` MATERIALIZED windows — so each rotation past the cap
    expires exactly the oldest populated window."""
    plane, t = _plane(window_s=10.0, num_windows=2)
    plane.observe(0.3, 1.0, model_version="gen-1")
    plane.observe(-0.3, 0.0, model_version="gen-1")
    t[0] = 112.0
    plane.observe(0.5, 1.0, model_version="gen-1")
    t[0] = 125.0  # third window: the t=100 window (2 events) must age out
    plane.observe(-0.5, 0.0, model_version="gen-1")
    assert _count(plane) == 2
    # A forward jump over many empty grid slots is ONE new window — it
    # expires one populated window, not every slot it skipped.
    t[0] = 1000.0
    plane.observe(0.5, 1.0, model_version="gen-1")
    assert _count(plane) == 2  # {t=125 window, t=1000 window}


def test_backwards_clock_after_rotation_never_reopens():
    plane, t = _plane(window_s=10.0, num_windows=3)
    plane.observe(0.3, 1.0, model_version="gen-1")
    t[0] = 115.0
    plane.observe(0.5, 1.0, model_version="gen-1")
    t[0] = 50.0  # way before the FIRST window — still clamps to newest
    plane.observe(-0.5, 0.0, model_version="gen-1")
    assert _count(plane) == 3
    # The clamped record landed in the t=115 window, NOT a reopened (or
    # new) stale one: rotating twice more expires the t=100 window while
    # the clamped record is still retained.
    t[0] = 135.0
    plane.observe(0.1, 1.0, model_version="gen-1")
    assert _count(plane) == 4  # windows {100, 115, 135}: 1 + 2 + 1
    t[0] = 145.0
    plane.observe(0.2, 1.0, model_version="gen-1")
    assert _count(plane) == 4  # {115, 135, 145}: t=100's 1 out, new 1 in


# -- 4. the port's plane against the reference's ----------------------------


@pytest.mark.parametrize("task", ["logistic", "poisson"])
def test_accumulator_matches_reference(task):
    """The same records through both packages' accumulators give the same
    counters, AUC and calibration, exactly (the same host arithmetic)."""
    from photon_tpu.obs.quality import QualityAccumulator as JAccumulator

    r = np.random.default_rng(5)
    n = 300
    preds = r.normal(size=n) if task == "logistic" else r.normal(size=n) * 0.3
    labels = (r.uniform(size=n) < 0.4).astype(float) if task == "logistic" else r.poisson(1.5, size=n).astype(float)
    weights = r.uniform(0.5, 2.0, size=n)
    delays = r.uniform(0, 30, size=n)
    mine = _fill(QualityAccumulator(64), preds, labels, weights, task, delays)
    ref = _fill(JAccumulator(64), preds, labels, weights, task, delays)
    assert mine.snapshot(task) == ref.snapshot(task)
