"""The port's train_glm slice against the JAX package on the CPU.

Module parity runs in float64 (jax's scoped x64 context, never the global
flag) at rtol 1e-5. The drivers run in float32, as both read their files
into float32: per-λ coefficients agree within 1e-3·max(1, max|w|), the
MetricsMaps within 1e-3·max(1, |metric|), and both pick the same best λ. Inputs are
made with numpy from a seed; the Avro and LIBSVM fixtures are written here.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.cli import train_glm as j_train_glm
from photon_tpu.data.batch import LabeledBatch as JBatch
from photon_tpu.data.index_map import IndexMap as JIndexMap
from photon_tpu.data.normalization import build_normalization_context as j_build_norm
from photon_tpu.data.stats import compute_feature_stats as j_stats
from photon_tpu.evaluation.metrics_map import metrics_map as j_metrics_map
from photon_tpu.io import data_reader as j_reader
from photon_tpu.io.avro import write_avro_records
from photon_tpu.io.libsvm import read_libsvm as j_read_libsvm
from photon_tpu.io.model_io import load_game_model as j_load_game_model
from photon_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_tpu.ops import losses as j_losses
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.ops.variance import coefficient_variances as j_variances
from photon_tpu.optim.common import OptimizerConfig as JConfig
from photon_tpu.optim.factory import OptimizerSpec as JSpec
from photon_tpu.optim.factory import make_optimizer as j_make_optimizer
from photon_tpu.optim.lbfgs import minimize_lbfgs as j_lbfgs
from photon_tpu.optim.lbfgs import minimize_lbfgsb as j_lbfgsb
from photon_tpu.optim.owlqn import minimize_owlqn as j_owlqn
from photon_tpu.optim.tron import minimize_tron as j_tron
from photon_tpu.types import NormalizationType as JNormType
from photon_tpu.types import OptimizerType as JOptType
from photon_tpu.types import TaskType as JTask
from photon_tpu.types import VarianceComputationType as JVar

from photon_tpu_torch.cli import train_glm
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.data.normalization import build_normalization_context
from photon_tpu_torch.data.stats import compute_feature_stats
from photon_tpu_torch.data.validators import DataValidationError, validate_labeled_batch
from photon_tpu_torch.evaluation.metrics_map import metrics_map
from photon_tpu_torch.io import data_reader
from photon_tpu_torch.io.libsvm import read_libsvm
from photon_tpu_torch.io.model_io import load_game_model
from photon_tpu_torch.ops import losses, objective as objective_module
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.ops.variance import coefficient_variances
from photon_tpu_torch.optim.common import OptimizerConfig
from photon_tpu_torch.optim.factory import OptimizerSpec, make_optimizer
from photon_tpu_torch.optim.lbfgs import minimize_lbfgs, minimize_lbfgsb
from photon_tpu_torch.optim.owlqn import minimize_owlqn
from photon_tpu_torch.optim.tron import minimize_tron
from photon_tpu_torch.types import NormalizationType, OptimizerType, TaskType, VarianceComputationType

REPO = Path(__file__).resolve().parent.parent
RTOL64 = 1e-5
TASKS = [t.name for t in TaskType]


def _close64(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL64, atol=RTOL64 * max(1e-12, np.abs(want).max()))


def _glm_data(n=300, d=6, seed=0):
    """Dense float64 features with the intercept last, planted logistic
    labels, offsets and weights (every 17th row weight 0)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + rng.normal(size=d)
    X[:, -1] = 1.0
    w = rng.normal(size=d) / np.sqrt(d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float64)
    off = 0.1 * rng.normal(size=n)
    wt = rng.uniform(0.5, 2.0, size=n)
    wt[::17] = 0.0
    return X, y, off, wt


def _batches(X, y, off=None, wt=None):
    jb = JBatch(*(None if a is None else jnp.asarray(a) for a in (y, X, off, wt)))
    tb = LabeledBatch.from_numpy(y, X, off, wt, device="cpu")
    return jb, tb


def _norm_pair(norm_type: str, X, wt, icpt):
    """The same normalization context in both packages, from each package's
    own feature statistics (checked equal in their own test)."""
    if norm_type == "NONE":
        return None, None
    jst = j_stats(JBatch(jnp.zeros(X.shape[0]), jnp.asarray(X), None, jnp.asarray(wt)), icpt)
    tst = compute_feature_stats(LabeledBatch.from_numpy(np.zeros(X.shape[0]), X, None, wt, device="cpu"), icpt)
    jn = j_build_norm(JNormType[norm_type], jst.mean, jst.std, jst.abs_max, icpt)
    tn = build_normalization_context(NormalizationType[norm_type], tst.mean, tst.std, tst.abs_max, icpt)
    return jn, tn


# ---------------------------------------------------------------------------
# Math core, float64.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", [t.name for t in NormalizationType])
def test_hessian_products_match_reference(norm_type, monkeypatch):
    # Chunks of 37 rows: the port's Hessian diagonal and matrix sum over
    # several row chunks, as they do at N = 2^21.
    monkeypatch.setattr(objective_module, "_CHUNK_ROWS", 37)
    X, y, off, wt = _glm_data(seed=1)
    d, icpt = X.shape[1], X.shape[1] - 1
    v = np.random.default_rng(2).normal(size=d)
    w = np.random.default_rng(3).normal(size=d) * 0.3
    with jax.enable_x64(True):
        jb, tb = _batches(X, y, off, wt)
        jn, tn = _norm_pair(norm_type, X, wt, icpt)
        jo = JObjective(loss=j_losses.LogisticLoss, l2_weight=0.7, intercept_index=icpt, normalization=jn)
        jw = jnp.asarray(w)
        want = [jo.hvp(jw, jnp.asarray(v), jb), jo.hessian_diagonal(jw, jb), jo.hessian_matrix(jw, jb),
                jo.linearized_hvp(jw, jb)(jnp.asarray(v)), jo.full_value(jw, jb)]
        want = [np.asarray(a) for a in want]
    to = GLMObjective(losses.LogisticLoss, l2_weight=0.7, intercept_index=icpt, normalization=tn)
    tw = torch.from_numpy(w)
    got = [to.hvp(tw, torch.from_numpy(v), tb), to.hessian_diagonal(tw, tb), to.hessian_matrix(tw, tb),
           to.linearized_hvp(tw, tb)(torch.from_numpy(v)), to.full_value(tw, tb)]
    for g, wv in zip(got, want):
        _close64(g, wv)
    torch.testing.assert_close(to.hessian_diagonal(tw, tb), torch.diagonal(to.hessian_matrix(tw, tb)))


def test_l1_term_and_regularization_copies_match_reference():
    X, y, off, wt = _glm_data(seed=4)
    w = np.random.default_rng(5).normal(size=X.shape[1])
    with jax.enable_x64(True):
        jb, tb = _batches(X, y, off, wt)
        jo = JObjective(loss=j_losses.SquaredLoss, l2_weight=0.3, l1_weight=0.2, intercept_index=0)
        want = [np.asarray(jo.l1_term(jnp.asarray(w))), np.asarray(jo.with_l1(0.9).full_value(jnp.asarray(w), jb)),
                np.asarray(jo.with_l2(2.0).value(jnp.asarray(w), jb))]
    to = GLMObjective(losses.SquaredLoss, l2_weight=0.3, l1_weight=0.2, intercept_index=0)
    tw = torch.from_numpy(w)
    for g, wv in zip([to.l1_term(tw), to.with_l1(0.9).full_value(tw, tb), to.with_l2(2.0).value(tw, tb)], want):
        _close64(g, wv)


@pytest.mark.parametrize("task", TASKS)
def test_loss_for_task_matches_reference(task):
    z = np.linspace(-4, 4, 41)
    y = np.where(np.arange(41) % 3 == 0, 1.0, 0.0) if "REGRESSION" not in task or task == "LOGISTIC_REGRESSION" \
        else np.abs(np.sin(np.arange(41)))
    jl, tl = j_losses.loss_for_task(JTask[task]), losses.loss_for_task(TaskType[task])
    assert jl.name == tl.name
    with jax.enable_x64(True):
        want = [np.asarray(f(jnp.asarray(z), jnp.asarray(y))) for f in (jl.value, jl.dz, jl.dzz)]
    for f, wv in zip((tl.value, tl.dz, tl.dzz), want):
        _close64(f(torch.from_numpy(z), torch.from_numpy(y)), wv)


@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("variance", ["SIMPLE", "FULL"])
def test_variances_match_reference(variance, degenerate):
    """``degenerate``: an all-zero feature column and no L2, so H is singular:
    FULL's Cholesky fails and every coordinate falls back to SIMPLE."""
    X, y, off, wt = _glm_data(seed=6)
    if degenerate:
        X[:, 2] = 0.0
    l2 = 0.0 if degenerate else 0.5
    w = np.random.default_rng(7).normal(size=X.shape[1]) * 0.2
    with jax.enable_x64(True):
        jb, _ = _batches(X, y, off, wt)
        jo = JObjective(loss=j_losses.LogisticLoss, l2_weight=l2, intercept_index=X.shape[1] - 1)
        want = np.asarray(j_variances(jo, jnp.asarray(w), jb, JVar[variance]))
    _, tb = _batches(X, y, off, wt)
    to = GLMObjective(losses.LogisticLoss, l2_weight=l2, intercept_index=X.shape[1] - 1)
    got = coefficient_variances(to, torch.from_numpy(w), tb, VarianceComputationType[variance])
    _close64(got, want)
    if degenerate:
        assert got[2] == pytest.approx(1e12)


def test_variances_none_is_none():
    X, y, off, wt = _glm_data(n=20, seed=8)
    _, tb = _batches(X, y, off, wt)
    assert coefficient_variances(GLMObjective(losses.LogisticLoss), torch.zeros(X.shape[1], dtype=torch.float64),
                                 tb, VarianceComputationType.NONE) is None


@pytest.mark.parametrize("chunk", [7, 1 << 16])
def test_feature_stats_match_reference(chunk, monkeypatch):
    from photon_tpu_torch.data import stats as stats_module

    monkeypatch.setattr(stats_module, "_CHUNK_ROWS", chunk)
    X, _, _, wt = _glm_data(n=90, seed=9)
    X[::5, 1] = 0.0
    with jax.enable_x64(True):
        want = j_stats(JBatch(jnp.zeros(90), jnp.asarray(X), None, jnp.asarray(wt)), 5)
        want = {f: np.asarray(getattr(want, f)) for f in
                ("count", "mean", "variance", "min", "max", "norm_l1", "norm_l2", "num_nonzeros", "std", "abs_max")}
    got = compute_feature_stats(LabeledBatch.from_numpy(np.zeros(90), X, None, wt, device="cpu"), 5)
    for f, wv in want.items():
        _close64(getattr(got, f), wv)


@pytest.mark.parametrize("norm_type", [t.name for t in NormalizationType])
def test_normalization_context_matches_reference(norm_type):
    X, _, _, wt = _glm_data(n=80, seed=10)
    X[:, 0] = 0.0  # a zero statistic: factor 1
    icpt = X.shape[1] - 1
    w = np.random.default_rng(11).normal(size=X.shape[1])
    with jax.enable_x64(True):
        jn, tn = _norm_pair(norm_type, X, wt, icpt)
        if jn is None:
            jn = j_build_norm(JNormType.NONE, None, None, None, icpt)
            tn = build_normalization_context(NormalizationType.NONE, None, None, None, icpt)
        jw = jnp.asarray(w)
        want = [jn.factors, jn.shifts, jn.transformed_to_model_space(jw), jn.model_to_transformed_space(jw)]
        want = [None if a is None else np.asarray(a) for a in want]
    assert tn.intercept_index == jn.intercept_index == icpt
    tw = torch.from_numpy(w)
    got = [tn.factors, tn.shifts, tn.transformed_to_model_space(tw), tn.model_to_transformed_space(tw)]
    for g, wv in zip(got, want):
        assert (g is None) == (wv is None)
        if wv is not None:
            _close64(g, wv)
    _close64(tn.model_to_transformed_space(tn.transformed_to_model_space(tw)), w)


def test_standardization_requires_an_intercept():
    with pytest.raises(ValueError, match="intercept"):
        build_normalization_context(NormalizationType.STANDARDIZATION, torch.zeros(3), torch.ones(3),
                                    torch.ones(3), None)


# ---------------------------------------------------------------------------
# Optimizers, float64, on the fixtures of tests/test_optimizers.py.
# ---------------------------------------------------------------------------


def _quadratic(d=8, seed=12, b_scale=10.0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(d, d))
    return M @ M.T + d * np.eye(d), b_scale * rng.normal(size=d)


def _quad_vg(A, b, lib):
    A, b = lib(A), lib(b)
    return lambda w: (0.5 * w @ A @ w - b @ w, A @ w - b)


def _assert_same_solve(got, want, zeros_exact=False):
    _close64(got.w, want.w)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.reason_code) == int(want.reason_code)
    _close64(got.value, want.value)
    _close64(got.loss_history, want.loss_history)
    if zeros_exact:
        np.testing.assert_array_equal(got.w.numpy() == 0.0, np.asarray(want.w) == 0.0)


def _logistic_fixture(n=256, d=10, seed=13):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[:, 0] = 1.0
    w_true = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-X @ w_true))).astype(np.float64)
    return X, y


@pytest.mark.parametrize("problem", ["quadratic", "logistic"])
def test_lbfgs_with_box_matches_reference(problem):
    cfg = dict(max_iter=60, tol=1e-9)
    if problem == "quadratic":
        A, b = _quadratic()
        d = 8
        jvg, tvg = _quad_vg(A, b, jnp.asarray), _quad_vg(A, b, torch.from_numpy)
    else:
        X, y = _logistic_fixture()
        d = X.shape[1]
        jo = JObjective(loss=j_losses.LogisticLoss, l2_weight=0.1)
        to = GLMObjective(losses.LogisticLoss, l2_weight=0.1)
        tb = LabeledBatch.from_numpy(y, X, device="cpu")
        tvg = lambda w: to.value_and_grad(w, tb)  # noqa: E731
    lo, hi = -0.5 * np.ones(d), 0.5 * np.ones(d)
    with jax.enable_x64(True):
        if problem == "logistic":
            jb = JBatch(jnp.asarray(y), jnp.asarray(X))
            jvg = lambda w: jo.value_and_grad(w, jb)  # noqa: E731
        want = j_lbfgs(jvg, jnp.zeros(d), JConfig(**cfg), box=(jnp.asarray(lo), jnp.asarray(hi)))
        want_free = j_lbfgs(jvg, jnp.zeros(d), JConfig(**cfg))
    got = minimize_lbfgs(tvg, torch.zeros(d, dtype=torch.float64), OptimizerConfig(**cfg),
                         box=(torch.from_numpy(lo), torch.from_numpy(hi)))
    _assert_same_solve(got, want)
    assert got.w.min() >= -0.5 and got.w.max() <= 0.5
    _assert_same_solve(minimize_lbfgs(tvg, torch.zeros(d, dtype=torch.float64), OptimizerConfig(**cfg)), want_free)


def test_lbfgsb_matches_reference():
    A, b = _quadratic(seed=14)
    lo, hi = -0.5 * np.ones(8), 0.5 * np.ones(8)
    with jax.enable_x64(True):
        want = j_lbfgsb(_quad_vg(A, b, jnp.asarray), jnp.zeros(8), jnp.asarray(lo), jnp.asarray(hi))
    got = minimize_lbfgsb(_quad_vg(A, b, torch.from_numpy), torch.zeros(8, dtype=torch.float64),
                          torch.from_numpy(lo), torch.from_numpy(hi))
    _assert_same_solve(got, want)


def test_lbfgs_rolls_back_a_diverged_step():
    """A gradient that turns NaN past a point (the value stays finite, so
    the line search accepts the step): the solve keeps the last finite
    iterate and reports DIVERGED, as the reference does."""
    def vg(lib):
        def f(w):
            bad = lib.where(w.max() > 1.5, float("nan"), 0.0)
            return 0.5 * (w * w).sum() - 3.0 * w.sum(), w - 3.0 + bad
        return f

    with jax.enable_x64(True):
        want = j_lbfgs(vg(jnp), jnp.zeros(3), JConfig(max_iter=10))
    got = minimize_lbfgs(vg(torch), torch.zeros(3, dtype=torch.float64), OptimizerConfig(max_iter=10))
    assert got.convergence_reason.value == "DIVERGED"
    _assert_same_solve(got, want)
    assert torch.isfinite(got.w).all()


@pytest.mark.parametrize("problem", ["lasso", "elastic_net_logistic"])
def test_owlqn_matches_reference_with_exact_zeros(problem):
    rng = np.random.default_rng(15)
    if problem == "lasso":
        n, d = 128, 20
        X = rng.normal(size=(n, d))
        w_true = np.zeros(d)
        w_true[:3] = [2.0, -3.0, 1.5]
        y = X @ w_true + 0.01 * rng.normal(size=n)
        jl, tl, l2, l1, mask = j_losses.SquaredLoss, losses.SquaredLoss, 0.0, 5.0, None
    else:
        X, y = _logistic_fixture(seed=16)
        d = X.shape[1]
        jl, tl, l2, l1 = j_losses.LogisticLoss, losses.LogisticLoss, 0.5, 4.0
        mask = np.ones(d)
        mask[0] = 0.0  # the intercept is not penalized
    cfg = dict(max_iter=300)
    with jax.enable_x64(True):
        jo, jb = JObjective(loss=jl, l2_weight=l2), JBatch(jnp.asarray(y), jnp.asarray(X))
        want = j_owlqn(lambda w: jo.value_and_grad(w, jb), jnp.zeros(d), l1, JConfig(**cfg),
                       None if mask is None else jnp.asarray(mask))
    to, tb = GLMObjective(tl, l2_weight=l2), LabeledBatch.from_numpy(y, X, device="cpu")
    got = minimize_owlqn(lambda w: to.value_and_grad(w, tb), torch.zeros(d, dtype=torch.float64), l1,
                         OptimizerConfig(**cfg), None if mask is None else torch.from_numpy(mask))
    _assert_same_solve(got, want, zeros_exact=True)
    assert int((got.w == 0).sum()) >= (3 if problem == "lasso" else 1)


@pytest.mark.parametrize("boxed", [False, True])
def test_tron_with_box_matches_reference(boxed):
    X, y = _logistic_fixture(seed=17)
    d = X.shape[1]
    cfg = dict(max_iter=15, tol=1e-9)
    lo, hi = -0.4 * np.ones(d), 0.4 * np.ones(d)
    with jax.enable_x64(True):
        jo, jb = JObjective(loss=j_losses.LogisticLoss, l2_weight=0.1), JBatch(jnp.asarray(y), jnp.asarray(X))
        want = j_tron(lambda w: jo.value_and_grad(w, jb), None, jnp.zeros(d), JConfig(**cfg),
                      box=(jnp.asarray(lo), jnp.asarray(hi)) if boxed else None,
                      hvp_factory=lambda w: jo.linearized_hvp(w, jb))
    to, tb = GLMObjective(losses.LogisticLoss, l2_weight=0.1), LabeledBatch.from_numpy(y, X, device="cpu")
    got = minimize_tron(lambda w: to.value_and_grad(w, tb), None, torch.zeros(d, dtype=torch.float64),
                        OptimizerConfig(**cfg), box=(torch.from_numpy(lo), torch.from_numpy(hi)) if boxed else None,
                        hvp_factory=lambda w: to.linearized_hvp(w, tb))
    _assert_same_solve(got, want)
    if boxed:
        assert got.w.abs().max() <= 0.4


# (optimizer, l1, box, the eval unit the route reports)
_ROUTES = [
    ("LBFGS", 0.0, False, "x_passes"),  # margin-space L-BFGS
    ("LBFGS", 0.0, True, "objective_evals"),  # L-BFGS with a box
    ("LBFGSB", 0.0, True, "objective_evals"),
    ("TRON", 0.0, False, "objective_evals"),
    ("TRON", 0.0, True, "objective_evals"),
    ("TRON", 0.5, False, "objective_evals"),  # an L1 weight routes to OWL-QN
    ("LBFGS", 0.5, False, "objective_evals"),
]


@pytest.mark.parametrize("opt,l1,boxed,unit", _ROUTES)
def test_factory_routing_matches_reference(opt, l1, boxed, unit):
    X, y = _logistic_fixture(n=200, d=6, seed=18)
    d = X.shape[1]
    lo, hi = -0.3 * np.ones(d), 0.3 * np.ones(d)
    common = dict(l2_weight=0.2, l1_weight=l1, intercept_index=0)
    with jax.enable_x64(True):
        jbox = (jnp.asarray(lo), jnp.asarray(hi)) if boxed else None
        want = j_make_optimizer(JObjective(loss=j_losses.LogisticLoss, **common),
                                JSpec(JOptType[opt], max_iter=40, tol=1e-9, box=jbox))(
            jnp.zeros(d), JBatch(jnp.asarray(y), jnp.asarray(X)))
    tbox = (torch.from_numpy(lo), torch.from_numpy(hi)) if boxed else None
    got = make_optimizer(GLMObjective(losses.LogisticLoss, **common),
                         OptimizerSpec(OptimizerType[opt], max_iter=40, tol=1e-9, box=tbox))(
        torch.zeros(d, dtype=torch.float64), LabeledBatch.from_numpy(y, X, device="cpu"))
    assert got.eval_unit == want.eval_unit == unit
    _close64(got.w, want.w)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.evals) == int(want.evals)


def test_factory_lbfgsb_needs_a_box():
    solve = make_optimizer(GLMObjective(losses.LogisticLoss), OptimizerSpec(OptimizerType.LBFGSB))
    with pytest.raises(ValueError, match="box"):
        solve(torch.zeros(2), LabeledBatch(torch.zeros(3), torch.zeros(3, 2)))


def test_optimizer_spec_defaults_match_reference():
    for opt in OptimizerType:
        got, want = OptimizerSpec(opt).config(), JSpec(JOptType[opt.name]).config()
        assert (got.max_iter, got.tol, got.memory) == (want.max_iter, want.tol, want.memory)


# ---------------------------------------------------------------------------
# Evaluation.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", TASKS)
def test_metrics_map_matches_reference_with_ties(task):
    rng = np.random.default_rng(19)
    n = 400
    # Scores on a coarse grid: many ties, across both classes.
    margins = np.round(rng.normal(size=n) * 2.0, 1).astype(np.float32)
    if task in ("LINEAR_REGRESSION",):
        labels = (margins + rng.normal(size=n)).astype(np.float32)
    elif task == "POISSON_REGRESSION":
        margins = np.clip(margins, -2, 2)
        labels = rng.poisson(np.exp(margins)).astype(np.float32)
    else:
        labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-margins))).astype(np.float32)
    coefs = np.array([0.5, 0.0, -1.0, 1e-12], np.float32)
    want = j_metrics_map(JTask[task], jnp.asarray(margins), jnp.asarray(labels), coefficients=jnp.asarray(coefs))
    got = metrics_map(TaskType[task], torch.from_numpy(margins), torch.from_numpy(labels),
                      coefficients=torch.from_numpy(coefs))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


@pytest.mark.parametrize("etype", ["AUC", "AUPR", "RMSE", "SQUARED_LOSS", "LOGISTIC_LOSS", "POISSON_LOSS",
                                   "PRECISION_AT_K"])
def test_evaluators_match_reference(etype):
    from photon_tpu.evaluation.evaluators import EvaluatorType as JEval
    from photon_tpu.evaluation.evaluators import evaluate as j_evaluate
    from photon_tpu_torch.evaluation.evaluators import EvaluatorType, evaluate

    rng = np.random.default_rng(36)
    scores = np.round(rng.normal(size=300), 1).astype(np.float32)  # ties
    labels = (rng.uniform(size=300) < 1 / (1 + np.exp(-scores))).astype(np.float32)
    weight = rng.uniform(0.2, 2.0, size=300).astype(np.float32)
    # Distinct top scores: precision@k does not depend on how top-k breaks ties.
    scores[:12] = 10.0 + np.arange(12)
    w_arg = None if etype == "PRECISION_AT_K" else weight
    want = float(j_evaluate(JEval[etype], jnp.asarray(scores), jnp.asarray(labels),
                            None if w_arg is None else jnp.asarray(w_arg), k=10))
    got = float(evaluate(EvaluatorType[etype], torch.from_numpy(scores), torch.from_numpy(labels),
                         None if w_arg is None else torch.from_numpy(w_arg), k=10))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("task", TASKS)
def test_glm_model_matches_reference(task):
    from photon_tpu.models.coefficients import Coefficients as JCoefficients
    from photon_tpu.models.glm import GeneralizedLinearModel as JGLM
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.models.glm import GeneralizedLinearModel

    rng = np.random.default_rng(37)
    X = rng.normal(size=(50, 4)).astype(np.float32)
    w = rng.normal(size=4).astype(np.float32)
    off = rng.normal(size=50).astype(np.float32)
    jm = JGLM(JCoefficients(jnp.asarray(w)), JTask[task])
    tm = GeneralizedLinearModel(Coefficients(torch.from_numpy(w)), TaskType[task])
    np.testing.assert_allclose(tm.compute_score(torch.from_numpy(X)).numpy(),
                               np.asarray(jm.compute_score(jnp.asarray(X))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.compute_mean(torch.from_numpy(X), torch.from_numpy(off)).numpy(),
                               np.asarray(jm.compute_mean(jnp.asarray(X), jnp.asarray(off))), rtol=1e-5, atol=1e-6)
    if task in ("LOGISTIC_REGRESSION", "SMOOTHED_HINGE_LOSS_LINEAR_SVM"):
        np.testing.assert_array_equal(tm.predict_class(torch.from_numpy(X)).numpy(),
                                      np.asarray(jm.predict_class(jnp.asarray(X))))
    else:
        with pytest.raises(ValueError):
            tm.predict_class(torch.from_numpy(X))


def test_auc_counts_ties_as_half():
    from photon_tpu_torch.evaluation.evaluators import auc_pr, auc_roc, peak_f1

    s = torch.tensor([0.0, 0.0, 1.0, 1.0])
    y = torch.tensor([0.0, 1.0, 0.0, 1.0])
    assert float(auc_roc(s, y)) == pytest.approx(0.5)
    assert float(auc_roc(torch.tensor([0.0, 1.0]), torch.tensor([0.0, 1.0]))) == 1.0
    assert float(peak_f1(s, y)) == pytest.approx(2 / 3)
    assert 0.0 < float(auc_pr(s, y)) <= 1.0


# ---------------------------------------------------------------------------
# Readers.
# ---------------------------------------------------------------------------


def _avro_records(n, d, seed, bags=("features",), weights=False):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=d) * 1.5
    recs = []
    for i in range(n):
        x = rng.normal(size=d)
        x[rng.uniform(size=d) < 0.2] = 0.0  # sparse rows: absent features
        rec = {"uid": str(i), "label": float(rng.uniform() < 1 / (1 + np.exp(-x @ w_true))),
               "metadataMap": None, "weight": float(rng.uniform(0.5, 2)) if weights else None,
               "offset": float(0.1 * rng.normal()) if weights else None}
        for b, bag in enumerate(bags):
            rec[bag] = [{"name": f"f{j}", "term": "t" if j % 4 == 0 else "", "value": float(x[j])}
                        for j in range(d) if x[j] != 0.0 and j % len(bags) == b]
        recs.append(rec)
    return recs


def _write_avro(path, recs):
    write_avro_records(str(path), TRAINING_EXAMPLE_SCHEMA, recs)
    return str(path)


def test_avro_reader_matches_reference(tmp_path):
    path = _write_avro(tmp_path / "a.avro", _avro_records(60, 9, seed=20, weights=True))
    cfg = {"s": j_reader.FeatureShardConfig(feature_bags=["features"], has_intercept=True)}
    want, want_maps, _ = j_reader.read_merged([path], cfg, use_columnar=False)
    got, got_maps, _ = data_reader.read_merged(
        [path], {"s": data_reader.FeatureShardConfig(feature_bags=["features"], has_intercept=True)},
        device="cpu")
    assert list(got_maps["s"].items()) == list(want_maps["s"].items())
    assert got_maps["s"].get_index(IndexMap.INTERCEPT) == len(got_maps["s"]) - 1
    jb, tb = want.labeled_batch("s"), got.labeled_batch("s")
    for f in ("label", "features", "offset", "weight"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    # A supplied index map is used as given (the validation path).
    got2, maps2, _ = data_reader.read_merged(
        [path], {"s": data_reader.FeatureShardConfig()}, index_maps=got_maps, device="cpu")
    assert maps2 is got_maps
    np.testing.assert_array_equal(got2.features["s"].numpy(), tb.features.numpy())


def test_avro_reader_entity_ids_and_column_names_match_reference(tmp_path):
    recs = _avro_records(40, 5, seed=38, bags=("features", "extra"), weights=True)
    for i, r in enumerate(recs):
        r["metadataMap"] = None if i % 7 == 0 else {"userId": f"u{i % 5}"}
        r["uid"] = None if i % 7 else f"u{i % 3}"
    schema = dict(TRAINING_EXAMPLE_SCHEMA)
    schema["fields"] = TRAINING_EXAMPLE_SCHEMA["fields"] + [
        {"name": "extra", "type": {"type": "array", "items": TRAINING_EXAMPLE_SCHEMA["fields"][2]["type"]["items"]}}]
    path = str(tmp_path / "e.avro")
    write_avro_records(path, schema, recs)
    kw = dict(entity_id_columns={"user": "userId", "row": "uid"}, use_columnar=False)
    cfg = dict(feature_bags=["features", "extra"], has_intercept=False)
    want, want_maps, want_idx = j_reader.read_merged([path], {"s": j_reader.FeatureShardConfig(**cfg)}, **kw)
    got, got_maps, got_idx = data_reader.read_merged([path], {"s": data_reader.FeatureShardConfig(**cfg)},
                                                     device="cpu", **kw)
    assert list(got_maps["s"].items()) == list(want_maps["s"].items())
    assert IndexMap.INTERCEPT not in got_maps["s"]
    np.testing.assert_array_equal(got.features["s"].numpy(), np.asarray(want.features["s"]))
    for t in ("user", "row"):
        np.testing.assert_array_equal(got.entity_ids[t].numpy(), np.asarray(want.entity_ids[t]))
        assert got_idx[t].ids() == want_idx[t].ids()
    assert (got.entity_ids["user"].numpy() == -1).sum() == 6


def test_avro_reader_rejects_a_shard_wider_than_the_dense_limit(tmp_path):
    """A shard wider than the dense limit is not read as a dense matrix: it
    comes back padded-sparse, with the reference's triples (and the dense
    matrix as its to_dense), through the columnar decoder and the row path
    alike."""
    path = _write_avro(tmp_path / "w.avro", _avro_records(5, 9, seed=21))
    want, _, _ = j_reader.read_merged([path], {"s": j_reader.FeatureShardConfig(dense_dim_limit=4)},
                                      use_columnar=False)
    got, _, _ = data_reader.read_merged([path], {"s": data_reader.FeatureShardConfig(dense_dim_limit=4)},
                                        device="cpu")
    sf = got.features["s"]
    assert isinstance(sf, SparseFeatures) and not isinstance(sf, torch.Tensor)
    np.testing.assert_array_equal(sf.indices.numpy(), np.asarray(want.features["s"].indices))
    np.testing.assert_array_equal(sf.values.numpy(), np.asarray(want.features["s"].values))
    np.testing.assert_array_equal(sf.to_dense().numpy(), np.asarray(want.features["s"].to_dense()))
    rows, _, _ = data_reader.read_merged([path], {"s": data_reader.FeatureShardConfig(dense_dim_limit=4)},
                                         use_columnar=False, device="cpu")
    for x, y in zip(sf.tensors(), rows.features["s"].tensors()):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_libsvm_reader_and_driver_loader_match_reference(tmp_path):
    path = tmp_path / "t.txt"
    _write_libsvm(path, 50, 6, seed=22)
    X, y = read_libsvm(str(path))
    jX, jy = j_read_libsvm(str(path))
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    args = train_glm.build_parser().parse_args(["--training-data", str(path), "--output-dir", "x",
                                                "--format", "libsvm"])
    batch, imap = train_glm.load_data(args, str(path), "cpu")
    np.testing.assert_array_equal(batch.features.numpy()[:, :-1], jX)
    np.testing.assert_array_equal(batch.features.numpy()[:, -1], np.ones(50, np.float32))
    assert [k for k, _ in imap.items()] == [str(j + 1) for j in range(6)] + [IndexMap.INTERCEPT]


@pytest.mark.parametrize("task,labels,ok", [
    ("LOGISTIC_REGRESSION", [0.0, 1.0], True), ("LOGISTIC_REGRESSION", [0.0, 2.0], False),
    ("POISSON_REGRESSION", [0.0, 3.0], True), ("POISSON_REGRESSION", [-1.0, 3.0], False),
    ("LINEAR_REGRESSION", [-5.0, 3.0], True), ("LINEAR_REGRESSION", [float("nan"), 3.0], False),
])
def test_validators_follow_reference(task, labels, ok):
    from photon_tpu.data.validators import DataValidationError as JError
    from photon_tpu.data.validators import validate_labeled_batch as j_validate

    X = np.ones((2, 2), np.float32)
    y = np.asarray(labels, np.float32)
    outcomes = []
    for fn, batch, err in ((j_validate, JBatch(jnp.asarray(y), jnp.asarray(X)), JError),
                           (validate_labeled_batch, LabeledBatch.from_numpy(y, X, device="cpu"), DataValidationError)):
        try:
            fn(batch, type(batch) is JBatch and JTask[task] or TaskType[task])
            outcomes.append(True)
        except err:
            outcomes.append(False)
    assert outcomes == [ok, ok]


# ---------------------------------------------------------------------------
# The driver end to end: JAX train_glm against the port's, --device cpu.
# ---------------------------------------------------------------------------


def _write_libsvm(path, n, d, seed, w=None):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=d) if w is None else np.asarray(w)
    lines = []
    for _ in range(n):
        x = rng.normal(size=d)
        y = 1 if rng.uniform() < 1 / (1 + np.exp(-x @ w)) else -1
        lines.append(f"{y:+d} " + " ".join(f"{j + 1}:{x[j]:.4f}" for j in range(d)))
    Path(path).write_text("\n".join(lines))
    return str(path)


def _text_model(path):
    out = {}
    for line in open(path):
        if not line.startswith("#"):
            k, v = line.rstrip("\n").split("\t")
            out[k] = float(v)
    return out


def _run_both(tmp_path, argv):
    j_summary = j_train_glm.run(j_train_glm.build_parser().parse_args(argv + ["--output-dir", str(tmp_path / "jax")]))
    t_summary = train_glm.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    return j_summary, t_summary


def _assert_drivers_agree(tmp_path, j_summary, t_summary):
    assert t_summary["best_lambda"] == j_summary["best_lambda"]
    assert t_summary["stage"] == j_summary["stage"]
    assert [m["lambda"] for m in t_summary["models"]] == [m["lambda"] for m in j_summary["models"]]
    for jm, tm in zip(j_summary["models"], t_summary["models"]):
        name = f"model-lambda-{jm['lambda']:g}.txt"
        want, got = _text_model(tmp_path / "jax" / name), _text_model(tmp_path / "port" / name)
        scale = max(1.0, max(abs(v) for v in want.values()))
        for k in set(want) | set(got):
            assert abs(got.get(k, 0.0) - want.get(k, 0.0)) <= 1e-3 * scale, (name, k)
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-4)
        if "validation" in jm:
            assert sorted(tm["validation"]) == sorted(jm["validation"])
            for k, v in jm["validation"].items():
                # 1e-3 absolute, relative above 1 (AIC sums over samples).
                assert tm["validation"][k] == pytest.approx(v, abs=1e-3 * max(1.0, abs(v))), k
    for out in ("jax", "port"):
        assert (tmp_path / out / "LATEST").read_text().strip() == "best"
        assert (tmp_path / out / "best" / "model-metadata.json").exists()
    with open(tmp_path / "port" / "training-summary.json") as f:
        assert json.load(f)["best_lambda"] == t_summary["best_lambda"]


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON", "LBFGSB"])
def test_driver_matches_reference_on_libsvm(tmp_path, optimizer):
    path = _write_libsvm(tmp_path / "train.txt", 300, 4, seed=23, w=[1.5, -2.0, 0.5, 1.0])
    valid = _write_libsvm(tmp_path / "valid.txt", 200, 4, seed=24, w=[1.5, -2.0, 0.5, 1.0])
    argv = ["--training-data", path, "--validation-data", valid, "--format", "libsvm",
            "--regularization-weights", "0.1,1,10", "--optimizer", optimizer, "--compute-variance"]
    if optimizer == "LBFGSB":
        argv += ["--coefficient-box=-1,1"]
    j_summary, t_summary = _run_both(tmp_path, argv)
    _assert_drivers_agree(tmp_path, j_summary, t_summary)
    assert max(m["validation"]["Area under ROC"] for m in t_summary["models"]) > 0.75


@pytest.mark.parametrize("normalization", ["NONE", "STANDARDIZATION", "SCALE_WITH_MAX_MAGNITUDE"])
def test_driver_matches_reference_on_avro(tmp_path, normalization):
    train = _write_avro(tmp_path / "train.avro", _avro_records(400, 7, seed=25))
    valid = _write_avro(tmp_path / "valid.avro", _avro_records(200, 7, seed=26))
    argv = ["--training-data", train, "--validation-data", valid, "--regularization-weights", "0.5,5",
            "--normalization", normalization, "--compute-variance", "FULL"]
    j_summary, t_summary = _run_both(tmp_path, argv)
    _assert_drivers_agree(tmp_path, j_summary, t_summary)


@pytest.mark.parametrize("task", ["LINEAR_REGRESSION", "POISSON_REGRESSION"])
def test_driver_matches_reference_on_regression_tasks(tmp_path, task):
    rng = np.random.default_rng(27)
    recs = []
    for i in range(300):
        x = rng.normal(size=5)
        z = 0.4 * x[0] - 0.3 * x[1] + 0.2
        y = z + 0.1 * rng.normal() if task == "LINEAR_REGRESSION" else float(rng.poisson(np.exp(z)))
        recs.append({"uid": str(i), "label": float(y), "metadataMap": None, "weight": None, "offset": None,
                     "features": [{"name": f"x{j}", "term": "", "value": float(x[j])} for j in range(5)]})
    path = _write_avro(tmp_path / "r.avro", recs)
    j_summary, t_summary = _run_both(tmp_path, ["--training-data", path, "--validation-data", path,
                                                "--task", task, "--regularization-weights", "0.1,10"])
    _assert_drivers_agree(tmp_path, j_summary, t_summary)


@pytest.mark.parametrize("reg_type,extra", [
    ("NONE", ["--no-optimization-state-tracker"]),
    ("L1", []),
    ("L2", ["--no-intercept"]),
    ("ELASTIC_NET", ["--optimizer", "TRON", "--max-iterations", "4"]),
])
def test_driver_regularization_type_matches_reference(tmp_path, reg_type, extra):
    path = _write_libsvm(tmp_path / "t.txt", 200, 5, seed=35)
    argv = ["--training-data", path, "--validation-data", path, "--format", "libsvm",
            "--regularization-weights", "2,20", "--elastic-net-alpha", "0.5", "--regularization-type", reg_type]
    j_summary, t_summary = _run_both(tmp_path, argv + extra)
    _assert_drivers_agree(tmp_path, j_summary, t_summary)


def test_driver_elastic_net_zeros_fall_on_the_same_coordinates(tmp_path):
    rng = np.random.default_rng(28)
    lines = []
    for _ in range(200):
        x = rng.normal(size=10)
        y = 1 if rng.uniform() < 1 / (1 + np.exp(-(2 * x[0] - 1.5 * x[1]))) else -1
        lines.append(f"{y:+d} " + " ".join(f"{j + 1}:{x[j]:.4f}" for j in range(10)))
    (tmp_path / "t.txt").write_text("\n".join(lines))
    argv = ["--training-data", str(tmp_path / "t.txt"), "--format", "libsvm", "--regularization-weights", "5",
            "--elastic-net-alpha", "1.0"]
    j_summary, t_summary = _run_both(tmp_path, argv)
    _assert_drivers_agree(tmp_path, j_summary, t_summary)
    want, got = _text_model(tmp_path / "jax" / "model-lambda-5.txt"), _text_model(tmp_path / "port" / "model-lambda-5.txt")
    assert set(got) == set(want) and len(got) < 11  # some coefficients are exactly zero


def test_driver_validate_per_iteration_matches_reference(tmp_path):
    path = _write_libsvm(tmp_path / "t.txt", 150, 3, seed=29)
    argv = ["--training-data", path, "--validation-data", path, "--format", "libsvm",
            "--regularization-weights", "1", "--validate-per-iteration", "--optimizer", "TRON"]
    j_summary, t_summary = _run_both(tmp_path, argv)
    _assert_drivers_agree(tmp_path, j_summary, t_summary)
    (jm,), (tm,) = j_summary["models"], t_summary["models"]
    assert len(tm["per_iteration_validation"]) == tm["iterations"] == jm["iterations"]
    for a, b in zip(tm["per_iteration_validation"], jm["per_iteration_validation"]):
        assert a["Area under ROC"] == pytest.approx(b["Area under ROC"], abs=1e-3)


# ---------------------------------------------------------------------------
# Model files across the two packages.
# ---------------------------------------------------------------------------


def _jax_index_map(imap: IndexMap) -> JIndexMap:
    return JIndexMap(dict(imap.items()))


def test_model_directories_load_and_score_in_both_packages(tmp_path):
    path = _write_libsvm(tmp_path / "t.txt", 250, 5, seed=30)
    argv = ["--training-data", path, "--format", "libsvm", "--regularization-weights", "1",
            "--compute-variance"]
    _run_both(tmp_path, argv)
    args = train_glm.build_parser().parse_args(argv + ["--output-dir", "x"])
    batch, imap = train_glm.load_data(args, path, "cpu")
    X = batch.features
    from photon_tpu.data.game_data import GameBatch as JGameBatch
    from photon_tpu_torch.data.game_data import GameBatch

    n = X.shape[0]
    jgb = JGameBatch(jnp.zeros(n), jnp.zeros(n), jnp.ones(n), {"features": jnp.asarray(X.numpy())}, {})
    tgb = GameBatch(torch.zeros(n), torch.zeros(n), torch.ones(n), {"features": X}, {})
    for writer in ("port", "jax"):
        best = str(tmp_path / writer / "best")
        j_model = j_load_game_model(best, {"features": _jax_index_map(imap)})
        t_model = load_game_model(best, {"features": imap}, device="cpu")
        want, got = np.asarray(j_model.score(jgb)), t_model.score(tgb).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        (jc,), (tc,) = j_model.models.values(), t_model.models.values()
        np.testing.assert_array_equal(tc.model.coefficients.means.numpy(), np.asarray(jc.model.coefficients.means))
        np.testing.assert_array_equal(tc.model.coefficients.variances.numpy(),
                                      np.asarray(jc.model.coefficients.variances))
        assert tc.model.task.value == jc.model.task.value and tc.feature_shard == jc.feature_shard


def test_coefficient_scores_do_not_depend_on_the_batch_size():
    from photon_tpu_torch.models.coefficients import Coefficients

    rng = np.random.default_rng(31)
    X = torch.from_numpy(rng.normal(size=(257, 33)).astype(np.float32))
    c = Coefficients(torch.from_numpy(rng.normal(size=33).astype(np.float32)))
    whole = c.compute_score(X)
    parts = torch.cat([c.compute_score(X[i:i + 5]) for i in range(0, 257, 5)])
    assert torch.equal(whole, parts) and torch.equal(c.compute_score(X[3:4]), whole[3:4])


# ---------------------------------------------------------------------------
# The driver's device rules and flags.
# ---------------------------------------------------------------------------


def test_driver_device_defaults_to_cuda_and_never_falls_back(tmp_path):
    path = _write_libsvm(tmp_path / "t.txt", 20, 2, seed=32)
    argv = ["--training-data", path, "--format", "libsvm", "--output-dir", str(tmp_path / "o"),
            "--regularization-weights", "1"]
    assert train_glm.build_parser().parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(SystemExit) as exc:
        train_glm.main(argv)
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "o").exists()


# Flags the driver refused before the telemetry was ported; each now runs.
_UNPORTED = [["--telemetry-out", "t.jsonl"]]


@pytest.mark.parametrize("flag", _UNPORTED, ids=[f[0] for f in _UNPORTED])
def test_driver_refuses_unported_flags(tmp_path, flag):
    path = _write_libsvm(tmp_path / "t.txt", 20, 2, seed=33)
    out = tmp_path / "o"
    flag = [str(tmp_path / f) if f.endswith(".jsonl") else f for f in flag]
    summary = train_glm.main(["--training-data", path, "--format", "libsvm", "--output-dir", str(out),
                              "--device", "cpu"] + flag)
    assert "best_lambda" in summary and (out / "best").is_dir()
    assert (tmp_path / "t.jsonl").stat().st_size > 0


def test_driver_runs_as_a_module_without_jax(tmp_path):
    """``python -m photon_tpu_torch.cli.train_glm --device cpu`` in a fresh
    interpreter: it trains, writes its files, and never imports jax or the
    JAX package."""
    path = _write_libsvm(tmp_path / "t.txt", 60, 3, seed=34)
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['train_glm', '--training-data', {path!r}, '--format', 'libsvm', '--output-dir',"
        f" {str(tmp_path / 'o')!r}, '--regularization-weights', '1,10', '--device', 'cpu']\n"
        "runpy.run_module('photon_tpu_torch.cli.train_glm', run_name='__main__')\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'photon_tpu') or k.startswith(('jax.', 'photon_tpu.')))\n"
        "sys.exit(3 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["best_lambda"] in (1.0, 10.0)
    assert (tmp_path / "o" / "best" / "fixed-effect" / "global" / "coefficients" / "part-00000.avro").exists()


# ---------------------------------------------------------------------------
# Sparse files, summaries, selected features and name-and-term bags.
# ---------------------------------------------------------------------------


def _wide_records(n, seed, vocab=8000, nnz=25):
    """Rows of a file wider than the reader's dense limit: ~5,700 of
    ``vocab`` features occur in 400 rows, ``nnz`` a row, some with a term."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(78).normal(size=vocab)
    recs = []
    for i in range(n):
        cols = rng.choice(vocab, size=nnz, replace=False)
        x = rng.normal(size=nnz)
        recs.append({"uid": str(i), "label": float(rng.uniform() < 1 / (1 + np.exp(-0.5 * x @ w[cols]))),
                     "metadataMap": None, "weight": None, "offset": None,
                     "features": [{"name": f"f{c}", "term": "t" if c % 5 == 0 else "", "value": float(v)}
                                  for c, v in zip(cols, x)]})
    return recs


def _wide_files(tmp_path):
    return (_write_avro(tmp_path / "train.avro", _wide_records(400, 30)),
            _write_avro(tmp_path / "valid.avro", _wide_records(200, 31)))


# The elastic net runs at λ = 3 and 10, where OWL-QN's optimum is fixed to
# better than 1e-3 in float32. At λ = 1 it stops on a plateau of 700
# coefficients over 400 rows, and at λ = 30 only the intercept survives, on an
# objective so flat that its float32 resolution (~1.6e-5 of 276.5) leaves the
# intercept free by ~6e-4 (curvature ~100): both packages stop within that,
# not within the drivers' 1e-3 of each other.
_SPARSE_SOLVERS = {
    "LBFGS": ["--regularization-weights", "1,10"],
    "TRON": ["--regularization-weights", "1,10", "--optimizer", "TRON"],
    "ELASTIC_NET": ["--regularization-weights", "3,10", "--regularization-type", "ELASTIC_NET",
                    "--elastic-net-alpha", "0.5"],
    "LBFGSB": ["--regularization-weights", "1,10", "--optimizer", "LBFGSB", "--coefficient-box=-0.5,0.5"],
}


@pytest.mark.parametrize("solver", list(_SPARSE_SOLVERS))
def test_driver_matches_reference_on_a_sparse_avro_file(tmp_path, solver):
    """train_glm on a file wider than the dense limit: both packages read it
    padded-sparse and give the same λ path, text models, losses and
    validation metrics (SIMPLE variances over the sparse Hessian diagonal)."""
    train, valid = _wide_files(tmp_path)
    argv = ["--training-data", train, "--validation-data", valid, "--compute-variance", "SIMPLE"] + \
        _SPARSE_SOLVERS[solver]
    j_summary, t_summary = _run_both(tmp_path, argv)
    _assert_drivers_agree(tmp_path, j_summary, t_summary)
    nonzero = len(_text_model(tmp_path / "port" / "model-lambda-3.txt" if solver == "ELASTIC_NET"
                              else tmp_path / "port" / "model-lambda-10.txt"))
    assert (0 < nonzero < 4096) if solver == "ELASTIC_NET" else (nonzero > 4096)
    args = train_glm.build_parser().parse_args(argv + ["--output-dir", str(tmp_path / "x")])
    batch, imap = train_glm.load_data(args, train, "cpu")
    assert isinstance(batch.features, SparseFeatures) and len(imap) > 4096


@pytest.mark.parametrize("wide", [False, True], ids=["dense", "sparse"])
def test_summarization_output_is_read_by_the_other_package(tmp_path, wide):
    """``--summarization-output-dir``: both packages' part-00000.avro, each
    read with the other package's reader, hold the same features and
    statistics (the sparse file's from its entries)."""
    train, _ = _wide_files(tmp_path) if wide else (_write_avro(tmp_path / "t.avro", _avro_records(300, 7, seed=32)),
                                                   None)
    argv = ["--training-data", train, "--regularization-weights", "1"]
    j_train_glm.run(j_train_glm.build_parser().parse_args(
        argv + ["--summarization-output-dir", str(tmp_path / "jsum"), "--output-dir", str(tmp_path / "jax")]))
    train_glm.main(argv + ["--summarization-output-dir", str(tmp_path / "tsum"), "--output-dir",
                           str(tmp_path / "port"), "--device", "cpu"])
    from photon_tpu.io.avro import read_avro_records as j_read_avro
    from photon_tpu_torch.io.avro import read_avro_records

    want = read_avro_records(str(tmp_path / "jsum" / "part-00000.avro"))  # the reference's, read by the port
    got = j_read_avro(str(tmp_path / "tsum" / "part-00000.avro"))  # the port's, read by the reference
    assert len(got) == len(want) > (4096 if wide else 5)
    assert [(r["featureName"], r["featureTerm"]) for r in got] == [(r["featureName"], r["featureTerm"]) for r in want]
    for g, w in zip(got, want):
        assert list(g["metrics"]) == list(w["metrics"])
        for k, v in w["metrics"].items():
            assert g["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), (g["featureName"], k)


def test_selected_features_file_matches_reference(tmp_path):
    """``--selected-features-file`` (FeatureNameTermAvro records): both
    packages train on the listed features only, to the same text models."""
    name_term_schema = {"type": "record", "name": "FeatureNameTermAvro", "fields": [
        {"name": "name", "type": "string"}, {"name": "term", "type": ["null", "string"], "default": None}]}
    train = _write_avro(tmp_path / "train.avro", _avro_records(300, 9, seed=33))
    sel = str(tmp_path / "selected.avro")
    write_avro_records(sel, name_term_schema, [{"name": f"f{j}", "term": "t" if j % 4 == 0 else ""}
                                               for j in (0, 2, 3, 7)])
    argv = ["--training-data", train, "--regularization-weights", "1", "--selected-features-file", sel]
    j_summary, t_summary = _run_both(tmp_path, argv)
    _assert_drivers_agree(tmp_path, j_summary, t_summary)
    got = _text_model(tmp_path / "port" / "model-lambda-1.txt")
    assert set(got) <= {"f0\x01t", "f2", "f3", "f7", IndexMap.INTERCEPT} and len(got) >= 4
    with pytest.raises(ValueError, match="avro format"):
        train_glm.main(["--training-data", "x.txt", "--format", "libsvm", "--selected-features-file", sel,
                        "--output-dir", str(tmp_path / "o"), "--device", "cpu"])


def test_name_and_term_bags_match_reference_and_read_across(tmp_path):
    """``python -m photon_tpu_torch.cli.name_and_term_bags`` writes the
    reference driver's text bags, and each package reads the other's into
    the same index map."""
    from photon_tpu.cli import name_and_term_bags as j_bags
    from photon_tpu_torch.cli import name_and_term_bags as t_bags

    recs = _avro_records(80, 9, seed=34, bags=("features", "extra"))
    schema = dict(TRAINING_EXAMPLE_SCHEMA)
    schema["fields"] = TRAINING_EXAMPLE_SCHEMA["fields"] + [
        {"name": "extra", "type": {"type": "array", "items": TRAINING_EXAMPLE_SCHEMA["fields"][2]["type"]["items"]}}]
    data = tmp_path / "in"
    data.mkdir()
    write_avro_records(str(data / "part-0.avro"), schema, recs)
    argv = ["--input-data-directories", str(data / "part-0.avro"), "--feature-bags-keys", "features", "extra"]
    want = j_bags.run(j_bags.build_parser().parse_args(argv + ["--root-output-directory", str(tmp_path / "j")]))
    out = subprocess.run([sys.executable, "-m", "photon_tpu_torch.cli.name_and_term_bags", *argv,
                          "--root-output-directory", str(tmp_path / "t")], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [f"{bag}: {n} distinct name-and-term features" for bag, n in want.items()]
    for bag in ("features", "extra"):
        assert (tmp_path / "t" / bag / "part-00000").read_text() == (tmp_path / "j" / bag / "part-00000").read_text()
        assert t_bags.load_name_and_terms(str(tmp_path / "j"), bag) == j_bags.load_name_and_terms(
            str(tmp_path / "t"), bag)
    tmap = t_bags.index_map_from_text_bags(str(tmp_path / "j"), ["features", "extra"])
    jmap = j_bags.index_map_from_text_bags(str(tmp_path / "t"), ["features", "extra"])
    assert list(tmap.items()) == list(jmap.items())
