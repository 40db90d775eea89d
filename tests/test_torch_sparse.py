"""The port's sparse wide fixed effect against the JAX package on the CPU:
``SparseFeatures`` (both rmatvec lowerings, to_dense, from_rows, bf16
values), the sparse objective, the solvers and the λ sweep over it, the
solve cache's counters, padding, validation, statistics, scoring, the
reader above ``dense_dim_limit``, the projected sparse random effect, and a
GAME fit with sparse shards.

Float64 under jax's scoped x64 context, coefficients and values at rtol
1e-5 with equal iteration counts and reasons; integer and structural
outputs (triples, plans, blocks) equal exactly.
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from photon_tpu.algorithm.random_effect import RandomEffectCoordinate as JCoord
from photon_tpu.algorithm.solve_cache import SolveCache as JSolveCache
from photon_tpu.data import random_effect as jre
from photon_tpu.data.batch import LabeledBatch as JBatch
from photon_tpu.data.batch import SparseFeatures as JSparse
from photon_tpu.data.game_data import GameBatch as JGameBatch
from photon_tpu.data.normalization import NormalizationContext as JNorm
from photon_tpu.data.padding import pad_feature_matrix as j_pad
from photon_tpu.data.stats import compute_feature_stats as j_stats
from photon_tpu.data.validators import DataValidationError as JValidationError
from photon_tpu.data.validators import validate_labeled_batch as j_validate
from photon_tpu.estimators import config as jconfig
from photon_tpu.estimators.game_estimator import GameEstimator as JEstimator
from photon_tpu.models.coefficients import Coefficients as JCoefficients
from photon_tpu.models.game import RandomEffectModel as JREModel
from photon_tpu.ops.losses import LogisticLoss as JLogistic
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.optim.common import OptimizerConfig as JConfig
from photon_tpu.optim.factory import OptimizerSpec as JSpec
from photon_tpu.optim.factory import make_optimizer as j_make_optimizer
from photon_tpu.optim.margin_lbfgs import minimize_lbfgs_margin as j_margin
from photon_tpu.optim.margin_lbfgs import sweep_l2_lbfgs_margin as j_sweep
from photon_tpu.types import OptimizerType as JOptType
from photon_tpu.types import TaskType as JTask

from photon_tpu_torch import interop
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_tpu_torch.algorithm.solve_cache import SolveCache
from photon_tpu_torch.data import random_effect as tre
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures, default_transpose_plan, matvec, rmatvec
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.data.padding import pad_feature_matrix
from photon_tpu_torch.data.stats import compute_feature_stats
from photon_tpu_torch.data.validators import DataValidationError, validate_labeled_batch
from photon_tpu_torch.estimators import config as tconfig
from photon_tpu_torch.estimators.game_estimator import GameEstimator
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import ProjectedRandomEffectModel, RandomEffectModel
from photon_tpu_torch.ops.losses import LogisticLoss
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import HOST_READS, OptimizerConfig
from photon_tpu_torch.optim.factory import OptimizerSpec, make_optimizer
from photon_tpu_torch.optim.margin_lbfgs import minimize_lbfgs_margin, sweep_l2_lbfgs_margin
from photon_tpu_torch.optim.newton import minimize_newton
from photon_tpu_torch.types import OptimizerType, TaskType

REPO = Path(__file__).resolve().parent.parent
RTOL64 = 1e-5
LOWERINGS = [False, True]
LOWERING_IDS = ["scatter", "segsum"]


def _close(got, want, rtol=RTOL64):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-9 * max(1.0, float(np.abs(want).max())))


def _triples(n=240, d=400, k=7, seed=0):
    """(indices, values, y, weight, offset): column 0 the intercept (slot 0,
    value 1), a repeated column in some rows and zero-valued padding slots
    at index 0 in others, float64."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, d, size=(n, k)).astype(np.int32)
    vals = rng.normal(size=(n, k))
    idx[:, 0], vals[:, 0] = 0, 1.0
    idx[::7, 2] = idx[::7, 1]  # a column twice in a row: the entries add up
    idx[::5, -1], vals[::5, -1] = 0, 0.0  # padding slots
    w_true = rng.normal(size=d) * 0.5
    z = np.sum(vals * w_true[idx], axis=1)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return idx, vals, y, rng.uniform(0.5, 1.5, size=n), rng.normal(size=n) * 0.1


def _pair(idx, vals, d, plan):
    """The same matrix in both packages (the reference's made under x64)."""
    with jax.enable_x64(True):
        ref = JSparse(jnp.asarray(idx), jnp.asarray(vals), d)
        ref = ref.with_transpose_plan() if plan else ref
    port = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals), d)
    return (port.with_transpose_plan() if plan else port), ref


@pytest.mark.parametrize("plan", LOWERINGS, ids=LOWERING_IDS)
def test_matvec_and_rmatvec_match_reference(plan):
    idx, vals, *_ = _triples()
    d = 400
    rng = np.random.default_rng(1)
    w, r = rng.normal(size=d), rng.normal(size=idx.shape[0])
    with jax.enable_x64(True):
        port, ref = _pair(idx, vals, d, plan)
        want_mv, want_rmv = np.asarray(ref.matvec(jnp.asarray(w))), np.asarray(ref.rmatvec(jnp.asarray(r)))
        if plan:
            np.testing.assert_array_equal(port.csc_order.numpy(), np.asarray(ref.csc_order))
            np.testing.assert_array_equal(port.csc_segments.numpy(), np.asarray(ref.csc_segments))
    _close(port.matvec(torch.from_numpy(w)), want_mv)
    _close(port.rmatvec(torch.from_numpy(r)), want_rmv)
    assert port.has_plan == plan and port.shape == (idx.shape[0], d)
    # Lanes: one product a lane, through the free functions GLMTerms calls.
    W, R = torch.from_numpy(rng.normal(size=(3, d))), torch.from_numpy(rng.normal(size=(3, idx.shape[0])))
    assert torch.equal(matvec(port, W), torch.stack([port.matvec(v) for v in W]))
    assert torch.equal(rmatvec(port, R), torch.stack([port.rmatvec(v) for v in R]))
    # The dense matrix's lanes, one product for all of them.
    Xd = port.to_dense()
    _close(matvec(Xd, W), torch.stack([Xd @ v for v in W]))
    _close(rmatvec(Xd, R), torch.stack([Xd.T @ v for v in R]))


def test_to_dense_and_from_rows_match_reference():
    rows = [([0, 5, 5], [1.0, 2.0, -0.5]), ([0], [1.0]), ([0, 3, 9, 1], [1.0, 0.25, -1.5, 4.0]), ([], [])]
    with jax.enable_x64(True):
        ref = JSparse.from_rows(rows, 10, dtype=np.float64)
        want = [np.asarray(a) for a in (ref.indices, ref.values, ref.to_dense())]
    port = SparseFeatures.from_rows(rows, 10, dtype=np.float64, device="cpu")
    np.testing.assert_array_equal(port.indices.numpy(), want[0])
    np.testing.assert_array_equal(port.values.numpy(), want[1])
    np.testing.assert_array_equal(port.to_dense().numpy(), want[2])
    assert port.to_dense()[0, 5] == 1.5  # a repeated column adds up
    idx, vals, *_ = _triples(n=30, d=50, k=4, seed=2)
    with jax.enable_x64(True):
        dense = np.asarray(JSparse(jnp.asarray(idx), jnp.asarray(vals), 50).to_dense())
    np.testing.assert_array_equal(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals), 50).to_dense().numpy(),
                                  dense)


@pytest.mark.parametrize("plan", LOWERINGS, ids=LOWERING_IDS)
def test_bf16_values_accumulate_gradient_in_f32(plan):
    """bf16-stored values give an f32 gradient summed at f32, on both
    lowerings (tests/test_objective.py's bf16 case): the f32 sums of the
    bf16-rounded values, within f32 rounding, and the reference's."""
    rng = np.random.default_rng(3)
    n, d, k = 256, 64, 16
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    r = rng.normal(size=n).astype(np.float32)
    bf = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals).to(torch.bfloat16), d)
    rounded = SparseFeatures(torch.from_numpy(idx), bf.values.float(), d)
    if plan:
        bf, rounded = bf.with_transpose_plan(), rounded.with_transpose_plan()
    g = bf.rmatvec(torch.from_numpy(r))
    assert g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), rounded.rmatvec(torch.from_numpy(r)).numpy(), rtol=1e-6, atol=1e-5)
    ref = JSparse(jnp.asarray(idx), jnp.asarray(vals.astype(ml_dtypes.bfloat16)), d)
    ref = ref.with_transpose_plan() if plan else ref
    np.testing.assert_allclose(g.numpy(), np.asarray(ref.rmatvec(jnp.asarray(r))), rtol=1e-5, atol=1e-5)
    g32 = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals), d).rmatvec(torch.from_numpy(r))
    np.testing.assert_allclose(g.numpy(), g32.numpy(), rtol=3e-2, atol=3e-2)
    m = bf.matvec(torch.from_numpy(rng.normal(size=d).astype(np.float32)))
    assert m.dtype == torch.float32


def _norms(kind, d, rng):
    """(port, reference) normalization contexts: None, scale factors, or
    factors with shifts (standardization, the intercept untouched)."""
    if kind == "none":
        return None, None
    f = rng.uniform(0.5, 2.0, size=d)
    s = rng.normal(size=d) * 0.1 if kind == "standardize" else None
    f[0] = 1.0
    if s is not None:
        s[0] = 0.0
    port = NormalizationContext(torch.from_numpy(f), None if s is None else torch.from_numpy(s), 0)
    with jax.enable_x64(True):
        ref = JNorm(jnp.asarray(f), None if s is None else jnp.asarray(s), 0)
    return port, ref


@pytest.mark.parametrize("plan", LOWERINGS, ids=LOWERING_IDS)
@pytest.mark.parametrize("norm", ["none", "scale", "standardize"])
def test_sparse_objective_matches_reference(norm, plan):
    """Value, gradient, Hessian-vector product, Hessian diagonal and matrix
    over sparse features (the diagonal scattered, or densified under shifts;
    the matrix densified) against the reference's, and against the port's
    own dense batch of the same matrix."""
    idx, vals, y, wt, off = _triples(n=160, d=60, k=6, seed=4)
    d = 60
    rng = np.random.default_rng(5)
    w, v = rng.normal(size=d) * 0.3, rng.normal(size=d)
    tnorm, jnorm = _norms(norm, d, rng)
    port, ref = _pair(idx, vals, d, plan)
    tb = LabeledBatch(torch.from_numpy(y), port, torch.from_numpy(off), torch.from_numpy(wt))
    dense = LabeledBatch(torch.from_numpy(y), port.to_dense(), torch.from_numpy(off), torch.from_numpy(wt))
    obj = GLMObjective(LogisticLoss, l2_weight=0.7, intercept_index=0, normalization=tnorm, use_fused=True)
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    got = [*obj.value_and_grad(tw, tb), obj.hvp(tw, tv, tb), obj.hessian_diagonal(tw, tb), obj.hessian_matrix(tw, tb)]
    with jax.enable_x64(True):
        jb = JBatch(jnp.asarray(y), ref, jnp.asarray(off), jnp.asarray(wt))
        jo = JObjective(loss=JLogistic, l2_weight=0.7, intercept_index=0, normalization=jnorm)
        jw, jv = jnp.asarray(w), jnp.asarray(v)
        want = [np.asarray(a) for a in (*jo.value_and_grad(jw, jb), jo.hvp(jw, jv, jb), jo.hessian_diagonal(jw, jb),
                                        jo.hessian_matrix(jw, jb))]
    if norm == "standardize":
        # The reference's densified sparse diagonal leaves out λ (ROADMAP
        # queue 3); the port adds it, as both packages' dense paths do.
        want[3] = want[3] + 0.7 * (np.arange(d) != 0)
    for a, b in zip(got, want):
        _close(a, b)
    assert not obj._can_fuse(tb)  # the fused kernels never take a sparse batch
    # The dense batch's diagonal only where no column repeats in a row: the
    # reference scatters values² entry by entry, Σv² where the dense matrix
    # has (Σv)² (ROADMAP queue 3), and the port keeps its numbers.
    on_dense = [*obj.value_and_grad(tw, dense), obj.hvp(tw, tv, dense), obj.hessian_matrix(tw, dense)]
    for a, b in zip(got[:3] + got[4:], on_dense):
        _close(a, b.numpy())
    repeated = {int(c) for row in idx for c, m in zip(*np.unique(row, return_counts=True)) if m > 1}
    clean = np.array(sorted(set(range(d)) - repeated))
    assert 0 < len(repeated) and len(clean) > d // 2
    _close(got[3][clean], obj.hessian_diagonal(tw, dense)[clean].numpy())


_ROUTES = {
    # name: (optimizer, l2, l1, box)
    "margin_lbfgs": (JOptType.LBFGS, 1.0, 0.0, None),
    "tron": (JOptType.TRON, 1.0, 0.0, None),
    "owlqn_elastic_net": (JOptType.LBFGS, 0.5, 3.0, None),
    "lbfgsb": (JOptType.LBFGSB, 1.0, 0.0, 0.3),
    "lbfgs_box": (JOptType.LBFGS, 1.0, 0.0, 0.3),
}


@pytest.mark.parametrize("plan", LOWERINGS, ids=LOWERING_IDS)
@pytest.mark.parametrize("route", list(_ROUTES))
def test_sparse_solvers_match_reference(route, plan):
    """``make_optimizer`` on a sparse batch takes the reference's route
    (margin L-BFGS, TRON, OWL-QN, L-BFGS-B, gradient-form L-BFGS with a
    box) to the reference's result: coefficients and value at rtol 1e-5,
    equal iterations, reason and evaluations."""
    opt, l2, l1, box = _ROUTES[route]
    idx, vals, y, wt, off = _triples(seed=6)
    d = 400
    port, ref = _pair(idx, vals, d, plan)
    cfg = dict(max_iter=40, tol=1e-9)
    with jax.enable_x64(True):
        jbox = None if box is None else (-box * jnp.ones(d), box * jnp.ones(d))
        want = j_make_optimizer(JObjective(loss=JLogistic, l2_weight=l2, l1_weight=l1, intercept_index=0),
                                JSpec(JOptType(opt.value), box=jbox, **cfg))(
            jnp.zeros(d), JBatch(jnp.asarray(y), ref, jnp.asarray(off), jnp.asarray(wt)))
        want = {k: np.asarray(getattr(want, k)) for k in ("w", "value", "iterations", "reason_code", "evals")}
    ones = torch.ones(d, dtype=torch.float64)
    tbox = None if box is None else (-box * ones, box * ones)
    got = make_optimizer(GLMObjective(LogisticLoss, l2_weight=l2, l1_weight=l1, intercept_index=0),
                         OptimizerSpec(OptimizerType(opt.value), box=tbox, **cfg))(
        torch.zeros(d, dtype=torch.float64),
        LabeledBatch(torch.from_numpy(y), port, torch.from_numpy(off), torch.from_numpy(wt)))
    _close(got.w, want["w"])
    _close(got.value, want["value"])
    assert (int(got.iterations), int(got.reason_code), int(got.evals)) == (
        int(want["iterations"]), int(want["reason_code"]), int(want["evals"]))
    assert int(got.iterations) > 3
    if box is not None:
        assert float(got.w.abs().max()) <= box + 1e-12


@pytest.mark.parametrize("plan", LOWERINGS, ids=LOWERING_IDS)
def test_sweep_matches_reference(plan):
    """``sweep_l2_lbfgs_margin`` over a sparse batch: each lane the
    reference's vmapped lane (rtol 1e-5, equal iterations)."""
    idx, vals, y, wt, off = _triples(seed=7)
    d = 400
    lams = [0.1, 1.0, 10.0, 100.0]
    port, ref = _pair(idx, vals, d, plan)
    cfg = dict(max_iter=40, tol=1e-9, track_history=False)
    with jax.enable_x64(True):
        want = j_sweep(JObjective(loss=JLogistic, intercept_index=0),
                       JBatch(jnp.asarray(y), ref, jnp.asarray(off), jnp.asarray(wt)), jnp.zeros((4, d)),
                       jnp.asarray(lams), JConfig(**cfg))
        want_w, want_it, want_v = np.asarray(want.w), np.asarray(want.iterations), np.asarray(want.value)
    got = sweep_l2_lbfgs_margin(GLMObjective(LogisticLoss, intercept_index=0, use_fused=True),
                                LabeledBatch(torch.from_numpy(y), port, torch.from_numpy(off), torch.from_numpy(wt)),
                                torch.zeros(4, d, dtype=torch.float64), lams, OptimizerConfig(**cfg))
    assert got.w.shape == (4, d)
    _close(got.w, want_w)
    _close(got.value, want_v)
    np.testing.assert_array_equal(got.iterations.numpy(), want_it)
    assert len(set(want_it.tolist())) > 1


def test_sweep_lanes_equal_single_solves():
    """One swept program == k independent solves (tests/test_margin_lbfgs.py's
    sweep case), on a dense batch: the lanes' direction passes are one X·P."""
    rng = np.random.default_rng(21)
    n, d = 256, 8
    X = rng.normal(size=(n, d))
    X[:, 0] = 1.0
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-X @ rng.normal(size=d)))).astype(np.float64)
    batch = LabeledBatch(torch.from_numpy(y), torch.from_numpy(X))
    obj = GLMObjective(LogisticLoss, intercept_index=0)
    cfg = OptimizerConfig(max_iter=50, track_history=False)
    lams = [0.1, 1.0, 10.0, 100.0]
    res = sweep_l2_lbfgs_margin(obj, batch, torch.zeros(4, d, dtype=torch.float64), lams, cfg)
    for i, lam in enumerate(lams):
        one = minimize_lbfgs_margin(obj.with_l2(lam), batch, torch.zeros(d, dtype=torch.float64), cfg)
        _close(res.w[i], one.w.numpy())
        assert int(res.iterations[i]) == int(one.iterations)
    norms = torch.linalg.norm(res.w, dim=1)
    assert float(norms[0]) > float(norms[-1])
    with jax.enable_x64(True):
        want = j_sweep(JObjective(loss=JLogistic, intercept_index=0), JBatch(jnp.asarray(y), jnp.asarray(X)),
                       jnp.zeros((4, d)), jnp.asarray(lams), JConfig(max_iter=50, track_history=False))
        _close(res.w, np.asarray(want.w))


def test_minimize_newton_refuses_sparse():
    idx, vals, y, *_ = _triples(n=20, d=30, k=3)
    sf = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals), 30)
    with pytest.raises(ValueError, match="dense features"):
        minimize_newton(GLMObjective(LogisticLoss), LabeledBatch(torch.from_numpy(y), sf),
                        torch.zeros(1, 30, dtype=torch.float64))


@pytest.mark.parametrize("route", ["margin_lbfgs", "tron", "owlqn_elastic_net"])
def test_solve_cache_counts_a_sparse_solve_like_a_dense_one(route):
    """Through ``SolveCache.fe_solver``: a λ sweep over one sparse batch
    captures one program and keys one entry a λ, as over a dense batch;
    the same batch again hits; the results are the eager ones bit for bit
    and the reference's cache's at rtol 1e-5 (its trace keys equal)."""
    opt, l2, l1, _ = _ROUTES[route]
    idx, vals, y, wt, off = _triples(seed=8)
    d = 400
    port, ref = _pair(idx, vals, d, True)
    lams = [10.0, 1.0]
    out = {}
    for name, X in (("sparse", port), ("dense", port.to_dense())):
        cache = SolveCache()
        tb = LabeledBatch(torch.from_numpy(y), X, torch.from_numpy(off), torch.from_numpy(wt))
        spec = OptimizerSpec(OptimizerType(opt.value), max_iter=30, tol=1e-9)
        res = []
        for lam in lams + lams:
            obj = GLMObjective(LogisticLoss, l2_weight=l2 * lam, l1_weight=l1 * lam, intercept_index=0)
            res.append(cache.fe_solver(obj, spec)(torch.zeros(d, dtype=torch.float64), tb))
            if len(res) <= len(lams):
                eager = make_optimizer(obj, spec)(torch.zeros(d, dtype=torch.float64), tb)
                assert torch.equal(res[-1].w, eager.w) and int(res[-1].iterations) == int(eager.iterations)
        out[name] = (dict(cache.stats.counts()), [tuple(k) for k in cache.stats.trace_keys], res)
    counts, keys, res = out["sparse"]
    assert counts["captures"] == out["dense"][0]["captures"] == 1
    assert counts["traces"] == out["dense"][0]["traces"] == len(lams)
    assert counts["hits"] == counts["calls"] - counts["traces"] == len(lams)
    assert keys == out["dense"][1] == [("fe", d)] * len(lams)
    for a, b in zip(res, out["dense"][2]):
        _close(a.w, b.w.numpy())
    jcache = JSolveCache()
    with jax.enable_x64(True):
        jb = JBatch(jnp.asarray(y), ref, jnp.asarray(off), jnp.asarray(wt))
        for lam, got in zip(lams, res):
            jo = JObjective(loss=JLogistic, l2_weight=l2 * lam, l1_weight=l1 * lam, intercept_index=0)
            want = jcache.fe_solver(jo, JSpec(JOptType(opt.value), max_iter=30, tol=1e-9))(jnp.zeros(d), jb)
            _close(got.w, np.asarray(want.w))
            assert int(got.iterations) == int(want.iterations)
    assert keys == [tuple(k) for k in jcache.stats.trace_keys]


def test_a_sparse_solve_keys_on_its_tensors():
    """A new plan (or new values) of the same shapes is a new key: the
    entry reads X's tensors in place, so it must not serve another X."""
    idx, vals, y, wt, off = _triples(seed=9)
    d = 400
    a = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals), d)
    b = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals * 2.0), d)
    cache = SolveCache()
    solve = cache.fe_solver(GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=0), OptimizerSpec(max_iter=10))
    ra = solve(torch.zeros(d, dtype=torch.float64), LabeledBatch(torch.from_numpy(y), a))
    rb = solve(torch.zeros(d, dtype=torch.float64), LabeledBatch(torch.from_numpy(y), b))
    solve(torch.zeros(d, dtype=torch.float64), LabeledBatch(torch.from_numpy(y), a.with_transpose_plan()))
    assert cache.stats.traces == 3 and not torch.equal(ra.w, rb.w)


@pytest.mark.parametrize("plan", LOWERINGS, ids=LOWERING_IDS)
@pytest.mark.parametrize("pad", [0, 3])
def test_padding_buckets_the_sparse_width_like_reference(pad, plan):
    idx, vals, *_ = _triples(n=12, d=40, k=5, seed=10)
    port, ref = _pair(idx, vals, 40, plan)
    got = pad_feature_matrix(port, pad)
    with jax.enable_x64(True):
        want = j_pad(JSparse(np.asarray(ref.indices), np.asarray(ref.values), 40,
                             *(None if a is None else np.asarray(a) for a in (ref.csc_order, ref.csc_segments))),
                     pad)
    assert got.indices.shape == (12 + pad, 8)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.has_plan == plan
    if plan:
        np.testing.assert_array_equal(got.csc_order.numpy(), np.asarray(want.csc_order))
    r = torch.from_numpy(np.random.default_rng(0).normal(size=12 + pad))
    _close(got.rmatvec(r), SparseFeatures(got.indices, got.values, 40).rmatvec(r).numpy())
    bucketed = pad_feature_matrix(got, 0)
    assert bucketed is got


@pytest.mark.parametrize("bad", ["ok", "nan_value", "inf_value"])
def test_validators_check_sparse_values_like_reference(bad):
    idx, vals, y, wt, off = _triples(n=30, d=50, k=4, seed=11)
    if bad != "ok":
        vals[7, 2] = np.nan if bad == "nan_value" else np.inf
    port, ref = _pair(idx, vals, 50, False)
    want = None
    try:
        j_validate(JBatch(jnp.asarray(y), ref, jnp.asarray(off), jnp.asarray(wt)), JTask.LOGISTIC_REGRESSION)
    except JValidationError as e:
        want = str(e)
    got = None
    try:
        validate_labeled_batch(LabeledBatch(torch.from_numpy(y), port, torch.from_numpy(off), torch.from_numpy(wt)),
                               TaskType.LOGISTIC_REGRESSION)
    except DataValidationError as e:
        got = str(e)
    assert got == want and (got is None) == (bad == "ok")


def test_feature_stats_of_a_sparse_batch_match_reference():
    """From the entries, the implicit zeros counted: the reference's
    statistics of ``to_dense``, with padding rows (weight 0) excluded, a
    repeated column summed, negative-only and never-seen columns."""
    idx, vals, y, wt, off = _triples(n=90, d=35, k=5, seed=12)
    wt[::9] = 0.0
    idx[:, 1], idx[1::2, 3] = 37, 38  # 37 in every row, 38 in odd rows
    vals[:, 1], vals[:, 3] = -np.abs(vals[:, 1]) - 0.1, -np.abs(vals[:, 3]) - 0.1  # both negative
    port, ref = _pair(idx, vals, 40, False)  # columns 35, 36 and 39 never seen
    got = compute_feature_stats(LabeledBatch(torch.from_numpy(y), port, weight=torch.from_numpy(wt)), 0)
    with jax.enable_x64(True):
        want = j_stats(JBatch(jnp.asarray(y), ref, None, jnp.asarray(wt)), 0)
    for f in ("count", "mean", "variance", "min", "max", "norm_l1", "norm_l2"):
        _close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.num_nonzeros.numpy(), np.asarray(want.num_nonzeros))
    assert float(got.max[37]) < 0.0 and float(got.max[38]) == 0.0 > float(got.min[38])


def test_scoring_sparse_features_matches_reference():
    """A fixed effect, a dense random effect and a projected random effect
    scored on sparse features: the reference's scores (projected through
    its inverse maps, absent columns 0, unseen entities 0)."""
    eids, idx, vals, y, wt = _wide_problem(seed=13)
    rng = np.random.default_rng(14)
    w = rng.normal(size=D_WIDE)
    W = rng.normal(size=(E_WIDE, D_WIDE))
    ids = eids.copy()
    ids[::11] = -1
    port, ref = _pair(idx, vals, D_WIDE, False)
    with jax.enable_x64(True):
        want_fe = np.asarray(JCoefficients(jnp.asarray(w)).compute_score(ref))
        jb = JGameBatch(label=jnp.asarray(y), offset=jnp.zeros(N_WIDE), weight=jnp.asarray(wt),
                        features={"wide": ref}, entity_ids={"userId": jnp.asarray(ids)})
        want_re = np.asarray(JREModel(jnp.asarray(W), "userId", "wide", JTask.LOGISTIC_REGRESSION).score(jb))
        jds = jre.build_random_effect_dataset(eids, (idx, vals, D_WIDE), y, wt, E_WIDE, _wide_cfg(jre))
        jcoord = JCoord("perUser", jds, JTask.LOGISTIC_REGRESSION, JObjective(loss=JLogistic, l2_weight=1.0,
                                                                               intercept_index=0))
        jmodel, _ = jcoord.train(jb, initial_model=_ref_zero_model(jds))
        want_proj = np.asarray(jmodel.score(jb))
        proj = interop.game_model(type("G", (), {"models": {"perUser": jmodel}})(), device="cpu").models["perUser"]
    tb = GameBatch(torch.from_numpy(y), torch.zeros(N_WIDE, dtype=torch.float64), torch.from_numpy(wt),
                   {"wide": port}, {"userId": torch.from_numpy(ids)})
    _close(Coefficients(torch.from_numpy(w)).compute_score(port), want_fe)
    _close(RandomEffectModel(torch.from_numpy(W), "userId", "wide", TaskType.LOGISTIC_REGRESSION).score(tb), want_re)
    assert isinstance(proj, ProjectedRandomEffectModel)
    _close(proj.score(tb), want_proj)
    assert float(proj.score(tb)[0]) == 0.0 and float(torch.abs(proj.score(tb)).sum()) > 0


# --- the projected sparse random effect (tests/test_subspace_projection.py's fixtures) ---

D_WIDE, K_WIDE, E_WIDE, N_WIDE = 500, 4, 24, 360


def _wide_problem(seed=0, window=12):
    """Each entity touches a small random set of columns (a ``window`` of
    them) of a wide shard (tests/test_subspace_projection.py::_wide_problem),
    float64."""
    rng = np.random.default_rng(seed)
    eids = (np.arange(N_WIDE) % E_WIDE).astype(np.int32)
    base = rng.integers(0, D_WIDE - window, size=E_WIDE)
    indices = np.zeros((N_WIDE, K_WIDE), np.int32)
    values = np.zeros((N_WIDE, K_WIDE))
    for i in range(N_WIDE):
        indices[i, :K_WIDE - 1] = base[eids[i]] + rng.choice(window, size=K_WIDE - 1, replace=False)
        values[i, :K_WIDE - 1] = rng.normal(size=K_WIDE - 1)
        indices[i, K_WIDE - 1], values[i, K_WIDE - 1] = 0, 1.0
    logits = rng.normal(size=E_WIDE)[eids] * 1.5
    y = (rng.uniform(size=N_WIDE) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    return eids, indices, values, y, np.ones(N_WIDE)


def _wide_cfg(pkg, **kw):
    return pkg.RandomEffectDataConfig(re_type="userId", feature_shard="wide", n_buckets=2, **kw)


def _ref_zero_model(jds):
    """A float64 zero warm start of the reference's projected coordinate
    (ROADMAP queue 3: it starts from float32 zeros otherwise)."""
    from photon_tpu.models.game import ProjectedRandomEffectModel as JProj

    eb, er, inv = jds.projection_tables()
    return JProj([jnp.zeros((b.num_entities, b.dim)) for b in jds.blocks], [b.col_map for b in jds.blocks], inv,
                 eb, er, jds.dim, "userId", "wide", JTask.LOGISTIC_REGRESSION)


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_blocks_match_reference(seed):
    """Host triples build the reference's projected blocks exactly: column
    maps (the union of the block's nonzero columns) and the scattered rows."""
    eids, idx, vals, y, wt = _wide_problem(seed)
    idx[5, 1] = idx[5, 0]  # a repeated column adds up in the block
    ds = tre.build_random_effect_dataset(eids, (idx, vals, D_WIDE), y, wt, E_WIDE, _wide_cfg(tre), device="cpu")
    with jax.enable_x64(True):
        jds = jre.build_random_effect_dataset(eids, (idx, vals, D_WIDE), y, wt, E_WIDE, _wide_cfg(jre))
    assert ds.projected and ds.dim == D_WIDE and len(ds.blocks) == len(jds.blocks)
    for b, jb in zip(ds.blocks, jds.blocks):
        for f in ("entity_idx", "features", "label", "weight", "sample_index", "train_mask", "col_map"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
        assert b.dim < D_WIDE // 2
    with pytest.raises(ValueError, match="requires subspace projection"):
        tre.build_random_effect_dataset(eids, (idx, vals, D_WIDE), y, wt, E_WIDE,
                                        _wide_cfg(tre, subspace_projection=False), device="cpu")


@pytest.mark.parametrize("window", [5, 12], ids=["newton", "margin_lbfgs"])
def test_projected_sparse_training_matches_reference_and_dense(window):
    """The projected sparse coordinate (Newton on a block of d <= 128, the
    K3 route on the card; margin L-BFGS on a wider one): the reference's
    coefficients, scores and iterations at rtol 1e-5, the dense-input
    coordinate's, and warm starts from either model form
    (tests/test_subspace_projection.py's cases)."""
    eids, idx, vals, y, wt = _wide_problem(seed=1, window=window)
    obj = dict(l2_weight=1.0, intercept_index=0)
    ds = tre.build_random_effect_dataset(eids, (idx, vals, D_WIDE), y, wt, E_WIDE, _wide_cfg(tre), device="cpu")
    dense_np = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals), D_WIDE).to_dense().numpy()
    ds_dn = tre.build_random_effect_dataset(eids, dense_np, y, wt, E_WIDE, _wide_cfg(tre), device="cpu")
    sf = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals), D_WIDE)
    tb = GameBatch(torch.from_numpy(y), torch.zeros(N_WIDE, dtype=torch.float64), torch.from_numpy(wt),
                   {"wide": sf}, {"userId": torch.from_numpy(eids)})
    tb_dn = dataclasses.replace(tb, features={"wide": torch.from_numpy(dense_np)})
    # Two routes (projected and dense-input) agree where both converge.
    mk = lambda d: RandomEffectCoordinate("perUser", d, TaskType.LOGISTIC_REGRESSION,  # noqa: E731
                                          GLMObjective(loss=LogisticLoss, **obj),
                                          optimizer_spec=OptimizerSpec(max_iter=200, tol=1e-12))
    coord = mk(ds)
    model, stats = coord.train(tb)
    model_dn, _ = mk(ds_dn).train(tb_dn)
    assert isinstance(model, ProjectedRandomEffectModel)
    assert all((b.dim <= 128) == (window == 5) for b in ds.blocks)
    np.testing.assert_allclose(model.to_dense().coefficients.numpy(), model_dn.coefficients.numpy(),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(model.score(tb).numpy(), model_dn.score(tb_dn).numpy(), rtol=2e-3, atol=2e-4)
    assert stats.num_entities == E_WIDE
    with jax.enable_x64(True):
        jds = jre.build_random_effect_dataset(eids, (idx, vals, D_WIDE), y, wt, E_WIDE, _wide_cfg(jre))
        jb = JGameBatch(label=jnp.asarray(y), offset=jnp.zeros(N_WIDE), weight=jnp.asarray(wt),
                        features={"wide": JSparse(jnp.asarray(idx), jnp.asarray(vals), D_WIDE)},
                        entity_ids={"userId": jnp.asarray(eids)})
        jm, jstats = JCoord("perUser", jds, JTask.LOGISTIC_REGRESSION, JObjective(loss=JLogistic, **obj),
                            optimizer_spec=JSpec(max_iter=200, tol=1e-12),
                            solve_cache=JSolveCache(donate=False)).train(jb, initial_model=_ref_zero_model(jds))
        want, want_scores = np.asarray(jm.to_dense().coefficients), np.asarray(jm.score(jb))
        want_iters = np.asarray(jstats.iterations)
    _close(model.to_dense().coefficients, want)
    _close(model.score(tb), want_scores)
    np.testing.assert_array_equal(stats.iterations.numpy(), want_iters)
    assert float(torch.sum(torch.abs(coord.zero_model().score(tb)))) == 0.0
    m2, _ = coord.train(tb, initial_model=model)
    m3, _ = coord.train(tb, initial_model=model.to_dense())
    np.testing.assert_allclose(m2.to_dense().coefficients.numpy(), m3.to_dense().coefficients.numpy(),
                               rtol=1e-3, atol=1e-4)


# --- the slice as a whole: GAME with sparse shards ---


def _sparse_game(seed=15):
    """A wide sparse global shard (intercept at 0) and the wide per-user
    shard of ``_wide_problem`` over the same rows."""
    eids, uidx, uvals, _, wt = _wide_problem(seed)
    gidx, gvals, *_ = _triples(n=N_WIDE, d=600, k=6, seed=seed)
    rng = np.random.default_rng(seed)
    z = np.sum(gvals * rng.normal(size=600)[gidx], axis=1) * 0.5 + rng.normal(size=E_WIDE)[eids]
    y = (rng.uniform(size=N_WIDE) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return eids, (gidx, gvals, 600), (uidx, uvals, D_WIDE), y, wt


@pytest.mark.parametrize("plan", LOWERINGS, ids=LOWERING_IDS)
def test_game_fit_with_sparse_shards_matches_reference(plan):
    """``GameEstimator.fit`` with a sparse global shard (margin L-BFGS
    through the solve cache) and a sparse per-user shard (projected blocks,
    batched Newton), two passes, against the reference's fit: the model's
    scores at rtol 1e-5."""
    eids, g, u, y, wt = _sparse_game()
    tsp = lambda t: SparseFeatures(torch.from_numpy(t[0]), torch.from_numpy(t[1]), t[2])  # noqa: E731
    gs, us = tsp(g), tsp(u)
    if plan:
        gs = gs.with_transpose_plan()
    tb = GameBatch(torch.from_numpy(y), torch.zeros(N_WIDE, dtype=torch.float64), torch.from_numpy(wt),
                   {"global": gs, "wide": us}, {"userId": torch.from_numpy(eids)})

    def configs(pkg):
        return [pkg.FixedEffectCoordinateConfig("global", "global", max_iter=40),
                pkg.RandomEffectCoordinateConfig("perUser", "userId", "wide", max_iter=20)]

    reg = lambda pkg: pkg.GameOptimizationConfig({"global": pkg.RegularizationConfig(1.0),  # noqa: E731
                                                  "perUser": pkg.RegularizationConfig(1.0)})
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, configs(tconfig), num_iterations=2,
                        intercept_indices={"global": 0, "wide": 0}, num_entities={"userId": E_WIDE})
    (res,) = est.fit(tb, optimization_configs=[reg(tconfig)])
    assert isinstance(res.model.models["perUser"], ProjectedRandomEffectModel)
    with jax.enable_x64(True):
        jsp = lambda t: JSparse(jnp.asarray(t[0]), jnp.asarray(t[1]), t[2])  # noqa: E731
        jg = jsp(g).with_transpose_plan() if plan else jsp(g)
        jb = JGameBatch(label=jnp.asarray(y), offset=jnp.zeros(N_WIDE), weight=jnp.asarray(wt),
                        features={"global": jg, "wide": jsp(u)}, entity_ids={"userId": jnp.asarray(eids)})
        jest = JEstimator(JTask.LOGISTIC_REGRESSION, configs(jconfig), num_iterations=2,
                          intercept_indices={"global": 0, "wide": 0}, num_entities={"userId": E_WIDE})
        jest._prepare_datasets(jb)
        jds = jest._re_datasets["perUser"]
        from photon_tpu.models.game import FixedEffectModel as JFE
        from photon_tpu.models.game import GameModel as JGame
        from photon_tpu.models.glm import GeneralizedLinearModel as JGLM

        init = JGame({"global": JFE(JGLM(JCoefficients(jnp.zeros(600)), JTask.LOGISTIC_REGRESSION), "global"),
                      "perUser": _ref_zero_model(jds)})
        (jres,) = jest.fit(jb, optimization_configs=[reg(jconfig)], initial_model=init)
        want = np.asarray(jres.model.score(jb))
    _close(res.model.score(tb), want)


def test_default_transpose_plan_by_device():
    assert default_transpose_plan("cpu") is False
    assert default_transpose_plan(torch.device("cpu")) is False
    assert isinstance(default_transpose_plan("cuda"), bool)


def test_sparse_modules_import_without_jax():
    """The modules this slice touched load in a process where jax and
    photon_tpu never load (tests/conftest.py imports jax here, so this runs
    in a subprocess)."""
    code = (
        "import sys\n"
        "import photon_tpu_torch.data.batch, photon_tpu_torch.data.constraints, photon_tpu_torch.data.stats\n"
        "import photon_tpu_torch.data.padding, photon_tpu_torch.data.validators, photon_tpu_torch.io.data_reader\n"
        "import photon_tpu_torch.optim.margin_lbfgs, photon_tpu_torch.cli.name_and_term_bags\n"
        "import photon_tpu_torch.cli.train_glm, photon_tpu_torch.cli.game_training, photon_tpu_torch.interop\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'photon_tpu'"
        " or m.startswith('photon_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_solve_reads_once_a_chunk_on_sparse():
    """The eager sparse solve reads back once a chunk of steps, as a dense
    one does (no host read hides in a sparse product)."""
    idx, vals, y, *_ = _triples(seed=16)
    d = 400
    sf = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals), d).with_transpose_plan()
    reads0 = HOST_READS.count
    res = minimize_lbfgs_margin(GLMObjective(LogisticLoss, l2_weight=1.0, intercept_index=0),
                                LabeledBatch(torch.from_numpy(y), sf), torch.zeros(d, dtype=torch.float64),
                                OptimizerConfig(max_iter=25))
    from photon_tpu_torch.optim.program import EAGER_CHUNK
    from photon_tpu_torch.optim.margin_lbfgs import TRIALS_PER_STEP

    steps_cap = 25 * math.ceil(20 / TRIALS_PER_STEP)
    assert HOST_READS.count - reads0 <= math.ceil(steps_cap / EAGER_CHUNK)
    with jax.enable_x64(True):
        want = j_margin(JObjective(loss=JLogistic, l2_weight=1.0, intercept_index=0),
                        JBatch(jnp.asarray(y), JSparse(jnp.asarray(idx), jnp.asarray(vals), d)), jnp.zeros(d),
                        JConfig(max_iter=25))
        _close(res.w, np.asarray(want.w))
        _close(res.loss_history, np.asarray(want.loss_history))
