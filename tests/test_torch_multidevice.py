"""Rows-sharded and feature-sharded fixed effects of the port on gloo ranks
against the reference on its 8 virtual devices: the GLMix sharded step on
1-, 2- and 4-device meshes (__graft_entry__.py's dryrun), with
``re_solver="lbfgs"`` too, TRON on a rows-sharded batch, and every case of
tests/test_feature_sharded.py and tests/test_multislice.py; then the rank
launcher itself (no fallback: NCCL refuses ranks that share a card, a
failing or hung rank fails the job).

Each world size spawns once (tests/torch_ranks.py::multidevice_program).
Float64 comparisons run the reference under the scoped x64 context, at
rtol 1e-5.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_ranks
from torch_ranks import GLMIX_D_FIX, GLMIX_D_RE, GLMIX_E, GLMIX_N, tiny_glmix

from photon_tpu_torch.utils.virtual_devices import RankFailed, run_ranks

REPO = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def port_runs():
    return {n: run_ranks(torch_ranks.multidevice_program, n, backend="gloo", device="cpu", threads=1,
                         timeout_s=60.0)
            for n in WORLDS}


def _ref_glmix(mesh, cfg, steps, re_solver="newton", sparse=False):
    from photon_tpu.data.batch import LabeledBatch, SparseFeatures
    from photon_tpu.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
    from photon_tpu.ops.losses import LogisticLoss
    from photon_tpu.ops.objective import GLMObjective
    from photon_tpu.parallel.train_step import glmix_sharded_train_step

    Xf, Xr, users, y = (a.astype(np.float64) if a.dtype == np.float32 else a
                        for a in tiny_glmix(GLMIX_N, GLMIX_D_FIX, GLMIX_D_RE, GLMIX_E))
    (block,) = build_random_effect_dataset(users, Xr, y, np.ones(GLMIX_N), GLMIX_E,
                                           RandomEffectDataConfig(re_type="userId", feature_shard="re",
                                                                  n_buckets=1)).blocks
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    step, place = glmix_sharded_train_step(mesh, obj, obj, cfg, cfg, re_solver=re_solver)
    X = jnp.asarray(Xf)
    if sparse:
        idx, vals = torch_ranks.glmix_sparse_rows(Xf)
        X = SparseFeatures(jnp.asarray(idx), jnp.asarray(vals), GLMIX_D_FIX)
    args = place(jnp.zeros(GLMIX_D_FIX), jnp.zeros((GLMIX_E, GLMIX_D_RE)), LabeledBatch(jnp.asarray(y), X),
                 block, jnp.asarray(Xr), jnp.asarray(users))
    w, c = args[0], args[1]
    for _ in range(steps):
        w, c, scores, fe_evals, visits = step(w, c, *args[2:])
    return dict(w=np.asarray(w), c=np.asarray(c), scores=np.asarray(scores), fe_evals=int(fe_evals),
                visits=int(visits))


def _mesh(n):
    from photon_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=n, devices=jax.devices()[:n])


def _assert_glmix(got, ref, exact_counts=True):
    for k in ("w", "c", "scores"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-9, err_msg=k)
    if exact_counts:
        assert (got["fe_evals"], got["visits"]) == (ref["fe_evals"], ref["visits"])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_glmix_sharded_step_matches_reference(port_runs, n):
    from photon_tpu.optim.common import OptimizerConfig

    with jax.enable_x64(True):
        ref = _ref_glmix(_mesh(n), OptimizerConfig(max_iter=3, track_history=False), steps=2)
    for res in port_runs[n]:
        _assert_glmix(res["glmix"], ref)


@pytest.mark.parametrize("n", WORLDS)
def test_glmix_sharded_step_repeats_bit_for_bit(port_runs, n):
    for res in port_runs[n]:
        for k in ("w", "c", "scores"):
            np.testing.assert_array_equal(res["glmix_again"][k], res["glmix"][k])
            np.testing.assert_array_equal(res["glmix"][k], port_runs[n][0]["glmix"][k])


@pytest.mark.parametrize("n", [1, 4])
def test_glmix_re_lbfgs_matches_reference(port_runs, n):
    """``re_solver="lbfgs"``: margin-space L-BFGS a lane an entity."""
    from photon_tpu.optim.common import OptimizerConfig

    with jax.enable_x64(True):
        ref = _ref_glmix(_mesh(n), OptimizerConfig(max_iter=3, track_history=False), steps=2, re_solver="lbfgs")
    for res in port_runs[n]:
        _assert_glmix(res["glmix_lbfgs"], ref)


@pytest.mark.parametrize("n", [1, 4])
def test_glmix_sharded_step_sparse_matches_reference(port_runs, n):
    """The sharded step's sparse branch: a padded-sparse fixed-effect shard,
    each rank's rows."""
    from photon_tpu.optim.common import OptimizerConfig

    with jax.enable_x64(True):
        ref = _ref_glmix(_mesh(n), OptimizerConfig(max_iter=3, track_history=False), steps=2, sparse=True)
    for res in port_runs[n]:
        _assert_glmix(res["glmix_sparse"], ref)


def _total_objective(w, coefs):
    """__graft_entry__.py's total objective of the converged dryrun."""
    Xf, Xr, users, y = (a.astype(np.float64) if a.dtype == np.float32 else a
                        for a in tiny_glmix(GLMIX_N, GLMIX_D_FIX, GLMIX_D_RE, GLMIX_E))
    z = Xf @ w + np.sum(Xr * coefs[users], -1)
    return float(np.sum(np.logaddexp(0, z) - y * z)) + 0.5 * float(np.sum(w[1:] ** 2)) + 0.5 * float(
        np.sum(coefs[:, 1:] ** 2))


def test_converged_objective_1_vs_4_ranks(port_runs):
    """Run to convergence (40 iterations, tol 1e-8), 1 and 4 ranks give total
    objectives within 1e-6 relative (the reference's dryrun bar), and each
    the reference's at its mesh within 1e-6."""
    from photon_tpu.optim.common import OptimizerConfig

    f = {n: _total_objective(port_runs[n][0]["glmix_converged"]["w"], port_runs[n][0]["glmix_converged"]["c"])
         for n in (1, 4)}
    assert abs(f[4] - f[1]) / abs(f[1]) < 1e-6, f
    with jax.enable_x64(True):
        for n in (1, 4):
            ref = _ref_glmix(_mesh(n), OptimizerConfig(max_iter=40, tol=1e-8, track_history=False), steps=1)
            assert abs(_total_objective(ref["w"], ref["c"]) - f[n]) / abs(f[n]) < 1e-6


@pytest.mark.parametrize("n", WORLDS)
def test_tron_on_rows_sharded_batch_matches_reference(port_runs, n):
    """A fixed-effect TRON solve over rows-sharded batches (each rank's rows,
    its sums reduced over the ranks: K1 trials and K2 products on the card)
    against the reference's minimize_tron over the whole batch: float64
    rtol 1e-5, equal iterations and reason; bitwise at every world size."""
    from photon_tpu.data.batch import LabeledBatch
    from photon_tpu.ops.losses import LogisticLoss
    from photon_tpu.ops.objective import GLMObjective
    from photon_tpu.optim.common import OptimizerConfig
    from photon_tpu.optim.tron import minimize_tron

    Xf, _Xr, _u, y = tiny_glmix(GLMIX_N, GLMIX_D_FIX, GLMIX_D_RE, GLMIX_E, seed=5)
    rng = np.random.default_rng(5)
    off, wt = 0.1 * rng.normal(size=GLMIX_N), rng.uniform(0.5, 1.5, size=GLMIX_N)
    with jax.enable_x64(True):
        lb = LabeledBatch(jnp.asarray(y, jnp.float64), jnp.asarray(Xf, jnp.float64), jnp.asarray(off),
                          jnp.asarray(wt))
        obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
        ref = minimize_tron(lambda w: obj.value_and_grad(w, lb), None, jnp.zeros(GLMIX_D_FIX),
                            OptimizerConfig(max_iter=15, tol=1e-9, track_history=False),
                            hvp_factory=lambda w: obj.linearized_hvp(w, lb))
        ref_w, ref_it, ref_reason = np.asarray(ref.w), int(ref.iterations), int(ref.reason_code)
    for res in port_runs[n]:
        got = res["tron"]
        np.testing.assert_allclose(got["w"], ref_w, rtol=1e-5, atol=1e-9)
        assert (got["iterations"], got["reason"]) == (ref_it, ref_reason)
        np.testing.assert_array_equal(got["w"], port_runs[1][0]["tron"]["w"])
        np.testing.assert_array_equal(res["tron_again"]["w"], got["w"])


# ---------------------------------------------------------------------------
# Feature-sharded fixed effect on a (data 2, feature 4) mesh of 8 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def feature_runs(port_runs):
    return [res["feature"] for res in port_runs[8]]


@pytest.fixture(scope="module")
def mesh24():
    from photon_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=2, n_feature=4)


def _ref_batch(indices, values, y, offset, weight, dim_p):
    from photon_tpu.data.batch import LabeledBatch, SparseFeatures

    return LabeledBatch(jnp.asarray(y, jnp.float64), SparseFeatures(jnp.asarray(indices),
                                                                    jnp.asarray(values, jnp.float64), dim_p),
                        jnp.asarray(offset, jnp.float64), jnp.asarray(weight, jnp.float64))


def _dense(X, y, offset, weight, dim_p):
    from photon_tpu.data.batch import LabeledBatch

    return LabeledBatch(jnp.asarray(y, jnp.float64), jnp.asarray(np.pad(X, ((0, 0), (0, dim_p - X.shape[1]))),
                                                                 jnp.float64),
                        jnp.asarray(offset, jnp.float64), jnp.asarray(weight, jnp.float64))


@pytest.mark.parametrize("case", ["vg", "vg_scaled"])
def test_feature_sharded_value_and_grad(feature_runs, mesh24, case):
    """Against the reference's sharded value and gradient and the dense
    replicated objective (with the scale normalization folded)."""
    from photon_tpu.data.normalization import NormalizationContext
    from photon_tpu.ops.losses import LogisticLoss
    from photon_tpu.ops.objective import GLMObjective
    from photon_tpu.parallel.feature_sharded import (
        padded_dim, place_feature_sharded, sparse_value_and_grad_feature_sharded)

    with jax.enable_x64(True):
        if case == "vg":
            idx, vals, X, y, wt, off = torch_ranks.sparse_problem(n=64, d=30)
            dim_p = padded_dim(30, 4)
            w = np.zeros(dim_p)
            w[:30] = np.linspace(-0.5, 0.5, 30)
            obj = GLMObjective(loss=LogisticLoss, l2_weight=0.7, intercept_index=3)
        else:
            idx, vals, X, y, wt, off = torch_ranks.sparse_problem(n=32, d=14, seed=3)
            dim_p = padded_dim(14, 4)
            factors = np.ones(dim_p)
            factors[:14] = np.linspace(0.5, 2.0, 14)
            obj = GLMObjective(loss=LogisticLoss, l2_weight=0.1,
                               normalization=NormalizationContext(factors=jnp.asarray(factors)))
            w = np.linspace(-0.3, 0.3, dim_p)
        w_sh, b_sh = place_feature_sharded(mesh24, jnp.asarray(w), _ref_batch(idx, vals, y, off, wt, dim_p))
        ref_val, ref_g = jax.jit(sparse_value_and_grad_feature_sharded(obj, mesh24, dim_p))(w_sh, b_sh)
        dense_val, dense_g = obj.value_and_grad(jnp.asarray(w), _dense(X, y, off, wt, dim_p))
    for res in feature_runs:
        val, g = res[case]
        np.testing.assert_allclose(val, float(ref_val), rtol=1e-5)
        np.testing.assert_allclose(g, np.asarray(ref_g), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(val, float(dense_val), rtol=1e-5)
        np.testing.assert_allclose(g, np.asarray(dense_g), rtol=1e-5, atol=1e-9)


def test_shift_normalization_rejected():
    from photon_tpu_torch.data.normalization import NormalizationContext
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.parallel.feature_sharded import sparse_value_and_grad_feature_sharded
    from photon_tpu_torch.parallel.mesh import make_mesh

    norm = NormalizationContext(factors=torch.ones(8), shifts=torch.ones(8), intercept_index=0)
    with pytest.raises(ValueError, match="scale normalization only"):
        sparse_value_and_grad_feature_sharded(GLMObjective(loss=LogisticLoss, normalization=norm), make_mesh(), 8)


@pytest.mark.parametrize("case,binary", [("train_logistic", True), ("train_poisson", False)])
def test_feature_sharded_training_matches_reference(feature_runs, mesh24, case, binary):
    """L-BFGS with w over the feature axis against the reference's on the
    same mesh (float64 rtol 1e-5, equal iterations) and the replicated
    dense solve; padded coefficients stay exactly 0; each rank holds a
    quarter of w."""
    from photon_tpu.ops.losses import LogisticLoss, PoissonLoss
    from photon_tpu.ops.objective import GLMObjective
    from photon_tpu.optim.common import OptimizerConfig
    from photon_tpu.optim.lbfgs import minimize_lbfgs
    from photon_tpu.parallel.feature_sharded import (
        padded_dim, place_feature_sharded, train_fixed_effect_feature_sharded)

    idx, vals, X, y, wt, off = torch_ranks.sparse_problem(n=64, d=30, seed=7, binary=binary)
    dim_p = padded_dim(30, 4)
    with jax.enable_x64(True):
        obj = GLMObjective(loss=LogisticLoss if binary else PoissonLoss, l2_weight=1.0, intercept_index=0)
        cfg = OptimizerConfig(max_iter=50, tol=1e-8, track_history=False)
        w0, b = place_feature_sharded(mesh24, jnp.zeros(dim_p), _ref_batch(idx, vals, y, off, wt, dim_p))
        ref = train_fixed_effect_feature_sharded(mesh24, obj, cfg, dim_p)(w0, b)
        dense = _dense(X, y, off, wt, dim_p)
        rep = minimize_lbfgs(lambda w: obj.value_and_grad(w, dense), jnp.zeros(dim_p), cfg)
        ref_w, ref_it, rep_w = np.asarray(ref.w), int(ref.iterations), np.asarray(rep.w)
    for res in feature_runs:
        got = res[case]
        np.testing.assert_allclose(got["w"], ref_w, rtol=1e-5, atol=1e-9)
        assert got["iterations"] == ref_it
        np.testing.assert_allclose(got["w"], rep_w, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(got["w"][30:], 0.0)
        assert got["local"] == dim_p // 4 and got["grad_norm"] < 1e-2
        np.testing.assert_array_equal(got["again"], got["w"])  # a second fit, bit for bit


def test_feature_sharded_hvp_matches_reference(feature_runs, mesh24):
    """The sharded linearized HVP (L2, the exempt intercept and the scale
    normalization folded) against the reference's and the dense product."""
    from photon_tpu.data.normalization import NormalizationContext
    from photon_tpu.ops.losses import LogisticLoss
    from photon_tpu.ops.objective import GLMObjective
    from photon_tpu.parallel.feature_sharded import (
        padded_dim, place_feature_sharded, sparse_linearized_hvp_feature_sharded)

    idx, vals, X, y, wt, off = torch_ranks.sparse_problem(n=64, d=30, seed=11)
    dim_p = padded_dim(30, 4)
    rng = np.random.default_rng(3)
    w, v = rng.normal(size=dim_p) * 0.3, rng.normal(size=dim_p)
    with jax.enable_x64(True):
        norm = NormalizationContext(factors=jnp.asarray(np.linspace(0.5, 1.5, dim_p)), intercept_index=0)
        for k, obj in enumerate((GLMObjective(loss=LogisticLoss, l2_weight=0.7, intercept_index=0),
                                 GLMObjective(loss=LogisticLoss, l2_weight=0.3, intercept_index=0,
                                              normalization=norm))):
            w_sh, b_sh = place_feature_sharded(mesh24, jnp.asarray(w), _ref_batch(idx, vals, y, off, wt, dim_p))
            make_hvp = sparse_linearized_hvp_feature_sharded(obj, mesh24, dim_p)
            ref = np.asarray(jax.jit(lambda ww, vv: make_hvp(ww, b_sh)(vv))(w_sh, jnp.asarray(v)))
            dense = np.asarray(obj.linearized_hvp(jnp.asarray(w), _dense(X, y, off, wt, dim_p))(jnp.asarray(v)))
            for res in feature_runs:
                np.testing.assert_allclose(res["hvp"][k], ref, rtol=1e-5, atol=1e-9)
                np.testing.assert_allclose(res["hvp"][k], dense, rtol=1e-5, atol=1e-9)


def test_feature_sharded_tron_matches_reference(feature_runs, mesh24):
    from photon_tpu.ops.losses import LogisticLoss
    from photon_tpu.ops.objective import GLMObjective
    from photon_tpu.optim.common import OptimizerConfig
    from photon_tpu.parallel.feature_sharded import (
        padded_dim, place_feature_sharded, train_fixed_effect_feature_sharded)

    idx, vals, X, y, wt, off = torch_ranks.sparse_problem(n=64, d=30, seed=13)
    dim_p = padded_dim(30, 4)
    with jax.enable_x64(True):
        obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
        cfg = OptimizerConfig(max_iter=30, tol=1e-8, track_history=False)
        w0, b = place_feature_sharded(mesh24, jnp.zeros(dim_p), _ref_batch(idx, vals, y, off, wt, dim_p))
        ref = train_fixed_effect_feature_sharded(mesh24, obj, cfg, dim_p, solver="tron")(w0, b)
        ref_w, ref_it = np.asarray(ref.w), int(ref.iterations)
    for res in feature_runs:
        np.testing.assert_allclose(res["tron"]["w"], ref_w, rtol=1e-5, atol=1e-9)
        assert res["tron"]["iterations"] == ref_it
        np.testing.assert_array_equal(res["tron"]["w"][30:], 0.0)
        assert res["tron"]["grad_norm"] < 1e-2
        np.testing.assert_array_equal(res["tron"]["again"], res["tron"]["w"])


# ---------------------------------------------------------------------------
# Multi-slice meshes of 8 ranks
# ---------------------------------------------------------------------------


def test_multislice_mesh_axes(port_runs):
    for res in port_runs[8]:
        names, shape, dp, dp_plain = res["multislice"]["axes"]
        assert names == ("slice", "data", "feature") and shape == {"slice": 2, "data": 2, "feature": 2}
        assert dp == ("slice", "data") and dp_plain == ("data",)


def test_mesh_defaults_to_the_ranks_device(port_runs):
    """A mesh built with no device takes the device its rank joined on (the
    CPU here, as the ranks were asked to run there)."""
    for res in port_runs[8]:
        assert res["multislice"]["devices"] == ("cpu", "cpu")


def test_feature_sharded_on_multislice_mesh(port_runs):
    """(2 slices × 2 data × 2 feature) against the reference's fit on the
    same mesh, float64 rtol 1e-5."""
    from photon_tpu.data.batch import LabeledBatch, SparseFeatures
    from photon_tpu.ops.losses import LogisticLoss
    from photon_tpu.ops.objective import GLMObjective
    from photon_tpu.optim.common import OptimizerConfig
    from photon_tpu.parallel.feature_sharded import place_feature_sharded, train_fixed_effect_feature_sharded
    from photon_tpu.parallel.mesh import make_multislice_mesh

    indices, values, y, _Xd = torch_ranks.multislice_sparse()
    with jax.enable_x64(True):
        mesh = make_multislice_mesh(n_slices=2, n_feature=2)
        obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
        fit = train_fixed_effect_feature_sharded(mesh, obj, OptimizerConfig(max_iter=40, tol=1e-8,
                                                                            track_history=False), 32)
        w0, b = place_feature_sharded(mesh, jnp.zeros(32), LabeledBatch(
            jnp.asarray(y, jnp.float64), SparseFeatures(jnp.asarray(indices), jnp.asarray(values, jnp.float64), 32)))
        ref = np.asarray(fit(w0, b).w)
    for res in port_runs[8]:
        np.testing.assert_allclose(res["multislice"]["feature_sharded"], ref, rtol=1e-5, atol=1e-9)


def test_glmix_step_on_multislice_mesh(port_runs):
    """The GLMix sharded step on a (2, 4, 1) slice mesh: its reductions run
    inside each slice, then across slices; against the reference's on the
    same mesh."""
    from photon_tpu.optim.common import OptimizerConfig
    from photon_tpu.parallel.mesh import make_multislice_mesh

    with jax.enable_x64(True):
        ref = _ref_glmix(make_multislice_mesh(n_slices=2, n_feature=1), OptimizerConfig(max_iter=3,
                                                                                      track_history=False), 1)
    for res in port_runs[8]:
        _assert_glmix(res["multislice"]["glmix"], ref)


def test_shard_batch_multislice_padding(port_runs):
    for res in port_runs[8]:
        padded, total_weight, rows = res["multislice"]["padding"]
        assert padded == 16 and total_weight == 13.0 and rows == 13


def test_evaluators_exact_on_sharded_scores(port_runs):
    """Scores, labels and weights that live on 8 ranks, gathered exactly,
    give every evaluator the value of the whole arrays on one device."""
    from photon_tpu_torch.evaluation import evaluators as ev

    rng = np.random.default_rng(77)
    n = 8 * 250
    scores = rng.normal(size=n).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.4).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    scores[::7] = 0.5
    gids = rng.integers(0, 16, size=n).astype(np.int32)
    t = torch.from_numpy
    plain = {name: float(fn(t(scores), t(labels), t(weight))) for name, fn in (
        ("auc_roc", ev.auc_roc), ("auc_pr", ev.auc_pr), ("rmse", ev.rmse),
        ("logistic_loss", ev.logistic_loss_metric), ("squared_loss", ev.squared_loss_metric))}
    plain["grouped_auc"] = float(ev.grouped_auc(t(scores), t(labels), t(gids), num_groups=16, weight=t(weight)))
    for res in port_runs[8]:
        assert res["multislice"]["evaluators"] == plain


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------


def test_ranks_join_one_group(tmp_path):
    """A ``file://`` rendezvous at the given path; every rank reports its
    rank, the world, its device and the backend."""
    got = run_ranks(torch_ranks.report_rank, 2, backend="gloo", device="cpu", init_file=str(tmp_path / "rdv"),
                    timeout_s=30.0)
    assert got == [(0, 2, "cpu", "gloo", 3.0), (1, 2, "cpu", "gloo", 3.0)]


def test_nccl_refuses_ranks_that_share_a_card():
    """NCCL with more ranks than cards (here: no card at all) raises before
    any rank starts; nothing switches to gloo or to the CPU."""
    n = max(torch.cuda.device_count(), 1) + 1
    with pytest.raises(ValueError, match="NCCL|CUDA"):
        run_ranks(torch_ranks.report_rank, n, backend="nccl")
    with pytest.raises(ValueError, match="(?i)nccl"):
        run_ranks(torch_ranks.report_rank, 2, backend="nccl", device="cpu")


def test_a_failing_rank_fails_the_job():
    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        run_ranks(torch_ranks.fail_on_rank_one, 2, backend="gloo", device="cpu", timeout_s=30.0)


def test_a_hung_collective_fails_within_the_group_timeout():
    import time

    t0 = time.perf_counter()
    with pytest.raises(RankFailed):
        run_ranks(torch_ranks.hang_in_collective, 2, backend="gloo", device="cpu", timeout_s=3.0, deadline_s=40.0)
    assert time.perf_counter() - t0 < 40.0


def test_init_from_env_joins_a_torchrun_group():
    """``init_from_env`` joins the group a launcher describes in the
    environment (torchrun's variables; one rank on the CPU here)."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = ("import torch.distributed as dist\n"
            "from photon_tpu_torch.utils.virtual_devices import init_from_env\n"
            "dev = init_from_env(backend='gloo', device='cpu', timeout_s=30)\n"
            "print(dist.get_backend(), dist.get_rank(), dist.get_world_size(), dev)\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["gloo", "0", "1", "cpu"]


def test_new_modules_import_no_jax():
    """The multi-device modules, the rank programs and chip_smoke.py load in
    a fresh interpreter without jax or the reference package."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tests')!r}]\n"
        "import photon_tpu_torch.parallel, photon_tpu_torch.parallel.train_step\n"
        "import photon_tpu_torch.algorithm.sharded_random_effect, photon_tpu_torch.utils.virtual_devices\n"
        "import photon_tpu_torch.serve.routing, torch_ranks, chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'photon_tpu') or k.startswith(('jax.', 'photon_tpu.')))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
