"""The port's random-effect data and coordinate against the JAX package on
the CPU: block building with subspace projection, merging, the active-set
repack, the Pearson mask, and the coordinate's dense, projected and gated
passes, variances and divergence quarantine.

Float64 parity under jax's scoped x64 context: coefficients at rtol 1e-5
(atol 1e-8 for coefficients that are zero up to rounding), iteration counts
and reasons equal per entity and pass, block contents equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.algorithm.random_effect import RandomEffectCoordinate as JCoord
from photon_tpu.algorithm.solve_cache import SolveCache as JSolveCache
from photon_tpu.data.game_data import GameBatch as JGameBatch
from photon_tpu.data import random_effect as jre
from photon_tpu.ops.losses import LogisticLoss as JLogistic
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.optim.factory import OptimizerSpec as JSpec
from photon_tpu.types import OptimizerType as JOptimizerType
from photon_tpu.types import TaskType as JTaskType

from photon_tpu_torch.algorithm.random_effect import (
    NEWTON_AUTO_MAX_DIM,
    RandomEffectCoordinate,
    newton_eligible,
)
from photon_tpu_torch.data import random_effect as tre
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.models.game import ProjectedRandomEffectModel
from photon_tpu_torch.ops.losses import LogisticLoss
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import REASON_DIVERGED
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.types import OptimizerType, TaskType

RTOL64, ATOL64 = 1e-5, 1e-8
E = 96
FIELDS = ("entity_idx", "features", "label", "weight", "sample_index", "train_mask")


def _cold_cohort_problem(frac_cold=3, d=6, seed=7):
    """Entities whose id is not a multiple of ``frac_cold`` have all-zero
    features, so their ridge solve is exactly 0 every pass and they retire
    from the active set at the first gated pass. Sample counts 37-46 share
    one n_max bucket, so the quantile grouping gives several blocks of one
    geometry (the regime where the repack compacts)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(37, 47, size=E)
    eids = np.repeat(np.arange(E, dtype=np.int32), counts)
    n = eids.size
    X = rng.normal(size=(n, d))
    X[eids % frac_cold != 0] = 0.0
    y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    return eids, X, y, np.ones(n)


def _cfg(pkg, **kw):
    kw.setdefault("n_buckets", 4)
    return pkg.RandomEffectDataConfig(re_type="userId", feature_shard="re", **kw)


def _both_datasets(eids, X, y, w, **kw):
    with jax.enable_x64(True):
        jds = jre.build_random_effect_dataset(eids, X, y, w, E, _cfg(jre, **kw))
    return tre.build_random_effect_dataset(eids, X, y, w, E, _cfg(tre, **kw), device="cpu"), jds


def _assert_same_blocks(blocks, jblocks):
    assert len(blocks) == len(jblocks)
    for b, jb in zip(blocks, jblocks):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
        if jb.col_map is None:
            assert b.col_map is None
        else:
            np.testing.assert_array_equal(b.col_map.numpy(), np.asarray(jb.col_map))


def _batches(eids, X, y, w):
    n = y.shape[0]
    with jax.enable_x64(True):
        jb = JGameBatch(label=jnp.asarray(y), offset=jnp.zeros(n), weight=jnp.asarray(w),
                        features={"re": jnp.asarray(X)}, entity_ids={"userId": jnp.asarray(eids)})
    tb = GameBatch(label=torch.from_numpy(y), offset=torch.zeros(n, dtype=torch.float64),
                   weight=torch.from_numpy(w), features={"re": torch.from_numpy(X)},
                   entity_ids={"userId": torch.from_numpy(eids)})
    return tb, jb


def _coordinates(ds, jds, active_set=False, tol=1e-4, ref_kw=None, **kw):
    kw.setdefault("optimizer_spec", dict(optimizer="NEWTON", max_iter=25, tol=1e-9))
    spec = kw.pop("optimizer_spec")
    obj = kw.pop("objective", dict(l2_weight=0.5))
    coord = RandomEffectCoordinate(
        "per_user", ds, TaskType.LOGISTIC_REGRESSION, GLMObjective(loss=LogisticLoss, **obj),
        OptimizerSpec(**dict(spec, optimizer=OptimizerType[spec["optimizer"]])),
        active_set=active_set, convergence_tol=tol, **kw)
    with jax.enable_x64(True):
        jcoord = JCoord(
            "per_user", jds, JTaskType.LOGISTIC_REGRESSION, JObjective(loss=JLogistic, **obj),
            JSpec(**dict(spec, optimizer=JOptimizerType[spec["optimizer"]])),
            solve_cache=JSolveCache(donate=False), active_set=active_set, convergence_tol=tol,
            **kw, **(ref_kw or {}))
    return coord, jcoord


def _ref_zero_model(jds):
    """A float64 all-zero dense model: the reference's projected path starts
    from float32 zeros without a warm start, which its float64 solve
    refuses, so under x64 it gets this one (the same values)."""
    from photon_tpu.models.game import RandomEffectModel as JModel

    return JModel(jnp.zeros((jds.num_entities, jds.dim)), "userId", "re", JTaskType.LOGISTIC_REGRESSION)


def _run_passes(coord, jcoord, tb, jb, passes):
    """The CD pass protocol (begin_cd_pass, train) on one coordinate with no
    residual, in both packages; returns per pass (port, reference) of
    (model, stats, active-set stats)."""
    out = []
    model = None
    with jax.enable_x64(True):
        jmodel = _ref_zero_model(jcoord.dataset) if jcoord.dataset.projected else None
    for it in range(passes):
        coord.begin_cd_pass(it)
        model, stats = coord.train(tb, None, model)
        with jax.enable_x64(True):
            jcoord.begin_cd_pass(it)
            jmodel, jstats = jcoord.train(jb, None, jmodel)
        out.append(((model, stats, coord.last_active_set_stats), (jmodel, jstats, jcoord.last_active_set_stats)))
    return out


def _dense(model):
    return (model.to_dense() if hasattr(model, "block_coefs") else model).coefficients


def _assert_pass_parity(passes):
    for (m, s, a), (jm, js, ja) in passes:
        np.testing.assert_allclose(np.asarray(_dense(m)), np.asarray(_dense(jm)), rtol=RTOL64, atol=ATOL64)
        v = np.asarray(js.valid)
        np.testing.assert_array_equal(s.valid.numpy(), v)
        np.testing.assert_array_equal(s.iterations.numpy()[v], np.asarray(js.iterations)[v])
        np.testing.assert_array_equal(s.reasons.numpy()[v], np.asarray(js.reasons)[v])
        if ja is not None:
            assert {k: a[k] for k in ja if k != "compaction_ratio"} == \
                {k: ja[k] for k in ja if k != "compaction_ratio"}


# ------------------------------------------------------------- block building


@pytest.mark.parametrize("kw", [dict(), dict(subspace_projection=True), dict(merge_same_geometry=True),
                                dict(active_upper_bound=40, active_lower_bound=39), dict(shape_bucketing=False)],
                         ids=["dense", "projected", "merged", "bounds", "exact_shapes"])
def test_blocks_match_reference(kw):
    eids, X, y, w = _cold_cohort_problem(d=7)
    X[:, 5] = 0.0  # a column no entity touches: projection drops it
    ds, jds = _both_datasets(eids, X, y, w, **kw)
    _assert_same_blocks(ds.blocks, jds.blocks)
    assert ds.projected == jds.projected
    if ds.projected:
        eb, er, inv = ds.projection_tables()
        jeb, jer, jinv = jds.projection_tables()
        np.testing.assert_array_equal(eb.numpy(), np.asarray(jeb))
        np.testing.assert_array_equal(er.numpy(), np.asarray(jer))
        for a, b in zip(inv, jinv):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        b = ds.blocks[0]
        w_block = torch.arange(b.num_entities * b.dim, dtype=torch.float64).reshape(b.num_entities, b.dim)
        assert torch.equal(b.project_forward(b.project_backward(w_block, 7)), w_block)


def test_merge_same_geometry_blocks_collapses_groups():
    eids, X, y, w = _cold_cohort_problem()
    ds, _ = _both_datasets(eids, X, y, w)
    merged = tre.merge_same_geometry_blocks(ds)
    assert len({(b.n_max, b.dim) for b in ds.blocks}) == len(merged.blocks) < len(ds.blocks)
    with jax.enable_x64(True):
        jmerged = jre.merge_same_geometry_blocks(jre.build_random_effect_dataset(eids, X, y, w, E, _cfg(jre)))
    _assert_same_blocks(merged.blocks, jmerged.blocks)


def test_pack_into_sizes_plans_from_allowed_set_only():
    assert tre.pack_into_sizes(10, [12, 24]) == [12]
    assert tre.pack_into_sizes(13, [12, 24]) == [24]
    assert tre.pack_into_sizes(25, [12, 24]) == [24, 12]
    assert tre.pack_into_sizes(60, [12, 24]) == [24, 24, 12]
    plan = tre.pack_into_sizes(100, [12])
    assert plan == [12] * 9 and sum(plan) >= 100
    with pytest.raises(ValueError):
        tre.pack_into_sizes(5, [])
    for total, allowed in ((10, [12, 24]), (61, [12, 24, 6]), (7, [3])):
        assert tre.pack_into_sizes(total, allowed) == jre.pack_into_sizes(total, allowed)


def test_compact_entity_blocks_matches_reference():
    """Kept rows in (block, row) order, an inert padding tail, and src maps
    back to each row's source — the reference's repack exactly."""
    eids, X, y, w = _cold_cohort_problem()
    ds, jds = _both_datasets(eids, X, y, w)
    idx = [i for i, b in enumerate(ds.blocks) if b.n_max == ds.blocks[0].n_max]
    keep = [(b.entity_idx.numpy() >= 0) & (np.arange(b.num_entities) % 3 == 0)
            for b in (ds.blocks[i] for i in idx)]
    out = tre.compact_entity_blocks([ds.blocks[i] for i in idx], keep)
    with jax.enable_x64(True):
        jout = jre.compact_entity_blocks([jds.blocks[i] for i in idx], keep)
    assert len(out) == len(jout) > 0
    for (b, sb, sr), (jb, jsb, jsr) in zip(out, jout):
        np.testing.assert_array_equal(sb, jsb)
        np.testing.assert_array_equal(sr, jsr)
        _assert_same_blocks([b], [jb])
        assert not b.train_mask.numpy()[sb < 0].any() and float(b.weight[torch.from_numpy(sb < 0)].sum()) == 0
    assert {o[0].num_entities for o in out} <= {ds.blocks[i].num_entities for i in idx}
    assert tre.compact_entity_blocks([ds.blocks[i] for i in idx], [np.zeros_like(k) for k in keep]) == []


def test_compact_entity_blocks_rejects_mixed_geometry():
    rng = np.random.default_rng(3)
    counts = np.where(np.arange(E) % 4 != 0, rng.integers(5, 7, size=E), rng.integers(37, 47, size=E))
    eids = np.repeat(np.arange(E, dtype=np.int32), counts)
    X = rng.normal(size=(eids.size, 6))
    y = (rng.uniform(size=eids.size) < 0.5).astype(np.float64)
    ds = tre.build_random_effect_dataset(eids, X, y, np.ones(eids.size), E, _cfg(tre, n_buckets=2), device="cpu")
    assert len({(b.n_max, b.dim) for b in ds.blocks}) >= 2
    with pytest.raises(ValueError, match="same-geometry"):
        tre.compact_entity_blocks(ds.blocks, [b.entity_idx.numpy() >= 0 for b in ds.blocks])


def test_pearson_feature_mask_matches_reference():
    rng = np.random.default_rng(5)
    eids, X, y, w = _cold_cohort_problem(frac_cold=1, d=8, seed=5)
    X = np.concatenate([X, np.zeros((X.shape[0], 4))], axis=1)  # dead columns
    X[:, 0] = 1.0
    ds, jds = _both_datasets(eids, X, y, w)
    for b, jb in zip(ds.blocks, jds.blocks):
        k = rng.integers(1, 8, size=b.num_entities).astype(np.int32)
        m = tre.pearson_feature_mask(b, torch.from_numpy(k), always_keep=0).numpy()
        with jax.enable_x64(True):
            jm = np.asarray(jre.pearson_feature_mask(jb, jnp.asarray(k), always_keep=0))
        np.testing.assert_array_equal(m, jm)
        assert np.all(m[:, 0] == 1.0) and np.all(m[:, 8:] == 0.0)


# --------------------------------------------------------------- coordinate


def test_newton_routing_by_width_mask_and_spec():
    obj = GLMObjective(loss=LogisticLoss)
    lbfgs, newton = OptimizerSpec(), OptimizerSpec(OptimizerType.NEWTON)
    assert newton_eligible(obj, lbfgs, NEWTON_AUTO_MAX_DIM, False)
    assert not newton_eligible(obj, lbfgs, NEWTON_AUTO_MAX_DIM + 1, False)
    assert newton_eligible(obj, newton, 4 * NEWTON_AUTO_MAX_DIM, False)
    assert not newton_eligible(obj, newton, 16, True)


@pytest.mark.parametrize("route", ["newton", "lbfgs_wide", "pearson"])
def test_dense_passes_match_reference(route):
    """Two passes, warm-started, on mixed-geometry blocks."""
    rng = np.random.default_rng(2)
    counts = rng.integers(3, 60, size=E)
    eids = np.repeat(np.arange(E, dtype=np.int32), counts)
    d = 130 if route == "lbfgs_wide" else 6
    X = rng.normal(size=(eids.size, d))
    X[:, 0] = 1.0
    y = (rng.uniform(size=eids.size) < 0.5).astype(np.float64)
    w = np.ones(eids.size)
    kw = dict(features_to_samples_ratio=0.08) if route == "pearson" else {}
    ds, jds = _both_datasets(eids, X, y, w, **kw)
    assert len({(b.n_max, b.dim) for b in ds.blocks}) > 1
    spec = dict(optimizer="LBFGS", max_iter=30) if route != "newton" else None
    coord, jcoord = _coordinates(ds, jds, objective=dict(l2_weight=0.5, intercept_index=0),
                                 **({"optimizer_spec": spec} if spec else {}))
    tb, jb = _batches(eids, X, y, w)
    _assert_pass_parity(_run_passes(coord, jcoord, tb, jb, 2))


# route: (objective keywords, optimizer, Pearson mask, normalization)
_LIFTED = {
    "l1": (dict(l2_weight=0.0, l1_weight=0.6), "LBFGS", False, None),
    "elastic_net": (dict(l2_weight=0.3, l1_weight=0.3), "LBFGS", False, None),
    "elastic_net_pearson": (dict(l2_weight=0.3, l1_weight=0.3), "LBFGS", True, None),
    "tron": (dict(l2_weight=0.5), "TRON", False, None),
    "tron_factors": (dict(l2_weight=0.5), "TRON", False, "factors"),
    "tron_pearson": (dict(l2_weight=0.5), "TRON", True, None),
    "tron_pearson_shifts": (dict(l2_weight=0.5), "TRON", True, "shifts"),
}


@pytest.mark.parametrize("route", list(_LIFTED))
def test_solve_block_lifted_routes_match_reference(route):
    """``_solve_block`` on the routes that were the reference's alone (OWL-QN
    under L1 or elastic net, TRON; plain, normalized and under a Pearson
    mask) against the reference's ``_solve_block`` on every block, from a
    warm start and with offsets: coefficients at rtol 1e-5, per-entity
    iterations and reasons equal."""
    from photon_tpu.algorithm.random_effect import _solve_block as j_solve_block
    from photon_tpu.data.normalization import NormalizationContext as JNorm
    from photon_tpu.optim.common import OptimizerConfig as JConfig

    from photon_tpu_torch.algorithm.random_effect import _solve_block
    from photon_tpu_torch.data.normalization import NormalizationContext
    from photon_tpu_torch.optim.common import OptimizerConfig

    obj_kw, opt, pearson, norm = _LIFTED[route]
    rng = np.random.default_rng(len(route))
    d = 6
    counts = rng.integers(3, 50, size=E)
    eids = np.repeat(np.arange(E, dtype=np.int32), counts)
    X = rng.normal(size=(eids.size, d))
    X[:, 0] = 1.0
    W = rng.normal(size=(E, d)) * 1.5
    y = (rng.uniform(size=eids.size) < 1.0 / (1.0 + np.exp(-np.sum(X * W[eids], axis=1)))).astype(np.float64)
    ds, jds = _both_datasets(eids, X, y, np.ones(eids.size))
    factors = rng.uniform(0.5, 2.0, size=d)
    shifts = rng.normal(size=d) * 0.2
    factors[0], shifts[0] = 1.0, 0.0
    ctx = None if norm is None else dict(factors=factors, shifts=shifts if norm == "shifts" else None)
    cfg = dict(max_iter=40, tol=1e-8, track_history=False)
    offsets = rng.normal(size=eids.size) * 0.2
    for b, jb in zip(ds.blocks, jds.blocks):
        w0 = rng.normal(size=(b.num_entities, b.dim)) * 0.1
        k = np.maximum(1, rng.integers(1, d, size=b.num_entities)).astype(np.int32)
        mask = tre.pearson_feature_mask(b, torch.from_numpy(k), always_keep=0) if pearson else None
        tnorm = None if ctx is None else NormalizationContext(
            *(None if ctx[f] is None else torch.from_numpy(ctx[f]) for f in ("factors", "shifts")), 0)
        tobj = GLMObjective(loss=LogisticLoss, intercept_index=0, normalization=tnorm, **obj_kw)
        got = _solve_block(b, b.gather_offsets(torch.from_numpy(offsets)), torch.from_numpy(w0), tobj,
                           OptimizerSpec(OptimizerType[opt]), OptimizerConfig(**cfg), mask)
        with jax.enable_x64(True):
            jnorm = None if ctx is None else JNorm(
                *(None if ctx[f] is None else jnp.asarray(ctx[f]) for f in ("factors", "shifts")), 0)
            jobj = JObjective(loss=JLogistic, intercept_index=0, normalization=jnorm, **obj_kw)
            want = j_solve_block(jb, jb.gather_offsets(jnp.asarray(offsets)), jnp.asarray(w0), jobj,
                                 JSpec(JOptimizerType[opt]), JConfig(**cfg),
                                 None if mask is None else jnp.asarray(mask.numpy()))
            want = [np.asarray(a) for a in want]
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL64, atol=ATOL64)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        if obj_kw.get("l1_weight"):
            assert int((got[0] == 0).sum()) > 0


@pytest.mark.parametrize("projected", [False, True], ids=["dense", "projected"])
def test_gated_passes_match_reference_and_skip(projected):
    """Three passes with the active set: the reference's gating, repack and
    counts; the cold cohort is skipped from pass 2 and keeps exact zeros;
    the final objective matches an ungated run at rtol 1e-5."""
    eids, X, y, w = _cold_cohort_problem()
    ds, jds = _both_datasets(eids, X, y, w, subspace_projection=projected)
    tb, jb = _batches(eids, X, y, w)
    passes = _run_passes(*_coordinates(ds, jds, active_set=True), tb, jb, 3)
    _assert_pass_parity(passes)
    stats = [p[0][2] for p in passes]
    n_cold = int(np.sum(np.arange(E) % 3 != 0))
    assert stats[0]["entities_skipped"] == 0
    if projected:
        assert stats[-1]["entities_skipped"] > 0
        assert stats[-1]["dispatched_blocks"] < stats[0]["dispatched_blocks"]
    else:
        for s in stats[1:]:
            assert s["entities_skipped"] >= n_cold > 0
            assert s["entities_active"] + s["entities_skipped"] == E
            assert s["dispatched_entity_alloc"] < s["full_entity_alloc"]
        assert s["dispatched_blocks"] < len(ds.blocks)
        cold = np.arange(E) % 3 != 0
        np.testing.assert_array_equal(_dense(passes[-1][0][0]).numpy()[cold], 0.0)
    full = _run_passes(*_coordinates(ds, jds, active_set=False), tb, jb, 3)

    def objective(model):
        z = model.score(tb).numpy()
        return float(np.mean(np.logaddexp(0.0, -(2.0 * y - 1.0) * z)))

    of, og = objective(full[-1][0][0]), objective(passes[-1][0][0])
    assert abs(og - of) / abs(of) <= 1e-5


def test_begin_cd_pass_resets_active_set_state():
    eids, X, y, w = _cold_cohort_problem()
    ds, jds = _both_datasets(eids, X, y, w)
    tb, _ = _batches(eids, X, y, w)
    coord, _ = _coordinates(ds, jds, active_set=True)
    model = None
    for it in range(2):
        coord.begin_cd_pass(it)
        model, _ = coord.train(tb, None, model)
    assert coord._pending_masks is not None and coord.last_active_set_stats["cd_pass"] == 1
    coord.begin_cd_pass(0)
    assert coord._pending_masks is None
    coord.train(tb, None, model)
    assert coord.last_active_set_stats["entities_skipped"] == 0
    coord.begin_cd_pass(1)
    assert coord._pending_masks is not None


def test_projected_training_matches_dense_and_reference():
    """Dense input with subspace projection: the projected model densifies
    to the dense-block model, scores the same, and warm-starts from either
    model form (the dense cases of tests/test_subspace_projection.py)."""
    rng = np.random.default_rng(1)
    n, d_full = 360, 40
    eids = (np.arange(n) % 24).astype(np.int32)
    X = np.zeros((n, d_full))
    base = rng.integers(0, d_full - 8, size=24)
    for i in range(n):
        X[i, base[eids[i]] + rng.choice(8, size=3, replace=False)] = rng.normal(size=3)
    X[:, 0] = 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-rng.normal(size=24)[eids] * 1.5))).astype(np.float64)
    w = np.ones(n)
    obj = dict(l2_weight=1.0, intercept_index=0)
    cfg = dict(n_buckets=2)
    ds_p = tre.build_random_effect_dataset(eids, X, y, w, 24, _cfg(tre, subspace_projection=True, **cfg), device="cpu")
    ds_d = tre.build_random_effect_dataset(eids, X, y, w, 24, _cfg(tre, **cfg), device="cpu")
    assert ds_p.projected and all(b.dim < d_full for b in ds_p.blocks)
    tb = GameBatch(torch.from_numpy(y), torch.zeros(n, dtype=torch.float64), torch.from_numpy(w),
                   {"re": torch.from_numpy(X)}, {"userId": torch.from_numpy(eids)})
    mk = lambda ds: RandomEffectCoordinate("per_user", ds, TaskType.LOGISTIC_REGRESSION,  # noqa: E731
                                           GLMObjective(loss=LogisticLoss, **obj))
    coord_p, coord_d = mk(ds_p), mk(ds_d)
    m_p, s_p = coord_p.train(tb)
    m_d, s_d = coord_d.train(tb)
    assert isinstance(m_p, ProjectedRandomEffectModel)
    np.testing.assert_allclose(m_p.to_dense().coefficients.numpy(), m_d.coefficients.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(m_p.score(tb).numpy(), m_d.score(tb).numpy(), rtol=2e-3, atol=2e-4)
    assert s_p.num_entities == s_d.num_entities == 24
    assert float(torch.sum(torch.abs(coord_p.zero_model().score(tb)))) == 0.0
    m2, _ = coord_p.train(tb, initial_model=m_p)
    m3, _ = coord_p.train(tb, initial_model=m_p.to_dense())
    np.testing.assert_allclose(m2.to_dense().coefficients.numpy(), m3.to_dense().coefficients.numpy(),
                               rtol=1e-3, atol=1e-4)
    with jax.enable_x64(True):
        jds = jre.build_random_effect_dataset(eids, X, y, w, 24, _cfg(jre, subspace_projection=True, **cfg))
        jb = JGameBatch(label=jnp.asarray(y), offset=jnp.zeros(n), weight=jnp.asarray(w),
                        features={"re": jnp.asarray(X)}, entity_ids={"userId": jnp.asarray(eids)})
        jm, _ = JCoord("per_user", jds, JTaskType.LOGISTIC_REGRESSION, JObjective(loss=JLogistic, **obj),
                       solve_cache=JSolveCache(donate=False)).train(jb, initial_model=_ref_zero_model(jds))
        want = np.asarray(jm.to_dense().coefficients)
        want_scores = np.asarray(jm.score(jb))
    np.testing.assert_allclose(m_p.to_dense().coefficients.numpy(), want, rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(m_p.score(tb).numpy(), want_scores, rtol=RTOL64, atol=ATOL64)


@pytest.mark.parametrize("projected", [False, True], ids=["dense", "projected"])
@pytest.mark.parametrize("vtype", ["SIMPLE", "FULL"])
def test_variances_match_reference(vtype, projected):
    eids, X, y, w = _cold_cohort_problem(frac_cold=1, seed=4)
    X[:, 0] = 1.0
    ds, jds = _both_datasets(eids, X, y, w, subspace_projection=projected)
    tb, jb = _batches(eids, X, y, w)
    coord, jcoord = _coordinates(ds, jds, objective=dict(l2_weight=0.5, intercept_index=0),
                                 compute_variance=vtype)
    model, _ = coord.train(tb)
    with jax.enable_x64(True):
        jmodel, _ = jcoord.train(jb, initial_model=_ref_zero_model(jds) if projected else None)
    if projected:
        got, want = model.to_dense().variances, jmodel.to_dense().variances
    else:
        got, want = model.variances, jmodel.variances
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL64)


def test_diverged_entities_keep_their_warm_start():
    """An entity whose residual offsets are not finite is quarantined: its
    coefficients stay at the warm start and its reason is DIVERGED, while
    the others train."""
    eids, X, y, w = _cold_cohort_problem(frac_cold=1)
    ds, jds = _both_datasets(eids, X, y, w)
    tb, _ = _batches(eids, X, y, w)
    coord, _ = _coordinates(ds, jds, active_set=True)
    resid = torch.zeros(tb.n, dtype=torch.float64)
    resid[torch.from_numpy(eids == 5)] = float("nan")
    model, stats = coord.train(tb, resid)
    assert torch.equal(model.coefficients[5], torch.zeros(6, dtype=torch.float64))
    assert stats.num_quarantined == 1 and stats.num_entities == E
    assert bool(torch.all(model.coefficients[6] != 0))
    coord.begin_cd_pass(1)
    coord.train(tb, None, model)
    assert coord.last_active_set_stats["entities_quarantined"] == 1
    reasons = stats.reasons[stats.valid]
    assert int(torch.sum(reasons == REASON_DIVERGED)) == 1
