"""The port's GAME core against the JAX package on the CPU: the estimator,
coordinate descent, the fixed-effect coordinate with its down-sampler, the
models, the evaluation suite and the transformer.

The same numpy data goes through ``photon_tpu`` and ``photon_tpu_torch``.
Float64 runs use jax's scoped x64 context (never the global flag, which
tests/conftest.py pins off) and hold coefficients at rtol 1e-5 (atol 1e-8
for coefficients that are zero up to rounding), the bar of the reference's
own x64 certification; iteration counts and convergence reasons, per pass
and per entity, must be equal. Three coordinates: a fixed effect, a
per-user random effect and a per-item one whose Zipf-like item counts give
blocks of several geometries.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.data.game_data import GameBatch as JGameBatch
from photon_tpu.data.normalization import NormalizationContext as JNorm
from photon_tpu.estimators import config as jconfig
from photon_tpu.estimators.game_estimator import GameEstimator as JGameEstimator
from photon_tpu.estimators.game_transformer import GameTransformer as JGameTransformer
from photon_tpu.evaluation import evaluators as jev
from photon_tpu.evaluation.suite import EvaluationSuite as JSuite
from photon_tpu.evaluation.suite import EvaluatorSpec as JSpec
from photon_tpu.data.batch import LabeledBatch as JLabeledBatch
from photon_tpu.sampling import down_sampler as jds
from photon_tpu.types import OptimizerType as JOptimizerType
from photon_tpu.types import TaskType as JTaskType

from photon_tpu_torch import interop
from photon_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
from photon_tpu_torch.algorithm.fixed_effect import FixedEffectCoordinate
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.data.padding import bucket_grid, bucket_pow2, pad_game_batch
from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
from photon_tpu_torch.estimators import config
from photon_tpu_torch.estimators.game_estimator import GameEstimator, _existing_entity_mask
from photon_tpu_torch.estimators.game_transformer import GameTransformer
from photon_tpu_torch.evaluation import evaluators as tev
from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
from photon_tpu_torch.models.game import GameModel, ProjectedRandomEffectModel, RandomEffectModel
from photon_tpu_torch.ops.losses import LogisticLoss
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.sampling import down_sampler as tds
from photon_tpu_torch.types import OptimizerType, TaskType

REPO = Path(__file__).resolve().parent.parent
RTOL64, ATOL64 = 1e-5, 1e-8
TASK, JTASK = TaskType.LOGISTIC_REGRESSION, JTaskType.LOGISTIC_REGRESSION


def _glmix(n=1536, d_fix=8, d_user=4, d_item=6, n_users=24, n_items=16, seed=0):
    """Planted logistic GLMix data: a fixed effect, per-user and per-item
    effects, item ids drawn Zipf-like (counts vary, so the item blocks take
    several n_max buckets)."""
    rng = np.random.default_rng(seed)
    Xf = rng.normal(size=(n, d_fix))
    Xf[:, 0] = 1.0
    Xu = rng.normal(size=(n, d_user))
    Xu[:, 0] = 1.0
    Xi = rng.normal(size=(n, d_item))
    Xi[:, 0] = 1.0
    users = rng.integers(0, n_users, size=n).astype(np.int32)
    p = 1.0 / np.arange(1, n_items + 1) ** 1.1
    items = rng.choice(n_items, size=n, p=p / p.sum()).astype(np.int32)
    logits = (Xf @ rng.normal(size=d_fix) / np.sqrt(d_fix)
              + np.sum(Xu * rng.normal(scale=1.5, size=(n_users, d_user))[users], axis=1)
              + np.sum(Xi * rng.normal(scale=1.0, size=(n_items, d_item))[items], axis=1))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    return dict(n=n, y=y, features={"global": Xf, "user": Xu, "item": Xi},
                ids={"userId": users, "itemId": items}, num_entities={"userId": n_users, "itemId": n_items})


def _jbatch(data, rows=slice(None)):
    n = data["y"][rows].shape[0]
    return JGameBatch(label=jnp.asarray(data["y"][rows]), offset=jnp.zeros(n), weight=jnp.ones(n),
                      features={k: jnp.asarray(v[rows]) for k, v in data["features"].items()},
                      entity_ids={k: jnp.asarray(v[rows]) for k, v in data["ids"].items()})


def _tbatch(data, rows=slice(None)):
    t = torch.from_numpy
    n = data["y"][rows].shape[0]
    return GameBatch(label=t(data["y"][rows]), offset=torch.zeros(n, dtype=torch.float64),
                     weight=torch.ones(n, dtype=torch.float64),
                     features={k: t(np.ascontiguousarray(v[rows])) for k, v in data["features"].items()},
                     entity_ids={k: t(np.ascontiguousarray(v[rows])) for k, v in data["ids"].items()})


def _configs(pkg, fixed=None, user=None, item=None):
    """(fixed, per_user, per_item) coordinate configs of one package."""
    opt = JOptimizerType if pkg is jconfig else OptimizerType
    conv = lambda kw: {k: (getattr(opt, v.name) if isinstance(v, OptimizerType) else v)  # noqa: E731
                       for k, v in (kw or {}).items()}
    return [pkg.FixedEffectCoordinateConfig("global", "global", **conv(fixed)),
            pkg.RandomEffectCoordinateConfig("per_user", "userId", "user", **conv(user)),
            pkg.RandomEffectCoordinateConfig("per_item", "itemId", "item", **conv(item))]


def _reg(pkg, lam=(1.0, 0.5, 0.5)):
    return pkg.GameOptimizationConfig(reg={cid: pkg.RegularizationConfig(weight=w)
                                           for cid, w in zip(("global", "per_user", "per_item"), lam)})


def _coefs(model) -> dict:
    """Coefficients per coordinate as numpy (projected models densified)."""
    out = {}
    for cid, sub in model.models.items():
        if hasattr(sub, "block_coefs"):
            sub = sub.to_dense()
        out[cid] = np.asarray(sub.coefficients if hasattr(sub, "re_type") else sub.model.coefficients.means)
    return out


def _trace(tracker) -> dict:
    """Per coordinate and pass: (iterations, reasons) of the valid rows."""
    out = {}
    for cid, diags in tracker.items():
        rows = []
        for dg in diags:
            if hasattr(dg, "valid"):
                v = np.asarray(dg.valid)
                rows.append((np.asarray(dg.iterations)[v], np.asarray(dg.reasons)[v]))
            else:
                rows.append((int(dg.iterations), int(dg.reason_code)))
        out[cid] = rows
    return out


def _assert_same_trace(got, want):
    assert got.keys() == want.keys()
    for cid in want:
        assert len(got[cid]) == len(want[cid]), cid
        for (gi, gr), (wi, wr) in zip(got[cid], want[cid]):
            np.testing.assert_array_equal(gi, wi, err_msg=f"{cid} iterations")
            np.testing.assert_array_equal(gr, wr, err_msg=f"{cid} reasons")


def _fit_both(data, passes=2, est_kw=None, fixed=None, user=None, item=None, norm=None):
    """Fit one configuration with both estimators; returns ((coefs, trace,
    result) of the port, of the reference)."""
    est_kw = dict(est_kw or {})
    common = dict(num_iterations=passes, intercept_indices={"global": 0, "user": 0, "item": 0},
                  num_entities=data["num_entities"])
    with jax.enable_x64(True):
        jnorm = None if norm is None else {k: JNorm(**{f: None if v is None else jnp.asarray(v)
                                                      for f, v in ctx.items() if f != "intercept_index"},
                                                   intercept_index=ctx.get("intercept_index"))
                                           for k, ctx in norm.items()}
        jest = JGameEstimator(JTASK, _configs(jconfig, fixed, user, item), normalization=jnorm,
                              **common, **est_kw)
        (jres,) = jest.fit(_jbatch(data), optimization_configs=[_reg(jconfig)])
        want = (_coefs(jres.model), _trace(jres.tracker), jres)
    tnorm = None if norm is None else {k: NormalizationContext(
        **{f: None if v is None else torch.from_numpy(v) for f, v in ctx.items() if f != "intercept_index"},
        intercept_index=ctx.get("intercept_index")) for k, ctx in norm.items()}
    est = GameEstimator(TASK, _configs(config, fixed, user, item), normalization=tnorm, **common, **est_kw)
    (res,) = est.fit(_tbatch(data), optimization_configs=[_reg(config)])
    return (_coefs(res.model), _trace(res.tracker), res), want


def _assert_fit_parity(got, want):
    for cid in want[0]:
        np.testing.assert_allclose(got[0][cid], want[0][cid], rtol=RTOL64, atol=ATOL64, err_msg=cid)
    _assert_same_trace(got[1], want[1])


# Every route of the random-effect solve, each against the reference:
#   dense       — default spec: batched Newton at d ≤ 128 (per user, per item);
#   pearson     — feature-masked entities: batched margin L-BFGS;
#   shifted     — shift normalization: margin L-BFGS (Newton refuses shifts);
#   masked_shifted — mask and shifts together: batched gradient-form L-BFGS;
#   wide        — per item at d = 130 (bucketed to 192 > 128): margin L-BFGS;
#   newton_wide — the same width under an explicit NEWTON spec: Newton;
#   downsampled — the fixed effect under the down-sampler's masks.
ROUTES = {
    "dense": {},
    "pearson": dict(user=dict(features_to_samples_ratio=0.05), item=dict(features_to_samples_ratio=0.04)),
    "shifted": dict(norm="shifts"),
    "masked_shifted": dict(norm="shifts", item=dict(features_to_samples_ratio=0.04)),
    "wide": dict(d_item=130),
    "newton_wide": dict(d_item=130, item=dict(optimizer=OptimizerType.NEWTON, max_iter=20)),
    "downsampled": dict(fixed=dict(down_sampling_rate=0.5)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_estimator_fit_matches_reference(route):
    kw = dict(ROUTES[route])
    data = _glmix(d_item=kw.pop("d_item", 6), seed=len(route))
    if kw.pop("norm", None):
        norm = {}
        for shard in ("user", "item"):
            X = data["features"][shard]
            mean, std = X.mean(0), X.std(0)
            mean[0], std[0] = 0.0, 1.0
            std[std == 0] = 1.0
            norm[shard] = dict(factors=1.0 / std, shifts=mean, intercept_index=0)
        kw["norm"] = norm
    got, want = _fit_both(data, **kw)
    _assert_fit_parity(got, want)


def test_lambda_sweep_and_warm_start_model_match_reference():
    """A regularization grid (two weights for the per-user effect,
    strongest first, each configuration warm-started from the last), with
    a warm-start model that has no record of item 15 (a rare one), so the
    per-item lower bound of 60 samples is waived for it: every
    configuration's coefficients and traces equal the reference's."""
    data = _glmix(seed=13)
    kw = dict(num_iterations=1, intercept_indices={"global": 0, "user": 0, "item": 0},
              num_entities=data["num_entities"], ignore_threshold_for_new_models=True)
    item = dict(active_lower_bound=60)

    def cfgs(pkg):
        c = _configs(pkg, item=item)
        c[1].reg_weights, c[2].reg_weights = (0.5, 2.0), (1.0,)
        c[0].reg_weights = (1.0,)
        return c

    with jax.enable_x64(True):
        from photon_tpu.models.game import GameModel as JGameModel, RandomEffectModel as JREModel
        present = np.ones(16, bool)
        present[15] = False
        jwarm = JGameModel({"per_item": JREModel(jnp.zeros((16, 6)), "itemId", "item", JTASK,
                                                 present_entities=jnp.asarray(present))})
        jres = JGameEstimator(JTASK, cfgs(jconfig), warm_start_model=jwarm, **kw).fit(_jbatch(data))
        want = [(_coefs(r.model), _trace(r.tracker), r.config.describe()) for r in jres]
    warm = GameModel({"per_item": RandomEffectModel(torch.zeros(16, 6, dtype=torch.float64), "itemId", "item", TASK,
                                                    present_entities=torch.from_numpy(present))})
    res = GameEstimator(TASK, cfgs(config), warm_start_model=warm, **kw).fit(_tbatch(data))
    assert [r.config.describe() for r in res] == [w[2] for w in want]
    assert len(res) == 2
    for r, (wc, wt, _) in zip(res, want):
        for cid in wc:
            np.testing.assert_allclose(_coefs(r.model)[cid], wc[cid], rtol=RTOL64, atol=ATOL64, err_msg=cid)
        _assert_same_trace(_trace(r.tracker), wt)


def test_estimator_active_set_matches_reference():
    """Three passes with the active set on: the gated passes re-solve only
    the entities still moving, in the reference's repacked layout."""
    data = _glmix(n=2048, n_users=40, seed=11)
    # A cold cohort of users with all-zero features retires after pass 1.
    cold = data["ids"]["userId"] % 3 != 0
    data["features"]["user"][cold] = 0.0
    got, want = _fit_both(data, passes=3, est_kw=dict(re_active_set=True, re_convergence_tol=1e-3),
                          user=dict(optimizer=OptimizerType.NEWTON, max_iter=25, tol=1e-9))
    _assert_fit_parity(got, want)
    skipped = [len(it) for it, _ in got[1]["per_user"]]
    assert skipped[0] == 40 and skipped[1] < 40  # pass 2 re-solved a subset


def test_glmix_beats_fixed_only_and_validation_tracks_best():
    data = _glmix(n=2048, seed=3)
    batch = _tbatch(data)
    suite = EvaluationSuite([EvaluatorSpec.parse("AUC"), EvaluatorSpec.parse("AUC:userId")],
                            num_entities=data["num_entities"])
    est = GameEstimator(TASK, _configs(config), num_iterations=2,
                        intercept_indices={"global": 0, "user": 0, "item": 0},
                        num_entities=data["num_entities"])
    (res,) = est.fit(batch, validation_batch=batch, evaluation_suite=suite,
                     optimization_configs=[_reg(config)])
    fe = GameEstimator(TASK, _configs(config)[:1], num_iterations=1, intercept_indices={"global": 0})
    (fe_res,) = fe.fit(batch, validation_batch=batch, evaluation_suite=suite,
                       optimization_configs=[config.GameOptimizationConfig(
                           reg={"global": config.RegularizationConfig(1.0)})])
    assert res.metrics["AUC"] > fe_res.metrics["AUC"] + 0.03
    assert est.select_best([fe_res, res], suite) is res
    stats = res.tracker["per_user"][-1]
    assert stats.num_entities == data["num_entities"]["userId"]
    assert stats.num_converged == stats.num_entities
    assert "entities=" in stats.summary()


def test_cold_start_entities_score_zero():
    data = _glmix(seed=4)
    est = GameEstimator(TASK, _configs(config), intercept_indices={"global": 0, "user": 0, "item": 0},
                        num_entities=data["num_entities"])
    (res,) = est.fit(_tbatch(data), optimization_configs=[_reg(config)])
    cold = _tbatch(data)
    cold = GameBatch(cold.label, cold.offset, cold.weight, cold.features,
                     {k: torch.full_like(v, -1) for k, v in cold.entity_ids.items()})
    for cid in ("per_user", "per_item"):
        assert float(torch.max(torch.abs(res.model.models[cid].score(cold)))) == 0.0


def _cd_both(data, passes, make_port, make_ref, initial=None):
    """Run a CoordinateDescent built by each package's factory."""
    with jax.enable_x64(True):
        jcd = make_ref()
        jr = jcd.run(_jbatch(data), initial_model=None if initial is None else initial[1])
    r = make_port().run(_tbatch(data), initial_model=None if initial is None else initial[0])
    return r, jr


def _coordinates(pkg, data, locked_model=None):
    """(fixed, per_user) coordinates of one package, as tests/test_game_e2e.py
    builds them."""
    if pkg == "ref":
        from photon_tpu.algorithm import FixedEffectCoordinate as JFixed, RandomEffectCoordinate as JRandom
        from photon_tpu.data.random_effect import RandomEffectDataConfig as JCfg
        from photon_tpu.data.random_effect import build_random_effect_dataset as j_build
        from photon_tpu.ops import GLMObjective as JObj, LogisticLoss as JLog
        from photon_tpu.optim.factory import OptimizerSpec as JSpecO
        fixed = JFixed("global", "global", JTASK, JObj(loss=JLog, l2_weight=1.0, intercept_index=0), JSpecO())
        ds = j_build(data["ids"]["userId"], data["features"]["user"], data["y"], np.ones(data["n"]),
                     data["num_entities"]["userId"], JCfg(re_type="userId", feature_shard="user"))
        rand = JRandom("per_user", ds, JTASK, JObj(loss=JLog, l2_weight=0.5, intercept_index=0))
        return fixed, rand
    fixed = FixedEffectCoordinate("global", "global", TASK,
                                  GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0),
                                  OptimizerSpec())
    ds = build_random_effect_dataset(data["ids"]["userId"], data["features"]["user"], data["y"],
                                     np.ones(data["n"]), data["num_entities"]["userId"],
                                     RandomEffectDataConfig(re_type="userId", feature_shard="user"), device="cpu")
    rand = RandomEffectCoordinate("per_user", ds, TASK,
                                  GLMObjective(loss=LogisticLoss, l2_weight=0.5, intercept_index=0))
    return fixed, rand


def _cd_factory(pkg, data, passes, **kw):
    def make():
        fixed, rand = _coordinates(pkg, data)
        if pkg == "ref":
            from photon_tpu.algorithm import CoordinateDescent as JCD
            return JCD({"global": fixed, "per_user": rand}, ["global", "per_user"], num_iterations=passes, **kw)
        return CoordinateDescent({"global": fixed, "per_user": rand}, ["global", "per_user"],
                                 num_iterations=passes, **kw)
    return make


def test_warm_start_initial_model_matches_reference():
    data = _glmix(seed=5)
    first, jfirst = _cd_both(data, 1, _cd_factory("port", data, 1), _cd_factory("ref", data, 1))
    second, jsecond = _cd_both(data, 1, _cd_factory("port", data, 1), _cd_factory("ref", data, 1),
                               initial=(first.model, jfirst.model))
    for got, want in ((first, jfirst), (second, jsecond)):
        gc, wc = _coefs(got.model), _coefs(want.model)
        for cid in wc:
            np.testing.assert_allclose(gc[cid], wc[cid], rtol=RTOL64, atol=ATOL64)
        _assert_same_trace(_trace(got.tracker), _trace(want.tracker))


def test_locked_coordinates():
    data = _glmix(seed=6)
    fixed, rand = _coordinates("port", data)
    pretrained = CoordinateDescent({"global": fixed}, ["global"]).run(_tbatch(data)).model
    cd = CoordinateDescent({"global": fixed, "per_user": rand}, ["global", "per_user"],
                           locked_coordinates=["global"])
    result = cd.run(_tbatch(data), initial_model=pretrained)
    assert torch.equal(result.model.models["global"].model.coefficients.means,
                       pretrained.models["global"].model.coefficients.means)
    with pytest.raises(ValueError):
        CoordinateDescent({"global": fixed, "per_user": rand}, ["global", "per_user"],
                          locked_coordinates=["global"]).run(_tbatch(data))
    with pytest.raises(ValueError, match="unknown"):
        CoordinateDescent({"global": fixed}, ["global", "nope"])
    with pytest.raises(ValueError, match="duplicate"):
        CoordinateDescent({"global": fixed}, ["global", "global"])


def test_tracker_wall_times_and_summary():
    data = _glmix(seed=7)
    result = _cd_factory("port", data, 2)().run(_tbatch(data))
    assert len(result.wall_times["global"]) == 2 and len(result.wall_times["per_user"]) == 2
    assert all(t > 0 for t in result.wall_times["global"])
    s = result.summary()
    assert "coordinate 'global', CD pass 0 (wall" in s
    assert "iter    loss           |grad|" in s
    assert "entities=" in s


def test_normalization_folded_matches_explicit_pretransform():
    """A fit with folded normalization on raw features scores as the same
    fit without normalization on standardized features (and as the
    reference's folded fit)."""
    rng = np.random.default_rng(42)
    n, e = 1024, 12
    scales = np.array([1.0, 50.0, 0.02, 7.0, 300.0, 0.5])
    Xf = rng.normal(size=(n, 6)) * scales + 2.0 * scales
    Xf[:, 0] = 1.0
    Xr = rng.normal(size=(n, 3)) * np.array([1.0, 20.0, 0.1])
    Xr[:, 0] = 1.0
    users = rng.integers(0, e, size=n).astype(np.int32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-((Xf / (scales + 1.0)) @ rng.normal(size=6))))).astype(float)

    def std(X):
        mean, sd = X.mean(0), X.std(0)
        mean[0], sd[0] = 0.0, 1.0
        return dict(factors=1.0 / sd, shifts=mean, intercept_index=0), (X - mean) / sd

    ctx_f, Xf_e = std(Xf.copy())
    ctx_r, Xr_e = std(Xr.copy())
    cfgs = lambda pkg: [pkg.FixedEffectCoordinateConfig("global", "global"),  # noqa: E731
                        pkg.RandomEffectCoordinateConfig("per_user", "userId", "per_user")]
    reg = lambda pkg: pkg.GameOptimizationConfig(reg={"global": pkg.RegularizationConfig(1.0),  # noqa: E731
                                                      "per_user": pkg.RegularizationConfig(1.0)})

    def data_of(a, b):
        return dict(n=n, y=y, features={"global": a, "per_user": b}, ids={"userId": users})

    def fit(d, norm):
        tn = None if norm is None else {k: NormalizationContext(torch.from_numpy(c["factors"]),
                                                                torch.from_numpy(c["shifts"]), 0)
                                         for k, c in norm.items()}
        est = GameEstimator(TASK, cfgs(config), num_iterations=2, normalization=tn,
                            intercept_indices={"global": 0, "per_user": 0}, num_entities={"userId": e})
        (res,) = est.fit(_tbatch(d), optimization_configs=[reg(config)])
        return res.model

    folded = fit(data_of(Xf, Xr), {"global": ctx_f, "per_user": ctx_r})
    explicit = fit(data_of(Xf_e, Xr_e), None)
    s_folded = folded.score(_tbatch(data_of(Xf, Xr))).numpy()
    np.testing.assert_allclose(s_folded, explicit.score(_tbatch(data_of(Xf_e, Xr_e))).numpy(),
                               rtol=2e-3, atol=2e-3)
    with jax.enable_x64(True):
        jn = {k: JNorm(jnp.asarray(c["factors"]), jnp.asarray(c["shifts"]), 0)
              for k, c in (("global", ctx_f), ("per_user", ctx_r))}
        jest = JGameEstimator(JTASK, cfgs(jconfig), num_iterations=2, normalization=jn,
                              intercept_indices={"global": 0, "per_user": 0}, num_entities={"userId": e})
        (jres,) = jest.fit(_jbatch(data_of(Xf, Xr)), optimization_configs=[reg(jconfig)])
        want = np.asarray(jres.model.score(_jbatch(data_of(Xf, Xr))))
    np.testing.assert_allclose(s_folded, want, rtol=RTOL64, atol=1e-7)


def test_fixed_effect_variances_are_in_model_space():
    """The coordinate scales its variances by factors², as the reference
    coordinate does."""
    data = _glmix(seed=8)
    X = data["features"]["global"]
    f = 1.0 / np.maximum(X.std(0), 1e-3)
    f[0] = 1.0
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0,
                       normalization=NormalizationContext(torch.from_numpy(f), None, 0))
    coord = FixedEffectCoordinate("global", "global", TASK, obj, compute_variance="SIMPLE")
    model, _ = coord.train(_tbatch(data))
    from photon_tpu.algorithm import FixedEffectCoordinate as JFixed
    from photon_tpu.ops import GLMObjective as JObj, LogisticLoss as JLog
    with jax.enable_x64(True):
        jobj = JObj(loss=JLog, l2_weight=1.0, intercept_index=0,
                    normalization=JNorm(jnp.asarray(f), None, 0))
        jmodel, _ = JFixed("global", "global", JTASK, jobj, compute_variance="SIMPLE").train(_jbatch(data))
        want = np.asarray(jmodel.model.coefficients.variances)
    np.testing.assert_allclose(model.model.coefficients.variances.numpy(), want, rtol=RTOL64)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("rate,seed", [(0.5, 0), (0.3, 7), (0.9, 123)])
@pytest.mark.parametrize("kind", ["binary", "default"])
def test_down_sampler_masks_match_reference(kind, rate, seed, dtype):
    """The port's masks are the reference's, bit for bit: float32 draws
    for float32 data, float64 draws (the reference under x64) for float64."""
    rng = np.random.default_rng(seed)
    n = 1000 + seed
    npdt = np.float64 if dtype == "f64" else np.float32
    y = (rng.uniform(size=n) < 0.4).astype(npdt)
    w = rng.uniform(0.5, 2.0, size=n).astype(npdt)
    X = rng.normal(size=(n, 3)).astype(npdt)
    jcls = jds.BinaryClassificationDownSampler if kind == "binary" else jds.DefaultDownSampler
    tcls = tds.BinaryClassificationDownSampler if kind == "binary" else tds.DefaultDownSampler
    assert jax.config.jax_threefry_partitionable  # the layout sampling/threefry.py draws
    with jax.enable_x64(dtype == "f64"):
        want = np.asarray(jcls(rate, seed).apply(JLabeledBatch(jnp.asarray(y), jnp.asarray(X), None,
                                                               jnp.asarray(w))).weight)
        masks = [np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), salt), (n,)) < rate)
                 for salt in (0, 1, 5)]
    got = tcls(rate, seed).apply(LabeledBatch(torch.from_numpy(y), torch.from_numpy(X),
                                              None, torch.from_numpy(w))).weight.numpy()
    np.testing.assert_array_equal(got, want)
    for salt, m in zip((0, 1, 5), masks):
        np.testing.assert_array_equal(tcls(rate, seed).keep_mask(n, salt, npdt), m)
    assert type(tds.down_sampler_for_task(TASK, rate)) is tds.BinaryClassificationDownSampler
    assert type(tds.down_sampler_for_task(TaskType.LINEAR_REGRESSION, rate)) is tds.DefaultDownSampler


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_evaluators_match_reference(seed):
    rng = np.random.default_rng(seed)
    n, G = 600, 17
    scores = np.round(rng.normal(size=n), 1)  # ties
    labels = (rng.uniform(size=n) < 0.4).astype(np.float64)
    gids = rng.integers(-1, G, size=n).astype(np.int32)  # -1: cold start, left out
    gids[gids == 5] = 6  # an empty group
    w = rng.uniform(0.5, 2.0, size=n)
    t = torch.from_numpy
    with jax.enable_x64(True):
        js, jl, jg, jw = (jnp.asarray(a) for a in (scores, labels, gids, w))
        want_auc = float(jev.grouped_auc(js, jl, jg, G, jw))
        want_p = [float(jev.grouped_precision_at_k(js, jl, jg, G, k)) for k in (1, 3, 10)]
    assert float(tev.grouped_auc(t(scores), t(labels), t(gids), G, t(w))) == pytest.approx(want_auc, rel=1e-12)
    for k, wp in zip((1, 3, 10), want_p):
        assert float(tev.grouped_precision_at_k(t(scores), t(labels), t(gids), G, k)) == pytest.approx(wp, rel=1e-12)


def test_evaluation_suite_parses_and_matches_reference():
    data = _glmix(seed=9)
    specs = ["AUC", "AUC:userId", "PRECISION@3:itemId", "LOGISTIC_LOSS", "PRECISION@5"]
    rng = np.random.default_rng(9)
    scores = rng.normal(size=data["n"])
    suite = EvaluationSuite([EvaluatorSpec.parse(s) for s in specs], num_entities=data["num_entities"])
    got = suite.evaluate_scores(torch.from_numpy(scores), _tbatch(data))
    with jax.enable_x64(True):
        jsuite = JSuite([JSpec.parse(s) for s in specs], num_entities=data["num_entities"])
        want = jsuite.evaluate_scores(jnp.asarray(scores), _jbatch(data))
    assert list(got) == specs
    for k in specs:
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    assert EvaluatorSpec.parse("PRECISION@3:itemId").k == 3
    assert suite.primary.better()(0.7, 0.6)


def test_transformer_and_interop_score_the_reference_model():
    """A reference model carried across scores the same in both packages,
    through GameModel and GameTransformer (with padding rows)."""
    data = _glmix(seed=10)
    with jax.enable_x64(True):
        jest = JGameEstimator(JTASK, _configs(jconfig), num_entities=data["num_entities"],
                              intercept_indices={"global": 0, "user": 0, "item": 0})
        (jres,) = jest.fit(_jbatch(data), optimization_configs=[_reg(jconfig)])
        jsuite = JSuite([JSpec.parse("AUC")])
        jt = JGameTransformer(jres.model, jsuite)
        want = np.asarray(jt.transform(_jbatch(data)))
        want_auc = jt.last_metrics["AUC"]
        ref_model = jres.model
    model = interop.game_model(ref_model, device="cpu")
    tt = GameTransformer(model, EvaluationSuite([EvaluatorSpec.parse("AUC")]))
    np.testing.assert_allclose(tt.transform(_tbatch(data)).numpy(), want, rtol=1e-12, atol=1e-12)
    assert tt.last_metrics["AUC"] == pytest.approx(want_auc, rel=1e-12)
    template = _tbatch(data, slice(0, 1))
    assert tt.warm_up(template, bucket_grid(5)) == len(bucket_grid(5))
    assert tt.warm_up(template, bucket_grid(5)) == 0
    padded = pad_game_batch(_tbatch(data, slice(0, 5)), 8)
    assert padded.n == 8 and float(padded.weight[5:].sum()) == 0.0
    assert (padded.entity_ids["userId"][5:] == -1).all()
    np.testing.assert_allclose(model.score(padded)[:5].numpy(), model.score(_tbatch(data, slice(0, 5))).numpy())
    assert bucket_pow2(5) == 8 and bucket_grid(7) == [1, 2, 3, 4, 6, 8]
    assert model.feature_shard_dims() == {"global": 8, "user": 4, "item": 6}


def test_active_lower_bound_and_ignore_threshold_for_new_models():
    counts = [5, 2, 2, 5]
    eids = np.concatenate([np.full(c, e, np.int32) for e, c in enumerate(counts)])
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(eids.size, 3))
    y = (rng.uniform(size=eids.size) < 0.5).astype(float)
    cfg = RandomEffectDataConfig(re_type="userId", feature_shard="re", active_lower_bound=3, n_buckets=1)

    def trainable(ds):
        return {int(e): bool(m) for b in ds.blocks for e, m in zip(b.entity_idx.tolist(), b.train_mask.tolist())
                if e >= 0}

    build = lambda **kw: build_random_effect_dataset(eids, feats, y, np.ones(eids.size), 4, cfg,  # noqa: E731
                                                     device="cpu", **kw)
    assert trainable(build()) == {0: True, 1: False, 2: False, 3: True}
    existing = np.array([True, True, False, True])
    assert trainable(build(existing_model_mask=existing)) == {0: True, 1: False, 2: True, 3: True}


def test_ignore_threshold_requires_warm_start_model():
    with pytest.raises(ValueError, match="warm-start"):
        GameEstimator(TASK, [config.FixedEffectCoordinateConfig("global", "global")],
                      ignore_threshold_for_new_models=True)


def test_existing_entity_mask_model_types():
    proj = ProjectedRandomEffectModel(
        block_coefs=[torch.zeros(2, 3)], col_maps=[torch.arange(3)], inv_maps=[torch.arange(3)],
        entity_block=torch.tensor([0, -1, 0]), entity_row=torch.tensor([0, 0, 1]), d_full=3,
        re_type="userId", feature_shard="re", task=TASK)
    np.testing.assert_array_equal(_existing_entity_mask(proj), [True, False, True])
    dense = RandomEffectModel(torch.tensor([[0.0, 0.0], [1.0, 0.0]]), "userId", "re", TASK)
    np.testing.assert_array_equal(_existing_entity_mask(dense), [True, True])
    with_mask = RandomEffectModel(torch.zeros(3, 2), "userId", "re", TASK,
                                  present_entities=torch.tensor([True, False, True]))
    np.testing.assert_array_equal(_existing_entity_mask(with_mask), [True, False, True])
    with pytest.raises(TypeError, match="RandomEffectModel"):
        _existing_entity_mask(object())


def test_unported_machinery_raises_not_ported_yet(tmp_path):
    data = _glmix(seed=12)
    batch = _tbatch(data)
    l1 = config.GameOptimizationConfig(reg={"global": config.RegularizationConfig(1.0),
                                            "per_user": config.RegularizationConfig(1.0, alpha=0.5),
                                            "per_item": config.RegularizationConfig(1.0)})
    est = GameEstimator(TASK, _configs(config), num_entities=data["num_entities"])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        est.fit(batch, optimization_configs=[l1])
    tron = GameEstimator(TASK, _configs(config, user=dict(optimizer=OptimizerType.TRON)),
                         num_entities=data["num_entities"])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tron.fit(batch, optimization_configs=[_reg(config)])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        est.fit(batch, optimization_configs=[_reg(config)], checkpoint_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        GameEstimator(TASK, _configs(config), re_device_budget_mb=1.0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_random_effect_dataset(data["ids"]["userId"], (np.zeros((data["n"], 2), np.int32),
                                                            np.ones((data["n"], 2)), 50),
                                    data["y"], np.ones(data["n"]), 24,
                                    RandomEffectDataConfig("userId", "wide"), device="cpu")


def test_game_modules_import_without_jax():
    """The GAME modules load in a process where jax and photon_tpu never
    load (tests/conftest.py imports jax here, so this runs in a subprocess)."""
    code = (
        "import sys\n"
        "import photon_tpu_torch.algorithm.coordinate_descent, photon_tpu_torch.algorithm.fixed_effect\n"
        "import photon_tpu_torch.algorithm.random_effect, photon_tpu_torch.algorithm.solve_cache\n"
        "import photon_tpu_torch.estimators.game_estimator, photon_tpu_torch.estimators.game_transformer\n"
        "import photon_tpu_torch.evaluation.suite, photon_tpu_torch.data.padding, photon_tpu_torch.interop\n"
        "import photon_tpu_torch.sampling.down_sampler, photon_tpu_torch.optim.batched\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'photon_tpu'"
        " or m.startswith('photon_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
