"""The port's hyperparameter tuning (photon_tpu_torch/hyperparameter/*,
estimators/evaluation_function.py, estimators/batched_tuning.py and the
tuning of cli/game_training.py) on the CPU, against the JAX package.

Every case of tests/test_hyperparameter_tuning.py runs on the port, the
telemetry case included. Against the reference:
- the searches propose the same candidates from the same observations and
  seed (the same numpy code: equal exactly);
- each candidate's sequential evaluation of a small GLMix fixture equals the
  reference's in float64 (metric and coefficients at rtol 1e-5);
- the port's batched lanes equal the reference's batched evaluator in
  float32 within 2e-3 (rtol and atol, the reference's own bar for batched
  against sequential);
- ``game_training --hyper-parameter-tuning BAYESIAN --output-mode TUNED`` on
  the fixture of tests/test_drivers.py gives the same observations
  (log10 λ within 1e-6, values within 1e-3), beats the explicit grid in both
  packages, and each package's TUNED model loads in the other and scores the
  same (1e-6 of max(1, |score|)).
Tuned metrics are the last coordinate-descent pass's in both packages (the
reference keeps the best pass's model with the last pass's metrics).
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.cli import game_training as j_game_training
from photon_tpu.data.game_data import GameBatch as JGameBatch
from photon_tpu.data.index_map import EntityIndex as JEntityIndex
from photon_tpu.data.index_map import IndexMap as JIndexMap
from photon_tpu.data.normalization import NormalizationContext as JNorm
from photon_tpu.estimators import config as jconfig
from photon_tpu.estimators.evaluation_function import GameEstimatorEvaluationFunction as JEvalFn
from photon_tpu.estimators.game_estimator import GameEstimator as JGameEstimator
from photon_tpu.evaluation import EvaluationSuite as JSuite
from photon_tpu.evaluation.suite import EvaluatorSpec as JSpec
from photon_tpu.hyperparameter import search as jsearch
from photon_tpu.hyperparameter import shrink as jshrink
from photon_tpu.io.avro import write_avro_records
from photon_tpu.io.data_reader import FeatureShardConfig as JShardConfig
from photon_tpu.io.data_reader import read_merged as j_read_merged
from photon_tpu.io.model_io import load_game_model as j_load_game_model
from photon_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_tpu.types import TaskType as JTaskType

from photon_tpu_torch.cli import game_training
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.estimators.config import (
    FixedEffectCoordinateConfig,
    GameOptimizationConfig,
    RandomEffectCoordinateConfig,
    RegularizationConfig,
)
from photon_tpu_torch.estimators.evaluation_function import GameEstimatorEvaluationFunction
from photon_tpu_torch.estimators.game_estimator import GameEstimator
from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
from photon_tpu_torch.hyperparameter import search, shrink
from photon_tpu_torch.hyperparameter.search import GaussianProcessSearch, RandomSearch, SearchRange
from photon_tpu_torch.hyperparameter.serialization import (
    config_from_json,
    observations_to_json,
    prior_from_json,
    transform_backward,
    transform_forward,
)
from photon_tpu_torch.hyperparameter.tuner import AtlasTuner, TuningMode
from photon_tpu_torch.io.data_reader import read_merged
from photon_tpu_torch.io.model_io import load_game_model
from photon_tpu_torch.types import TaskType

REPO = Path(__file__).resolve().parent.parent
BATCHED_TOL = 2e-3

# ---------- the vectorization adapter ----------


class _FakeSuite:
    class _P:
        name = "AUC"

        def better(self):
            return lambda a, b: a > b

    primary = _P()


class _FakeResult:
    def __init__(self, config, metrics):
        self.config = config
        self.metrics = metrics


class _FakeEstimator:
    """Quadratic response surface: best AUC at log10 λ_g = 1, log10 λ_u = -1."""

    def __init__(self):
        self.calls = []

    def fit(self, batch, validation_batch=None, evaluation_suite=None, optimization_configs=None, **kw):
        (config,) = optimization_configs
        lg = np.log10(config.reg["global"].weight)
        lu = np.log10(config.reg["perUser"].weight)
        self.calls.append((lg, lu))
        return [_FakeResult(config, {"AUC": 0.9 - 0.05 * (lg - 1.0) ** 2 - 0.05 * (lu + 1.0) ** 2})]


def _base_config():
    return GameOptimizationConfig({"global": RegularizationConfig(weight=1.0),
                                   "perUser": RegularizationConfig(weight=1.0)})


def test_config_vector_round_trip():
    fn = GameEstimatorEvaluationFunction(_FakeEstimator(), _base_config(), None, object(), _FakeSuite(), True)
    assert fn.dim == 2 and fn.names == ["global.weight", "perUser.weight"]
    cfg = GameOptimizationConfig({"global": RegularizationConfig(weight=100.0),
                                  "perUser": RegularizationConfig(weight=0.01)})
    x = fn.config_to_vector(cfg)
    np.testing.assert_allclose(x, [2.0, -2.0])
    back = fn.vector_to_config(x)
    assert back.reg["global"].weight == pytest.approx(100.0)
    assert back.reg["perUser"].weight == pytest.approx(0.01)


def test_elastic_net_adds_alpha_dimension():
    cfg = GameOptimizationConfig({"global": RegularizationConfig(weight=1.0, alpha=0.5),
                                  "locked": RegularizationConfig(weight=0.0)})
    fn = GameEstimatorEvaluationFunction(_FakeEstimator(), cfg, None, object(), _FakeSuite(), True)
    assert fn.dim == 2 and fn.names == ["global.weight", "global.alpha"]
    back = fn.vector_to_config(np.asarray([0.0, 0.25]))
    assert back.reg["global"].weight == pytest.approx(1.0)
    assert back.reg["global"].alpha == pytest.approx(0.25)
    assert back.reg["locked"].weight == 0.0


def test_bayesian_search_beats_grid_on_surface():
    est = _FakeEstimator()
    fn = GameEstimatorEvaluationFunction(est, _base_config(), None, object(), _FakeSuite(), is_opt_max=True)
    grid = [_FakeResult(GameOptimizationConfig({"global": RegularizationConfig(weight=10.0 ** a),
                                                "perUser": RegularizationConfig(weight=10.0 ** b)}),
                        {"AUC": 0.9 - 0.05 * (a - 1.0) ** 2 - 0.05 * (b + 1.0) ** 2})
            for a, b in [(-3.0, 3.0), (3.0, 3.0), (-3.0, -3.0)]]
    priors = fn.convert_observations(grid)
    assert len(priors) == 3
    best_grid_auc = max(r.metrics["AUC"] for r in grid)
    _x, _best_v, obs = AtlasTuner().search(12, fn.dim, TuningMode.BAYESIAN, fn, search_range=fn.search_range,
                                           prior_observations=priors, seed=3)
    assert max(r.metrics["AUC"] for r in fn.results) > best_grid_auc + 0.05
    assert len(obs) == len(priors) + 12


# ---------- JSON serialization ----------


def test_config_from_json():
    cfg = config_from_json(json.dumps({"tuning_mode": "BAYESIAN", "variables": {
        "lambda": {"type": "DOUBLE", "min": 0.0001, "max": 10000.0, "transform": "LOG"},
        "alpha": {"type": "DOUBLE", "min": 0.0, "max": 1.0},
        "depth": {"type": "INT", "min": 1.0, "max": 5.0}}}))
    assert cfg.mode == TuningMode.BAYESIAN
    assert cfg.names == ["lambda", "alpha", "depth"]
    assert cfg.transforms == {0: "LOG"} and cfg.discrete == {2: 5}
    np.testing.assert_allclose(cfg.lower, [0.0001, 0.0, 1.0])


def test_transforms_round_trip():
    x = np.asarray([100.0, 0.25, 9.0])
    t = {0: "LOG", 2: "SQRT"}
    fwd = transform_forward(x, t)
    np.testing.assert_allclose(fwd, [2.0, 0.25, 3.0])
    np.testing.assert_allclose(transform_backward(fwd, t), x)


def test_prior_observations_round_trip():
    obs = [(np.asarray([2.0, 0.5]), 0.85), (np.asarray([-1.0, 0.1]), 0.7)]
    names = ["global.weight", "global.alpha"]
    parsed = prior_from_json(observations_to_json(obs, names), {}, names)
    assert len(parsed) == 2
    np.testing.assert_allclose(parsed[0][0], obs[0][0])
    assert parsed[0][1] == pytest.approx(0.85)
    partial = json.dumps({"records": [{"global.weight": "1.5", "evaluationValue": "0.6"}]})
    np.testing.assert_allclose(prior_from_json(partial, {"global.alpha": 0.0}, names)[0][0], [1.5, 0.0])


def test_atlas_tuner_batch_mode():
    calls = {"batch": 0, "single": 0}

    class BatchFn:
        def __call__(self, x):
            calls["single"] += 1
            return float(np.sum((x - 0.3) ** 2))

        def evaluate_batch(self, X):
            calls["batch"] += 1
            return [float(np.sum((x - 0.3) ** 2)) for x in np.asarray(X)]

    _best_x, best_v, obs = AtlasTuner().search(8, 2, TuningMode.BAYESIAN, BatchFn(),
                                               search_range=SearchRange(np.zeros(2), np.ones(2)), batch_size=4)
    assert calls["batch"] == 2 and calls["single"] == 0
    assert len(obs) >= 8
    assert best_v <= min(v for _, v in obs) + 1e-12


def test_gp_next_batch_distinct_candidates():
    s = GaussianProcessSearch(2, lambda x: float(np.sum(x ** 2)), SearchRange(np.zeros(2), np.ones(2)), seed=5)
    for _ in range(4):  # past min_observations: the GP path
        x = s.next_point()
        s.observe(x, float(np.sum(x ** 2)))
    X = s.next_batch(3)
    assert X.shape == (3, 2)
    assert len({tuple(np.round(row, 9)) for row in X}) == 3


# ---------- the searches against the reference ----------


@pytest.mark.parametrize("kind", ["random", "gp"])
def test_searches_propose_the_reference_candidates(kind):
    """From the same observations and seed, the port's search proposes
    exactly the reference's candidates (the same numpy and scipy code),
    round after round, singly and in batches."""
    rng = np.random.default_rng(41)
    lower, upper = np.array([-4.0, -4.0, 0.0]), np.array([4.0, 4.0, 1.0])
    f = lambda x: float(np.sum((x - np.array([1.0, -1.0, 0.3])) ** 2))  # noqa: E731
    cls, jcls = ((search.RandomSearch, jsearch.RandomSearch) if kind == "random"
                 else (search.GaussianProcessSearch, jsearch.GaussianProcessSearch))
    ours = cls(3, f, search.SearchRange(lower, upper), seed=7)
    ref = jcls(3, f, jsearch.SearchRange(lower, upper), seed=7)
    for x in rng.uniform(lower, upper, size=(4, 3)):
        ours.observe(x, f(x))
        ref.observe(x, f(x))
    for _ in range(3):
        a, b = ours.next_point(), ref.next_point()
        np.testing.assert_array_equal(a, b)
        ours.observe(a, f(a))
        ref.observe(b, f(b))
        A, B = ours.next_batch(3), ref.next_batch(3)
        np.testing.assert_array_equal(A, B)
        for x in A:
            ours.observe(x, f(x))
            ref.observe(x, f(x))
    obs = [(x, v) for x, v in ours.observations]
    got = shrink.shrink_search_range(obs, search.SearchRange(lower, upper), 0.2, candidate_pool_size=64, seed=3)
    want = jshrink.shrink_search_range(obs, jsearch.SearchRange(lower, upper), 0.2, candidate_pool_size=64, seed=3)
    np.testing.assert_array_equal(got.lower, want.lower)
    np.testing.assert_array_equal(got.upper, want.upper)


# ---------- GLMix fixtures ----------


def _glmix_arrays(n=2048, e=32, d_fix=8, d_re=4, seed=13):
    """The reference test's GLMix data: planted fixed and per-user effects."""
    rng = np.random.default_rng(seed)
    Xf = rng.normal(size=(n, d_fix)).astype(np.float32)
    Xf[:, 0] = 1.0
    Xr = rng.normal(size=(n, d_re)).astype(np.float32)
    Xr[:, 0] = 1.0
    users = rng.integers(0, e, size=n).astype(np.int32)
    w_fix = rng.normal(size=d_fix).astype(np.float32)
    w_users = rng.normal(size=(e, d_re)).astype(np.float32)
    logits = Xf @ w_fix + np.sum(Xr * w_users[users], axis=1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return dict(y=y, g=Xf, r=Xr, u=users, e=e)


def _split(a, dtype):
    half = a["y"].shape[0] // 2
    out = []
    for sl in (slice(0, half), slice(half, None)):
        out.append(dict(y=a["y"][sl].astype(dtype), g=a["g"][sl].astype(dtype), r=a["r"][sl].astype(dtype),
                        u=a["u"][sl]))
    return out


def _tbatch(p):
    m = p["y"].shape[0]
    t = torch.from_numpy
    return GameBatch(label=t(p["y"]), offset=torch.zeros(m, dtype=t(p["y"]).dtype),
                     weight=torch.ones(m, dtype=t(p["y"]).dtype), features={"g": t(p["g"]), "r": t(p["r"])},
                     entity_ids={"u": t(p["u"])})


def _jbatch(p):
    m = p["y"].shape[0]
    dt = p["y"].dtype
    return JGameBatch(label=jnp.asarray(p["y"]), offset=jnp.zeros(m, dt), weight=jnp.ones(m, dt),
                      features={"g": jnp.asarray(p["g"]), "r": jnp.asarray(p["r"])},
                      entity_ids={"u": jnp.asarray(p["u"])})


def _port_setup(a, dtype=np.float32, norm=None, locked=()):
    train, valid = _split(a, dtype)
    est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                        coordinate_configs=[FixedEffectCoordinateConfig("fe", "g"),
                                            RandomEffectCoordinateConfig("re", "u", "r")],
                        num_iterations=2, intercept_indices={"g": 0, "r": 0}, num_entities={"u": a["e"]},
                        normalization=norm, locked_coordinates=locked)
    base = GameOptimizationConfig(reg={"fe": RegularizationConfig(weight=1.0), "re": RegularizationConfig(weight=1.0)})
    fn = GameEstimatorEvaluationFunction(est, base, _tbatch(train), _tbatch(valid),
                                         EvaluationSuite([EvaluatorSpec.parse("AUC")]), is_opt_max=True)
    return fn


def _ref_setup(a, dtype=np.float32):
    train, valid = _split(a, dtype)
    est = JGameEstimator(task=JTaskType.LOGISTIC_REGRESSION,
                         coordinate_configs=[jconfig.FixedEffectCoordinateConfig("fe", "g"),
                                             jconfig.RandomEffectCoordinateConfig("re", "u", "r")],
                         num_iterations=2, intercept_indices={"g": 0, "r": 0}, num_entities={"u": a["e"]})
    base = jconfig.GameOptimizationConfig(reg={"fe": jconfig.RegularizationConfig(weight=1.0),
                                               "re": jconfig.RegularizationConfig(weight=1.0)})
    return JEvalFn(est, base, _jbatch(train), _jbatch(valid), JSuite([JSpec.parse("AUC")]), is_opt_max=True)


CANDIDATES = np.array([[0.0, 0.0], [1.0, -1.0], [-1.0, 1.0], [2.0, 2.0]])


# ---------- batched lanes ----------


def test_batched_evaluation_matches_sequential():
    fn = _port_setup(_glmix_arrays())
    lanes = fn._batched_evaluator()
    assert lanes is not None, "GLMix setup must be batchable"
    batched = fn.evaluate_batch(CANDIDATES)
    sequential = [fn(x) for x in CANDIDATES]
    np.testing.assert_allclose(batched, sequential, rtol=BATCHED_TOL, atol=BATCHED_TOL)
    # A second round of the same q builds nothing new and repeats the first.
    counts = lanes.cache.stats.counts()
    assert fn.evaluate_batch(CANDIDATES) == batched
    since = lanes.cache.stats.since(counts)
    assert since["traces"] == 0 and since["captures"] == 0 and since["hits"] == since["calls"] > 0


def test_batched_evaluation_fallback_when_not_batchable(caplog):
    fn = _port_setup(_glmix_arrays(n=512, e=8), locked=["fe"])  # partial retrain is not batchable
    with caplog.at_level(logging.WARNING):
        assert fn._batched_evaluator() is None
    assert any("declined" in r.message for r in caplog.records)
    fn.estimator.locked_coordinates = []
    vals = fn.evaluate_batch(np.array([[0.0, 0.0], [1.0, -1.0]]))  # falls back to sequential fits
    assert len(vals) == 2 and all(np.isfinite(v) for v in vals)
    assert len(fn.results) == 2


def test_batched_evaluation_matches_sequential_with_normalization():
    a = _glmix_arrays(n=1024, e=16)
    rng = np.random.default_rng(5)
    d_fix, d_re = a["g"].shape[1], a["r"].shape[1]
    norm = {"g": NormalizationContext(
                factors=torch.from_numpy(1.0 / rng.uniform(0.5, 3.0, d_fix).astype(np.float32)),
                shifts=torch.from_numpy(np.r_[0.0, rng.normal(size=d_fix - 1)].astype(np.float32)),
                intercept_index=0),
            "r": NormalizationContext(factors=torch.from_numpy(1.0 / rng.uniform(0.5, 2.0, d_re).astype(np.float32)),
                                      shifts=None, intercept_index=0)}
    fn = _port_setup(a, norm=norm)
    assert fn._batched_evaluator() is not None, "normalized GLMix must batch"
    X = CANDIDATES[:3]
    np.testing.assert_allclose(fn.evaluate_batch(X), [fn(x) for x in X], rtol=BATCHED_TOL, atol=BATCHED_TOL)


def test_batched_lanes_match_reference_batched_evaluator():
    """The port's lanes against the reference's vmapped evaluator, both in
    float32, within 2e-3."""
    a = _glmix_arrays()
    ref = _ref_setup(a)
    assert ref._batched_evaluator() is not None
    want = ref.evaluate_batch(CANDIDATES)
    got = _port_setup(a).evaluate_batch(CANDIDATES)
    np.testing.assert_allclose(got, want, rtol=BATCHED_TOL, atol=BATCHED_TOL)


def test_sequential_evaluations_match_reference_f64():
    """Each candidate's sequential evaluation (one GameEstimator.fit) equals
    the reference's in float64: the signed metric and every coefficient at
    rtol 1e-5."""
    a = _glmix_arrays(n=1024, e=16)
    fn = _port_setup(a, dtype=np.float64)
    with jax.enable_x64(True):
        ref = _ref_setup(a, dtype=np.float64)
        want = [ref(x) for x in CANDIDATES[:3]]
        want_models = [{cid: np.asarray(m.coefficients if hasattr(m, "re_type") else m.model.coefficients.means)
                        for cid, m in r.model.models.items()} for r in ref.results]
    got = [fn(x) for x in CANDIDATES[:3]]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
    for r, wm in zip(fn.results, want_models):
        for cid, m in r.model.models.items():
            w = m.coefficients if hasattr(m, "re_type") else m.model.coefficients.means
            np.testing.assert_allclose(w.numpy(), wm[cid], rtol=1e-5, atol=1e-8, err_msg=cid)


# ---------- the driver ----------

GRID_ARGS = ["--feature-shard-configurations", "name=globalShard",
             "--coordinate-configurations",
             # Far-too-strong regularization: the grid underfits badly.
             "name=global,feature.shard=globalShard,optimizer=LBFGS,reg.weights=2000|5000",
             "--update-sequence", "global", "--evaluators", "AUC",
             "--hyper-parameter-tuning", "BAYESIAN", "--hyper-parameter-tuning-iter", "6", "--output-mode", "TUNED"]


def _write_fixture(path, n, rng, d=6, n_users=8):
    """The fixture of tests/test_drivers.py (synthetic logistic GLMix rows)."""
    w = np.linspace(-1, 1, d)
    user_bias = np.linspace(-2, 2, n_users)
    records = []
    for i in range(n):
        x = rng.normal(size=d)
        u = i % n_users
        y = float(rng.uniform() < 1 / (1 + np.exp(-(x @ w + user_bias[u]))))
        records.append({"uid": str(i), "label": y,
                        "features": [{"name": f"x{j}", "term": "", "value": float(x[j])} for j in range(d)],
                        "metadataMap": {"userId": f"u{u}"}, "weight": 1.0, "offset": 0.0})
    write_avro_records(str(path), TRAINING_EXAMPLE_SCHEMA, records)
    return str(path)


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tuning")
    rng = np.random.default_rng(23)
    return {"train": _write_fixture(d / "train.avro", 400, rng), "valid": _write_fixture(d / "valid.avro", 200, rng),
            "dir": d}


def _records(path):
    return json.loads(Path(path).read_text())["records"]


def test_tuned_driver_matches_reference(fixture_files, tmp_path):
    io = ["--input-paths", fixture_files["train"], "--validation-paths", fixture_files["valid"]]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    j_summary = j_game_training.run(j_game_training.build_parser().parse_args(io + GRID_ARGS + ["--output-dir",
                                                                                                 str(jdir)]))
    t_summary = game_training.main(io + GRID_ARGS + ["--output-dir", str(tdir), "--device", "cpu"])
    for summary in (j_summary, t_summary):
        assert len(summary["configs"]) == 2 and len(summary["tuned_configs"]) == 6
        best_grid = max(c["metrics"]["AUC"] for c in summary["configs"])
        best_tuned = max(c["metrics"]["AUC"] for c in summary["tuned_configs"])
        assert best_tuned > best_grid  # tuning beat the explicit grid
        assert summary["best"]["metrics"]["AUC"] == best_tuned
    got, want = _records(tdir / "hyperparameter-observations.json"), _records(jdir / "hyperparameter-observations.json")
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"global.weight", "evaluationValue"}
        assert g["global.weight"] == pytest.approx(w["global.weight"], abs=1e-6)
        assert g["evaluationValue"] == pytest.approx(w["evaluationValue"], abs=1e-3)
    assert t_summary["best"]["config"] == j_summary["best"]["config"]

    # Each package's TUNED model loads in the other and scores the same.
    cfg = {"globalShard": JShardConfig(feature_bags=["features"])}
    jb, _, _ = j_read_merged([fixture_files["valid"]], cfg)
    from photon_tpu_torch.io.data_reader import FeatureShardConfig

    tb, _, _ = read_merged([fixture_files["valid"]], {"globalShard": FeatureShardConfig(feature_bags=["features"])},
                           device="cpu")
    for out in (jdir, tdir):
        jmap = {"globalShard": JIndexMap.load(str(out / "index-map-globalShard.json"))}
        tmap = {"globalShard": IndexMap.load(str(out / "index-map-globalShard.json"))}
        jmodel = j_load_game_model(str(out / "best"), jmap, {"userId": JEntityIndex()})
        tmodel = load_game_model(str(out / "best"), tmap, {"userId": EntityIndex()}, device="cpu")
        want_scores = np.asarray(jmodel.score(jb))
        got_scores = tmodel.score(tb).numpy()
        np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=1e-6 * max(1.0, np.abs(want_scores).max()))


def test_tuned_driver_runs_batched_lanes(fixture_files, tmp_path, caplog):
    """BAYESIAN tuning of a GLMix config, two candidates a round: the lanes
    run (no decline), every candidate is observed, and TUNED saves the
    winner refitted sequentially."""
    argv = ["--input-paths", fixture_files["train"], "--validation-paths", fixture_files["valid"],
            "--feature-shard-configurations", "name=globalShard",
            "--coordinate-configurations", "name=global,feature.shard=globalShard,reg.weights=1|10",
            "name=perUser,feature.shard=globalShard,random.effect.type=userId,reg.weights=1",
            "--update-sequence", "global,perUser", "--coordinate-descent-iterations", "2", "--evaluators", "AUC",
            "--hyper-parameter-tuning", "BAYESIAN", "--hyper-parameter-tuning-iter", "4",
            "--hyper-parameter-batch-size", "2", "--output-mode", "TUNED",
            "--output-dir", str(tmp_path / "o"), "--device", "cpu"]
    with caplog.at_level(logging.WARNING):
        summary = game_training.main(argv)
    assert not any("declined" in r.getMessage() for r in caplog.records)
    records = _records(tmp_path / "o" / "hyperparameter-observations.json")
    assert len(records) == 2 + 4
    assert all(np.isfinite(r["evaluationValue"]) for r in records)
    assert len(summary["tuned_configs"]) == 1  # the winner's sequential refit
    best = max(records[2:], key=lambda r: -r["evaluationValue"])
    assert summary["best"]["metrics"]["AUC"] == pytest.approx(-best["evaluationValue"], abs=BATCHED_TOL)
    assert (tmp_path / "o" / "best" / "model-metadata.json").exists()


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_tuning_loop_telemetry_spans_and_metrics(mode):
    """Each tuning round emits tuning/round{i}/{propose,train,observe}
    spans, the candidate-count gauge is the proposal batch width, and the
    round counter advances, as in the reference."""
    from photon_tpu_torch.hyperparameter.search import RandomSearch
    from photon_tpu_torch.obs import begin_run
    from photon_tpu_torch.obs.metrics import registry
    from photon_tpu_torch.obs.trace import get_spans

    begin_run()
    if mode == "sequential":
        RandomSearch(dim=2, evaluator=lambda x: float(np.sum(x ** 2))).find(2)
        width = 1
    else:
        best, _val = RandomSearch(dim=2, evaluator=lambda x: 0.0).find_batch(
            2, 3, lambda X: [float(np.sum(x ** 2)) for x in X])
        assert best.shape == (2,)
        width = 3
    names = {s.name for s in get_spans()}
    for i in range(2):
        for stage in ("propose", "train", "observe"):
            assert f"tuning/round{i}/{stage}" in names, names
    assert registry().gauge("tuning_candidate_count").value == width
    assert registry().counter("tuning_rounds_total").value == 2
    begin_run()


def test_tuning_modules_import_without_jax():
    """The modules of this slice load in a process where jax and photon_tpu
    never load (tests/conftest.py imports jax here, so this runs in a
    subprocess)."""
    code = (
        "import sys\n"
        "import photon_tpu_torch.io.columnar, photon_tpu_torch.io.data_reader\n"
        "import photon_tpu_torch.hyperparameter, photon_tpu_torch.hyperparameter.criteria\n"
        "import photon_tpu_torch.hyperparameter.gp, photon_tpu_torch.hyperparameter.kernels\n"
        "import photon_tpu_torch.hyperparameter.search, photon_tpu_torch.hyperparameter.serialization\n"
        "import photon_tpu_torch.hyperparameter.shrink, photon_tpu_torch.hyperparameter.tuner\n"
        "import photon_tpu_torch.estimators.evaluation_function, photon_tpu_torch.estimators.batched_tuning\n"
        "import photon_tpu_torch.cli.game_training\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'photon_tpu'"
        " or m.startswith('photon_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
