"""The port's incremental generations (photon_tpu_torch/train/incremental.py,
cli/game_incremental.py), held as tests/test_rollout.py holds the
reference's: the row merge, the generation chain that keeps unchanged
entities verbatim, the gate's refusal of corrupted generations and the
quarantined entity that heals, on the CPU. Then against the reference:
``incremental_update`` of both packages on copies of one publish root in
float64 (changed rows at rtol 1e-5 with equal iteration counts and stop
reasons per pass, unchanged rows bit for bit, the same manifest keys and
gate verdict), and both packages' ``game_incremental`` drivers in float32
(metrics and coefficients within 1e-3).

Which pass's model and metrics each side carries: both packages' fits here
have one configuration, so ``select_best`` returns the last pass's result;
the generation saved is that result's model (the estimator's best pass,
ROADMAP queue 3) merged over the parent, and the manifest's holdout metrics
are taken on that merged model by ``compute_holdout_metrics``.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.models.game import RandomEffectModel
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import faults
from photon_tpu_torch.utils.faults import FaultPlan, FaultRule

T = torch.as_tensor
D_RE = 4


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


def test_merge_random_effect_keeps_unchanged_rows_verbatim():
    from photon_tpu_torch.train.incremental import changed_entity_mask, merge_random_effect

    E = 6
    parent = RandomEffectModel(T(np.arange(E * D_RE, dtype=np.float32).reshape(E, D_RE)), "userId", "shardB",
                               TaskType.LOGISTIC_REGRESSION)
    trained = RandomEffectModel(T(-np.ones((E, D_RE), np.float32)), "userId", "shardB",
                                TaskType.LOGISTIC_REGRESSION)
    users = np.asarray([1, 1, 4], np.int32)
    batch = GameBatch(label=torch.zeros(3), offset=torch.zeros(3), weight=torch.ones(3),
                      features={"shardB": torch.zeros((3, D_RE))}, entity_ids={"userId": T(users)})
    changed = changed_entity_mask(batch, "userId", E)
    assert changed.tolist() == [False, True, False, False, True, False]
    merged = merge_random_effect(parent, trained, changed)
    coefs = merged.coefficients.numpy()
    p = parent.coefficients.numpy()
    np.testing.assert_array_equal(coefs[[0, 2, 3, 5]], p[[0, 2, 3, 5]])
    assert (coefs[[1, 4]] == -1.0).all()
    assert merged.present_entities.tolist() == [True] * E

    # A feature-dimension change is a hard error, not a silent merge.
    wider = RandomEffectModel(torch.zeros((E, D_RE + 1)), "userId", "shardB", TaskType.LOGISTIC_REGRESSION)
    with pytest.raises(ValueError):
        merge_random_effect(parent, wider, changed)


def _planted(E, d_fix, d_re, seed):
    r = np.random.default_rng(seed)
    return r.normal(size=d_fix).astype(np.float32), r.normal(scale=1.5, size=(E, d_re)).astype(np.float32)


def _arrays(n, entities, seed, w_fix, w_re):
    rr = np.random.default_rng(seed)
    d_fix, d_re = w_fix.shape[0], w_re.shape[1]
    Xf = rr.normal(size=(n, d_fix)).astype(np.float32)
    Xf[:, 0] = 1.0
    Xr = rr.normal(size=(n, d_re)).astype(np.float32)
    Xr[:, 0] = 1.0
    users = rr.choice(np.asarray(entities, np.int32), size=n)
    logits = Xf @ w_fix + np.sum(Xr * w_re[users], axis=1)
    y = (rr.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return Xf, Xr, users, y


def _training_fixture(E=16, d_fix=5, d_re=3, seed=9, dtype=torch.float32):
    """tests/test_rollout.py::_training_fixture with the port's batches."""
    w_fix, w_re = _planted(E, d_fix, d_re, seed)

    def batch(n, entities, seed):
        Xf, Xr, users, y = _arrays(n, entities, seed, w_fix, w_re)
        return GameBatch(label=T(y).to(dtype), offset=torch.zeros(n, dtype=dtype), weight=torch.ones(n, dtype=dtype),
                         features={"global": T(Xf).to(dtype), "per_user": T(Xr).to(dtype)},
                         entity_ids={"userId": T(users)})

    imaps = {"global": IndexMap.build([f"g{j}" for j in range(d_fix)]),
             "per_user": IndexMap.build([f"r{j}" for j in range(d_re)])}
    eidx = EntityIndex()
    for e in range(E):
        eidx.intern(f"user{e}")
    return batch, imaps, eidx, E


def _train_configs():
    from photon_tpu_torch.estimators.config import FixedEffectCoordinateConfig, RandomEffectCoordinateConfig

    return [FixedEffectCoordinateConfig("global", "global"),
            RandomEffectCoordinateConfig("per_user", "userId", "per_user")]


def _save_artifacts(root, imaps, eidx):
    for shard, imap in imaps.items():
        imap.save(os.path.join(root, f"index-map-{shard}.json"))
    eidx.save(os.path.join(root, "entity-index-userId.json"))


def _publish_gen1(root, dtype=torch.float32):
    """gen-1: a full fit of every entity, published with its holdout
    metrics. Returns the fixture and the validation batch."""
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.io.model_io import gate_and_publish, save_game_model, write_generation_manifest
    from photon_tpu_torch.train.incremental import compute_holdout_metrics

    batch, imaps, eidx, E = _training_fixture(dtype=dtype)
    _save_artifacts(root, imaps, eidx)
    suite = EvaluationSuite([EvaluatorSpec.parse("AUC")], num_entities={"userId": E})
    full, valid = batch(512, list(range(E)), seed=11), batch(256, list(range(E)), seed=12)
    est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=_train_configs(), num_iterations=2,
                        num_entities={"userId": E})
    (res,) = est.fit(full, validation_batch=valid, evaluation_suite=suite)
    g1 = os.path.join(root, "gen-1")
    save_game_model(res.model, g1, imaps, {"userId": eidx}, sparsity_threshold=0.0)
    write_generation_manifest(g1, parent=None, holdout_metrics=compute_holdout_metrics(res.model, valid, suite))
    assert gate_and_publish(root, "gen-1").ok
    return batch, imaps, eidx, E, suite, valid


def test_incremental_update_chain_preserves_unchanged_entities(tmp_path):
    from photon_tpu_torch.io.model_io import load_game_model, load_generation_manifest
    from photon_tpu_torch.train.incremental import incremental_update

    root = str(tmp_path)
    batch, imaps, eidx, E, suite, valid = _publish_gen1(root)
    g1 = os.path.join(root, "gen-1")
    # Only entities 0..3 have fresh data: the rest must ride along verbatim.
    delta = batch(192, list(range(4)), seed=21)
    result = incremental_update(root, delta, imaps, {"userId": eidx}, TaskType.LOGISTIC_REGRESSION, _train_configs(),
                                ["global", "per_user"], valid_batch=valid, evaluation_suite=suite, num_iterations=2,
                                metric_tolerance=0.1, device="cpu")
    assert result.generation == "gen-2"
    assert result.published, result.gate_reason
    assert result.changed_entities == {"userId": 4}

    parent = load_game_model(g1, imaps, {"userId": eidx}, device="cpu")
    child = load_game_model(result.model_dir, imaps, {"userId": eidx}, device="cpu")
    p_re = parent.models["per_user"].coefficients.numpy()
    c_re = child.models["per_user"].coefficients.numpy()
    np.testing.assert_array_equal(p_re[4:], c_re[4:])
    assert np.abs(c_re[:4] - p_re[:4]).max() > 0
    man = load_generation_manifest(result.model_dir)
    assert man["parent"] == "gen-1"
    assert man["gate"]["status"] == "published"
    assert man["changedEntities"] == {"userId": 4}
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-2"


def test_incremental_gate_refuses_injected_corruption(tmp_path):
    """model.corrupt_manifest and model.bad_holdout both leave the bad
    generation on disk, unpublished, with the refusal reason recorded, and
    LATEST never moves."""
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.io.model_io import load_generation_manifest
    from photon_tpu_torch.train.incremental import incremental_update

    root = str(tmp_path)
    batch, imaps, eidx, E = _training_fixture(seed=10)
    _save_artifacts(root, imaps, eidx)
    suite = EvaluationSuite([EvaluatorSpec.parse("AUC")], num_entities={"userId": E})
    valid = batch(256, list(range(E)), seed=2)

    def update(seed, **kw):
        return incremental_update(root, batch(256, list(range(E)), seed=seed), imaps, {"userId": eidx},
                                  TaskType.LOGISTIC_REGRESSION, _train_configs(), ["global", "per_user"],
                                  valid_batch=valid, evaluation_suite=suite, num_iterations=1, device="cpu", **kw)

    assert update(1, metric_tolerance=1.0).published  # gen-1 baseline

    faults.configure(FaultPlan(rules=(FaultRule("model.corrupt_manifest", kind="permanent", at=(0,)),)))
    r = update(3, metric_tolerance=1.0)
    faults.reset()
    assert not r.published and "checksum_mismatch" in r.gate_reason
    assert load_generation_manifest(r.model_dir)["gate"]["status"] == "rejected"

    faults.configure(FaultPlan(rules=(FaultRule("model.bad_holdout", kind="permanent", at=(0,)),)))
    r = update(4)
    faults.reset()
    assert not r.published and "holdout_regression" in r.gate_reason

    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-1"


def test_quarantined_entity_heals_across_generations(tmp_path):
    """A DIVERGED entity of generation g (quarantined: warm start kept)
    trains again in g+1 when its data is in the delta, from the warm start
    that survived the save → manifest → load round trip."""
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.io.model_io import (gate_and_publish, load_game_model, save_game_model,
                                              write_generation_manifest)
    from photon_tpu_torch.train.incremental import incremental_update

    root = str(tmp_path)
    batch, imaps, eidx, E = _training_fixture(E=12, seed=13)
    _save_artifacts(root, imaps, eidx)
    full = batch(384, list(range(E)), seed=5)
    faults.configure(FaultPlan(rules=(FaultRule("solve.re_block", kind="nan", at=(0,)),)))
    est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=_train_configs(), num_iterations=1,
                        num_entities={"userId": E}, re_active_set=True)
    (res,) = est.fit(full)
    faults.reset()

    coefs1 = res.model.models["per_user"].coefficients.numpy()[:E]
    assert np.isfinite(coefs1).all()
    quarantined = ~np.any(coefs1 != 0.0, axis=-1)
    assert quarantined.sum() >= 1  # the poison landed

    g1 = os.path.join(root, "gen-1")
    save_game_model(res.model, g1, imaps, {"userId": eidx}, sparsity_threshold=0.0)
    write_generation_manifest(g1, parent=None, holdout_metrics={})
    assert gate_and_publish(root, "gen-1").ok
    reloaded = load_game_model(g1, imaps, {"userId": eidx}, device="cpu")
    np.testing.assert_array_equal(reloaded.models["per_user"].coefficients.numpy()[:E], coefs1)

    result = incremental_update(root, batch(384, list(range(E)), seed=6), imaps, {"userId": eidx},
                                TaskType.LOGISTIC_REGRESSION, _train_configs(), ["global", "per_user"],
                                num_iterations=1, device="cpu")
    assert result.published, result.gate_reason
    assert result.changed_entities == {"userId": E}
    child = load_game_model(result.model_dir, imaps, {"userId": eidx}, device="cpu")
    coefs2 = child.models["per_user"].coefficients.numpy()[:E]
    assert np.isfinite(coefs2).all()
    assert np.all(np.any(coefs2[quarantined] != 0.0, axis=-1))  # trained, not stuck


def test_emit_delta_resolves_to_the_full_publish_and_rebuilds_byte_for_byte(tmp_path):
    """``emit_delta``: the delta layer resolves to the coefficients a full
    publish of the same update writes, bit for bit; and the same update on a
    copy of the root writes the same files (equal manifest checksums)."""
    from photon_tpu_torch.io.model_io import delta_info, load_generation_manifest, load_resolved_game_model
    from photon_tpu_torch.train.incremental import incremental_update

    root = str(tmp_path / "a")
    os.makedirs(root)
    batch, imaps, eidx, E, suite, valid = _publish_gen1(root)
    copies = {k: str(tmp_path / k) for k in ("b", "full")}
    for d in copies.values():
        shutil.copytree(root, d)
    delta = batch(160, [1, 3, 5], seed=31)
    results = {}
    for name, r, emit in (("a", root, True), ("b", copies["b"], True), ("full", copies["full"], False)):
        results[name] = incremental_update(r, delta, imaps, {"userId": EntityIndex.load(
            os.path.join(r, "entity-index-userId.json"))}, TaskType.LOGISTIC_REGRESSION, _train_configs(),
            ["global", "per_user"], locked_coordinates=["global"], num_iterations=1, emit_delta=emit,
            device="cpu")
        assert results[name].published, results[name].gate_reason
    assert results["a"].is_delta and results["b"].is_delta and not results["full"].is_delta
    assert delta_info(results["a"].model_dir)["base"] == "gen-1"
    man = {k: load_generation_manifest(v.model_dir) for k, v in results.items()}
    assert man["a"]["files"] == man["b"]["files"]
    resolved = {k: load_resolved_game_model(v.model_dir, imaps, {"userId": eidx}, to_device=False,
                                            publish_root=os.path.dirname(v.model_dir))
                for k, v in results.items()}
    for cid in ("global", "per_user"):
        get = (lambda m: m.models[cid].coefficients) if cid == "per_user" else (
            lambda m: m.models[cid].model.coefficients.means)
        np.testing.assert_array_equal(get(resolved["a"]).numpy(), get(resolved["full"]).numpy())


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def _trace(results) -> dict:
    """Per coordinate and pass of the last result: (iterations, reasons) of
    the valid rows (a random effect) or the solve (a fixed effect)."""
    out = {}
    for cid, diags in results[-1].tracker.items():
        rows = []
        for dg in diags:
            if hasattr(dg, "valid"):
                v = np.asarray(dg.valid)
                rows.append((np.asarray(dg.iterations)[v], np.asarray(dg.reasons)[v]))
            else:
                rows.append((int(dg.iterations), int(dg.reason_code)))
        out[cid] = rows
    return out


def test_incremental_update_matches_reference_in_float64(tmp_path, monkeypatch):
    """One publish root, copied; each package's ``incremental_update`` on
    the same float64 delta (a subset of entities plus new ones) and holdout:
    changed rows at rtol 1e-5 with equal iteration counts and stop reasons
    per coordinate and pass, unchanged rows bit for bit equal to the
    parent's, the same manifest keys and the same gate verdict."""
    from photon_tpu.data.game_data import GameBatch as JGameBatch
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex
    from photon_tpu.data.index_map import IndexMap as JIndexMap
    from photon_tpu.estimators import game_estimator as jge
    from photon_tpu.estimators.config import FixedEffectCoordinateConfig as JFixedCfg
    from photon_tpu.estimators.config import RandomEffectCoordinateConfig as JRandomCfg
    from photon_tpu.evaluation.suite import EvaluationSuite as JSuite
    from photon_tpu.evaluation.suite import EvaluatorSpec as JSpec
    from photon_tpu.io import model_io as jio
    from photon_tpu.train.incremental import incremental_update as j_incremental_update
    from photon_tpu.types import TaskType as JTask

    from photon_tpu_torch.estimators import game_estimator as tge
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.io import model_io as tio
    from photon_tpu_torch.train.incremental import incremental_update

    root = str(tmp_path / "port")
    os.makedirs(root)
    _publish_gen1(root)
    jroot = str(tmp_path / "ref")
    shutil.copytree(root, jroot)

    E0 = 16
    w_fix, w_re = _planted(E0 + 4, 5, 3, seed=9)
    n_new = 4
    Xf, Xr, users, y = _arrays(224, [1, 2, 5, 8] + list(range(E0, E0 + n_new)), 41, w_fix, w_re)
    vXf, vXr, vusers, vy = _arrays(256, list(range(E0)), 12, w_fix, w_re)
    names = [f"user{u}" for u in users]

    captured = {}
    for key, mod in (("port", tge), ("ref", jge)):
        orig = mod.GameEstimator.fit

        def fit(self, *a, _orig=orig, _key=key, **kw):
            out = _orig(self, *a, **kw)
            captured[_key] = out
            return out

        monkeypatch.setattr(mod.GameEstimator, "fit", fit)

    # The reference loads its parent in float32, which its float64 solves
    # refuse to mix (ROADMAP queue 3's float32 warm start): widen it, as the
    # port does.
    j_load = jio.load_resolved_game_model

    def load_f64(*a, **kw):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64) if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
            j_load(*a, **kw))

    monkeypatch.setattr(jio, "load_resolved_game_model", load_f64)

    # The port, in float64.
    timaps = {s: IndexMap.load(os.path.join(root, f"index-map-{s}.json")) for s in ("global", "per_user")}
    teidx = EntityIndex.load(os.path.join(root, "entity-index-userId.json"))
    t_ids = np.asarray([teidx.intern(s) for s in names], np.int32)
    f64 = torch.float64
    tb = GameBatch(label=T(y).to(f64), offset=torch.zeros(len(y), dtype=f64), weight=torch.ones(len(y), dtype=f64),
                   features={"global": T(Xf).to(f64), "per_user": T(Xr).to(f64)}, entity_ids={"userId": T(t_ids)})
    tv = GameBatch(label=T(vy).to(f64), offset=torch.zeros(len(vy), dtype=f64),
                   weight=torch.ones(len(vy), dtype=f64),
                   features={"global": T(vXf).to(f64), "per_user": T(vXr).to(f64)},
                   entity_ids={"userId": T(vusers)})
    tres = incremental_update(root, tb, timaps, {"userId": teidx}, TaskType.LOGISTIC_REGRESSION, _train_configs(),
                              ["global", "per_user"], valid_batch=tv,
                              evaluation_suite=EvaluationSuite([EvaluatorSpec.parse("AUC")],
                                                               num_entities={"userId": len(teidx)}),
                              num_iterations=2, metric_tolerance=0.5, norm_drift_bound=1000.0, device="cpu")

    # The reference, in float64 under its scoped x64.
    jimaps = {s: JIndexMap.load(os.path.join(jroot, f"index-map-{s}.json")) for s in ("global", "per_user")}
    jeidx = JEntityIndex.load(os.path.join(jroot, "entity-index-userId.json"))
    j_ids = np.asarray([jeidx.intern(s) for s in names], np.int32)
    np.testing.assert_array_equal(j_ids, t_ids)
    with jax.enable_x64(True):
        jb = JGameBatch(label=jnp.asarray(y, jnp.float64), offset=jnp.zeros(len(y), jnp.float64),
                        weight=jnp.ones(len(y), jnp.float64),
                        features={"global": jnp.asarray(Xf, jnp.float64), "per_user": jnp.asarray(Xr, jnp.float64)},
                        entity_ids={"userId": jnp.asarray(j_ids)})
        jv = JGameBatch(label=jnp.asarray(vy, jnp.float64), offset=jnp.zeros(len(vy), jnp.float64),
                        weight=jnp.ones(len(vy), jnp.float64),
                        features={"global": jnp.asarray(vXf, jnp.float64),
                                  "per_user": jnp.asarray(vXr, jnp.float64)},
                        entity_ids={"userId": jnp.asarray(vusers)})
        jres = j_incremental_update(jroot, jb, jimaps, {"userId": jeidx}, JTask.LOGISTIC_REGRESSION,
                                    [JFixedCfg("global", "global"), JRandomCfg("per_user", "userId", "per_user")],
                                    ["global", "per_user"], valid_batch=jv,
                                    evaluation_suite=JSuite([JSpec.parse("AUC")], num_entities={"userId": len(jeidx)}),
                                    num_iterations=2, metric_tolerance=0.5, norm_drift_bound=1000.0)
        jtrace = _trace(captured["ref"])
    ttrace = _trace(captured["port"])

    assert (tres.generation, tres.published, tres.gate_reason, tres.parent, tres.changed_entities) == (
        jres.generation, jres.published, jres.gate_reason, jres.parent, jres.changed_entities)
    assert tres.published and tres.changed_entities == {"userId": 8}
    assert tres.holdout_metrics.keys() == jres.holdout_metrics.keys()
    for k, v in jres.holdout_metrics.items():
        assert tres.holdout_metrics[k] == pytest.approx(v, rel=1e-5)
    assert ttrace.keys() == jtrace.keys()
    for cid in jtrace:
        assert len(ttrace[cid]) == len(jtrace[cid])
        for (gi, gr), (wi, wr) in zip(ttrace[cid], jtrace[cid]):
            np.testing.assert_array_equal(gi, wi, err_msg=f"{cid} iterations")
            np.testing.assert_array_equal(gr, wr, err_msg=f"{cid} reasons")
    tman = tio.load_generation_manifest(tres.model_dir)
    jman = jio.load_generation_manifest(jres.model_dir)
    assert sorted(tman) == sorted(jman) and sorted(tman["files"]) == sorted(jman["files"])
    assert sorted(tman["gate"]) == sorted(jman["gate"])
    assert (tman["gate"]["status"], tman["gate"]["reason"]) == (jman["gate"]["status"], jman["gate"]["reason"])
    assert tman["changedEntities"] == jman["changedEntities"]

    parent = tio.load_game_model(os.path.join(root, "gen-1"), timaps, {"userId": teidx}, device="cpu")
    t = tio.load_game_model(tres.model_dir, timaps, {"userId": teidx}, device="cpu")
    j = jio.load_game_model(jres.model_dir, jimaps, {"userId": jeidx}, to_device=False)
    t_re, j_re = t.models["per_user"].coefficients.numpy(), np.asarray(j.models["per_user"].coefficients)
    p_re = parent.models["per_user"].coefficients.numpy()
    changed = np.zeros(len(teidx), bool)
    changed[t_ids] = True
    unchanged = np.flatnonzero(~changed)
    np.testing.assert_array_equal(t_re[unchanged], p_re[unchanged])
    np.testing.assert_array_equal(j_re[unchanged], p_re[unchanged])
    np.testing.assert_allclose(t_re[changed], j_re[changed], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.models["global"].model.coefficients.means.numpy(),
                               np.asarray(j.models["global"].model.coefficients.means), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------


def _driver_records(n, seed, users):
    rng = np.random.default_rng(seed)
    w = np.linspace(-1, 1, 5)
    bias = np.linspace(-2, 2, 12)
    out = []
    for i in range(n):
        x = rng.normal(size=5)
        u = users[i % len(users)]
        logit = x @ w + bias[u]
        out.append({"uid": str(i), "label": float(rng.uniform() < 1 / (1 + np.exp(-logit))),
                    "features": [{"name": f"x{j}", "term": "", "value": float(x[j])} for j in range(5)],
                    "metadataMap": {"userId": f"u{u}"}, "weight": 1.0, "offset": 0.0})
    return out


def test_game_incremental_drivers_match_reference(tmp_path):
    """A publish root from the port's game_training, copied; both packages'
    game_incremental on the same delta Avro file (users u1, u3 and the new
    u9, u10) and holdout, float32: the same generation, verdict, parent and
    changed counts, holdout AUC within 1e-3, coefficients within 1e-3, and
    unchanged users' rows equal to the parent's in both."""
    from photon_tpu.cli import game_incremental as j_game_incremental
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex
    from photon_tpu.data.index_map import IndexMap as JIndexMap
    from photon_tpu.io import model_io as jio

    from photon_tpu_torch.cli import game_incremental, game_training
    from photon_tpu_torch.io import model_io as tio
    from photon_tpu_torch.io.avro import write_avro_records
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA

    d = tmp_path / "data"
    d.mkdir()
    paths = {}
    for name, n, seed, users in (("train", 400, 1, list(range(8))), ("valid", 200, 2, list(range(8))),
                                 ("delta", 120, 3, [1, 3, 9, 10])):
        paths[name] = str(d / f"{name}.avro")
        write_avro_records(paths[name], TRAINING_EXAMPLE_SCHEMA, _driver_records(n, seed, users))
    shards = ["--feature-shard-configurations", "name=globalShard,feature.bags=features"]
    coords = ["--coordinate-configurations", "name=global,feature.shard=globalShard,reg.weights=1",
              "name=perUser,feature.shard=globalShard,random.effect.type=userId,reg.weights=1",
              "--update-sequence", "global,perUser"]
    root = tmp_path / "port"
    game_training.main(["--input-paths", paths["train"], "--validation-paths", paths["valid"], "--output-dir",
                        str(root), *shards, *coords, "--evaluators", "AUC", "--device", "cpu"])
    jroot = tmp_path / "ref"
    shutil.copytree(root, jroot)
    argv = ["--input-paths", paths["delta"], "--validation-paths", paths["valid"], *shards, *coords,
            "--evaluators", "AUC", "--metric-tolerance", "0.5", "--norm-drift-bound", "1000"]
    t = game_incremental.run(game_incremental.build_parser().parse_args(
        argv + ["--publish-root", str(root), "--device", "cpu"]))
    j = j_game_incremental.run(j_game_incremental.build_parser().parse_args(argv + ["--publish-root", str(jroot)]))
    for k in ("generation", "published", "gateReason", "parent", "changedEntities"):
        assert t[k] == j[k], k
    assert t["published"] and t["parent"] == "best" and t["changedEntities"] == {"userId": 4}
    assert t["holdoutMetrics"].keys() == j["holdoutMetrics"].keys()
    for k, v in j["holdoutMetrics"].items():
        assert t["holdoutMetrics"][k] == pytest.approx(v, abs=1e-3)
    with open(root / "LATEST") as f:
        assert f.read().strip() == t["generation"]

    timaps = {"globalShard": IndexMap.load(str(root / "index-map-globalShard.json"))}
    teidx = EntityIndex.load(str(root / "entity-index-userId.json"))
    jimaps = {"globalShard": JIndexMap.load(str(jroot / "index-map-globalShard.json"))}
    jeidx = JEntityIndex.load(str(jroot / "entity-index-userId.json"))
    assert len(teidx) == len(jeidx) == 10
    tm = tio.load_game_model(t["modelDir"], timaps, {"userId": teidx}, device="cpu")
    jm = jio.load_game_model(j["modelDir"], jimaps, {"userId": jeidx}, to_device=False)
    parent = tio.load_game_model(str(root / "best"), timaps, {"userId": teidx}, device="cpu")
    t_re, j_re = tm.models["perUser"].coefficients.numpy(), np.asarray(jm.models["perUser"].coefficients)
    np.testing.assert_allclose(t_re, j_re, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(tm.models["global"].model.coefficients.means.numpy(),
                               np.asarray(jm.models["global"].model.coefficients.means), atol=1e-3, rtol=1e-3)
    p_re = parent.models["perUser"].coefficients.numpy()
    for u in ("u0", "u2", "u4", "u5", "u6", "u7"):
        e = teidx.lookup(u)
        np.testing.assert_array_equal(t_re[e], p_re[e])
        np.testing.assert_array_equal(j_re[jeidx.lookup(u)], p_re[e])


def test_game_incremental_defaults_to_cuda(tmp_path):
    """Without ``--device cpu`` the driver asks for the card and, with none,
    exits non-zero before reading anything."""
    from photon_tpu_torch.cli import game_incremental

    with pytest.raises(SystemExit) as exc:
        game_incremental.run(game_incremental.build_parser().parse_args(
            ["--publish-root", str(tmp_path), "--input-paths", str(tmp_path / "none.avro"),
             "--coordinate-configurations", "name=global,feature.shard=globalShard", "--update-sequence", "global"]))
    assert "no CUDA device" in str(exc.value)
