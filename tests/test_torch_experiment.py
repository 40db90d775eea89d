"""The port's online experiment plane (photon_tpu_torch/experiment/,
cli/game_experiment.py, /v1/experiment, ``obs_tool experiments``).

First the reference's cases (tests/test_experiment.py) against the port: the
crash-resume contract rests on deterministic re-proposal (the same seed and
observations give the same GP batches, in process and across processes) and
on durable records (the generation manifests are the experiment store: a
manager that dies mid-round re-trains only candidates with no manifest and
never re-measures a stamped observation), plus the search-history round
trip, ``ExperimentSpace`` / ``point_key`` and the offline rollup.

Then against the reference: the GP proposals, spaces and keys equal; a
root written by either package's manager summarized and resumed by the
other; ``IncrementalCandidateTrainer`` in float64 (rtol 1e-5, equal
iteration counts and stop reasons); both packages' ``game_experiment
--train-only`` writing the same generation names and experiment tags. And
the port alone on the CPU: an online run under driven traffic (the
regressed candidate poisoned, a winner promoted), a run killed at
``experiment.trained`` and resumed, ``/v1/experiment`` through both
backends and ``obs_tool experiments --publish-root``.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_tpu_torch.estimators.config import GameOptimizationConfig, RegularizationConfig
from photon_tpu_torch.experiment import (
    ExperimentConfig,
    ExperimentManager,
    ExperimentSpace,
    experiment_summary,
    point_key,
)
from photon_tpu_torch.hyperparameter import search as t_search
from photon_tpu_torch.hyperparameter.serialization import observations_to_json, prior_from_json
from photon_tpu_torch.io.model_io import (
    experiment_generations,
    update_generation_manifest,
    write_generation_manifest,
)
from photon_tpu_torch.utils import faults
from photon_tpu_torch.utils.faults import FaultPlan, FaultRule, InjectedFault

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


def _search(seed=11, dim=2, num_candidates=64, module=t_search):
    rng = module.SearchRange(np.array([-3.0, 0.0]), np.array([3.0, 1.0]))
    return module.GaussianProcessSearch(dim, None, rng, seed=seed, num_candidates=num_candidates,
                                        min_observations=3)


def _objective(x):
    return float((x[0] - 1.0) ** 2 + 0.5 * x[1])


# ---------------------------------------------------------------------------
# 1. seeded determinism — same seed + same observations → same batches
# ---------------------------------------------------------------------------


def test_gp_next_batch_deterministic_for_seed_and_observations():
    a, b = _search(seed=11), _search(seed=11)
    for rnd in range(3):
        Xa, Xb = a.next_batch(4), b.next_batch(4)
        np.testing.assert_array_equal(Xa, Xb)
        for x in Xa:
            v = _objective(x)
            a.observe(x, v)
            b.observe(x, v)
    # Past min_observations both rounds above came from the GP posterior,
    # not the Sobol fallback.
    assert len(a.observations) == 12 > a.min_observations


def test_gp_next_batch_differs_across_seeds():
    a, b = _search(seed=11), _search(seed=12)
    assert not np.array_equal(a.next_batch(4), b.next_batch(4))


def test_gp_resume_replay_matches_uninterrupted_run():
    """The manager's resume discipline: replaying the full observation
    history into a FRESH search (same seed) puts it in the same state as
    the search that never died."""
    a = _search(seed=7)
    history = []
    for _ in range(3):
        for x in a.next_batch(3):
            v = _objective(x)
            a.observe(x, v)
            history.append((x, v))
    b = _search(seed=7)  # "restarted process"
    for _ in range(3):
        X = b.next_batch(3)
        for x in X:
            b.observe(x, _objective(x))
    for (xa, va), (xb, vb) in zip(history, b.observations):
        np.testing.assert_array_equal(xa, xb)
        assert va == vb
    np.testing.assert_array_equal(a.next_batch(3), b.next_batch(3))


_CROSS_PROCESS_SCRIPT = """
import json
import numpy as np
from photon_tpu_torch.hyperparameter.search import GaussianProcessSearch, SearchRange

rng = SearchRange(np.array([-3.0, 0.0]), np.array([3.0, 1.0]))
s = GaussianProcessSearch(2, None, rng, seed=11, num_candidates=64,
                          min_observations=3)
best_x, best_v = s.find_batch(
    3, 4, lambda X: [float((x[0] - 1.0) ** 2 + 0.5 * x[1]) for x in X]
)
print(json.dumps({
    "best_x": [float(v) for v in best_x],
    "best_v": float(best_v),
    "observations": [
        ([float(v) for v in x], float(val)) for x, val in s.observations
    ],
}))
"""


def test_gp_find_batch_deterministic_across_processes():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    outs = []
    for _ in range(2):
        p = subprocess.run([sys.executable, "-c", _CROSS_PROCESS_SCRIPT], capture_output=True, text=True, env=env,
                           timeout=300)
        assert p.returncode == 0, p.stderr
        outs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    assert len(outs[0]["observations"]) == 12


# ---------------------------------------------------------------------------
# 2. search-history serialization round-trip
# ---------------------------------------------------------------------------


def test_observations_round_trip_to_prior_json():
    s = _search(seed=5)
    for x in s.next_batch(5):
        s.observe(x, _objective(x))
    names = ["global.weight", "per_user.weight"]
    blob = observations_to_json(s.observations, names)
    back = prior_from_json(blob, {}, names)
    assert len(back) == len(s.observations)
    for (x0, v0), (x1, v1) in zip(s.observations, back):
        np.testing.assert_allclose(x0, x1, rtol=0, atol=0)
        assert v0 == v1


def test_round_tripped_history_seeds_identical_search_state():
    a = _search(seed=9)
    for _ in range(2):
        for x in a.next_batch(3):
            a.observe(x, _objective(x))
    names = ["a", "b"]
    blob = observations_to_json(a.observations, names)

    # "restarted tuner": re-propose with the same seed, observe the
    # round-tripped history instead of re-evaluating.
    b = _search(seed=9)
    replay = iter(prior_from_json(blob, {}, names))
    for _ in range(2):
        for x in b.next_batch(3):
            xp, vp = next(replay)
            np.testing.assert_array_equal(x, xp)
            b.observe(xp, vp)
    np.testing.assert_array_equal(a.next_batch(3), b.next_batch(3))


def test_prior_from_json_fills_missing_params_from_default():
    blob = json.dumps({"records": [{"a": 2.0, "evaluationValue": 0.5}]})
    [(vec, val)] = prior_from_json(blob, {"b": 7.0}, ["a", "b"])
    np.testing.assert_array_equal(vec, [2.0, 7.0])
    assert val == 0.5


# ---------------------------------------------------------------------------
# 3. ExperimentSpace / point_key units
# ---------------------------------------------------------------------------


def _space(weights, alphas=None):
    alphas = alphas or {}
    return ExperimentSpace(GameOptimizationConfig(reg={
        cid: RegularizationConfig(weight=w, alpha=alphas.get(cid, 0.0)) for cid, w in weights.items()
    }))


def test_space_slots_sorted_and_untuned_skipped():
    space = _space({"b": 1.0, "a": 2.0, "c": 0.0})
    assert space.names == ["a.weight", "b.weight"]  # sorted; c untuned
    assert space.dim == 2


def test_space_vector_to_config_is_log10_weights():
    space = _space({"a": 1.0})
    cfg = space.vector_to_config(np.array([2.0]))
    assert cfg.reg["a"].weight == pytest.approx(100.0)


def test_space_alpha_slot_when_base_mixes():
    space = _space({"a": 1.0}, alphas={"a": 0.5})
    assert space.names == ["a.weight", "a.alpha"]
    cfg = space.vector_to_config(np.array([1.0, 0.25]))
    assert cfg.reg["a"].weight == pytest.approx(10.0)
    assert cfg.reg["a"].alpha == pytest.approx(0.25)


def test_space_regressed_config_over_regularizes_every_tuned_slot():
    space = _space({"a": 1.0, "b": 2.0, "c": 0.0})
    reg = space.regressed_config().reg
    assert reg["a"].weight == reg["b"].weight == 1e8
    assert reg["c"].weight == 0.0  # untuned coordinates untouched


def test_space_empty_raises():
    with pytest.raises(ValueError, match="empty"):
        _space({"a": 0.0})


def test_point_key_is_order_and_noise_stable():
    k1 = point_key({"a": 1.23456789, "b": -2.0})
    k2 = point_key({"b": -2.0, "a": 1.23456789 + 1e-9})
    assert k1 == k2  # sorted params, 6-decimal rounding
    assert point_key({"a": 1.2345, "b": -2.0}) != k1


# ---------------------------------------------------------------------------
# 4. manager crash-resume from durable manifest records
# ---------------------------------------------------------------------------


class DummyTrainer:
    """Writes real generation manifests (the durable record the resume
    discipline reads) without training anything; ``write_manifest`` is
    either package's writer."""

    def __init__(self, root, write_manifest=write_generation_manifest):
        self.root = root
        self.trained = []
        self._write = write_manifest

    def train(self, config, generation, extra_manifest):
        model_dir = os.path.join(self.root, generation)
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, "weights.json"), "w") as f:
            json.dump({cid: r.weight for cid, r in config.reg.items()}, f)
        self._write(model_dir, parent=None, extra=extra_manifest)
        self.trained.append(generation)
        return model_dir

    def load(self, model_dir):  # pragma: no cover — train-only tests
        raise NotImplementedError


def _cfg(root, **kw):
    base = dict(experiment_id="exp-t", publish_root=root, rounds=1, candidates_per_round=3, seed=23)
    base.update(kw)
    return ExperimentConfig(**base)


def test_manager_train_only_writes_durable_records(tmp_path):
    root = str(tmp_path)
    space = _space({"global": 1.0, "per_user": 1.0})
    trainer = DummyTrainer(root)
    summary = ExperimentManager(_cfg(root), space, trainer).run(train_only=True)
    assert summary["trained"] == 3 and summary["reused_trained"] == 0
    recs = experiment_generations(root, "exp-t")
    assert len(recs) == 3
    assert {r["status"] for r in recs} == {"proposed"}
    assert all(r["paramsKey"] in r["generation"] for r in recs)


def test_manager_resume_retrains_nothing_already_durable(tmp_path):
    root = str(tmp_path)
    space = _space({"global": 1.0, "per_user": 1.0})
    ExperimentManager(_cfg(root), space, DummyTrainer(root)).run(train_only=True)
    # "restarted process": fresh manager, fresh trainer, same config.
    t2 = DummyTrainer(root)
    summary = ExperimentManager(_cfg(root), _space({"global": 1.0, "per_user": 1.0}), t2).run(train_only=True)
    assert t2.trained == []
    assert summary["trained"] == 0 and summary["reused_trained"] == 3


def test_manager_crash_mid_round_resumes_remaining_candidates(tmp_path):
    root = str(tmp_path)
    # The experiment.trained site sits AFTER the durable train record; an
    # injected crash there leaves 2 of 3 candidates recorded.
    faults.configure(FaultPlan(rules=(FaultRule("experiment.trained", kind="transient", at=(1,)),)))
    t1 = DummyTrainer(root)
    with pytest.raises(InjectedFault):
        ExperimentManager(_cfg(root), _space({"global": 1.0, "per_user": 1.0}), t1).run(train_only=True)
    assert len(t1.trained) == 2
    faults.reset()

    t2 = DummyTrainer(root)
    summary = ExperimentManager(_cfg(root), _space({"global": 1.0, "per_user": 1.0}), t2).run(train_only=True)
    assert len(t2.trained) == 1  # ONLY the candidate with no record
    assert summary["reused_trained"] == 2 and summary["trained"] == 1
    assert len(experiment_generations(root, "exp-t")) == 3


def _stamp_observations(root, update=update_generation_manifest):
    """Stamp online observations durably, as _observe_round would have."""
    values = {}
    for i, rec in enumerate(experiment_generations(root, "exp-t")):
        values[rec["generation"]] = 0.4 + 0.1 * i
        update(os.path.join(root, rec["generation"]),
               {"experiment": {"observation": values[rec["generation"]], "observationSource": "online",
                               "status": "observed"}})
    return values


def test_manager_resume_reuses_stamped_observations(tmp_path):
    root = str(tmp_path)
    space = _space({"global": 1.0, "per_user": 1.0})
    ExperimentManager(_cfg(root), space, DummyTrainer(root)).run(train_only=True)
    values = _stamp_observations(root)
    # Engine-less FULL run (not train_only): every candidate is reused
    # with its stamped observation, so observation never requires an
    # engine and the GP is fed the full history.
    t2 = DummyTrainer(root)
    mgr = ExperimentManager(_cfg(root, promote_winner=False), _space({"global": 1.0, "per_user": 1.0}), t2)
    summary = mgr.run()
    assert t2.trained == []
    assert summary["reused_observed"] == 3
    assert {c["source"] for c in summary["candidates"]} == {"stamped"}
    assert len(mgr.search.observations) == 3
    best = summary["best"]
    assert values[best["generation"]] == min(values.values())


# ---------------------------------------------------------------------------
# 5. offline rollup
# ---------------------------------------------------------------------------


def test_experiment_summary_rollup(tmp_path):
    root = str(tmp_path)
    ExperimentManager(_cfg(root), _space({"global": 1.0, "per_user": 1.0}), DummyTrainer(root)).run(
        train_only=True)
    doc = experiment_summary(root)
    exps = {e["id"]: e for e in doc["experiments"]}
    assert "exp-t" in exps
    exp = exps["exp-t"]
    assert len(exp["candidates"]) == 3
    assert exp["rounds"] == 1
    assert exp["winner"] is None  # train-only: nothing promoted
    assert all(c["params"] for c in exp["candidates"])


# ---------------------------------------------------------------------------
# 6. against the reference
# ---------------------------------------------------------------------------


def test_gp_proposals_match_reference():
    """The same seed and observations give the reference's batches exactly
    (both searches are the same numpy and scipy code), Sobol rounds and GP
    rounds alike."""
    import photon_tpu.hyperparameter.search as j_search

    a, b = _search(seed=23), _search(seed=23, module=j_search)
    for _ in range(4):
        Xa, Xb = a.next_batch(3), b.next_batch(3)
        np.testing.assert_array_equal(Xa, Xb)
        for x in Xa:
            a.observe(x, _objective(x))
            b.observe(x, _objective(x))
    assert len(a.observations) == 12


@pytest.mark.parametrize("weights,alphas", [({"global": 1.0, "perUser": 10.0, "perItem": 0.0}, {}),
                                            ({"global": 0.5, "perUser": 2.0}, {"global": 0.3})])
def test_space_and_point_key_match_reference(weights, alphas):
    """Slots, names, ranges, the configs of vectors, the regressed config
    and ``point_key`` strings are the reference's."""
    from photon_tpu.estimators.config import GameOptimizationConfig as JConfig
    from photon_tpu.estimators.config import RegularizationConfig as JReg
    from photon_tpu.experiment import ExperimentSpace as JSpace
    from photon_tpu.experiment import point_key as j_point_key

    t = _space(weights, alphas)
    j = JSpace(JConfig(reg={c: JReg(weight=w, alpha=alphas.get(c, 0.0)) for c, w in weights.items()}))
    assert t.names == j.names and t.dim == j.dim
    np.testing.assert_array_equal(t.search_range.lower, j.search_range.lower)
    np.testing.assert_array_equal(t.search_range.upper, j.search_range.upper)
    rng = np.random.default_rng(3)
    for _ in range(8):
        x = rng.uniform(t.search_range.lower, t.search_range.upper)
        tp, jp = t.params_from_vector(x), j.params_from_vector(x)
        assert tp == jp and point_key(tp) == j_point_key(jp)
        tc, jc = t.vector_to_config(x), j.vector_to_config(x)
        assert {c: (r.weight, r.alpha) for c, r in tc.reg.items()} == {
            c: (r.weight, r.alpha) for c, r in jc.reg.items()}
    assert {c: (r.weight, r.alpha) for c, r in t.regressed_config().reg.items()} == {
        c: (r.weight, r.alpha) for c, r in j.regressed_config().reg.items()}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_roots_of_either_package_resume_and_summarize_in_the_other(tmp_path, writer):
    """A root whose candidates (and stamped observations and poison list)
    one package's manager wrote: the other package's manager resumes it
    with nothing re-trained, and both packages' ``experiment_summary``
    read it alike. The tags are byte for byte alike across the packages."""
    from photon_tpu.experiment import ExperimentConfig as JExpConfig
    from photon_tpu.experiment import ExperimentManager as JManager
    from photon_tpu.experiment import ExperimentSpace as JSpace
    from photon_tpu.experiment import experiment_summary as j_summary
    from photon_tpu.estimators.config import GameOptimizationConfig as JConfig
    from photon_tpu.estimators.config import RegularizationConfig as JReg
    from photon_tpu.io import model_io as jio

    from photon_tpu_torch.io.model_io import load_generation_manifest, mark_poisoned

    def j_space():
        return JSpace(JConfig(reg={"global": JReg(weight=1.0), "per_user": JReg(weight=1.0)}))

    def j_cfg(root, **kw):
        return JExpConfig(**dict(dict(experiment_id="exp-t", publish_root=root, rounds=1, candidates_per_round=3,
                                      seed=23), **kw))

    roots = {k: str(tmp_path / k) for k in ("port", "reference")}
    ExperimentManager(_cfg(roots["port"]), _space({"global": 1.0, "per_user": 1.0}),
                      DummyTrainer(roots["port"])).run(train_only=True)
    JManager(j_cfg(roots["reference"]), j_space(),
             DummyTrainer(roots["reference"], jio.write_generation_manifest)).run(train_only=True)
    gens = {k: sorted(r["generation"] for r in experiment_generations(v, "exp-t")) for k, v in roots.items()}
    assert gens["port"] == gens["reference"] and len(gens["port"]) == 3
    for g in gens["port"]:
        t_tag = load_generation_manifest(os.path.join(roots["port"], g))["experiment"]
        j_tag = jio.load_generation_manifest(os.path.join(roots["reference"], g))["experiment"]
        assert json.dumps(t_tag) == json.dumps(j_tag)

    root = roots[writer]
    if writer == "port":
        _stamp_observations(root)
        mark_poisoned(root, gens["port"][0], "quality burn: drill")
    else:
        _stamp_observations(root, jio.update_generation_manifest)
        jio.mark_poisoned(root, gens["port"][0], "quality burn: drill")
    assert experiment_summary(root) == j_summary(root)
    if writer == "port":
        t2 = DummyTrainer(root, jio.write_generation_manifest)
        summary = JManager(j_cfg(root, promote_winner=False), j_space(), t2).run()
    else:
        t2 = DummyTrainer(root)
        summary = ExperimentManager(_cfg(root, promote_winner=False), _space({"global": 1.0, "per_user": 1.0}),
                                    t2).run()
    assert t2.trained == [] and summary["reused_trained"] == 3 and summary["reused_observed"] == 3


def test_incremental_candidate_trainer_matches_reference_in_float64(tmp_path, monkeypatch):
    """One publish root, copied; each package's IncrementalCandidateTrainer
    trains the same candidate (a proposed λ per coordinate) on the same
    float64 delta and holdout: coefficients at rtol 1e-5 with equal
    iteration counts and stop reasons per coordinate and pass, the same
    generation, manifest keys and experiment tag, LATEST untouched."""
    import jax
    import jax.numpy as jnp
    from test_torch_incremental import _arrays, _planted, _publish_gen1, _trace, _train_configs

    from photon_tpu.data.game_data import GameBatch as JGameBatch
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex
    from photon_tpu.data.index_map import IndexMap as JIndexMap
    from photon_tpu.estimators import game_estimator as jge
    from photon_tpu.estimators.config import FixedEffectCoordinateConfig as JFixedCfg
    from photon_tpu.estimators.config import GameOptimizationConfig as JConfig
    from photon_tpu.estimators.config import RandomEffectCoordinateConfig as JRandomCfg
    from photon_tpu.estimators.config import RegularizationConfig as JReg
    from photon_tpu.evaluation.suite import EvaluationSuite as JSuite
    from photon_tpu.evaluation.suite import EvaluatorSpec as JSpec
    from photon_tpu.experiment import IncrementalCandidateTrainer as JTrainer
    from photon_tpu.io import model_io as jio
    from photon_tpu.types import TaskType as JTask

    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.estimators import game_estimator as tge
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.experiment import IncrementalCandidateTrainer
    from photon_tpu_torch.io import model_io as tio
    from photon_tpu_torch.types import TaskType

    T = torch.as_tensor
    root = str(tmp_path / "port")
    os.makedirs(root)
    _publish_gen1(root)
    jroot = str(tmp_path / "ref")
    shutil.copytree(root, jroot)

    E0 = 16
    w_fix, w_re = _planted(E0 + 4, 5, 3, seed=9)
    Xf, Xr, users, y = _arrays(224, [1, 2, 5, 8] + list(range(E0, E0 + 4)), 41, w_fix, w_re)
    vXf, vXr, vusers, vy = _arrays(256, list(range(E0)), 12, w_fix, w_re)
    names = [f"user{u}" for u in users]
    lam = {"global": 0.35, "per_user": 4.2}
    generation = "exp-parity-r0-0123456789ab"
    tag = {"experiment": {"id": "parity", "round": 0, "index": 0, "params": {"global.weight": float(np.log10(0.35))},
                          "paramsKey": "0123456789ab", "status": "proposed"}}

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

    timaps = {s: IndexMap.load(os.path.join(root, f"index-map-{s}.json")) for s in ("global", "per_user")}
    teidx = EntityIndex.load(os.path.join(root, "entity-index-userId.json"))
    t_ids = np.asarray([teidx.intern(s) for s in names], np.int32)
    f64 = torch.float64

    def tbatch(lab, xf, xr, ids):
        return GameBatch(label=T(lab).to(f64), offset=torch.zeros(len(lab), dtype=f64),
                         weight=torch.ones(len(lab), dtype=f64),
                         features={"global": T(xf).to(f64), "per_user": T(xr).to(f64)},
                         entity_ids={"userId": T(ids)})

    t_trainer = IncrementalCandidateTrainer(
        root, tbatch(y, Xf, Xr, t_ids), timaps, {"userId": teidx}, TaskType.LOGISTIC_REGRESSION, _train_configs(),
        ["global", "per_user"], valid_batch=tbatch(vy, vXf, vXr, vusers),
        evaluation_suite=EvaluationSuite([EvaluatorSpec.parse("AUC")], num_entities={"userId": len(teidx)}),
        num_iterations=2, device="cpu")
    t_dir = t_trainer.train(GameOptimizationConfig({c: RegularizationConfig(weight=w) for c, w in lam.items()}),
                            generation, tag)

    jimaps = {s: JIndexMap.load(os.path.join(jroot, f"index-map-{s}.json")) for s in ("global", "per_user")}
    jeidx = JEntityIndex.load(os.path.join(jroot, "entity-index-userId.json"))
    j_ids = np.asarray([jeidx.intern(s) for s in names], np.int32)
    np.testing.assert_array_equal(j_ids, t_ids)
    with jax.enable_x64(True):
        def jbatch(lab, xf, xr, ids):
            return JGameBatch(label=jnp.asarray(lab, jnp.float64), offset=jnp.zeros(len(lab), jnp.float64),
                              weight=jnp.ones(len(lab), jnp.float64),
                              features={"global": jnp.asarray(xf, jnp.float64),
                                        "per_user": jnp.asarray(xr, jnp.float64)},
                              entity_ids={"userId": jnp.asarray(ids)})

        j_trainer = JTrainer(
            jroot, jbatch(y, Xf, Xr, j_ids), jimaps, {"userId": jeidx}, JTask.LOGISTIC_REGRESSION,
            [JFixedCfg("global", "global"), JRandomCfg("per_user", "userId", "per_user")], ["global", "per_user"],
            valid_batch=jbatch(vy, vXf, vXr, vusers),
            evaluation_suite=JSuite([JSpec.parse("AUC")], num_entities={"userId": len(jeidx)}), num_iterations=2)
        j_dir = j_trainer.train(JConfig({c: JReg(weight=w) for c, w in lam.items()}), generation, tag)
        jtrace = _trace(captured["ref"])
    ttrace = _trace(captured["port"])

    assert os.path.basename(t_dir) == os.path.basename(j_dir) == generation
    for r in (root, jroot):
        with open(os.path.join(r, "LATEST")) as f:
            assert f.read().strip() == "gen-1"  # publish=False: LATEST untouched
    assert ttrace.keys() == jtrace.keys()
    for cid in jtrace:
        assert len(ttrace[cid]) == len(jtrace[cid])
        for (gi, gr), (wi, wr) in zip(ttrace[cid], jtrace[cid]):
            np.testing.assert_array_equal(gi, wi, err_msg=f"{cid} iterations")
            np.testing.assert_array_equal(gr, wr, err_msg=f"{cid} reasons")
    tman, jman = tio.load_generation_manifest(t_dir), jio.load_generation_manifest(j_dir)
    assert sorted(tman) == sorted(jman) and sorted(tman["files"]) == sorted(jman["files"])
    assert json.dumps(tman["experiment"]) == json.dumps(jman["experiment"])
    assert tman["holdoutMetrics"].keys() == jman["holdoutMetrics"].keys()
    for k, v in jman["holdoutMetrics"].items():
        assert tman["holdoutMetrics"][k] == pytest.approx(v, rel=1e-5)
    t = tio.load_game_model(t_dir, timaps, {"userId": teidx}, device="cpu")
    j = jio.load_game_model(j_dir, jimaps, {"userId": jeidx}, to_device=False)
    np.testing.assert_allclose(t.models["per_user"].coefficients.numpy(), np.asarray(j.models["per_user"].coefficients),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.models["global"].model.coefficients.means.numpy(),
                               np.asarray(j.models["global"].model.coefficients.means), rtol=1e-5, atol=1e-6)
    # The trainer's load is the engine's host master of the same files.
    loaded = t_trainer.load(t_dir)
    assert loaded.models["per_user"].coefficients.device.type == "cpu"
    np.testing.assert_array_equal(loaded.models["per_user"].coefficients.numpy(),
                                  t.models["per_user"].coefficients.numpy())


# ---------------------------------------------------------------------------
# 7. the driver
# ---------------------------------------------------------------------------

SHARDS = ["--feature-shard-configurations", "name=globalShard,feature.bags=features"]
COORDS = ["--coordinate-configurations", "name=global,feature.shard=globalShard,reg.weights=1",
          "name=perUser,feature.shard=globalShard,random.effect.type=userId,reg.weights=1",
          "--update-sequence", "global,perUser"]


def _records(n, seed, users):
    """Avro training rows: five features and a per-user bias (the users of
    ``users`` in turn)."""
    rng = np.random.default_rng(seed)
    w = np.linspace(-1.5, 1.5, 5)
    bias = np.linspace(-2, 2, 14)
    out = []
    for i in range(n):
        x = rng.normal(size=5)
        u = users[i % len(users)]
        logit = x @ w + bias[u]
        out.append({"uid": str(i), "label": float(rng.uniform() < 1 / (1 + np.exp(-logit))),
                    "features": [{"name": f"x{j}", "term": "", "value": float(x[j])} for j in range(5)],
                    "metadataMap": {"userId": f"u{u}"}, "weight": 1.0, "offset": 0.0})
    return out


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """A publish root from the port's game_training (LATEST = best), with
    its training, holdout and delta Avro files."""
    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.io.avro import write_avro_records
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA

    d = tmp_path_factory.mktemp("experiment")
    paths = {}
    for name, n, seed, users in (("train", 600, 1, list(range(12))), ("valid", 300, 2, list(range(12))),
                                 ("delta", 240, 3, [1, 3, 5, 7, 12, 13])):
        paths[name] = str(d / f"{name}.avro")
        write_avro_records(paths[name], TRAINING_EXAMPLE_SCHEMA, _records(n, seed, users))
    root = d / "root"
    game_training.main(["--input-paths", paths["train"], "--validation-paths", paths["valid"], "--output-dir",
                        str(root), *SHARDS, *COORDS, "--evaluators", "AUC", "--device", "cpu"])
    paths["root"] = str(root)
    return paths


def _copy_root(published, dst) -> str:
    shutil.copytree(published["root"], dst)
    return str(dst)


def _argv(published, root, *extra):
    return ["--publish-root", root, "--input-paths", published["delta"], "--validation-paths", published["valid"],
            *SHARDS, *COORDS, "--evaluators", "AUC", "--metric-tolerance", "0.5", "--norm-drift-bound", "1000",
            *extra]


def test_train_only_driver_matches_reference(published, tmp_path):
    """Both packages' game_experiment --train-only on copies of one root:
    the same candidate generations, and experiment tags byte for byte alike
    (the rest of a manifest carries times and the model files' sha256s).
    The port's models hold the reference's within 1e-3 (float32)."""
    from photon_tpu.cli import game_experiment as j_game_experiment
    from photon_tpu.io import model_io as jio

    from photon_tpu_torch.cli import game_experiment
    from photon_tpu_torch.io.model_io import load_generation_manifest

    roots = {k: _copy_root(published, tmp_path / k) for k in ("port", "reference")}
    common = ["--experiment-id", "exp1", "--rounds", "2", "--candidates-per-round", "3", "--seed", "5",
              "--train-only"]
    t = game_experiment.run(game_experiment.build_parser().parse_args(
        _argv(published, roots["port"], *common, "--device", "cpu")))
    j = j_game_experiment.run(j_game_experiment.build_parser().parse_args(
        _argv(published, roots["reference"], *common)))
    timing = t.pop("timing")
    assert t == j
    assert t["trained"] == 3 and t["reused_trained"] == 0
    assert [r["round"] for r in timing["rounds"]] == [0] and len(timing["rounds"][0]["trained"]) == 3
    gens = {k: sorted(p for p in os.listdir(v) if p.startswith("exp-")) for k, v in roots.items()}
    assert gens["port"] == gens["reference"] and len(gens["port"]) == 3
    for g in gens["port"]:
        tman = load_generation_manifest(os.path.join(roots["port"], g))
        jman = jio.load_generation_manifest(os.path.join(roots["reference"], g))
        assert json.dumps(tman["experiment"]) == json.dumps(jman["experiment"])
        assert sorted(tman) == sorted(jman) and tman["parent"] == jman["parent"] == "best"
        for k, v in jman["holdoutMetrics"].items():
            assert tman["holdoutMetrics"][k] == pytest.approx(v, abs=1e-3)
    for r in roots.values():
        with open(os.path.join(r, "LATEST")) as f:
            assert f.read().strip() == "best"


def test_killed_at_trained_resumes_without_retraining(published, tmp_path):
    """game_experiment --train-only SIGKILLed right after its first durable
    candidate (a kill rule at experiment.trained) exits -9 with one
    candidate on disk; the rerun re-trains only the others."""
    from photon_tpu_torch.cli import game_experiment

    root = _copy_root(published, tmp_path / "root")
    argv = _argv(published, root, "--experiment-id", "kill", "--rounds", "1", "--candidates-per-round", "3",
                 "--train-only", "--device", "cpu")
    env = dict(os.environ, PYTHONPATH=str(REPO), **{faults.FAULT_PLAN_ENV: json.dumps(
        {"rules": [{"site": "experiment.trained", "kind": "kill", "at": [0]}]})})
    p = subprocess.run([sys.executable, "-m", "photon_tpu_torch.cli.game_experiment", *argv], cwd=REPO,
                       capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == -9, p.stderr[-2000:]
    assert len(experiment_generations(root, "kill")) == 1
    summary = game_experiment.run(game_experiment.build_parser().parse_args(argv))
    assert summary["reused_trained"] == 1 and summary["trained"] == 2
    assert len(experiment_generations(root, "kill")) == 3


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _banner(proc, timeout_s=180.0) -> dict:
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("line", proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    line = box.get("line") or ""
    assert line.startswith("{"), f"no startup banner within {timeout_s:.0f} s"
    return json.loads(line)


@pytest.mark.parametrize("workers", [0, 1])
def test_v1_experiment_answers_through_both_backends(published, tmp_path, workers):
    """game_serving on a root with a train-only experiment, in process
    (LocalBackend) and behind a spawned HTTP worker (the scorer op): GET
    /v1/experiment answers 200 with the offline rollup of the root and the
    engine's live lanes."""
    import signal

    from photon_tpu_torch.cli import game_experiment

    root = _copy_root(published, tmp_path / "root")
    game_experiment.run(game_experiment.build_parser().parse_args(_argv(
        published, root, "--experiment-id", "exp-http", "--rounds", "1", "--candidates-per-round", "2",
        "--train-only", "--device", "cpu")))
    proc = subprocess.Popen([sys.executable, "-m", "photon_tpu_torch.cli.game_serving", "--model-input-dir", root,
                             "--port", "0", "--workers", str(workers), "--device", "cpu"],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        port = _banner(proc)["port"]
        code, doc = _get(port, "/v1/experiment")
        assert code == 200
        assert doc["publishRoot"] == root
        assert doc["experiments"] == experiment_summary(root)["experiments"]
        [exp] = doc["experiments"]
        assert exp["id"] == "exp-http" and len(exp["candidates"]) == 2
        assert doc["live"]["primary"].endswith("best") and doc["live"]["shadows"] == []
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def test_obs_tool_experiments_renders_a_root(published, tmp_path, capsys):
    """``obs_tool experiments --publish-root`` renders a root offline (text
    and --json, the latter experiment_summary's document); a root with no
    experiment exits 1 saying so."""
    from photon_tpu_torch.cli import game_experiment, obs_tool

    root = _copy_root(published, tmp_path / "root")
    assert obs_tool.main(["experiments", "--publish-root", root]) == 1
    assert "no experiment generations" in capsys.readouterr().out
    game_experiment.run(game_experiment.build_parser().parse_args(_argv(
        published, root, "--experiment-id", "exp-obs", "--rounds", "1", "--candidates-per-round", "2",
        "--train-only", "--device", "cpu")))
    capsys.readouterr()
    assert obs_tool.main(["experiments", "--publish-root", root]) == 0
    out = capsys.readouterr().out
    assert "experiment exp-obs: rounds=1 candidates=2 poisoned=0" in out
    assert out.count("gen=exp-exp-obs-r0-") == 2
    assert obs_tool.main(["experiments", "--publish-root", root, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == experiment_summary(root)


def _drive(port, rows, stop, out):
    """Scored requests with uids and their labels through /v1/feedback,
    round after round over ``rows``, until ``stop`` or the server goes."""
    i = 0
    while not stop.is_set():
        batch = []
        for _ in range(16):
            feats, user, label = rows[i % len(rows)]
            uid = f"d{i}"
            i += 1
            try:
                got = _post(port, "/v1/score", {"features": {"globalShard": feats}, "entityIds": {"userId": user},
                                                "uid": uid})
            except urllib.error.HTTPError as exc:
                out["failed"].append(f"{exc.code}: {exc.read()[:200]!r}")
                continue
            except (urllib.error.URLError, OSError):
                return  # the driver tore its server down
            out["scored"].append((uid, got["modelVersion"], got["score"]))
            batch.append({"uid": uid, "label": label})
        try:
            res = _post(port, "/v1/feedback", {"labels": batch})
            out["joined"] += res["joined"]
        except urllib.error.HTTPError as exc:
            out["failed"].append(f"{exc.code}: {exc.read()[:200]!r}")
        except (urllib.error.URLError, OSError):
            return


def test_online_experiment_poisons_the_regressed_candidate_and_promotes_a_winner(published, tmp_path):
    """game_experiment online on the CPU as a subprocess, its candidates in
    a spawned trainer process, under a thread of scored requests and their
    labels: a fault plan fires experiment.regress on the second candidate,
    which the quality burn poisons on its loss (its scores shrink to the
    intercept; 300 events a reading, so noise does not decide), and the poison
    list names; the winner was observed online, passes the gate, LATEST
    moves to it and the engine serves it; /v1/experiment shows the rollup
    live, and no request failed."""
    from photon_tpu_torch.io.avro import read_avro_records
    from photon_tpu_torch.io.model_io import load_generation_manifest, load_poison_list

    root = _copy_root(published, tmp_path / "root")
    rows = [({f["name"]: f["value"] for f in r["features"]}, r["metadataMap"]["userId"], r["label"])
            for r in read_avro_records(published["valid"])]
    env = dict(os.environ, PYTHONPATH=str(REPO), **{faults.FAULT_PLAN_ENV: json.dumps(
        {"rules": [{"site": "experiment.regress", "kind": "transient", "at": [1]}]})})
    argv = _argv(published, root, "--experiment-id", "online", "--rounds", "2", "--candidates-per-round", "2",
                 "--seed", "7", "--feedback-spool", str(tmp_path / "spool"), "--shadow-fraction", "1.0",
                 "--min-events", "300", "--auc-drop-bound", "0.2", "--loss-burn-ratio", "0.25",
                 "--observe-timeout", "120", "--observe-poll", "0.1", "--port", "0", "--device", "cpu")
    proc = subprocess.Popen([sys.executable, "-m", "photon_tpu_torch.cli.game_experiment", *argv], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    stop = threading.Event()
    out = {"scored": [], "failed": [], "joined": 0}
    try:
        banner = _banner(proc)
        assert banner["serving"] and banner["modelVersion"].endswith("best")
        port = banner["port"]
        driver = threading.Thread(target=_drive, args=(port, rows, stop, out), daemon=True)
        driver.start()
        live = None
        while proc.poll() is None and live is None:
            try:
                _, doc = _get(port, "/v1/experiment")
            except (urllib.error.URLError, OSError):
                break
            if doc.get("live", {}).get("shadows"):
                live = doc
            time.sleep(0.1)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, stderr[-3000:]
    summary = json.loads(stdout.strip().splitlines()[-1])
    assert not out["failed"] and out["joined"] > 0
    assert live is not None and live["experiments"][0]["id"] == "online"
    cands = {c["generation"]: c for c in summary["candidates"]}
    assert len(cands) == 4 and summary["trained"] == 4
    regressed = [g for g in cands if load_generation_manifest(os.path.join(root, g))["experiment"].get("regressed")]
    assert len(regressed) == 1 and cands[regressed[0]]["round"] == 0 and cands[regressed[0]]["index"] == 1
    assert regressed[0] in summary["poisoned"] and cands[regressed[0]]["status"] == "poisoned"
    assert "quality burn: candidate loss" in cands[regressed[0]]["poisonReason"]
    assert regressed[0] in load_poison_list(root)
    observed = [c for c in cands.values() if c["status"] == "observed"]
    assert observed and all(c["source"] == "online" for c in observed)
    winner = summary["winner"]
    assert winner is not None and winner == summary["best"]["generation"] and winner not in summary["poisoned"]
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == winner
    assert load_generation_manifest(os.path.join(root, winner))["experiment"]["winner"] is True
    assert {v for _, v, _ in out["scored"]} <= {banner["modelVersion"], winner}
    rounds = summary["timing"]["rounds"]
    assert [r["round"] for r in rounds] == [0, 1]
    assert all(len(r["resident"]) == 2 for r in rounds)  # the primary and the best candidate so far
    assert sorted(g for r in rounds for g in r["trained"]) == sorted(cands)
    assert summary["engine"]["primary"] == winner and summary["engine"]["retracesSinceWarmup"] == 0
