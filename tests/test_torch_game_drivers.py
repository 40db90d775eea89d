"""The port's GAME drivers (game_training, game_scoring, feature_indexing)
and their file formats against the JAX package's on the CPU.

Both packages read their files into float32, so the drivers are compared as
the train_glm drivers are: coefficients within 1e-3·max(1, max |w|) of a
coordinate, metrics within 1e-3 (relative above 1), scores within
1e-3·max(1, max |score|); config strings, λ lists, entity indexes, index
maps and output layouts equal. A model directory written by one package
loads in the other to the same float32 coefficients and the same
``present_entities``. The Avro fixtures are written here from numpy seeds:
the reference driver test's fixture (400 rows, 6 features, 8 users) with a
second feature bag of 3 per-item features over 5 items.
"""

import copy
import dataclasses
import datetime as dt
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.cli import common as j_common
from photon_tpu.cli import feature_indexing as j_feature_indexing
from photon_tpu.cli import game_scoring as j_game_scoring
from photon_tpu.cli import game_training as j_game_training
from photon_tpu.data import validators as j_validators
from photon_tpu.data.game_data import GameBatch as JGameBatch
from photon_tpu.data.index_map import EntityIndex as JEntityIndex
from photon_tpu.data.index_map import IndexMap as JIndexMap
from photon_tpu.io.avro import read_avro_records as j_read_avro, write_avro_records
from photon_tpu.io.model_io import load_game_model as j_load_game_model
from photon_tpu.io.model_io import save_game_model as j_save_game_model
from photon_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_tpu.io.scores import load_scores as j_load_scores
from photon_tpu.models.game import GameModel as JGameModel
from photon_tpu.models.game import ProjectedRandomEffectModel as JProjected
from photon_tpu.types import TaskType as JTask
from photon_tpu.utils import io_utils as j_io_utils

from photon_tpu_torch.cli import common, feature_indexing, game_scoring, game_training
from photon_tpu_torch.data import validators
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.io.avro import read_avro_records
from photon_tpu_torch.io.data_reader import read_merged
from photon_tpu_torch.io.model_io import load_game_model, save_game_model
from photon_tpu_torch.io.scores import load_scores
from photon_tpu_torch.models.game import GameModel, ProjectedRandomEffectModel
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import io_utils

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-3

# TrainingExampleAvro with a second feature bag.
SCHEMA = copy.deepcopy(TRAINING_EXAMPLE_SCHEMA)
SCHEMA["fields"].append({"name": "itemFeatures", "type": {"type": "array", "items": "FeatureAvro"}})

SHARDS = ["--feature-shard-configurations", "name=globalShard,feature.bags=features|itemFeatures",
          "name=itemShard,feature.bags=itemFeatures"]
GLOBAL = "name=global,feature.shard=globalShard,optimizer=LBFGS,reg.weights=1|10"
PER_USER = "name=perUser,feature.shard=globalShard,random.effect.type=userId,reg.weights=1"
PER_ITEM = "name=perItem,feature.shard=itemShard,random.effect.type=itemId,reg.weights=1"


def _records(n, seed, users, n_items=5, d=6, d_item=3):
    """Planted logistic GLMix rows: a fixed effect over ``features``, a bias
    per user (row i belongs to users[i % len(users)]) and per-item weights
    over ``itemFeatures``."""
    rng = np.random.default_rng(seed)
    w = np.linspace(-1, 1, d)
    user_bias = np.linspace(-2, 2, 8)
    item_w = np.random.default_rng(99).normal(size=(n_items, d_item))
    out = []
    for i in range(n):
        x, xi = rng.normal(size=d), rng.normal(size=d_item)
        u, it = users[i % len(users)], int(rng.integers(n_items))
        logit = x @ w + user_bias[u % 8] + xi @ item_w[it]
        out.append({
            "uid": str(i),
            "label": float(rng.uniform() < 1 / (1 + np.exp(-logit))),
            "features": [{"name": f"x{j}", "term": "", "value": float(x[j])} for j in range(d)],
            "itemFeatures": [{"name": f"i{j}", "term": "t", "value": float(xi[j])} for j in range(d_item)],
            "metadataMap": {"userId": f"u{u}", "itemId": f"item{it}"},
            "weight": 1.0,
            "offset": 0.0,
        })
    return out


def _write(path, recs):
    write_avro_records(str(path), SCHEMA, recs)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("game_fixtures")
    train = _records(400, 23, list(range(8)))
    valid = _records(200, 24, list(range(10)))  # users u8, u9 are unseen in training
    out = {
        "dir": d,
        "train": _write(d / "train.avro", train),
        "valid": _write(d / "valid.avro", valid),
        # The warm-start scenario: a model of users u0-u7, then a run on
        # users u2-u11 (u0, u1 only in the model; u8-u11 new to it).
        "train2": _write(d / "train2.avro", _records(400, 25, list(range(2, 12)))),
    }
    (d / "split").mkdir()
    _write(d / "split" / "part-0.avro", valid[:120])
    _write(d / "split" / "part-1.avro", valid[120:])
    return out


def _train_both(root, argv, name):
    """Both packages' game_training on ``argv``; (jax summary, port summary,
    jax output dir, port output dir)."""
    jdir, tdir = root / "jax" / name, root / "port" / name
    j_summary = j_game_training.run(j_game_training.build_parser().parse_args(argv + ["--output-dir", str(jdir)]))
    t_summary = game_training.main(argv + ["--output-dir", str(tdir), "--device", "cpu"])
    return j_summary, t_summary, jdir, tdir


def _score(package, model_dir, data, out, extra=()):
    argv = ["--input-paths", data, "--output-dir", str(out), *SHARDS, "--model-input-dir", str(model_dir),
            "--evaluators", "AUC", *extra]
    if package == "jax":
        return j_game_scoring.run(j_game_scoring.build_parser().parse_args(argv))
    return game_scoring.main(argv + ["--device", "cpu"])


def _close(got, want, what):
    assert got == pytest.approx(want, abs=TOL * max(1.0, abs(want))), what


def _assert_summaries_agree(j, t):
    assert [c["config"] for c in t["configs"]] == [c["config"] for c in j["configs"]]
    assert t["tuned_configs"] == j["tuned_configs"] == []
    assert t["best"]["config"] == j["best"]["config"]
    for jc, tc in zip(j["configs"] + [j["best"]], t["configs"] + [t["best"]]):
        if jc["metrics"] is None:
            assert tc["metrics"] is None
            continue
        assert sorted(tc["metrics"]) == sorted(jc["metrics"])
        for k, v in jc["metrics"].items():
            _close(tc["metrics"][k], v, (jc["config"], k))


def _layout(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def _coefficient_records(model_dir, reader):
    """{coordinate: {modelId: (means {(name, term): v}, variances or None)}}
    of a model directory, read with one package's Avro reader."""
    out = {}
    for kind in ("fixed-effect", "random-effect"):
        base = Path(model_dir) / kind
        if not base.is_dir():
            continue
        for cdir in sorted(base.iterdir()):
            recs = {}
            for part in sorted((cdir / "coefficients").glob("*.avro")):
                for r in reader(str(part)):
                    means = {(m["name"], m["term"]): m["value"] for m in r["means"]}
                    var = None if r["variances"] is None else {(m["name"], m["term"]): m["value"]
                                                               for m in r["variances"]}
                    recs[r["modelId"]] = (means, var, r["modelClass"], r["lossFunction"])
            out[cdir.name] = recs
    return out


def _assert_model_dirs_agree(jdir, tdir):
    """Metadata, id-info and coefficient records of two model directories,
    each read with its own package's reader, record for record."""
    jm, tm = (json.loads((Path(p) / "model-metadata.json").read_text()) for p in (jdir, tdir))
    assert tm["coordinates"] == jm["coordinates"]
    assert tm.get("config") == jm.get("config") and tm["modelType"] == jm["modelType"]
    for p in Path(jdir).rglob("id-info"):
        assert (Path(tdir) / p.relative_to(jdir)).read_text() == p.read_text()
    want, got = _coefficient_records(jdir, j_read_avro), _coefficient_records(tdir, read_avro_records)
    assert list(got) == list(want)
    for cid in want:
        assert list(got[cid]) == list(want[cid]), cid  # same entities, same order
        scale = max([1.0] + [abs(v) for m, _, _, _ in want[cid].values() for v in m.values()])
        for mid, (wm, wv, wcls, wloss) in want[cid].items():
            gm, gv, gcls, gloss = got[cid][mid]
            assert (gcls, gloss) == (wcls, wloss)
            for key in set(wm) | set(gm):
                assert abs(gm.get(key, 0.0) - wm.get(key, 0.0)) <= TOL * scale, (cid, mid, key)
            assert (gv is None) == (wv is None)
            if wv is not None:
                for key in set(wv) & set(gv):
                    _close(gv[key], wv[key], (cid, mid, key))


def _assert_score_files_agree(jpath, tpath, rtol=TOL):
    want, got = j_load_scores(str(jpath)), load_scores(str(tpath))
    assert len(got) == len(want)
    scale = max(1.0, max(abs(r["predictionScore"]) for r in want))
    for g, w in zip(got, want):
        assert (g["uid"], g["label"], g["weight"], g["modelId"]) == (w["uid"], w["label"], w["weight"], w["modelId"])
        assert abs(g["predictionScore"] - w["predictionScore"]) <= rtol * scale


# ---------------------------------------------------------------------------
# The driver test of the reference (test_drivers.py:54), with a per-item
# coordinate on a second bag: both packages train, then score.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    root = tmp_path_factory.mktemp("game_runs")
    argv = ["--input-paths", files["train"], "--validation-paths", files["valid"], *SHARDS,
            "--coordinate-configurations", GLOBAL, PER_USER, PER_ITEM,
            "--update-sequence", "global,perUser,perItem", "--coordinate-descent-iterations", "2",
            "--evaluators", "AUC", "LOGISTIC_LOSS", "--variance-computation", "SIMPLE"]
    j_summary, t_summary, jdir, tdir = _train_both(root, argv, "train")
    scored = {(m, s): _score(s, d / "best", files["valid"], root / f"score-{m}-by-{s}")
              for m, d in (("jax", jdir), ("port", tdir)) for s in ("jax", "port")}
    return dict(root=root, j=j_summary, t=t_summary, jdir=jdir, tdir=tdir, scored=scored)


def test_training_summaries_match_reference(runs):
    _assert_summaries_agree(runs["j"], runs["t"])
    assert len(runs["t"]["configs"]) == 2 and runs["t"]["best"]["metrics"]["AUC"] > 0.7
    on_disk = json.loads((runs["tdir"] / "training-summary.json").read_text())
    assert on_disk["best"]["config"] == runs["t"]["best"]["config"]


def test_training_output_layouts_match_reference(runs):
    assert _layout(runs["tdir"]) == _layout(runs["jdir"])
    assert (runs["tdir"] / "LATEST").read_text().strip() == "best"
    for name in ("index-map-globalShard.json", "index-map-itemShard.json", "entity-index-userId.json",
                 "entity-index-itemId.json"):
        assert json.loads((runs["tdir"] / name).read_text()) == json.loads((runs["jdir"] / name).read_text())


def test_best_model_records_match_reference(runs):
    _assert_model_dirs_agree(runs["jdir"] / "best", runs["tdir"] / "best")


def test_scoring_drivers_match_reference(runs):
    sc = runs["scored"]
    for model in ("jax", "port"):
        j_out, t_out = sc[(model, "jax")], sc[(model, "port")]
        assert t_out["numScored"] == j_out["numScored"] == 200
        _close(t_out["metrics"]["AUC"], j_out["metrics"]["AUC"], model)
        root = runs["root"]
        # One model scored by both packages: the same float32 coefficients.
        _assert_score_files_agree(root / f"score-{model}-by-jax" / "scores.avro",
                                  root / f"score-{model}-by-port" / "scores.avro", rtol=1e-5)
        assert json.loads((root / f"score-{model}-by-port" / "scoring-metrics.json").read_text()) == t_out["metrics"]
    _assert_score_files_agree(runs["root"] / "score-jax-by-jax" / "scores.avro",
                              runs["root"] / "score-port-by-port" / "scores.avro")


def test_scoring_driver_reproduces_the_training_validation_metric(runs):
    assert runs["scored"][("port", "port")]["metrics"]["AUC"] == pytest.approx(
        runs["t"]["best"]["metrics"]["AUC"], abs=1e-6)


def _jax_maps(out_dir):
    imaps = {p.name[len("index-map-"):-5]: JIndexMap.load(str(p)) for p in Path(out_dir).glob("index-map-*.json")}
    eidx = {p.name[len("entity-index-"):-5]: JEntityIndex.load(str(p)) for p in Path(out_dir).glob("entity-index-*.json")}
    return imaps, eidx


def _port_maps(out_dir):
    imaps = {p.name[len("index-map-"):-5]: IndexMap.load(str(p)) for p in Path(out_dir).glob("index-map-*.json")}
    eidx = {p.name[len("entity-index-"):-5]: EntityIndex.load(str(p)) for p in Path(out_dir).glob("entity-index-*.json")}
    return imaps, eidx


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_model_directories_load_in_both_packages(runs, writer):
    out = runs["jdir"] if writer == "jax" else runs["tdir"]
    (jmaps, jeidx), (tmaps, teidx) = _jax_maps(out), _port_maps(out)
    j_model = j_load_game_model(str(out / "best"), jmaps, jeidx)
    t_model = load_game_model(str(out / "best"), tmaps, teidx, device="cpu")
    assert list(t_model.models) == list(j_model.models)
    for cid, jm in j_model.models.items():
        tm = t_model.models[cid]
        if cid == "global":
            np.testing.assert_array_equal(tm.model.coefficients.means.numpy(), np.asarray(jm.model.coefficients.means))
            np.testing.assert_array_equal(tm.model.coefficients.variances.numpy(),
                                          np.asarray(jm.model.coefficients.variances))
            continue
        assert (tm.re_type, tm.feature_shard, tm.task.value) == (jm.re_type, jm.feature_shard, jm.task.value)
        np.testing.assert_array_equal(tm.coefficients.numpy(), np.asarray(jm.coefficients))
        np.testing.assert_array_equal(tm.variances.numpy(), np.asarray(jm.variances))
        np.testing.assert_array_equal(tm.present_entities.numpy(), np.asarray(jm.present_entities))
    assert {k: v.ids() for k, v in teidx.items()} == {k: v.ids() for k, v in jeidx.items()}


# ---------------------------------------------------------------------------
# Projected random effects: the per-block write through col_maps.
# ---------------------------------------------------------------------------


def _projected_pair():
    """The same ProjectedRandomEffectModel in both packages: 7 entities in 2
    blocks of different column subsets of a 6-wide shard, entity 3 without a
    block, coefficients on both sides of the 1e-4 threshold, variances."""
    rng = np.random.default_rng(41)
    col_maps = [np.array([0, 2, 5], np.int32), np.array([1, 2, 3, 4], np.int32)]
    entity_block = np.array([0, 1, 0, -1, 1, 1, 0], np.int32)
    entity_row = np.array([0, 0, 1, -1, 1, 2, 2], np.int32)
    coefs = [rng.normal(size=(3, 3)).astype(np.float32), rng.normal(size=(3, 4)).astype(np.float32)]
    coefs[0][1, 1] = 5e-5  # below the threshold: not written
    coefs[1][2, 0] = -2e-4
    variances = [rng.uniform(0.1, 1, size=c.shape).astype(np.float32) for c in coefs]
    inv_maps = []
    for cm in col_maps:
        inv = np.full(6, -1, np.int32)
        inv[cm] = np.arange(cm.size, dtype=np.int32)
        inv_maps.append(inv)
    common_args = dict(d_full=6, re_type="userId", feature_shard="s")
    j_model = JProjected([jnp.asarray(c) for c in coefs], [jnp.asarray(c) for c in col_maps],
                         [jnp.asarray(i) for i in inv_maps], jnp.asarray(entity_block), jnp.asarray(entity_row),
                         task=JTask.LOGISTIC_REGRESSION, block_variances=[jnp.asarray(v) for v in variances],
                         **common_args)
    t_model = ProjectedRandomEffectModel([torch.from_numpy(c) for c in coefs], [torch.from_numpy(c) for c in col_maps],
                                         [torch.from_numpy(i) for i in inv_maps], torch.from_numpy(entity_block),
                                         torch.from_numpy(entity_row), task=TaskType.LOGISTIC_REGRESSION,
                                         block_variances=[torch.from_numpy(v) for v in variances], **common_args)
    keys = [f"f{j}" for j in range(5)] + [IndexMap.INTERCEPT]
    ids = [f"e{k}" for k in range(7)]
    return j_model, t_model, keys, ids


def test_projected_model_files_match_reference_and_load_in_both(tmp_path):
    j_model, t_model, keys, ids = _projected_pair()
    jmap, tmap = JIndexMap({k: i for i, k in enumerate(keys)}), IndexMap({k: i for i, k in enumerate(keys)})
    jeidx, teidx = JEntityIndex(), EntityIndex()
    for e in ids:
        jeidx.intern(e)
        teidx.intern(e)
    j_save_game_model(JGameModel({"perUser": j_model}), str(tmp_path / "jax"), {"s": jmap}, {"userId": jeidx})
    save_game_model(GameModel({"perUser": t_model}), str(tmp_path / "port"), {"s": tmap}, {"userId": teidx})
    want = _coefficient_records(tmp_path / "jax", j_read_avro)
    got = _coefficient_records(tmp_path / "port", read_avro_records)
    assert got == want  # the same float32 values: equal records
    assert list(got["perUser"]) == [e for k, e in enumerate(ids) if k != 3]
    _assert_model_dirs_agree(tmp_path / "jax", tmp_path / "port")
    X = np.random.default_rng(42).normal(size=(20, 6)).astype(np.float32)
    eids = np.array([k % 8 - 1 for k in range(20)], np.int32)  # -1 (unseen) and every entity
    jb = JGameBatch(jnp.zeros(20), jnp.zeros(20), jnp.ones(20), {"s": jnp.asarray(X)}, {"userId": jnp.asarray(eids)})
    tb = GameBatch(torch.zeros(20), torch.zeros(20), torch.ones(20), {"s": torch.from_numpy(X)},
                   {"userId": torch.from_numpy(eids)})
    for writer in ("jax", "port"):
        jm = j_load_game_model(str(tmp_path / writer), {"s": jmap}, {"userId": JEntityIndex()}).models["perUser"]
        tm = load_game_model(str(tmp_path / writer), {"s": tmap}, {"userId": EntityIndex()}, device="cpu")
        tm = tm.models["perUser"]
        np.testing.assert_array_equal(tm.coefficients.numpy(), np.asarray(jm.coefficients))
        np.testing.assert_array_equal(tm.variances.numpy(), np.asarray(jm.variances))
        np.testing.assert_array_equal(tm.present_entities.numpy(), np.asarray(jm.present_entities))
        assert tm.present_entities.sum() == 6
        # The loaded dense model scores as the projected model it came from
        # (the entity indexes were built afresh in file order: e3 is absent).
        order = [ids.index(e) for e in (f"e{k}" for k in range(7) if k != 3)]
        dense = t_model.to_dense().coefficients.numpy()[order]
        dense[np.abs(dense) <= 1e-4] = 0.0
        np.testing.assert_array_equal(tm.coefficients.numpy(), dense)
    np.testing.assert_allclose(t_model.score(tb).numpy(), np.asarray(j_model.score(jb)), rtol=1e-6, atol=1e-6)


def test_pearson_capped_random_effect_driver_matches_reference(files, tmp_path):
    """``features.to.samples.ratio=`` on a dense shard: the Pearson cap of the
    reference, through both drivers, and the model files across packages."""
    argv = ["--input-paths", files["train"], "--validation-paths", files["valid"], *SHARDS,
            "--coordinate-configurations", "name=global,feature.shard=globalShard,reg.weights=1",
            PER_USER + ",features.to.samples.ratio=0.05", "--update-sequence", "global,perUser",
            "--evaluators", "AUC"]
    j_summary, t_summary, jdir, tdir = _train_both(tmp_path, argv, "pearson")
    _assert_summaries_agree(j_summary, t_summary)
    _assert_model_dirs_agree(jdir / "best", tdir / "best")
    # The reference scores the port's directory as the port does.
    _score("jax", tdir / "best", files["valid"], tmp_path / "sj")
    _score("port", tdir / "best", files["valid"], tmp_path / "st")
    _assert_score_files_agree(tmp_path / "sj" / "scores.avro", tmp_path / "st" / "scores.avro", rtol=1e-5)


@pytest.mark.parametrize("per_user", ["reg.alpha=0.5", "optimizer=TRON"], ids=["elastic_net", "tron"])
def test_elastic_net_and_tron_random_effects_match_reference(files, tmp_path, per_user):
    """``reg.alpha=`` (elastic net: batched OWL-QN) and ``optimizer=TRON``
    (batched TRON) on a random effect, beside a per-item effect that takes
    the other one: both drivers' summaries and model files agree, and each
    package scores the other's model directory as its own."""
    other = "optimizer=TRON" if per_user != "optimizer=TRON" else "reg.alpha=0.5"
    argv = ["--input-paths", files["train"], "--validation-paths", files["valid"], *SHARDS,
            "--coordinate-configurations", GLOBAL, PER_USER + "," + per_user, PER_ITEM + "," + other,
            "--update-sequence", "global,perUser,perItem", "--coordinate-descent-iterations", "2",
            "--evaluators", "AUC"]
    j_summary, t_summary, jdir, tdir = _train_both(tmp_path, argv, "lifted")
    _assert_summaries_agree(j_summary, t_summary)
    _assert_model_dirs_agree(jdir / "best", tdir / "best")
    for model, d in (("jax", jdir), ("port", tdir)):
        _score("jax", d / "best", files["valid"], tmp_path / f"{model}-by-jax")
        _score("port", d / "best", files["valid"], tmp_path / f"{model}-by-port")
        _assert_score_files_agree(tmp_path / f"{model}-by-jax" / "scores.avro",
                                  tmp_path / f"{model}-by-port" / "scores.avro", rtol=1e-5)


# ---------------------------------------------------------------------------
# Warm start, locked coordinates and new entities (test_drivers.py:97).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("locked", [False, True])
def test_warm_start_with_new_entities_matches_reference(files, tmp_path, locked):
    base = ["--validation-paths", files["valid"], *SHARDS, "--evaluators", "AUC", "--update-sequence",
            "global,perUser"]
    first = ["--input-paths", files["train"], "--coordinate-configurations",
             "name=global,feature.shard=globalShard,reg.weights=1", PER_USER] + base
    _, _, jdir1, tdir1 = _train_both(tmp_path / "first", first, "m1")
    second = ["--input-paths", files["train2"], "--coordinate-configurations",
              "name=global,feature.shard=globalShard,reg.weights=1",
              PER_USER + ",active.data.lower.bound=60", "--ignore-threshold-for-new-models"] + base
    if locked:
        second += ["--locked-coordinates", "global"]
    jdir2, tdir2 = tmp_path / "second" / "jax" / "m2", tmp_path / "second" / "port" / "m2"
    j_summary = j_game_training.run(j_game_training.build_parser().parse_args(
        second + ["--model-input-dir", str(jdir1 / "best"), "--output-dir", str(jdir2)]))
    t_summary = game_training.main(second + ["--model-input-dir", str(tdir1 / "best"), "--output-dir", str(tdir2),
                                             "--device", "cpu"])
    _assert_summaries_agree(j_summary, t_summary)
    _assert_model_dirs_agree(jdir2 / "best", tdir2 / "best")
    # Training interned u2-u11 in row order; the warm model appended u0, u1.
    ids = json.loads((tdir2 / "entity-index-userId.json").read_text())
    assert ids == json.loads((jdir2 / "entity-index-userId.json").read_text())
    assert ids[-2:] == ["u0", "u1"] and len(ids) == 12
    if locked:  # the fixed effect is the warm model's, unchanged
        w1 = _coefficient_records(tdir1 / "best", read_avro_records)["global"]
        w2 = _coefficient_records(tdir2 / "best", read_avro_records)["global"]
        assert w2 == w1


@pytest.mark.parametrize("normalization", ["STANDARDIZATION", "SCALE_WITH_MAX_MAGNITUDE"])
def test_normalized_training_matches_reference(files, tmp_path, normalization):
    argv = ["--input-paths", files["train"], "--validation-paths", files["valid"], *SHARDS,
            "--coordinate-configurations", "name=global,feature.shard=globalShard,reg.weights=1", PER_USER,
            "--update-sequence", "global,perUser", "--evaluators", "AUC", "--normalization", normalization]
    j_summary, t_summary, jdir, tdir = _train_both(tmp_path, argv, normalization)
    _assert_summaries_agree(j_summary, t_summary)
    _assert_model_dirs_agree(jdir / "best", tdir / "best")
    assert t_summary["best"]["metrics"]["AUC"] > 0.7


def test_feature_indexing_then_training_matches_reference(files, tmp_path):
    shards = ["--feature-shard-configurations", "name=globalShard,feature.bags=features|itemFeatures",
              "name=noIntercept,intercept=false"]
    j_out = j_feature_indexing.run(j_feature_indexing.build_parser().parse_args(
        ["--input-paths", files["train"], "--output-dir", str(tmp_path / "jidx"), *shards]))
    t_out = feature_indexing.main(["--input-paths", files["train"], "--output-dir", str(tmp_path / "tidx"), *shards])
    assert t_out == j_out == {"globalShard": 10, "noIntercept": 6}
    assert _layout(tmp_path / "tidx") == _layout(tmp_path / "jidx")
    for p in (tmp_path / "jidx").iterdir():
        assert json.loads((tmp_path / "tidx" / p.name).read_text()) == json.loads(p.read_text())
    argv = ["--input-paths", files["train"], "--validation-paths", files["valid"], *SHARDS,
            "--coordinate-configurations", "name=global,feature.shard=globalShard,reg.weights=1", PER_ITEM,
            "--update-sequence", "global,perItem", "--evaluators", "AUC"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    (tmp_path / "tidx" / "index-map-itemShard.json").write_text(json.dumps({"i0\x01t": 0, "i1\x01t": 1}))
    (tmp_path / "jidx" / "index-map-itemShard.json").write_text(json.dumps({"i0\x01t": 0, "i1\x01t": 1}))
    j_summary = j_game_training.run(j_game_training.build_parser().parse_args(
        argv + ["--feature-index-dir", str(tmp_path / "jidx"), "--output-dir", str(jdir)]))
    t_summary = game_training.main(argv + ["--feature-index-dir", str(tmp_path / "tidx"), "--output-dir", str(tdir),
                                           "--device", "cpu"])
    _assert_summaries_agree(j_summary, t_summary)
    _assert_model_dirs_agree(jdir / "best", tdir / "best")
    # The preloaded item map (no i2, no intercept) is the one the run used.
    assert json.loads((tdir / "index-map-itemShard.json").read_text()) == {"i0\x01t": 0, "i1\x01t": 1}


def test_missing_feature_index_map_exits(files, tmp_path):
    (tmp_path / "idx").mkdir()
    with pytest.raises(SystemExit) as exc:
        game_training.main(["--input-paths", files["train"], *SHARDS, "--coordinate-configurations", GLOBAL,
                            "--update-sequence", "global", "--feature-index-dir", str(tmp_path / "idx"),
                            "--output-dir", str(tmp_path / "o"), "--device", "cpu"])
    assert "index-map-globalShard.json" in str(exc.value.code)


def test_summarization_output_matches_reference(files, tmp_path):
    argv = ["--input-paths", files["train"], *SHARDS, "--coordinate-configurations",
            "name=global,feature.shard=globalShard,reg.weights=1", "--update-sequence", "global", "--evaluators"]
    j_game_training.run(j_game_training.build_parser().parse_args(
        argv + ["--summarization-output-dir", str(tmp_path / "jsum"), "--output-dir", str(tmp_path / "jax")]))
    game_training.main(argv + ["--summarization-output-dir", str(tmp_path / "tsum"), "--output-dir",
                               str(tmp_path / "port"), "--device", "cpu"])
    for shard in ("globalShard", "itemShard"):
        want = j_read_avro(str(tmp_path / "jsum" / shard / "part-00000.avro"))
        got = read_avro_records(str(tmp_path / "tsum" / shard / "part-00000.avro"))
        assert [(r["featureName"], r["featureTerm"]) for r in got] == [
            (r["featureName"], r["featureTerm"]) for r in want]
        for g, w in zip(got, want):
            assert list(g["metrics"]) == list(w["metrics"])
            for k, v in w["metrics"].items():
                assert g["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), (g["featureName"], k)


@pytest.mark.parametrize("mode", ["ALL", "EXPLICIT", "NONE"])
def test_output_modes_match_reference(files, tmp_path, mode):
    argv = ["--input-paths", files["train"], "--validation-paths", files["valid"], *SHARDS,
            "--coordinate-configurations", GLOBAL, PER_USER, "--update-sequence", "global,perUser",
            "--evaluators", "AUC", "--output-mode", mode]
    j_summary, t_summary, jdir, tdir = _train_both(tmp_path, argv, mode)
    _assert_summaries_agree(j_summary, t_summary)
    assert _layout(tdir) == _layout(jdir)
    if mode == "ALL":
        for i in range(2):
            _assert_model_dirs_agree(jdir / "models" / f"configs-{i}", tdir / "models" / f"configs-{i}")
    elif mode == "NONE":
        assert _layout(tdir) == ["training-summary.json"]


# ---------------------------------------------------------------------------
# Scores, devices, flags and imports.
# ---------------------------------------------------------------------------


def test_scores_do_not_depend_on_the_batch_size(runs, files, tmp_path):
    """The same rows scored from one file and from two give equal scores:
    every coordinate scores a row by a per-row product and sum."""
    best = runs["tdir"] / "best"
    whole = _score("port", best, files["valid"], tmp_path / "whole")
    split = _score("port", best, str(files["dir"] / "split"), tmp_path / "split")
    assert whole["numScored"] == split["numScored"] == 200
    a, b = (load_scores(str(tmp_path / d / "scores.avro")) for d in ("whole", "split"))
    assert [r["predictionScore"] for r in a] == [r["predictionScore"] for r in b]
    assert [r["uid"] for r in a] == [str(i) for i in range(200)] == [r["uid"] for r in b]


def test_unseen_entities_score_only_their_known_coordinates(runs, files):
    """Users u8 and u9 of the validation file were never trained: their rows
    score the fixed effect and the per-item effect, and 0 for per user."""
    out = runs["tdir"]
    imaps, eidx = _port_maps(out)
    model = load_game_model(str(out / "best"), imaps, eidx, device="cpu")
    shard_cfgs = {}
    for spec in SHARDS[1:]:
        shard_cfgs.update(common.parse_feature_shard_config(spec))
    batch, _, _ = read_merged([files["valid"]], shard_cfgs, imaps, {"userId": "userId", "itemId": "itemId"},
                              eidx, intern_new_entities=False, device="cpu")
    unseen = batch.entity_ids["userId"] < 0
    assert int(unseen.sum()) == 40
    per_user = model.models["perUser"].score(batch)
    assert torch.all(per_user[unseen] == 0) and torch.any(per_user[~unseen] != 0)
    scores = [r["predictionScore"] for r in load_scores(str(runs["root"] / "score-port-by-port" / "scores.avro"))]
    np.testing.assert_array_equal(np.asarray(scores, np.float32), model.score_with_offset(batch).numpy())


@pytest.mark.parametrize("driver", ["game_training", "game_scoring"])
def test_drivers_default_to_cuda_and_never_fall_back(runs, files, tmp_path, driver):
    if driver == "game_training":
        module, argv = game_training, ["--input-paths", files["train"], *SHARDS, "--coordinate-configurations",
                                       GLOBAL, "--update-sequence", "global"]
    else:
        module, argv = game_scoring, ["--input-paths", files["valid"], *SHARDS, "--model-input-dir",
                                      str(runs["tdir"] / "best")]
    argv += ["--output-dir", str(tmp_path / "o")]
    assert module.build_parser().parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "o").exists()


# Flags these drivers refused before the telemetry was ported: each now gets
# past the refusal and the driver stops only at the missing input.
_TRAINING_UNPORTED = [["--telemetry-out", "t.jsonl"], ["--otlp-endpoint", "http://localhost:1"]]
_SCORING_UNPORTED = [["--telemetry-out", "t.jsonl"]]


@pytest.mark.parametrize("driver,flag", [("game_training", f) for f in _TRAINING_UNPORTED]
                         + [("game_scoring", f) for f in _SCORING_UNPORTED],
                         ids=lambda v: v if isinstance(v, str) else v[0])
def test_drivers_refuse_unported_flags(tmp_path, driver, flag):
    argv = {"game_training": ["--input-paths", "t.avro", "--coordinate-configurations", GLOBAL,
                              "--update-sequence", "global", "--device", "cpu"],
            "game_scoring": ["--input-paths", "t.avro", "--model-input-dir", "m/best", "--device", "cpu"]}[driver]
    module = {"game_training": game_training, "game_scoring": game_scoring}
    with pytest.raises(Exception) as exc:  # no input under "t.avro"
        module[driver].main(argv + ["--output-dir", str(tmp_path / "o")] + flag)
    assert "not ported yet" not in str(exc.value)


def _decoded_coefficients(model_dir):
    """{(coordinate, modelId): {(name, term): value}} of a model directory."""
    return {(cid, mid): rec[0] for cid, recs in _coefficient_records(model_dir, read_avro_records).items()
            for mid, rec in recs.items()}


@pytest.mark.parametrize("spill", ["host_memory", "spill_member"])
def test_out_of_core_training_driver_matches_resident_and_reference(files, tmp_path, spill):
    """game_training with --re-device-budget-mb (and --re-spill-dir,
    --re-spill-member): the port's model is its unbudgeted model bit for bit
    (decoded records), and the reference's budgeted driver's within 1e-3;
    the spill files lie under host-<k>/, one set a coordinate. (The
    reference runs without the spill flags: its two random effects would
    overwrite each other's mapped spill files, ROADMAP queue 3; a spill
    changes no value.)"""
    argv = ["--input-paths", files["train"], "--validation-paths", files["valid"], *SHARDS,
            "--coordinate-configurations", GLOBAL, PER_USER, PER_ITEM,
            "--update-sequence", "global,perUser,perItem", "--coordinate-descent-iterations", "2",
            "--re-active-set", "--evaluators", "AUC", "--re-device-budget-mb", "0.001"]
    spill_flags = []
    if spill == "spill_member":
        spill_flags = ["--re-spill-dir", str(tmp_path / "spill"), "--re-spill-member", "updater:3"]
    resident = game_training.main(argv[:-2] + ["--output-dir", str(tmp_path / "resident"), "--device", "cpu"])
    j_summary = j_game_training.run(j_game_training.build_parser().parse_args(
        argv + ["--output-dir", str(tmp_path / "jax")]))
    t_summary = game_training.main(argv + spill_flags + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert t_summary["best"]["config"] == resident["best"]["config"]
    assert _decoded_coefficients(tmp_path / "port" / "best") == _decoded_coefficients(tmp_path / "resident" / "best")
    _assert_summaries_agree(j_summary, t_summary)
    _assert_model_dirs_agree(tmp_path / "jax" / "best", tmp_path / "port" / "best")
    if spill == "spill_member":
        assert sorted(p.name for p in (tmp_path / "spill").iterdir()) == ["host-3"]
        for cid in ("perUser", "perItem"):
            assert list((tmp_path / "spill" / "host-3").glob(f"{cid}.block*_features.npy"))


def test_feature_indexing_partitioned_stores_match_reference(files, tmp_path):
    """feature_indexing --num-partitions 3 in both packages: the same
    summary and store files byte for byte (tests/test_drivers.py:183-200),
    each readable by the other package's reader."""
    import filecmp

    from photon_tpu.data.native_index import NativeIndexMap as JNativeIndexMap
    from photon_tpu_torch.data.native_index import NativeIndexMap

    shards = ["--feature-shard-configurations", "name=globalShard,feature.bags=features|itemFeatures",
              "name=noIntercept,intercept=false", "--num-partitions", "3"]
    j_out = j_feature_indexing.run(j_feature_indexing.build_parser().parse_args(
        ["--input-paths", files["train"], "--output-dir", str(tmp_path / "jidx"), *shards]))
    t_out = feature_indexing.main(["--input-paths", files["train"], "--output-dir", str(tmp_path / "tidx"), *shards])
    assert t_out == j_out == {"globalShard": 10, "noIntercept": 6}
    assert _layout(tmp_path / "tidx") == _layout(tmp_path / "jidx")
    for rel in _layout(tmp_path / "jidx"):
        assert filecmp.cmp(tmp_path / "jidx" / rel, tmp_path / "tidx" / rel, shallow=False), rel
    for shard, size in t_out.items():
        ours = NativeIndexMap(str(tmp_path / "tidx" / f"index-store-{shard}"), use_native=True)
        theirs = JNativeIndexMap(str(tmp_path / "jidx" / f"index-store-{shard}"), use_native=False)
        assert len(ours) == len(theirs) == size
        for i in range(size):
            name = ours.get_feature_name(i)
            assert name == theirs.get_feature_name(i) and theirs.get_index(name) == i
        ours.close()
        theirs.close()


@pytest.mark.parametrize("override", [False, True])
def test_training_refuses_a_non_empty_output_dir(files, tmp_path, override):
    out = tmp_path / "o"
    out.mkdir()
    (out / "old.txt").write_text("x")
    argv = ["--input-paths", files["train"], *SHARDS, "--coordinate-configurations", GLOBAL,
            "--update-sequence", "global", "--evaluators", "--output-dir", str(out), "--device", "cpu"]
    if not override:
        with pytest.raises(FileExistsError):
            game_training.main(argv)
        return
    game_training.main(argv + ["--override-output-dir"])
    assert not (out / "old.txt").exists() and (out / "best").is_dir()


def test_drivers_run_as_modules_without_jax(files, tmp_path):
    """The three drivers as ``python -m`` modules in one fresh interpreter:
    they index, train and score, and never import jax or the JAX package."""
    w = str(tmp_path)
    code = (
        "import runpy, sys\n"
        "def drive(mod, argv):\n"
        "    sys.argv = [mod] + argv\n"
        "    runpy.run_module('photon_tpu_torch.cli.' + mod, run_name='__main__')\n"
        f"shards = {SHARDS!r}\n"
        f"drive('feature_indexing', ['--input-paths', {files['train']!r}, '--output-dir', {w!r} + '/idx'] + shards)\n"
        f"drive('game_training', ['--input-paths', {files['train']!r}, '--validation-paths', {files['valid']!r},"
        f" '--output-dir', {w!r} + '/out', '--feature-index-dir', {w!r} + '/idx', '--coordinate-configurations',"
        f" {GLOBAL!r}, {PER_USER!r}, '--update-sequence', 'global,perUser', '--device', 'cpu'] + shards)\n"
        f"drive('game_scoring', ['--input-paths', {files['valid']!r}, '--output-dir', {w!r} + '/sc',"
        f" '--model-input-dir', {w!r} + '/out/best', '--evaluators', 'AUC', '--device', 'cpu'] + shards)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'photon_tpu') or k.startswith(('jax.', 'photon_tpu.')))\n"
        "sys.exit(3 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1])["numScored"] == 200 and "AUC" in json.loads(lines[-1])["metrics"]
    assert (tmp_path / "out" / "best" / "random-effect" / "perUser" / "coefficients" / "part-00000.avro").exists()


# ---------------------------------------------------------------------------
# The pieces: validators, grammars, date ranges.
# ---------------------------------------------------------------------------


_BAD = {
    "ok": lambda b: None,
    "nan_label": lambda b: b["label"].__setitem__(0, np.nan),
    "label_out_of_domain": lambda b: b["label"].__setitem__(0, 2.0),
    "negative_weight": lambda b: b["weight"].__setitem__(0, -1.0),
    "inf_offset": lambda b: b["offset"].__setitem__(0, np.inf),
    "nan_feature_second_shard": lambda b: b["b"].__setitem__((0, 1), np.nan),
    "off_stride_nan_feature": lambda b: b["a"].__setitem__((1, 0), np.nan),
}


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "POISSON_REGRESSION", "LINEAR_REGRESSION"])
@pytest.mark.parametrize("bad", list(_BAD))
@pytest.mark.parametrize("mode", ["VALIDATE_FULL", "VALIDATE_SAMPLE", "VALIDATE_DISABLED"])
def test_validate_game_batch_follows_reference(mode, bad, task):
    # 20001 rows: VALIDATE_SAMPLE takes every second row, so row 1 is out.
    n = 20001
    rng = np.random.default_rng(43)
    arrays = {"label": (rng.uniform(size=n) < 0.5).astype(np.float32), "weight": np.ones(n, np.float32),
              "offset": np.zeros(n, np.float32), "a": rng.normal(size=(n, 3)).astype(np.float32),
              "b": rng.normal(size=(n, 2)).astype(np.float32)}
    _BAD[bad](arrays)

    def outcome(validate, error, batch, task_type):
        try:
            validate(batch, task_type[task], mode_type[mode])
            return None
        except error as e:
            return str(e)

    mode_type = j_validators.DataValidationType
    j_batch = JGameBatch(*(jnp.asarray(arrays[k]) for k in ("label", "offset", "weight")),
                         {"a": jnp.asarray(arrays["a"]), "b": jnp.asarray(arrays["b"])}, {})
    want = outcome(j_validators.validate_game_batch, j_validators.DataValidationError, j_batch, JTask)
    mode_type = validators.DataValidationType
    t_batch = GameBatch(*(torch.from_numpy(arrays[k]) for k in ("label", "offset", "weight")),
                        {"a": torch.from_numpy(arrays["a"]), "b": torch.from_numpy(arrays["b"])}, {})
    got = outcome(validators.validate_game_batch, validators.DataValidationError, t_batch, TaskType)
    assert got == want
    assert (want is None) == (bad == "ok" or mode == "VALIDATE_DISABLED" or (
        bad == "off_stride_nan_feature" and mode == "VALIDATE_SAMPLE") or (
        bad == "label_out_of_domain" and task != "LOGISTIC_REGRESSION"))


def test_validate_game_batch_refuses_a_sparse_shard():
    """A sparse shard is checked through its values: refused with a
    non-finite value, as the reference refuses it, and passed without."""
    from photon_tpu_torch.data.batch import SparseFeatures

    t = torch.zeros(3)
    values = torch.tensor([[1.0, 0.0], [float("nan"), 2.0], [0.5, 0.0]])
    sparse = SparseFeatures(torch.zeros(3, 2, dtype=torch.int32), values, 5000)
    batch = GameBatch(t, t, torch.ones(3), {"s": sparse}, {})
    with pytest.raises(validators.DataValidationError, match=r"features\[s\] contains non-finite"):
        validators.validate_game_batch(batch, TaskType.LINEAR_REGRESSION)
    ok = GameBatch(t, t, torch.ones(3), {"s": SparseFeatures(sparse.indices, torch.nan_to_num(values), 5000)}, {})
    validators.validate_game_batch(ok, TaskType.LINEAR_REGRESSION)


_COORDINATE_SPECS = [
    "name=global,feature.shard=s",
    "name=global,feature.shard=s,optimizer=tron,reg.weights=0.1|1|10,reg.alpha=0.5,max.iter=7,tol=1e-5",
    "name=global,feature.shard=s,down.sampling.rate=0.25,optimizer=OWLQN",
    "name=u,feature.shard=s,random.effect.type=userId",
    "name=u,feature.shard=s,random.effect.type=userId,reg.weights=2|3,active.data.upper.bound=40,"
    "active.data.lower.bound=3,features.to.samples.ratio=0.5,active.set=true,convergence.tol=1e-3,max.iter=4",
    "name=u, feature.shard=s , random.effect.type=itemId,active.set=no,optimizer=NEWTON,,",
]
_COORDINATE_ERRORS = [
    "feature.shard=s",  # no name
    "name=g",  # no shard
    "name=g,feature.shard=s,optimizer=SGD",
    "name=g,feature.shard=s,reg.weight=1",  # unknown key
    "name=g,feature.shard=s,random.effect.type=u,down.sampling.rate=0.5",  # fixed-effect key on a random effect
    "name=g,feature.shard=s,max.iter=x",
    "name=g,feature.shard=s,oops",
]
_FIELDS = ("coordinate_id", "feature_shard", "max_iter", "tol", "reg_weights", "reg_alpha", "down_sampling_rate",
           "re_type", "active_upper_bound", "active_lower_bound", "features_to_samples_ratio", "active_set",
           "convergence_tol")


@pytest.mark.parametrize("spec", _COORDINATE_SPECS)
def test_parse_coordinate_config_matches_reference(spec):
    want, got = j_common.parse_coordinate_config(spec), common.parse_coordinate_config(spec)
    assert type(got).__name__ == type(want).__name__
    assert got.optimizer.name == want.optimizer.name
    for f in _FIELDS:
        assert getattr(got, f, "absent") == getattr(want, f, "absent"), f


@pytest.mark.parametrize("spec", _COORDINATE_ERRORS)
def test_parse_coordinate_config_errors_match_reference(spec):
    with pytest.raises(Exception) as want:
        j_common.parse_coordinate_config(spec)
    with pytest.raises(Exception) as got:
        common.parse_coordinate_config(spec)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,ok", [
    ("name=g", True), ("name=g,feature.bags=features|itemFeatures|userFeatures", True),
    ("name=g,intercept=false,feature.bags=a", True), ("name=g,intercept=TRUE", True),
    ("name=g,bags=a", False), ("feature.bags=a", False), ("name=g,a", False),
])
def test_parse_feature_shard_config_matches_reference(spec, ok):
    if not ok:
        with pytest.raises(Exception) as want:
            j_common.parse_feature_shard_config(spec)
        with pytest.raises(Exception) as got:
            common.parse_feature_shard_config(spec)
        assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
        return
    (name, want), = j_common.parse_feature_shard_config(spec).items()
    (tname, got), = common.parse_feature_shard_config(spec).items()
    assert (tname, list(got.feature_bags), got.has_intercept) == (name, list(want.feature_bags), want.has_intercept)


def test_parse_input_column_names_matches_reference():
    spec = "response=y,weight=w,offset=o,uid=id,metadata=meta"
    assert dataclasses.asdict(common.parse_input_column_names(spec)) == dataclasses.asdict(
        j_common.parse_input_column_names(spec))
    assert common.parse_input_column_names(None) is None
    for bad in ("label=y", "response="):
        with pytest.raises(ValueError):
            common.parse_input_column_names(bad)


def _daily_tree(root, days):
    for day in days:
        (root / "daily" / f"{day.year:04d}" / f"{day.month:02d}" / f"{day.day:02d}").mkdir(parents=True)


@pytest.mark.parametrize("date_spec,days_spec", [
    ("20240101-20240103", None), ("20240102-20240110", None), ("20231230-20240101", None),
    (None, "3-1"), (None, "0-0"), ("20240101-20240101", "5-0"),
])
def test_date_and_days_ranges_match_reference(tmp_path, date_spec, days_spec):
    today = dt.date.today()
    days = [dt.date(2024, 1, 1), dt.date(2024, 1, 2), dt.date(2024, 1, 3), dt.date(2024, 1, 5),
            dt.date(2023, 12, 31)] + [today - dt.timedelta(days=k) for k in (1, 2, 3)]
    _daily_tree(tmp_path / "a", days)
    _daily_tree(tmp_path / "b", days[:2])
    bases = [str(tmp_path / "a"), str(tmp_path / "b")]
    args = type("Args", (), dict(input_paths=bases, input_data_date_range=date_spec,
                                 input_data_days_range=days_spec))()

    def outcome(fn):
        try:
            return fn(args)
        except (ValueError, FileNotFoundError) as e:
            return type(e).__name__

    assert outcome(common.resolve_input_paths) == outcome(j_common.resolve_input_paths)


@pytest.mark.parametrize("spec", ["20240105-20240101", "2024-01-01", "20240101", "x-y"])
def test_bad_date_ranges_match_reference(spec):
    with pytest.raises(ValueError) as want:
        j_io_utils.DateRange.parse(spec)
    with pytest.raises(ValueError) as got:
        io_utils.DateRange.parse(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["1-3", "-1-0", "a-b"])
def test_bad_days_ranges_match_reference(spec):
    with pytest.raises(ValueError) as want:
        j_io_utils.DaysRange.parse(spec)
    with pytest.raises(ValueError) as got:
        io_utils.DaysRange.parse(spec)
    assert str(got.value) == str(want.value)


def test_process_output_dir_and_text_files_match_reference(tmp_path):
    for mod, d in ((io_utils, tmp_path / "port"), (j_io_utils, tmp_path / "jax")):
        mod.process_output_dir(str(d), False)  # creates it
        mod.write_text(str(d / "a" / "t.txt"), ["x", "y"])
        assert mod.read_text(str(d / "a" / "t.txt")) == ["x", "y"]
        with pytest.raises(FileExistsError):
            mod.process_output_dir(str(d), False)
        mod.process_output_dir(str(d), True)
        assert os.listdir(d) == []
