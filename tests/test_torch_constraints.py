"""The port's per-feature constraints (data/constraints.py, copied from the
JAX package) and the driver flags that use them, ``train_glm
--constraint-string`` and ``game_training --coordinate-constraints``,
against the JAX package on the CPU: tests/test_constraints.py's cases on
both packages, and both packages' drivers on the same files (dense, and a
wide sparse file), compared as tests/test_torch_game_drivers.py compares
drivers (float32 on both sides: coefficients within 1e-3·max(1, max |w|)).
"""

import json

import numpy as np
import pytest

from photon_tpu.cli import game_training as j_game_training
from photon_tpu.cli import train_glm as j_train_glm
from photon_tpu.data.constraints import constraint_bound_vectors as j_bounds
from photon_tpu.data.index_map import IndexMap as JIndexMap
from photon_tpu.io.avro import write_avro_records
from photon_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA

from photon_tpu_torch.cli import game_scoring, game_training, train_glm
from photon_tpu_torch.data.constraints import constraint_bound_vectors
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.io.avro import read_avro_records
from tests.test_torch_game_drivers import (
    _assert_model_dirs_agree,
    _assert_score_files_agree,
    _assert_summaries_agree,
    _coefficient_records,
)

TOL = 1e-3


def _maps():
    keys = [IndexMap.key("age", ""), IndexMap.key("geo", "us"), IndexMap.key("geo", "uk")]
    return IndexMap.build(keys, add_intercept=True), JIndexMap.build(keys, add_intercept=True)


_CASES = {
    "explicit": [{"name": "age", "term": "", "lowerBound": -1.0, "upperBound": 1.0},
                 {"name": "geo", "term": "uk", "lowerBound": 0.0}],
    "term_wildcard": [{"name": "geo", "term": "*", "upperBound": 2.0}],
    "all_wildcard": [{"name": "*", "term": "*", "lowerBound": -3.0, "upperBound": 3.0}],
    "absent_feature": [{"name": "nope", "term": "x", "lowerBound": 0.0}],
    "missing_term": [{"name": "age"}],
    "both_infinite": [{"name": "age", "term": ""}],
    "lower_above_upper": [{"name": "age", "term": "", "lowerBound": 2.0, "upperBound": 1.0}],
    "wildcard_name_only": [{"name": "*", "term": "x", "lowerBound": 0.0}],
    "overlap": [{"name": "geo", "term": "uk", "lowerBound": 0.0}, {"name": "geo", "term": "*", "upperBound": 1.0}],
    "wildcard_combined": [{"name": "age", "term": "", "lowerBound": 0.0},
                          {"name": "*", "term": "*", "upperBound": 1.0}],
    "not_an_array": {"name": "age", "term": "", "lowerBound": 0.0},
}


@pytest.mark.parametrize("with_intercept", [False, True])
@pytest.mark.parametrize("case", list(_CASES))
def test_constraint_vectors_match_reference(case, with_intercept):
    """The same bounds (or None), or the same refusal, as the reference."""
    tmap, jmap = _maps()
    s = json.dumps(_CASES[case])
    icpt = tmap.get_index(IndexMap.INTERCEPT) if with_intercept else None

    def run(fn, imap):
        try:
            return fn(s, imap, len(imap), icpt)
        except ValueError as e:
            return ("error", str(e))

    got, want = run(constraint_bound_vectors, tmap), run(j_bounds, jmap)
    if want is None or isinstance(want[0], str):
        assert got == want
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    if case == "all_wildcard" and with_intercept:
        assert np.isinf(got[0][icpt]) and np.isinf(got[1][icpt])


def _fixture(path, n=500, d=4, n_users=8, seed=0):
    """tests/test_drivers.py::write_fixture's rows (w = linspace(-1, 1, d),
    user biases), from a seed of their own."""
    rng = np.random.default_rng(seed)
    w, user_bias = np.linspace(-1, 1, d), np.linspace(-2, 2, n_users)
    recs = []
    for i in range(n):
        x = rng.normal(size=d)
        y = float(rng.uniform() < 1 / (1 + np.exp(-(x @ w + user_bias[i % n_users]))))
        recs.append({"uid": str(i), "label": y, "metadataMap": {"userId": f"u{i % n_users}"}, "weight": 1.0,
                     "offset": 0.0, "features": [{"name": f"x{j}", "term": "", "value": float(x[j])}
                                                 for j in range(d)]})
    write_avro_records(str(path), TRAINING_EXAMPLE_SCHEMA, recs)
    return str(path)


def _train_both(tmp_path, argv, name="out"):
    jdir, tdir = tmp_path / "jax" / name, tmp_path / "port" / name
    js = j_game_training.run(j_game_training.build_parser().parse_args(argv + ["--output-dir", str(jdir)]))
    ts = game_training.main(argv + ["--output-dir", str(tdir), "--device", "cpu"])
    return js, ts, jdir, tdir


def test_game_driver_constraints_bind_like_reference(tmp_path):
    """tests/test_constraints.py's GAME driver case on both packages: x0 and
    x3 boxed to ±0.02 come out on their bounds, and the model directories
    agree."""
    train = _fixture(tmp_path / "train.avro")
    box = {"global": [{"name": "x0", "term": "", "lowerBound": -0.02, "upperBound": 0.02},
                      {"name": "x3", "term": "", "lowerBound": -0.02, "upperBound": 0.02}]}
    argv = ["--input-paths", train, "--feature-shard-configurations", "name=s", "--coordinate-configurations",
            "name=global,feature.shard=s,reg.weights=0.01", "--update-sequence", "global", "--evaluators",
            "--coordinate-constraints", json.dumps(box)]
    js, ts, jdir, tdir = _train_both(tmp_path, argv)
    _assert_summaries_agree(js, ts)
    _assert_model_dirs_agree(jdir / "best", tdir / "best")
    (means, *_), = _coefficient_records(tdir / "best", read_avro_records)["global"].values()
    assert means[("x0", "")] == pytest.approx(-0.02, abs=1e-3)
    assert means[("x3", "")] == pytest.approx(0.02, abs=1e-3)
    assert abs(means[("x1", "")]) > 0.05 or abs(means[("x2", "")]) > 0.05


@pytest.mark.parametrize("bad", ["random_effect", "unknown"])
def test_game_driver_refuses_constraints_like_reference(tmp_path, bad):
    train = _fixture(tmp_path / "train.avro", n=60)
    cid = "perUser" if bad == "random_effect" else "nope"
    argv = ["--input-paths", train, "--feature-shard-configurations", "name=s", "--coordinate-configurations",
            "name=global,feature.shard=s,reg.weights=1", "name=perUser,feature.shard=s,random.effect.type=userId",
            "--update-sequence", "global,perUser", "--evaluators",
            "--coordinate-constraints", json.dumps({cid: [{"name": "x0", "term": "", "lowerBound": 0.0}]})]
    with pytest.raises(ValueError) as want:
        j_game_training.run(j_game_training.build_parser().parse_args(argv + ["--output-dir", str(tmp_path / "j")]))
    with pytest.raises(ValueError) as got:
        game_training.main(argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    assert str(got.value) == str(want.value)


def _libsvm(path, n=300, seed=3):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        x = rng.normal(size=3)
        y = 1 if rng.uniform() < 1 / (1 + np.exp(-(2.0 * x[0] - 2.0 * x[1]))) else -1
        lines.append(f"{y:+d} 1:{x[0]:.4f} 2:{x[1]:.4f} 3:{x[2]:.4f}")
    path.write_text("\n".join(lines))
    return str(path)


def _text_model(path):
    return {line.split("\t")[0]: float(line.split("\t")[1]) for line in path.read_text().splitlines()
            if "\t" in line}


@pytest.mark.parametrize("optimizer", ["LBFGS", "LBFGSB", "TRON"])
def test_legacy_driver_constraint_string_like_reference(tmp_path, optimizer):
    """tests/test_constraints.py's train_glm case on both packages: feature
    1 binds at its 0.1 upper bound, feature 2 stays free, and the text
    models agree."""
    data = _libsvm(tmp_path / "t.txt")
    s = json.dumps([{"name": "1", "term": "", "lowerBound": -0.1, "upperBound": 0.1}])
    argv = ["--training-data", data, "--format", "libsvm", "--task", "LOGISTIC_REGRESSION",
            "--regularization-weights", "0.01", "--constraint-string", s, "--optimizer", optimizer]
    j_train_glm.run(j_train_glm.build_parser().parse_args(argv + ["--output-dir", str(tmp_path / "j")]))
    train_glm.main(argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    want, got = (_text_model(tmp_path / d / "model-lambda-0.01.txt") for d in ("j", "t"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=TOL * max(1.0, abs(v))), k
    assert got["1"] == pytest.approx(0.1, abs=5e-3)
    assert got["2"] < -0.5


def test_constraint_string_and_coefficient_box_are_exclusive(tmp_path):
    data = _libsvm(tmp_path / "t.txt", n=40)
    argv = ["--training-data", data, "--format", "libsvm", "--coefficient-box=-1,1", "--constraint-string",
            json.dumps([{"name": "1", "term": "", "upperBound": 0.1}])]
    with pytest.raises(ValueError) as want:
        j_train_glm.run(j_train_glm.build_parser().parse_args(argv + ["--output-dir", str(tmp_path / "j")]))
    with pytest.raises(ValueError) as got:
        train_glm.main(argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    assert str(got.value) == str(want.value)


def _wide_records(n, seed, vocab=8000, nnz=25, n_users=10):
    """Rows of a shard wider than the reader's dense limit (~5,700 of
    ``vocab`` features occur in 400 rows), a bias per user."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(77).normal(size=vocab)
    recs = []
    for i in range(n):
        cols = rng.choice(vocab, size=nnz, replace=False)
        x = rng.normal(size=nnz)
        u = i % n_users
        logit = 0.5 * x @ w[cols] + (u - n_users / 2) * 0.3
        recs.append({"uid": str(i), "label": float(rng.uniform() < 1 / (1 + np.exp(-logit))), "weight": 1.0,
                     "offset": 0.0, "metadataMap": {"userId": f"u{u}"},
                     "features": [{"name": f"f{c}", "term": "", "value": float(v)} for c, v in zip(cols, x)]})
    return recs


def test_sparse_game_driver_with_constraints_matches_reference(tmp_path):
    """A file wider than the dense limit through both packages'
    game_training (a sparse global shard with a box on two features, a
    per-user coordinate on the same sparse shard in projected blocks) and
    game_scoring: summaries, model directories and score files agree, each
    package scoring the other's model."""
    train, valid = (str(tmp_path / f"{p}.avro") for p in ("train", "valid"))
    write_avro_records(train, TRAINING_EXAMPLE_SCHEMA, _wide_records(400, 1))
    write_avro_records(valid, TRAINING_EXAMPLE_SCHEMA, _wide_records(200, 2))
    box = {"global": [{"name": "f1", "term": "", "lowerBound": -0.05, "upperBound": 0.05},
                      {"name": "f2", "term": "", "upperBound": 0.0}]}
    shards = ["--feature-shard-configurations", "name=wide"]
    argv = ["--input-paths", train, "--validation-paths", valid, *shards, "--coordinate-configurations",
            "name=global,feature.shard=wide,reg.weights=1", "name=perUser,feature.shard=wide,random.effect.type=userId,"
            "reg.weights=10", "--update-sequence", "global,perUser", "--evaluators", "AUC",
            "--coordinate-descent-iterations", "2", "--coordinate-constraints", json.dumps(box)]
    js, ts, jdir, tdir = _train_both(tmp_path, argv)
    assert len(IndexMap.load(str(tdir / "index-map-wide.json"))) > 4096
    _assert_summaries_agree(js, ts)
    _assert_model_dirs_agree(jdir / "best", tdir / "best")
    (means, *_), = _coefficient_records(tdir / "best", read_avro_records)["global"].values()
    assert abs(means.get(("f1", ""), 0.0)) <= 0.05 + 1e-6 and means.get(("f2", ""), 0.0) <= 1e-6
    from photon_tpu.cli import game_scoring as j_game_scoring

    for name, model in (("jax", jdir), ("port", tdir)):
        sargv = ["--input-paths", valid, *shards, "--model-input-dir", str(model / "best"), "--evaluators", "AUC"]
        j_game_scoring.run(j_game_scoring.build_parser().parse_args(
            sargv + ["--output-dir", str(tmp_path / f"js-{name}")]))
        game_scoring.main(sargv + ["--output-dir", str(tmp_path / f"ts-{name}"), "--device", "cpu"])
        _assert_score_files_agree(tmp_path / f"js-{name}" / "scores.avro", tmp_path / f"ts-{name}" / "scores.avro")
