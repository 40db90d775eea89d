"""The port's native columnar Avro decoder (photon_tpu_torch/io/columnar.py
and the columnar half of io/data_reader.py) on the CPU.

Every case of tests/test_columnar.py runs on the port: program compilation,
decode against rows, ``read_merged`` at both dense limits, the
response-prediction schema, numeric, long (beyond 2^53) and double entity
ids, and the speed case. Then, bit for bit: the port's ``ColumnarRows``
against the reference's, the port's columnar batches against the
reference's columnar batches and against the port's own row path (dense and
padded-sparse), and ``stream_avro_columnar``'s chunks against the whole
decode. The decoder builds at once in three processes without a partial
file, and ``READ_PATHS`` counts the path of every read.

Padded-sparse indices: the reference's columnar path pads unused slots with
index -1, the port's ``SparseFeatures`` with index 0 (as both row paths do);
the comparison with the reference maps -1 to 0 where the value is 0.
"""

import copy
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_tpu.io import columnar as jcol
from photon_tpu.io.data_reader import FeatureShardConfig as JShardConfig
from photon_tpu.io.data_reader import read_merged as j_read_merged

from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.io import columnar
from photon_tpu_torch.io.avro import write_avro_records
from photon_tpu_torch.io.data_reader import READ_PATHS, FeatureShardConfig, read_merged
from photon_tpu_torch.io.schemas import FEATURE_SCHEMA, RESPONSE_PREDICTION_SCHEMA, TRAINING_EXAMPLE_SCHEMA

REPO = Path(__file__).resolve().parent.parent

# A second bag, as the GAME drivers' fixtures have (a by-name FeatureAvro).
TWO_BAGS = copy.deepcopy(TRAINING_EXAMPLE_SCHEMA)
TWO_BAGS["fields"].append({"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}})


def _write_training_examples(path, n=300, d=10, with_nulls=True, seed=77, second_bag=False):
    """The fixture of tests/test_columnar.py (optionally with a second bag)."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        nnz = rng.integers(1, d)
        idx = rng.choice(d, size=nnz, replace=False)
        rec = {
            "uid": None if (with_nulls and i % 7 == 0) else str(i),
            "label": float(i % 2),
            "features": [{"name": f"f{j}", "term": "t" if j % 3 == 0 else "", "value": float(rng.normal())}
                         for j in idx],
            "metadataMap": None if (with_nulls and i % 5 == 0) else {"userId": f"u{i % 13}", "extra": "x"},
            "weight": None if (with_nulls and i % 11 == 0) else 1.0 + (i % 3),
            "offset": None if (with_nulls and i % 13 == 0) else 0.1 * (i % 4),
        }
        if second_bag:
            rec["userFeatures"] = [{"name": f"g{j}", "term": "", "value": float(rng.normal())}
                                   for j in rng.choice(6, size=rng.integers(0, 4), replace=False)]
        records.append(rec)
    write_avro_records(str(path), TWO_BAGS if second_bag else TRAINING_EXAMPLE_SCHEMA, records,
                       block_records=64)
    return records


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same_features(a, b):
    """Bit-for-bit equal shards (dense, or padded-sparse with the transpose plan)."""
    if isinstance(a, SparseFeatures):
        assert isinstance(b, SparseFeatures) and a.dim == b.dim
        for x, y in zip(a.tensors(), b.tensors()):
            np.testing.assert_array_equal(_np(x), _np(y))
    else:
        np.testing.assert_array_equal(_np(a), _np(b))


def _assert_same_batches(fast, slow):
    for name in ("label", "offset", "weight", "uid"):
        np.testing.assert_array_equal(_np(getattr(fast, name)), _np(getattr(slow, name)))
    assert fast.features.keys() == slow.features.keys()
    for k in fast.features:
        _assert_same_features(fast.features[k], slow.features[k])
    assert fast.entity_ids.keys() == slow.entity_ids.keys()
    for k in fast.entity_ids:
        np.testing.assert_array_equal(_np(fast.entity_ids[k]), _np(slow.entity_ids[k]))


# --- the cases of tests/test_columnar.py ------------------------------------------------


def test_program_compilation():
    prog, names = columnar.compile_program(TRAINING_EXAMPLE_SCHEMA)
    assert names == ["uid", "label", "features", "metadataMap", "weight", "offset"]
    assert list(prog) == [3, 0, 4, 5, 1, 1]
    prog2, _ = columnar.compile_program(RESPONSE_PREDICTION_SCHEMA)
    assert list(prog2) == [0, 4, 0, 0]
    assert columnar.compile_program({"type": "record", "fields": [
        {"name": "x", "type": {"type": "array", "items": "double"}}]}) is None
    assert columnar.compile_program(TWO_BAGS) == jcol.compile_program(TWO_BAGS)


def test_columnar_decode_matches_rows(tmp_path):
    path = tmp_path / "t.avro"
    records = _write_training_examples(path)
    cols = columnar.read_avro_columnar([str(path)])
    assert cols is not None and cols.n == len(records)
    for i, rec in enumerate(records):
        assert cols.numeric["label"][i] == rec["label"]
        w = cols.numeric["weight"][i]
        assert (np.isnan(w) and rec["weight"] is None) or w == rec["weight"]
    bag = cols.bags["features"]
    for i, rec in enumerate(records):
        lo, hi = bag.offsets[i], bag.offsets[i + 1]
        got = sorted((cols.intern[k], v) for k, v in zip(bag.key_ids[lo:hi], bag.values[lo:hi]))
        want = sorted((IndexMap.key(f["name"], f["term"]), f["value"]) for f in rec["features"])
        assert got == want
    ucol = cols.meta_column("userId")
    for i, rec in enumerate(records):
        if rec["metadataMap"] is None:
            assert ucol[i] == -1
        else:
            assert cols.intern[ucol[i]] == rec["metadataMap"]["userId"]


@pytest.mark.parametrize("dense_limit", [4096, 4])  # dense and padded-sparse
def test_read_merged_columnar_matches_row_path_bitwise(tmp_path, dense_limit):
    path = tmp_path / "t.avro"
    _write_training_examples(path, second_bag=True)
    cfg = {"s": FeatureShardConfig(feature_bags=["features", "userFeatures"], dense_dim_limit=dense_limit),
           "u": FeatureShardConfig(feature_bags=["userFeatures"], has_intercept=False)}
    ids = {"userId": "userId"}
    fast, maps_fast, eidx_fast = read_merged([str(path)], cfg, entity_id_columns=ids, device="cpu")
    slow, maps_slow, eidx_slow = read_merged([str(path)], cfg, entity_id_columns=ids, use_columnar=False,
                                             device="cpu")
    assert isinstance(fast.features["s"], SparseFeatures) == (dense_limit < 10)
    for k in cfg:
        assert dict(maps_fast[k].items()) == dict(maps_slow[k].items())
    _assert_same_batches(fast, slow)
    if dense_limit < 10:
        np.testing.assert_array_equal(_np(fast.features["s"].to_dense()), _np(slow.features["s"].to_dense()))
    assert eidx_fast["userId"].ids() == eidx_slow["userId"].ids()


@pytest.mark.parametrize("plan", [False, True])
def test_sparse_transpose_plan_matches_row_path(tmp_path, plan):
    """A padded-sparse shard with and without the transpose plan: the plan
    is built from the same pattern on both paths."""
    path = tmp_path / "t.avro"
    _write_training_examples(path, n=120)
    cfg = {"s": FeatureShardConfig(dense_dim_limit=4, transpose_plan=plan)}
    fast, _, _ = read_merged([str(path)], cfg, device="cpu")
    slow, _, _ = read_merged([str(path)], cfg, use_columnar=False, device="cpu")
    assert (fast.features["s"].csc_order is not None) == plan
    _assert_same_batches(fast, slow)


def test_response_prediction_schema_columnar(tmp_path):
    path = tmp_path / "rp.avro"
    records = [{"response": float(i % 2), "features": [{"name": "a", "term": "", "value": 1.0 * i}],
                "weight": 2.0, "offset": 0.5} for i in range(20)]
    write_avro_records(str(path), RESPONSE_PREDICTION_SCHEMA, records)
    cfg = {"s": FeatureShardConfig(feature_bags=["features"])}
    fast, _, _ = read_merged([str(path)], cfg, device="cpu")
    slow, _, _ = read_merged([str(path)], cfg, use_columnar=False, device="cpu")
    _assert_same_batches(fast, slow)


def test_columnar_is_faster(tmp_path):
    """The native columnar read beats the row-by-row Python codec."""
    path = tmp_path / "big.avro"
    _write_training_examples(path, n=4000, d=40, with_nulls=False)
    cfg = {"s": FeatureShardConfig(feature_bags=["features"])}
    columnar._load_lib()  # the build is not the read
    t0 = time.perf_counter()
    read_merged([str(path)], cfg, device="cpu")
    t_fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    read_merged([str(path)], cfg, use_columnar=False, device="cpu")
    t_slow = time.perf_counter() - t0
    assert t_fast < t_slow, (t_fast, t_slow)


def _id_rows_file(tmp_path, name, id_type, ids):
    schema = {"type": "record", "name": f"{name}Row", "fields": [
        {"name": "response", "type": "double"},
        {"name": "userId", "type": id_type},
        {"name": "features", "type": {"type": "array", "items": FEATURE_SCHEMA}}]}
    records = [{"response": float(i % 2), "userId": v, "features": [{"name": f"f{i % 5}", "term": "", "value": 1.0 + i}]}
               for i, v in enumerate(ids)]
    path = tmp_path / f"{name}.avro"
    write_avro_records(str(path), schema, records)
    return path


def _ids_both_paths(path):
    cfg = {"s": FeatureShardConfig(feature_bags=["features"])}
    ids = {"userId": "userId"}
    assert columnar.read_avro_columnar([str(path)]) is not None  # the columnar path is taken
    fast, _, eidx_fast = read_merged([str(path)], cfg, entity_id_columns=ids, device="cpu")
    slow, _, eidx_slow = read_merged([str(path)], cfg, entity_id_columns=ids, use_columnar=False, device="cpu")
    f, s = _np(fast.entity_ids["userId"]), _np(slow.entity_ids["userId"])
    np.testing.assert_array_equal(f, s)
    assert eidx_fast["userId"].ids() == eidx_slow["userId"].ids()
    return f, eidx_fast["userId"]


def test_numeric_entity_id_column_parity(tmp_path):
    ids, _ = _ids_both_paths(_id_rows_file(tmp_path, "LongId", "long", [(i % 7) * 1000 for i in range(60)]))
    assert (ids >= 0).all()


def test_long_entity_ids_beyond_double_precision(tmp_path):
    base = (1 << 53) + 1  # adjacent ids collapse in float64
    ids, eidx = _ids_both_paths(_id_rows_file(tmp_path, "HugeId", "long", [base + (i % 4) for i in range(40)]))
    assert len(set(ids.tolist())) == 4
    assert str(base) in eidx.ids()


def test_double_entity_id_column_parity(tmp_path):
    _, eidx = _ids_both_paths(_id_rows_file(tmp_path, "DoubleId", "double", [float(i % 5) for i in range(30)]))
    assert "3.0" in eidx.ids()


# --- the port against the reference ------------------------------------------------------


def test_columnar_rows_equal_reference(tmp_path):
    """The port's ColumnarRows equal the reference decoder's, bit for bit,
    over two files with a second bag, nulls and metadata."""
    paths = [tmp_path / "a.avro", tmp_path / "b.avro"]
    _write_training_examples(paths[0], second_bag=True)
    _write_training_examples(paths[1], n=150, seed=78, second_bag=True)
    got = columnar.read_avro_columnar([str(p) for p in paths])
    want = jcol.read_avro_columnar([str(p) for p in paths])
    assert got is not None and want is not None and got.n == want.n == 450
    assert got.intern == want.intern
    for field in ("numeric", "longs", "strings"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert got.bags.keys() == want.bags.keys()
    for k in got.bags:
        for part in ("offsets", "key_ids", "values"):
            np.testing.assert_array_equal(getattr(got.bags[k], part), getattr(want.bags[k], part))
    for part in ("meta_rows", "meta_keys", "meta_vals"):
        np.testing.assert_array_equal(getattr(got, part), getattr(want, part))


@pytest.mark.parametrize("dense_limit", [4096, 4])
def test_read_merged_equals_reference_columnar(tmp_path, dense_limit):
    """The port's columnar batch equals the reference's columnar batch bit
    for bit: labels, offsets, weights, dense features, padded-sparse
    indices and values, entity ids and index maps (training with a
    distinct scan, then validation rows looked up without interning)."""
    train, valid = tmp_path / "t.avro", tmp_path / "v.avro"
    _write_training_examples(train, second_bag=True)
    _write_training_examples(valid, n=90, seed=79, second_bag=True)
    bags = ["features", "userFeatures"]
    ids = {"userId": "userId"}
    cfg = {"s": FeatureShardConfig(feature_bags=bags, dense_dim_limit=dense_limit, transpose_plan=False)}
    jcfg = {"s": JShardConfig(feature_bags=bags, dense_dim_limit=dense_limit, transpose_plan=False)}
    tb, tmaps, teidx = read_merged([str(train)], cfg, entity_id_columns=ids, device="cpu")
    jb, jmaps, jeidx = j_read_merged([str(train)], jcfg, entity_id_columns=ids)
    vb, _, _ = read_merged([str(valid)], cfg, index_maps=tmaps, entity_id_columns=ids, entity_indexes=teidx,
                           intern_new_entities=False, device="cpu")
    jvb, _, _ = j_read_merged([str(valid)], jcfg, index_maps=jmaps, entity_id_columns=ids, entity_indexes=jeidx,
                              intern_new_entities=False)
    assert dict(tmaps["s"].items()) == dict(jmaps["s"].items())
    assert teidx["userId"].ids() == jeidx["userId"].ids()
    for ours, ref in ((tb, jb), (vb, jvb)):
        for name in ("label", "offset", "weight", "uid"):
            np.testing.assert_array_equal(_np(getattr(ours, name)), np.asarray(getattr(ref, name)))
        np.testing.assert_array_equal(_np(ours.entity_ids["userId"]), np.asarray(ref.entity_ids["userId"]))
        f, g = ours.features["s"], ref.features["s"]
        if dense_limit < 10:
            ref_idx, ref_val = np.asarray(g.indices), np.asarray(g.values)
            assert np.all(ref_val[ref_idx < 0] == 0)
            np.testing.assert_array_equal(_np(f.indices), np.where(ref_idx < 0, 0, ref_idx))
            np.testing.assert_array_equal(_np(f.values), ref_val)
            assert f.dim == g.dim
        else:
            np.testing.assert_array_equal(_np(f), np.asarray(g))


@pytest.mark.parametrize("workers", [1, 3])
def test_stream_chunks_merge_to_the_whole_decode(tmp_path, workers):
    paths = [tmp_path / "a.avro", tmp_path / "b.avro"]
    _write_training_examples(paths[0], n=400, second_bag=True)
    _write_training_examples(paths[1], n=210, seed=80, second_bag=True)
    whole = columnar.read_avro_columnar([str(p) for p in paths])
    chunks = list(columnar.stream_avro_columnar([str(p) for p in paths], chunk_rows=100, workers=workers))
    assert len(chunks) > 1 and all(c.n >= 64 for c in chunks)
    merged = columnar.merge_columnar(chunks)
    assert merged.n == whole.n and merged.intern == whole.intern
    for field in ("numeric", "longs", "strings"):
        for k, v in getattr(whole, field).items():
            np.testing.assert_array_equal(getattr(merged, field)[k], v)
    for k, bag in whole.bags.items():
        for part in ("offsets", "key_ids", "values"):
            np.testing.assert_array_equal(getattr(merged.bags[k], part), getattr(bag, part))
    for part in ("meta_rows", "meta_keys", "meta_vals"):
        np.testing.assert_array_equal(getattr(merged, part), getattr(whole, part))


def test_concurrent_build_leaves_no_partial_file(tmp_path):
    """Three processes load the decoder at once into an empty build
    directory: each builds to a file of its own and moves it into place, so
    all three load it and no partial file is left."""
    build = tmp_path / "native"
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "import photon_tpu_torch.io.columnar as c\n"
        "c.BUILD_DIR = Path(sys.argv[1])\n"
        "while time.time() < float(sys.argv[2]):\n"
        "    time.sleep(0.005)\n"
        "lib = c._load_lib()\n"
        "assert lib is not None, c.load_error()\n"
        "print(c._lib_path().name)\n"
    )
    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build), str(start)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1
    assert sorted(f.name for f in build.iterdir()) == sorted(names)


def test_read_paths_count_columnar_and_fallback(tmp_path, caplog):
    """A supported schema reads columnar; a schema outside the decoder's
    program takes the row path, warns with the reason once, and both paths
    give the same batch."""
    good = tmp_path / "good.avro"
    _write_training_examples(good, n=40)
    odd_schema = copy.deepcopy(TRAINING_EXAMPLE_SCHEMA)
    odd_schema["fields"].append({"name": "tags", "type": {"type": "array", "items": "string"}})
    odd = tmp_path / "odd.avro"
    records = _write_training_examples(tmp_path / "tmp.avro", n=40)
    write_avro_records(str(odd), odd_schema, [dict(r, tags=["a"]) for r in records])
    cfg = {"s": FeatureShardConfig()}
    READ_PATHS.reset()
    read_merged([str(good)], cfg, device="cpu")
    assert READ_PATHS.counts == {"columnar": 1}
    READ_PATHS._warned.clear()
    with caplog.at_level(logging.WARNING, logger="photon_tpu_torch.io.data_reader"):
        b_odd, _, _ = read_merged([str(odd)], cfg, device="cpu")
        read_merged([str(odd)], cfg, device="cpu")
    assert READ_PATHS.counts == {"columnar": 1, "rows": 2}
    (reason,) = READ_PATHS.reasons
    assert "schema" in reason
    warned = [r for r in caplog.records if "row decoder" in r.getMessage()]
    assert len(warned) == 1 and "schema" in warned[0].getMessage()
    b_rows, _, _ = read_merged([str(tmp_path / "tmp.avro")], cfg, use_columnar=False, device="cpu")
    _assert_same_batches(b_odd, b_rows)
    assert READ_PATHS.counts["rows"] == 3
