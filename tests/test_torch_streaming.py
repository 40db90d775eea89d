"""The port's streaming freshness loop (photon_tpu_torch/stream/, the
engine's feedback lane, delta generations), held as tests/test_streaming.py
holds the reference: each of its cases, running the port's code on the CPU,
with the same assertions (the models' tensors on the CPU, the engine and the
updater with ``device="cpu"``). Then the cross-package cases: a spool that
each package's engine writes is consumed by the other's updater; a delta
generation that one package publishes resolves in the other's
``load_resolved_game_model`` to the same coefficients bit for bit; and
``records_to_batch`` builds the reference's arrays exactly.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.estimators.game_transformer import GameTransformer
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.stream.spool import (
    FeedbackSpool,
    SpoolConfig,
    read_segment,
    recover_orphan_parts,
    recover_segments,
    sealed_segments,
    segment_seq,
)
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import faults
from photon_tpu_torch.utils.faults import FaultPlan, FaultRule

T = torch.as_tensor
rng = np.random.default_rng(23)

D_FIX, D_RE, N_ENTITIES = 4, 3, 8


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


def make_model(w_re, w_fix=None):
    if w_fix is None:
        w_fix = np.linspace(-1, 1, D_FIX).astype(np.float32)
    return GameModel({
        "global": FixedEffectModel(
            GeneralizedLinearModel(
                Coefficients(T(np.asarray(w_fix, np.float32))),
                TaskType.LOGISTIC_REGRESSION,
            ),
            "global",
        ),
        "per_user": RandomEffectModel(
            T(np.asarray(w_re, np.float32)), "userId", "per_user",
            TaskType.LOGISTIC_REGRESSION,
        ),
    })


def make_index_maps():
    return {
        "global": IndexMap.build([f"g{j}" for j in range(D_FIX)]),
        "per_user": IndexMap.build([f"r{j}" for j in range(D_RE)]),
    }


def make_entity_index(n=N_ENTITIES):
    eidx = EntityIndex()
    for e in range(n):
        eidx.intern(f"user{e}")
    return eidx


def batch_scores(model, xf, xr, users):
    n = len(users)
    b = GameBatch(
        label=torch.zeros(n), offset=torch.zeros(n), weight=torch.ones(n),
        features={"global": T(xf), "per_user": T(xr)},
        entity_ids={"userId": T(np.asarray(users), dtype=torch.int32)},
    )
    return GameTransformer(model).transform(b).numpy().astype(np.float32)


def _publish_full(root, gen, model, imaps, eidx, parent=None):
    from photon_tpu_torch.io.model_io import (
        gate_and_publish,
        save_game_model,
        write_generation_manifest,
    )

    save_game_model(model, os.path.join(root, gen), imaps,
                    {"userId": eidx}, sparsity_threshold=0.0)
    write_generation_manifest(os.path.join(root, gen), parent=parent)
    res = gate_and_publish(root, gen)
    assert res.ok, res.reason


def _publish_delta(root, gen, model, changed, imaps, eidx, base, gate=True):
    from photon_tpu_torch.io.model_io import (
        gate_and_publish,
        save_delta_model,
        write_generation_manifest,
    )

    mask = np.zeros(N_ENTITIES, bool)
    mask[np.asarray(changed)] = True
    save_delta_model(model, {"userId": mask}, os.path.join(root, gen),
                     imaps, {"userId": eidx}, base=base)
    write_generation_manifest(os.path.join(root, gen), parent=base)
    if gate:
        res = gate_and_publish(root, gen)
        assert res.ok, res.reason


def _save_artifacts(root, imaps, eidx):
    for shard, imap in imaps.items():
        imap.save(os.path.join(root, f"index-map-{shard}.json"))
    eidx.save(os.path.join(root, "entity-index-userId.json"))


# ---------------------------------------------------------------------------
# Feedback spool
# ---------------------------------------------------------------------------


def test_spool_join_rotation_and_readback(tmp_path):
    sdir = str(tmp_path)
    spool = FeedbackSpool(sdir, SpoolConfig(
        segment_max_records=3, segment_max_age_s=3600.0,
    ))
    for i in range(7):
        assert spool.observe_scored(
            f"u{i}", features={"global": np.arange(D_FIX, dtype=np.float32)},
            entity_ids={"userId": f"user{i % 4}"}, offset=0.5, score=0.25,
            model_version="gen-1", ts=100.0 + i,
        )
        assert spool.observe_label(f"u{i}", float(i % 2), ts=200.0 + i)
    # 7 records at 3/segment: two sealed, one active.
    assert len(sealed_segments(sdir)) == 2
    spool.flush()
    segs = sealed_segments(sdir)
    assert len(segs) == 3 and [segment_seq(s) for s in segs] == [1, 2, 3]
    recs = [r for s in segs for r in read_segment(os.path.join(sdir, s))]
    assert [r["uid"] for r in recs] == [f"u{i}" for i in range(7)]
    r0 = recs[0]
    assert r0["label"] == 0.0 and r0["labelTs"] == 200.0
    assert r0["offset"] == 0.5 and r0["score"] == 0.25
    assert r0["modelVersion"] == "gen-1" and r0["ts"] == 100.0
    assert r0["entityIds"] == {"userId": "user0"}
    assert r0["features"]["global"] == [0.0, 1.0, 2.0, 3.0]
    spool.close()


def test_spool_sampling_and_unmatched_labels(tmp_path):
    spool = FeedbackSpool(str(tmp_path), SpoolConfig(
        sample_fraction=0.5, tenant_fractions={"never": 0.0},
    ))
    kept = [
        spool.observe_scored(f"u{i}", features=None, score=0.0)
        for i in range(10)
    ]
    # Deterministic fractional accumulator: exactly every other request.
    assert sum(kept) == 5
    assert not spool.observe_scored("t0", tenant="never")
    # A label whose request was sampled out (or never scored) is unmatched.
    dropped_uid = f"u{kept.index(False)}"
    assert not spool.observe_label(dropped_uid, 1.0)
    assert not spool.observe_label("never-scored", 1.0)
    kept_uid = f"u{kept.index(True)}"
    assert spool.observe_label(kept_uid, 1.0)
    spool.close()


def test_spool_join_ttl_evicts(tmp_path):
    spool = FeedbackSpool(str(tmp_path), SpoolConfig(join_ttl_s=0.0))
    assert spool.observe_scored("u0", ts=1.0)
    spool.tick()  # TTL 0: the pending join ages out immediately
    assert not spool.observe_label("u0", 1.0)
    spool.close()


def test_spool_single_writer(tmp_path):
    spool = FeedbackSpool(str(tmp_path))
    with pytest.raises(RuntimeError, match="live writer"):
        FeedbackSpool(str(tmp_path))
    spool.close()
    FeedbackSpool(str(tmp_path)).close()


def test_spool_torn_segment_recovers_at_exact_parity(tmp_path):
    """serve.feedback torn fault: the active segment is abandoned with a
    half-written record; recovery seals the complete prefix — every record
    the spool acknowledged (True) is readable, the torn tail is dropped."""
    from photon_tpu_torch.obs.metrics import registry

    sdir = str(tmp_path)
    spool = FeedbackSpool(sdir, SpoolConfig(
        segment_max_records=100, segment_max_age_s=3600.0,
    ))
    faults.configure(FaultPlan(rules=(
        FaultRule("serve.feedback", kind="torn", at=(3,)),
    )))
    landed = []
    for i in range(5):
        spool.observe_scored(f"u{i}")
        if spool.observe_label(f"u{i}", 1.0):
            landed.append(f"u{i}")
    faults.reset()
    # Call 3 (u3) tore the active segment: u0..u2 sit in the torn part,
    # u3's label dropped, u4 landed in a fresh part.
    assert landed == ["u0", "u1", "u2", "u4"]
    spool.close()  # seals u4's part; the torn part stays orphaned

    before = registry().counter("feedback_spool_torn_recovered_total").value
    recovered = recover_segments(sdir)
    assert recovered == {"segment-00000001.jsonl": 3}
    assert (
        registry().counter("feedback_spool_torn_recovered_total").value
        == before + 1
    )
    recs = [
        r for s in sealed_segments(sdir)
        for r in read_segment(os.path.join(sdir, s))
    ]
    assert [r["uid"] for r in recs] == landed


def test_spool_fault_drops_label_join_not_serving(tmp_path):
    """transient/permanent/enospc at serve.feedback: the caller sees a clean
    False and the NEXT label lands — label ingestion never throws."""
    spool = FeedbackSpool(str(tmp_path))
    faults.configure(FaultPlan(rules=(
        FaultRule("serve.feedback", kind="permanent", at=(0,)),
        FaultRule("serve.feedback", kind="enospc", at=(1,)),
    )))
    spool.observe_scored("u0")
    spool.observe_scored("u1")
    spool.observe_scored("u2")
    assert not spool.observe_label("u0", 1.0)  # permanent -> dropped
    assert not spool.observe_label("u1", 1.0)  # enospc -> dropped
    assert spool.observe_label("u2", 1.0)
    faults.reset()
    spool.flush()
    recs = [
        r for s in sealed_segments(str(tmp_path))
        for r in read_segment(os.path.join(str(tmp_path), s))
    ]
    assert [r["uid"] for r in recs] == ["u2"]
    spool.close()


def test_recover_orphan_parts_respects_live_writer(tmp_path):
    sdir = str(tmp_path)
    spool = FeedbackSpool(sdir)
    spool.observe_scored("u0")
    spool.observe_label("u0", 1.0)  # one record in the live .part
    assert recover_orphan_parts(sdir) == {}  # live writer holds the lock
    assert sealed_segments(sdir) == []
    spool.close()
    # Writer gone: a consumer may recover (nothing orphaned — close sealed).
    assert recover_orphan_parts(sdir) == {}
    assert sealed_segments(sdir) == ["segment-00000001.jsonl"]


# ---------------------------------------------------------------------------
# Delta model artifacts
# ---------------------------------------------------------------------------


def test_delta_chain_resolves_bit_identical_to_full_publish(tmp_path):
    from photon_tpu_torch.io.model_io import (
        load_generation_manifest,
        load_resolved_game_model,
    )

    root = str(tmp_path)
    imaps, eidx = make_index_maps(), make_entity_index()
    _save_artifacts(root, imaps, eidx)
    r = np.random.default_rng(3)
    w1 = r.normal(size=(N_ENTITIES, D_RE)).astype(np.float32)
    w2, w3 = w1.copy(), w1.copy()
    w2[[1, 4]] += 1.5
    w3[[1, 4]] += 1.5
    w3[[4, 6]] -= 0.75  # overlaps gen-2's rows: later layer must win

    _publish_full(root, "gen-1", make_model(w1), imaps, eidx)
    _publish_delta(root, "gen-2", make_model(w2), [1, 4], imaps, eidx,
                   base="gen-1")
    _publish_delta(root, "gen-3", make_model(w3), [4, 6], imaps, eidx,
                   base="gen-2")
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-3"

    resolved = load_resolved_game_model(
        os.path.join(root, "gen-3"), imaps, {"userId": eidx}, to_device=False
    )
    # Bit-identical to publishing the whole model as a full generation.
    full_root = os.path.join(root, "full")
    os.makedirs(full_root)
    _save_artifacts(full_root, imaps, eidx)
    _publish_full(full_root, "gen-1", make_model(w3), imaps, eidx)
    whole = load_resolved_game_model(
        os.path.join(full_root, "gen-1"), imaps, {"userId": eidx},
        to_device=False,
    )
    np.testing.assert_array_equal(
        np.asarray(resolved.models["per_user"].coefficients),
        np.asarray(whole.models["per_user"].coefficients),
    )
    np.testing.assert_array_equal(
        np.asarray(resolved.models["global"].model.coefficients.means),
        np.asarray(whole.models["global"].model.coefficients.means),
    )
    # A delta layer writes a small fraction of the full generation's bytes.
    man_full = load_generation_manifest(os.path.join(root, "gen-1"))
    man_delta = load_generation_manifest(os.path.join(root, "gen-3"))
    assert man_delta["totalBytes"] < man_full["totalBytes"]


def test_corrupted_delta_refused_and_latest_never_flips(tmp_path):
    from photon_tpu_torch.io.model_io import (
        gate_and_publish,
        load_generation_manifest,
        mark_poisoned,
        save_delta_model,
        write_generation_manifest,
    )

    root = str(tmp_path)
    imaps, eidx = make_index_maps(), make_entity_index()
    _save_artifacts(root, imaps, eidx)
    r = np.random.default_rng(4)
    w1 = r.normal(size=(N_ENTITIES, D_RE)).astype(np.float32)
    w2 = w1.copy()
    w2[[2, 5]] += 1.0
    _publish_full(root, "gen-1", make_model(w1), imaps, eidx)

    # 1. bit-rot in a delta payload after the manifest captured digests.
    mask = np.zeros(N_ENTITIES, bool)
    mask[[2, 5]] = True
    save_delta_model(make_model(w2), {"userId": mask},
                     os.path.join(root, "gen-2"), imaps, {"userId": eidx},
                     base="gen-1")
    man = write_generation_manifest(os.path.join(root, "gen-2"),
                                    parent="gen-1")
    victim = next(rel for rel in sorted(man["files"]) if rel.endswith(".avro"))
    path = os.path.join(root, "gen-2", victim)
    with open(path, "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))
    res = gate_and_publish(root, "gen-2")
    assert not res.ok and "checksum_mismatch" in res.reason
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-1"
    assert load_generation_manifest(
        os.path.join(root, "gen-2"))["gate"]["status"] == "rejected"

    # 2. a delta whose base chain is unresolvable is refused.
    save_delta_model(make_model(w2), {"userId": mask},
                     os.path.join(root, "gen-3"), imaps, {"userId": eidx},
                     base="gen-99")
    write_generation_manifest(os.path.join(root, "gen-3"), parent="gen-99")
    res = gate_and_publish(root, "gen-3")
    assert not res.ok and "delta_chain_unresolvable" in res.reason

    # 3. a delta over a poisoned base is refused even when bytes verify.
    save_delta_model(make_model(w2), {"userId": mask},
                     os.path.join(root, "gen-4"), imaps, {"userId": eidx},
                     base="gen-1")
    write_generation_manifest(os.path.join(root, "gen-4"), parent="gen-1")
    mark_poisoned(root, "gen-1", "test poison")
    res = gate_and_publish(root, "gen-4")
    assert not res.ok and "delta_base_poisoned" in res.reason
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-1"


def test_allocate_generation_is_race_free(tmp_path):
    from photon_tpu_torch.io.model_io import allocate_generation

    root = str(tmp_path)
    names, errs = [], []
    lock = threading.Lock()

    def claim():
        try:
            name = allocate_generation(root)
            with lock:
                names.append(name)
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            with lock:
                errs.append(exc)

    threads = [threading.Thread(target=claim) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(set(names)) == 16
    for name in names:
        assert os.path.isdir(os.path.join(root, name))
    assert sorted(int(n[len("gen-"):]) for n in names) == list(range(1, 17))


# ---------------------------------------------------------------------------
# Engine: in-place delta version loads
# ---------------------------------------------------------------------------


def test_engine_delta_version_bit_exact_and_zero_retraces(tmp_path):
    from photon_tpu_torch.io.model_io import read_delta_rows, save_delta_model
    from photon_tpu_torch.serve import ServeConfig, ServingEngine
    from photon_tpu_torch.serve.engine import ReloadError

    root = str(tmp_path)
    imaps, eidx = make_index_maps(), make_entity_index()
    r = np.random.default_rng(5)
    w1 = r.normal(size=(N_ENTITIES, D_RE)).astype(np.float32)
    w2 = w1.copy()
    changed = [0, 3, 6]
    w2[changed] += 2.0
    m1, m2 = make_model(w1), make_model(w2)

    # Disk round-trip: the delta the updater writes is the delta the engine
    # applies.
    mask = np.zeros(N_ENTITIES, bool)
    mask[changed] = True
    gdir = os.path.join(root, "gen-2")
    save_delta_model(m2, {"userId": mask}, gdir, imaps, {"userId": eidx},
                     base="gen-1")
    delta = read_delta_rows(gdir, imaps, {"userId": eidx})
    assert delta["base"] == "gen-1"

    eng = ServingEngine(
        m1, entity_indexes={"userId": eidx}, index_maps=imaps,
        config=ServeConfig(max_batch_size=4, max_versions=3, device="cpu"),
        model_version="gen-1",
    )
    info = eng.load_delta_version("gen-1", delta, "gen-2")
    assert info["base"] == "gen-1"
    assert sorted(eng.versions) == ["gen-1", "gen-2"]

    n = 8
    xf = rng.normal(size=(n, D_FIX)).astype(np.float32)
    xr = rng.normal(size=(n, D_RE)).astype(np.float32)
    users = [0, 1, 3, 5, 6, 7, 3, 0]
    ref1, ref2 = batch_scores(m1, xf, xr, users), batch_scores(m2, xf, xr, users)
    feats = lambda i: {"global": xf[i], "per_user": xr[i]}
    ids = lambda i: {"userId": f"user{users[i]}"}
    got2 = np.asarray([
        np.float32(eng.score(feats(i), ids(i), model_version="gen-2"))
        for i in range(n)
    ])
    got1 = np.asarray([
        np.float32(eng.score(feats(i), ids(i))) for i in range(n)
    ])
    np.testing.assert_array_equal(got2, ref2)
    np.testing.assert_array_equal(got1, ref1)  # base version untouched
    assert eng.retraces_since_warmup == 0

    # An inapplicable delta is refused; resident generations are unchanged.
    with pytest.raises(ReloadError):
        eng.load_delta_version(
            "gen-1",
            {"re_rows": {"nope": (np.asarray([0]), w2[:1])}, "fixed": {}},
            "gen-3",
        )
    assert sorted(eng.versions) == ["gen-1", "gen-2"]
    eng.close()


def test_engine_feedback_and_frontend_backend(tmp_path):
    from photon_tpu_torch.serve import ServeConfig, ServingEngine
    from photon_tpu_torch.serve.frontend import LocalBackend, apply_feedback

    r = np.random.default_rng(6)
    m1 = make_model(r.normal(size=(N_ENTITIES, D_RE)).astype(np.float32))
    eng = ServingEngine(
        m1, entity_indexes={"userId": make_entity_index()},
        index_maps=make_index_maps(),
        config=ServeConfig(max_batch_size=4, device="cpu"), model_version="v1",
    )
    with pytest.raises(ValueError, match="feedback spool not enabled"):
        apply_feedback(eng, {"uid": "u0", "label": 1.0})

    spool = FeedbackSpool(str(tmp_path), SpoolConfig(segment_max_records=4))
    eng.attach_feedback(spool)
    backend = LocalBackend(eng)
    xf = rng.normal(size=D_FIX).astype(np.float32)
    xr = rng.normal(size=D_RE).astype(np.float32)
    backend.submit(
        {"features": {"global": xf.tolist(), "per_user": xr.tolist()},
         "entityIds": {"userId": "user1"}, "uid": "req-1"},
        tenant=None, priority="interactive",
    ).result(60.0)
    assert backend.feedback({"uid": "req-1", "label": 1.0}) == {
        "joined": 1, "dropped": 0,
    }
    # Re-labelling a consumed uid and labelling an unknown uid both drop.
    out = backend.feedback({"labels": [
        {"uid": "req-1", "label": 1.0},
        {"uid": "never-scored", "label": 0.0},
    ]})
    assert out == {"joined": 0, "dropped": 2}
    with pytest.raises(ValueError, match="needs 'uid' and 'label'"):
        backend.feedback({"labels": [{"uid": "x"}]})
    spool.flush()
    recs = [
        r2 for s in sealed_segments(str(tmp_path))
        for r2 in read_segment(os.path.join(str(tmp_path), s))
    ]
    assert len(recs) == 1 and recs[0]["uid"] == "req-1"
    assert recs[0]["modelVersion"] == "v1"
    assert eng.stats()["feedback"]["sealed"] == 1
    eng.close()  # closes the attached spool too
    assert spool._closed


# ---------------------------------------------------------------------------
# Streaming updater
# ---------------------------------------------------------------------------


def _stream_configs():
    from photon_tpu_torch.estimators.config import (
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )

    return [
        FixedEffectCoordinateConfig("global", "global"),
        RandomEffectCoordinateConfig("per_user", "userId", "per_user"),
    ]


def _updater_root(root, seed=7):
    """Publish root with a gen-1 full generation plus index artifacts."""
    r = np.random.default_rng(seed)
    w1 = r.normal(size=(N_ENTITIES, D_RE)).astype(np.float32)
    imaps, eidx = make_index_maps(), make_entity_index()
    _save_artifacts(root, imaps, eidx)
    _publish_full(root, "gen-1", make_model(w1), imaps, eidx)
    return w1, imaps, eidx


def _segment_records(n, entities, seed):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        e = entities[i % len(entities)]
        out.append({
            "ts": 1000.0 + i,
            "uid": f"u{seed}-{i}",
            "tenant": None,
            "features": {
                "global": [float(v) for v in r.normal(size=D_FIX)],
                "per_user": [float(v) for v in r.normal(size=D_RE)],
            },
            "entityIds": {"userId": f"user{e}"},
            "offset": 0.0,
            "score": 0.0,
            "modelVersion": "gen-1",
            "label": float(i % 2),
            "labelTs": 2000.0 + i,
        })
    return out


def _write_segment(sdir, seq, records):
    os.makedirs(sdir, exist_ok=True)
    name = f"segment-{seq:08d}.jsonl"
    with open(os.path.join(sdir, name), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return name


def _updater(root, sdir, imaps, eidx, **overrides):
    from photon_tpu_torch.stream.updater import (
        StreamingUpdater,
        StreamingUpdaterConfig,
    )

    kw = dict(
        publish_root=root, spool_dir=sdir,
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs=_stream_configs(),
        update_sequence=["global", "per_user"],
        cadence_s=0.01, min_records=4,
        locked_coordinates=["global"],
        num_iterations=1,
        # Tiny random micro-batches legitimately move per-entity norms a
        # lot; the drift gate is exercised separately (test_rollout).
        norm_drift_bound=1000.0,
        device="cpu",
    )
    kw.update(overrides)
    return StreamingUpdater(
        StreamingUpdaterConfig(**kw), imaps, {"userId": eidx}
    )


def test_updater_publishes_delta_and_moves_cursor(tmp_path):
    from photon_tpu_torch.io.model_io import (
        load_generation_manifest,
        load_resolved_game_model,
    )

    root, sdir = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    w1, imaps, eidx = _updater_root(root)
    s1 = _write_segment(sdir, 1, _segment_records(8, [0, 1], seed=31))
    s2 = _write_segment(sdir, 2, _segment_records(8, [2], seed=32))

    upd = _updater(root, sdir, imaps, eidx)
    assert upd.consumed_through() == 0
    res = upd.run_once()
    assert res is not None and res.published and res.is_delta
    assert res.segments == [s1, s2] and res.records == 16
    assert res.consumed_through == 2
    assert upd.consumed_through() == 2

    man = load_generation_manifest(os.path.join(root, res.generation))
    assert man["parent"] == "gen-1"
    assert man["stream"] == {
        "consumedThrough": 2, "segments": [s1, s2], "records": 16,
        "oldestLabelTs": 2000.0,
    }
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == res.generation

    # Only entities 0..2 trained; the rest (and the locked FE) ride along
    # verbatim through the delta resolve.
    child = load_resolved_game_model(
        os.path.join(root, res.generation), imaps, {"userId": eidx},
        to_device=False,
    )
    c_re = np.asarray(child.models["per_user"].coefficients)
    np.testing.assert_array_equal(c_re[3:], w1[3:])
    assert np.abs(c_re[:3] - w1[:3]).max() > 0
    np.testing.assert_array_equal(
        np.asarray(child.models["global"].model.coefficients.means),
        np.linspace(-1, 1, D_FIX).astype(np.float32),
    )
    # Idempotent: nothing new to consume.
    assert upd.run_once() is None
    st = upd.stats()
    slo = st.pop("slo")
    assert set(slo["objectives"]) == {
        "update_cycle", "model_staleness_s", "fe_age_s",
    }
    assert st.pop("busy_s") > 0.0
    assert st.pop("train_s") > 0.0
    # The quality plane saw the deterministic holdout slice (none here:
    # holdout_fraction defaults off in this config), and neither
    # correction pass ran.
    assert st.pop("quality")["task"] == "logistic"
    assert st == {
        "cycles": 1, "publishes": 1, "consumed_through": 2,
        "records_trained": 16, "late_replays": 0, "fe_retrains": 0,
    }


def test_updater_accumulates_below_min_records(tmp_path):
    root, sdir = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    _, imaps, eidx = _updater_root(root)
    _write_segment(sdir, 1, _segment_records(2, [0], seed=41))
    upd = _updater(root, sdir, imaps, eidx, min_records=6)
    assert upd.run_once() is None  # 2 < 6: segments accumulate
    assert upd.consumed_through() == 0
    _write_segment(sdir, 2, _segment_records(4, [1], seed=42))
    res = upd.run_once()
    assert res is not None and res.records == 6 and res.consumed_through == 2


def test_updater_crash_mid_generation_resumes_without_double_apply(tmp_path):
    """stream.consume crash after consuming segments but before the solve:
    LATEST (the cursor) is unchanged, so a restarted updater reprocesses the
    SAME segments from the SAME parent and lands a bit-identical model."""
    from photon_tpu_torch.io.model_io import (
        load_generation_manifest,
        load_resolved_game_model,
    )
    from photon_tpu_torch.utils.faults import PermanentInjectedFault

    def run(root, crash_cycle_two):
        sdir = os.path.join(root, "spool")
        os.makedirs(root, exist_ok=True)
        _, imaps, eidx = _updater_root(root)
        upd = _updater(root, sdir, imaps, eidx)
        s1 = _write_segment(sdir, 1, _segment_records(6, [0, 1], seed=51))
        s2 = _write_segment(sdir, 2, _segment_records(6, [2], seed=52))
        r1 = upd.run_once()
        assert r1.published and r1.segments == [s1, s2]
        s3 = _write_segment(sdir, 3, _segment_records(6, [3, 4], seed=53))
        s4 = _write_segment(sdir, 4, _segment_records(6, [5], seed=54))
        if crash_cycle_two:
            # Cycle-2 call indices at stream.consume: segment-3 -> 0,
            # segment-4 -> 1, "train" -> 2. Crash right before the solve,
            # after everything was consumed.
            faults.configure(FaultPlan(rules=(
                FaultRule("stream.consume", kind="permanent", at=(2,)),
            )))
            with pytest.raises(PermanentInjectedFault):
                upd.run_once()
            faults.reset()
            # Mid-generation death left the cursor where cycle 1 put it.
            assert upd.consumed_through() == 2
            with open(os.path.join(root, "LATEST")) as f:
                assert f.read().strip() == r1.generation
            # "Restart": a fresh updater instance, no shared state.
            upd = _updater(root, sdir, imaps, eidx)
        r2 = upd.run_once()
        assert r2.published and r2.segments == [s3, s4]
        assert r2.consumed_through == 4
        man = load_generation_manifest(os.path.join(root, r2.generation))
        assert man["stream"]["segments"] == [s3, s4]
        model = load_resolved_game_model(
            os.path.join(root, r2.generation), imaps, {"userId": eidx},
            to_device=False,
        )
        return np.asarray(model.models["per_user"].coefficients)

    uninterrupted = run(str(tmp_path / "a"), crash_cycle_two=False)
    crashed = run(str(tmp_path / "b"), crash_cycle_two=True)
    np.testing.assert_array_equal(uninterrupted, crashed)


def test_updater_gate_reject_keeps_segments_unconsumed(tmp_path):
    """A refused micro-generation never moves the cursor: the same segments
    retry (and publish) on the next cycle."""
    root, sdir = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    _, imaps, eidx = _updater_root(root)
    _write_segment(sdir, 1, _segment_records(8, [0, 1], seed=61))
    upd = _updater(root, sdir, imaps, eidx)

    faults.configure(FaultPlan(rules=(
        FaultRule("model.corrupt_manifest", kind="permanent", at=(0,)),
    )))
    res = upd.run_once()
    faults.reset()
    assert res is not None and not res.published
    assert "checksum_mismatch" in res.gate_reason
    assert upd.consumed_through() == 0
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-1"

    res = upd.run_once()
    assert res is not None and res.published and res.consumed_through == 1


def test_updater_recovers_orphaned_spool_part(tmp_path):
    """A crashed WRITER's half-finished .part is sealed (complete prefix
    only) by the consumer before the cycle — no live writer, no lock."""
    root, sdir = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    _, imaps, eidx = _updater_root(root)
    os.makedirs(sdir)
    recs = _segment_records(6, [0, 1], seed=71)
    with open(os.path.join(sdir, "segment-00000001.part"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.write('{"torn": tru')  # crash mid-append
    upd = _updater(root, sdir, imaps, eidx)
    res = upd.run_once()
    assert res is not None and res.published
    assert res.segments == ["segment-00000001.jsonl"] and res.records == 6


def test_consumed_through_walks_interleaved_full_publishes(tmp_path):
    """A full (batch) generation published on top of a streaming one carries
    no stream block; the cursor walk follows parent links through it."""
    from photon_tpu_torch.io.model_io import publish_latest_pointer

    root, sdir = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    w1, imaps, eidx = _updater_root(root)
    _write_segment(sdir, 1, _segment_records(8, [0], seed=81))
    upd = _updater(root, sdir, imaps, eidx)
    res = upd.run_once()
    assert res.published and upd.consumed_through() == 1

    # Interleaved full publish (e.g. the nightly batch retrain).
    _publish_full(root, "gen-9", make_model(w1), imaps, eidx,
                  parent=res.generation)
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-9"
    assert upd.consumed_through() == 1  # walked through gen-9 to the cursor

    # And an empty lineage reads as cursor 0.
    fresh = str(tmp_path / "fresh")
    os.makedirs(fresh)
    _updater_root(fresh, seed=8)
    publish_latest_pointer(fresh, "gen-1")
    assert _updater(fresh, os.path.join(fresh, "s"), imaps, eidx
                    ).consumed_through() == 0


def test_records_to_batch_matches_serving_densify():
    """Dict, (indices, values) pair, and dense features all densify into the
    same vectors serving scored; unknown entity ids intern append-only."""
    from photon_tpu_torch.stream.updater import records_to_batch

    imaps = {
        "global": IndexMap.build(
            [f"g{j}" for j in range(D_FIX - 1)], add_intercept=True
        ),
        "per_user": IndexMap.build([f"r{j}" for j in range(D_RE)]),
    }
    eidx = make_entity_index(4)
    recs = [
        {"features": {"global": {"g0": 2.0, "missing": 9.0},
                      "per_user": [[0, 2], [1.5, -1.5]]},
         "entityIds": {"userId": "user1"}, "label": 1.0, "offset": 0.25},
        {"features": {"per_user": [0.5] * D_RE},
         "entityIds": {"userId": "brand-new"}, "label": 0.0},
    ]
    batch = records_to_batch(recs, imaps, {"userId": eidx}, intern=True, device="cpu")
    g = np.asarray(batch.features["global"])
    icpt = imaps["global"].get_index(IndexMap.INTERCEPT)
    g0 = imaps["global"].get_index("g0")
    assert g[0, icpt] == 1.0 and g[0, g0] == 2.0
    assert g[1, icpt] == 1.0  # intercept set even with no global features
    p = np.asarray(batch.features["per_user"])
    np.testing.assert_array_equal(p[0], [1.5, 0.0, -1.5])
    np.testing.assert_array_equal(p[1], [0.5] * D_RE)
    users = np.asarray(batch.entity_ids["userId"])
    assert users[0] == 1
    assert users[1] == 4 and eidx.lookup("brand-new") == 4  # appended
    np.testing.assert_array_equal(np.asarray(batch.label), [1.0, 0.0])
    np.testing.assert_array_equal(np.asarray(batch.offset), [0.25, 0.0])


# ---------------------------------------------------------------------------
# Sharded updater plane ()
# ---------------------------------------------------------------------------


def test_shard_router_matches_serving_owned_mask():
    """An updater shard's working set is literally a serving replica's
    entity shard: shard_of_record hashes the identical string
    serve/store._owned_mask hashes, so the partition agrees with
    StorePartition.owns for every entity — and is disjoint + complete."""
    from photon_tpu_torch.serve.store import StorePartition
    from photon_tpu_torch.stream.shard_router import (
        owned_records,
        shard_members,
        shard_of_record,
        shard_ring,
        split_records,
    )

    n_shards = 4
    ring = shard_ring(n_shards)
    eidx = make_entity_index(32)
    records = [
        {"entityIds": {"userId": eidx.entity_id(i)}} for i in range(32)
    ]
    for i, rec in enumerate(records):
        k = shard_of_record(rec, ring)
        for member in shard_members(n_shards):
            part = StorePartition(member, ring, re_types=("userId",))
            assert part.owns(eidx.entity_id(i)) == (
                member == f"updater:{k}"
            )
    buckets = split_records(records, ring, n_shards)
    assert sorted(k for v in buckets.values() for k in map(id, v)) == sorted(
        map(id, records)
    )
    for k in range(n_shards):
        assert buckets[k] == owned_records(records, ring, k)
    # More than one shard actually owns something at this size.
    assert sum(1 for v in buckets.values() if v) > 1
    # Entity-less records (FE-only feedback) home deterministically on 0.
    assert shard_of_record({"entityIds": {}}, ring) == 0
    assert shard_of_record({}, ring) == 0


def test_raw_line_routing_agrees_with_full_parse(tmp_path):
    """The read-side fast path (entityIds-only decode of the raw line)
    must route every record exactly where the full json parse would —
    including adversarial uids that embed the token text, escaped quotes,
    entity-less records, and corrupt tails."""
    from photon_tpu_torch.stream.shard_router import (
        entity_ids_of_line,
        read_owned_segment,
        shard_of_record,
        shard_ring,
    )

    records = [
        {"uid": "plain", "entityIds": {"userId": "user3"}, "label": 1.0},
        # Token text inside a string VALUE: json.dumps escapes the quotes,
        # so the raw line never contains an unescaped '"entityIds":' from
        # this uid — the extractor must still route on the real key.
        {"uid": 'evil "entityIds": {"userId": "user0"}',
         "entityIds": {"userId": "user5"}, "label": 0.0},
        {"uid": 'esc\\"entityIds\\":', "entityIds": {"userId": "user1"}},
        {"uid": "no-entities", "label": 1.0},
        {"uid": "null-ids", "entityIds": None},
        {"uid": "multi", "entityIds": {"b": "user2", "a": "user6"}},
    ]
    for rec in records:
        line = json.dumps(rec)
        ok, ids = entity_ids_of_line(line)
        assert ok, line
        assert ids == rec.get("entityIds"), (line, ids)

    ring = shard_ring(4)
    path = str(tmp_path / "segment-00000001.jsonl")
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        # Torn mid-entityIds: extraction fails -> full-parse fallback
        # fails -> every shard skips and counts it identically.
        f.write('{"uid": "torn", "entityIds": {"user\n')
        # Torn AFTER a complete entityIds: only the owner full-parses (and
        # skips) it; non-owners route past on the prefix, so their totals
        # legitimately run one high — corruption is only detectable where
        # the record lands.
        f.write('{"uid": "torn2", "entityIds": {"userId": "user7"}, "la\n')
    owner7 = shard_of_record({"entityIds": {"userId": "user7"}}, ring)
    expect = {k: [] for k in range(4)}
    for rec in records:
        expect[shard_of_record(rec, ring)].append(rec["uid"])
    for k in range(4):
        owned, total = read_owned_segment(path, ring, k)
        assert total == len(records) + (0 if k == owner7 else 1)
        assert [r["uid"] for r in owned] == expect[k]


def _drain_shards(updaters, max_rounds=8):
    """Round-robin run_once over shard workers until a full round consumes
    nothing — a deterministic interleaved-publish schedule."""
    results = []
    for _ in range(max_rounds):
        progressed = False
        for upd in updaters:
            res = upd.run_once()
            if res is not None:
                assert res.published, res.gate_reason
                results.append(res)
                progressed = True
        if not progressed:
            return results
    raise AssertionError("shard workers did not drain the spool")


def _resolved_re(root, imaps, eidx):
    from photon_tpu_torch.cli.game_serving import resolve_model_dir
    from photon_tpu_torch.io.model_io import load_resolved_game_model

    model = load_resolved_game_model(
        resolve_model_dir(root), imaps, {"userId": eidx}, to_device=False,
    )
    return np.asarray(model.models["per_user"].coefficients)


def _sharded_segments(sdir):
    """Four mixed segments spanning every test entity — mixed on purpose,
    so routing must split records, not files."""
    s = []
    s.append(_write_segment(sdir, 1, _segment_records(8, [0, 3, 5], seed=91)))
    s.append(_write_segment(sdir, 2, _segment_records(8, [1, 2, 6], seed=92)))
    s.append(_write_segment(sdir, 3, _segment_records(8, [4, 7, 0], seed=93)))
    s.append(_write_segment(sdir, 4, _segment_records(8, [2, 5, 1], seed=94)))
    return s


def test_sharded_updaters_compose_bit_identical_to_single(tmp_path):
    """The tentpole invariant: N shard workers consuming the same mixed
    segments through interleaved delta publishes compose to the SAME bits
    as one updater consuming everything — disjoint rows commute."""
    from photon_tpu_torch.io.model_io import layers_commute, resolve_delta_chain

    # Reference: single updater, two cycles of two segments each.
    root_a = str(tmp_path / "single")
    os.makedirs(root_a)
    _, imaps_a, eidx_a = _updater_root(root_a)
    _sharded_segments(os.path.join(root_a, "spool"))
    single = _updater(root_a, os.path.join(root_a, "spool"), imaps_a, eidx_a,
                      min_records=1, norm_drift_bound=1e12, max_segments_per_cycle=2)
    assert len(_drain_shards([single])) == 2
    ref = _resolved_re(root_a, imaps_a, eidx_a)

    # Sharded: 3 workers over the same segment bytes, interleaved publishes.
    root_b = str(tmp_path / "sharded")
    os.makedirs(root_b)
    _, imaps_b, eidx_b = _updater_root(root_b)
    sdir_b = os.path.join(root_b, "spool")
    _sharded_segments(sdir_b)
    shards = [
        _updater(root_b, sdir_b, imaps_b, eidx_b, min_records=1, norm_drift_bound=1e12,
                 max_segments_per_cycle=2, num_shards=3, shard_index=k)
        for k in range(3)
    ]
    results = _drain_shards(shards)
    assert all(r.is_delta for r in results)
    got = _resolved_re(root_b, imaps_b, eidx_b)
    np.testing.assert_array_equal(ref, got)

    # Every pair of shard layers in the lineage is row-disjoint.
    chain = resolve_delta_chain(
        os.path.join(root_b, results[-1].generation), root_b
    )
    layers = [d for d in chain[1:]]
    by_gen = {os.path.basename(d): d for d in layers}
    from photon_tpu_torch.io.model_io import load_generation_manifest

    shard_of_gen = {}
    for gen, d in by_gen.items():
        man = load_generation_manifest(d) or {}
        shard_of_gen[gen] = (man.get("stream") or {}).get("shard", {}).get(
            "index"
        )
    for i, a in enumerate(layers):
        for b in layers[i + 1:]:
            ga, gb = os.path.basename(a), os.path.basename(b)
            if shard_of_gen[ga] != shard_of_gen[gb]:
                assert layers_commute(a, b), (ga, gb)

    # Per-shard cursor chains are independent: each worker reads its own.
    for upd in shards:
        if upd.stats()["publishes"]:
            assert upd.consumed_through() == 4


def test_concurrent_shard_publishes_rebase_to_linear_chain(tmp_path):
    """Two shard workers racing through the flock'd publish tail: whatever
    the thread interleaving, the lineage stays a single parent chain and
    the composed model matches the single-updater reference bitwise (the
    loser of the LATEST race rebases its commuting layer)."""
    root_a = str(tmp_path / "single")
    os.makedirs(root_a)
    _, imaps_a, eidx_a = _updater_root(root_a)
    _sharded_segments(os.path.join(root_a, "spool"))
    single = _updater(root_a, os.path.join(root_a, "spool"), imaps_a, eidx_a,
                      min_records=1, norm_drift_bound=1e12)
    _drain_shards([single])
    ref = _resolved_re(root_a, imaps_a, eidx_a)

    root_b = str(tmp_path / "sharded")
    os.makedirs(root_b)
    _, imaps_b, eidx_b = _updater_root(root_b)
    sdir_b = os.path.join(root_b, "spool")
    _sharded_segments(sdir_b)
    shards = [
        _updater(root_b, sdir_b, imaps_b, eidx_b, min_records=1, norm_drift_bound=1e12,
                 num_shards=2, shard_index=k)
        for k in range(2)
    ]
    errs = []

    def drive(upd):
        try:
            for _ in range(4):
                if upd.run_once() is None:
                    break
        except Exception as exc:  # noqa: BLE001 — surface in main thread
            errs.append(exc)

    threads = [threading.Thread(target=drive, args=(u,)) for u in shards]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    assert all(u.stats()["publishes"] >= 1 for u in shards)
    got = _resolved_re(root_b, imaps_b, eidx_b)
    np.testing.assert_array_equal(ref, got)
    # Linear lineage: walking parents from LATEST reaches gen-1 and visits
    # every published generation exactly once.
    from photon_tpu_torch.cli.game_serving import resolve_model_dir
    from photon_tpu_torch.io.model_io import load_generation_manifest

    seen = []
    cur = resolve_model_dir(root_b)
    while True:
        name = os.path.basename(cur)
        assert name not in seen
        seen.append(name)
        parent = (load_generation_manifest(cur) or {}).get("parent")
        if not parent:
            break
        cur = os.path.join(root_b, parent)
    publishes = sum(u.stats()["publishes"] for u in shards)
    assert seen[-1] == "gen-1" and len(seen) == publishes + 1


def test_sharded_crash_independence(tmp_path):
    """SIGKILL-equivalent mid-cycle death of ONE shard worker: siblings
    keep publishing on their own cursor chains; the restarted shard resumes
    from ITS cursor and the final composed model is bit-identical to an
    uninterrupted 3-shard run."""
    from photon_tpu_torch.utils.faults import PermanentInjectedFault

    def run(root, crash):
        os.makedirs(root, exist_ok=True)
        _, imaps, eidx = _updater_root(root)
        sdir = os.path.join(root, "spool")
        _sharded_segments(sdir)

        def worker(k):
            return _updater(root, sdir, imaps, eidx, min_records=1, norm_drift_bound=1e12,
                            num_shards=3, shard_index=k)

        shards = [worker(k) for k in range(3)]
        if crash:
            # The victim dies right before its solve — segments read,
            # nothing published, cursor untouched.
            faults.configure(FaultPlan(rules=(
                FaultRule("stream.consume", kind="permanent", at=(4,)),
            )))
            with pytest.raises(PermanentInjectedFault):
                shards[1].run_once()
            faults.reset()
            assert shards[1].consumed_through() == 0
            # Siblings are unaffected: they publish their subsets.
            r0, r2 = shards[0].run_once(), shards[2].run_once()
            assert r0.published and r2.published
            assert shards[0].consumed_through() == 4
            assert shards[2].consumed_through() == 4
            assert shards[1].consumed_through() == 0  # victim's own cursor
            # Restart: a fresh worker for the same shard id resumes from
            # the victim's (unmoved) cursor and re-lands deterministically.
            shards[1] = worker(1)
            r1 = shards[1].run_once()
            assert r1.published and shards[1].consumed_through() == 4
        else:
            for upd in shards:
                res = upd.run_once()
                assert res is not None and res.published
        assert _drain_shards(shards) == []  # everything consumed
        return _resolved_re(root, imaps, eidx)

    clean = run(str(tmp_path / "clean"), crash=False)
    crashed = run(str(tmp_path / "crashed"), crash=True)
    np.testing.assert_array_equal(clean, crashed)


def test_spool_late_label_sidecar(tmp_path):
    """TTL-evicted joins are reclaimable, not lost: eviction writes the
    scored half to late-labels.jsonl, the late-arriving label writes the
    other half, and the counters measure both."""
    import time as time_mod

    from photon_tpu_torch.obs.metrics import registry
    from photon_tpu_torch.stream.spool import LATE_LABELS_FILE

    spooled0 = registry().counter("feedback_late_spooled_total").value
    spool = FeedbackSpool(str(tmp_path), SpoolConfig(join_ttl_s=0.01))
    assert spool.observe_scored(
        "slow-uid", features={"global": [1.0] * D_FIX},
        entity_ids={"userId": "user0"}, ts=100.0,
    )
    time_mod.sleep(0.05)
    # The next scored request runs the eviction sweep past the TTL.
    assert spool.observe_scored("fresh-uid", entity_ids={"userId": "user1"})
    # The label arrives after eviction: late, side-spooled, not joined.
    assert not spool.observe_label("slow-uid", 1.0, ts=400.0)
    path = os.path.join(str(tmp_path), LATE_LABELS_FILE)
    assert spool.late_labels_path() == path
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert [ln["kind"] for ln in lines] == ["evicted", "late_label"]
    assert lines[0]["record"]["uid"] == "slow-uid"
    assert lines[0]["record"]["entityIds"] == {"userId": "user0"}
    assert lines[1] == {
        "kind": "late_label", "uid": "slow-uid", "label": 1.0,
        "labelTs": 400.0,
    }
    assert (
        registry().counter("feedback_late_spooled_total").value - spooled0
        == 2
    )
    # The sidecar never masquerades as a consumable segment.
    assert LATE_LABELS_FILE not in sealed_segments(str(tmp_path))
    spool.close()


def test_updater_fe_age_objective_and_retrain_gauge(tmp_path):
    """FE-drift trigger scaffold: the locked FE's age feeds the fe_age_s
    objective every cycle, and stream_fe_retrain_wanted raises once the
    age passes the configured bar (wiring only — nothing retrains)."""
    from photon_tpu_torch.obs.metrics import registry

    root, sdir = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    _, imaps, eidx = _updater_root(root)
    _write_segment(sdir, 1, _segment_records(8, [0, 1], seed=95))
    upd = _updater(root, sdir, imaps, eidx)
    res = upd.run_once()
    assert res.published
    age = upd.fe_age_s()
    # gen-1 (the only FE-bearing layer: streaming deltas lock the FE) was
    # published moments ago.
    assert age is not None and 0.0 <= age < 60.0
    assert registry().gauge("stream_fe_retrain_wanted").value == 0.0
    snap = upd.stats()["slo"]
    assert snap["objectives"]["fe_age_s"]["events"] == 1

    # Same lineage, a worker configured with an already-expired bar.
    _write_segment(sdir, 2, _segment_records(8, [2], seed=96))
    stale = _updater(root, sdir, imaps, eidx, fe_max_age_s=1e-9)
    res = stale.run_once()
    assert res.published
    assert registry().gauge("stream_fe_retrain_wanted").value == 1.0
    assert registry().gauge("stream_fe_age_s").value > 0.0
    snap = stale.stats()["slo"]
    assert snap["objectives"]["fe_age_s"]["events"] == 1
    assert snap["objectives"]["fe_age_s"]["threshold"] == 1e-9


def test_route_segments_materializes_disjoint_subspools(tmp_path):
    """The materializing router: every sealed segment splits into N
    per-shard sub-spool segments that (a) partition the source records
    exactly as read-side routing would, line-for-line and in order,
    (b) keep the source sequence numbers, (c) exist for EVERY shard (an
    empty file is the routed-ness marker), and (d) survive idempotent and
    crash-interrupted re-runs byte-identically."""
    from photon_tpu_torch.obs.metrics import registry
    from photon_tpu_torch.stream.shard_router import (
        route_segments,
        shard_of_record,
        shard_ring,
        shard_spool_dir,
    )
    from photon_tpu_torch.stream.spool import read_segment

    sdir = str(tmp_path / "spool")
    names = _sharded_segments(sdir)
    # A fifth segment exercising the edge lines: an entity-less record
    # (homes on shard 0), a corrupt tokenless line (passes through to
    # shard 0 verbatim — shard 0's read_segment skips and counts it, the
    # same place read-side routing charges it), a line torn INSIDE
    # entityIds (ambiguous prefix: the router full-parses, fails, drops
    # it for every shard and counts it itself), and a plain routed record.
    extra = "segment-00000005.jsonl"
    with open(os.path.join(sdir, extra), "w") as f:
        f.write(json.dumps({"uid": "fe-only", "label": 1.0}) + "\n")
        f.write("{not json\n")
        f.write('{"uid": "torn", "entityIds": {"user\n')
        f.write(json.dumps(
            {"uid": "ok", "entityIds": {"userId": "user3"}}) + "\n")
    names.append(extra)

    out = str(tmp_path / "routed")
    n_shards = 3
    ring = shard_ring(n_shards)
    bad0 = registry().counter("feedback_spool_bad_lines_total").value
    assert route_segments(sdir, out, n_shards) == len(names)
    assert (
        registry().counter("feedback_spool_bad_lines_total").value - bad0
        == 1  # the torn-entityIds line; the tokenless one rides through
    )

    def shard_bytes():
        return {
            (k, fn): open(
                os.path.join(shard_spool_dir(out, k), fn), "rb").read()
            for k in range(n_shards) for fn in names
        }

    first = shard_bytes()  # raises if any shard file is missing
    for fn in names[:4]:  # the all-valid mixed segments
        src_lines = [
            ln for ln in open(os.path.join(sdir, fn)).read().splitlines()
            if ln.strip()
        ]
        merged = []
        for k in range(n_shards):
            lines = first[(k, fn)].decode().splitlines()
            # Every routed line is a verbatim source line owned by k.
            for ln in lines:
                assert ln in src_lines
                assert shard_of_record(json.loads(ln), ring) == k
            merged.extend(lines)
        assert sorted(merged) == sorted(src_lines)  # disjoint + complete
        # Per-shard order preserved == read-side filtered order.
        for k in range(n_shards):
            assert first[(k, fn)].decode().splitlines() == [
                ln for ln in src_lines
                if shard_of_record(json.loads(ln), ring) == k
            ]
    # Edge segment: exact expected placement.
    owner3 = shard_of_record({"entityIds": {"userId": "user3"}}, ring)
    per_shard = {
        k: first[(k, extra)].decode().splitlines() for k in range(n_shards)
    }
    assert per_shard[0][:2] == [
        json.dumps({"uid": "fe-only", "label": 1.0}), "{not json"
    ]
    assert sum(len(v) for v in per_shard.values()) == 3  # torn is dropped
    assert per_shard[owner3][-1] == json.dumps(
        {"uid": "ok", "entityIds": {"userId": "user3"}})
    assert not any("torn" in ln for v in per_shard.values() for ln in v)
    # Routed sub-spools are real spools: read_segment parses them.
    assert len(read_segment(
        os.path.join(shard_spool_dir(out, 0), names[0]))) == len(
        first[(0, names[0])].decode().splitlines())

    # Idempotent: a second pass routes nothing and changes no byte.
    assert route_segments(sdir, out, n_shards) == 0
    assert shard_bytes() == first
    # Crash re-run: losing ONE shard file of a segment re-routes exactly
    # that segment, byte-identically, touching nothing else.
    os.unlink(os.path.join(shard_spool_dir(out, 1), names[2]))
    assert route_segments(sdir, out, n_shards) == 1
    assert shard_bytes() == first


def test_pre_routed_workers_match_read_side_filtering(tmp_path):
    """Consuming materialized sub-spools (pre_routed=True) composes to the
    same bits as read-side ring filtering over the raw spool — the router
    changes WHERE the partition is paid for, never what it is. Cursor
    chains keep working because routed segments keep source seqs."""
    from photon_tpu_torch.stream.shard_router import (
        route_segments,
        shard_spool_dir,
    )

    n_shards = 3
    # Reference: read-side filtering, every worker lists the raw spool.
    root_a = str(tmp_path / "readside")
    os.makedirs(root_a)
    _, imaps_a, eidx_a = _updater_root(root_a)
    sdir_a = os.path.join(root_a, "spool")
    _sharded_segments(sdir_a)
    shards_a = [
        _updater(root_a, sdir_a, imaps_a, eidx_a, min_records=1,
                 norm_drift_bound=1e12, num_shards=n_shards, shard_index=k)
        for k in range(n_shards)
    ]
    _drain_shards(shards_a)
    ref = _resolved_re(root_a, imaps_a, eidx_a)

    # Same bytes through the materializing router + pre-routed workers.
    root_b = str(tmp_path / "routed")
    os.makedirs(root_b)
    _, imaps_b, eidx_b = _updater_root(root_b)
    sdir_b = os.path.join(root_b, "spool")
    _sharded_segments(sdir_b)
    out = os.path.join(sdir_b, ".shards")
    assert route_segments(sdir_b, out, n_shards) == 4
    shards_b = [
        _updater(root_b, shard_spool_dir(out, k), imaps_b, eidx_b,
                 min_records=1, norm_drift_bound=1e12,
                 num_shards=n_shards, shard_index=k, pre_routed=True)
        for k in range(n_shards)
    ]
    _drain_shards(shards_b)
    np.testing.assert_array_equal(ref, _resolved_re(root_b, imaps_b, eidx_b))
    for a, b in zip(shards_a, shards_b):
        assert a.consumed_through() == b.consumed_through() == 4
        assert (a.stats()["records_trained"]
                == b.stats()["records_trained"])


def _late_pair_lines(n, entities, seed, ts0=5000.0):
    """n (evicted, late_label) line pairs in sidecar shape, spool-record
    shaped halves — what TTL eviction + a late observe_label write."""
    r = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        e = entities[i % len(entities)]
        rec = {
            "ts": ts0 + i,
            "uid": f"late{seed}-{i}",
            "tenant": None,
            "features": {
                "global": [float(v) for v in r.normal(size=D_FIX)],
                "per_user": [float(v) for v in r.normal(size=D_RE)],
            },
            "entityIds": {"userId": f"user{e}"},
            "offset": 0.0,
            "score": 0.25,
            "modelVersion": "gen-1",
        }
        lines.append({"kind": "evicted", "record": rec})
        lines.append({
            "kind": "late_label", "uid": rec["uid"],
            "label": float(i % 2), "labelTs": ts0 + 100.0 + i,
        })
    return lines


def _append_sidecar(sdir, lines):
    from photon_tpu_torch.stream.spool import LATE_LABELS_FILE

    os.makedirs(sdir, exist_ok=True)
    with open(os.path.join(sdir, LATE_LABELS_FILE), "a") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")


def test_updater_replays_late_labels(tmp_path):
    """The correction pass end to end: side-spooled (evicted, late_label)
    pairs re-join, the affected entities retrain from the side-spool, and
    a corrective DELTA publishes through the unchanged gate with the
    joined-pair count as a manifest cursor (``stream.lateReplay``) — so a
    re-run replays nothing, and new pairs below the floor wait."""
    from photon_tpu_torch.io.model_io import (
        delta_info,
        load_generation_manifest,
    )
    from photon_tpu_torch.obs.metrics import registry
    from photon_tpu_torch.stream.updater import spool_dir_key

    root, sdir = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    w1, imaps, eidx = _updater_root(root)
    _append_sidecar(sdir, _late_pair_lines(8, [0, 1], seed=61))
    upd = _updater(root, sdir, imaps, eidx,
                   late_replay_cadence_s=0.01, late_replay_min_pairs=4)

    replays0 = registry().counter("stream_late_replays_total").value
    pairs0 = registry().counter("stream_late_replayed_pairs_total").value
    res = upd.replay_late_labels()
    assert res is not None and res.published and res.is_delta
    assert res.records == 8 and res.segments == []
    key = spool_dir_key(sdir)
    man = load_generation_manifest(os.path.join(root, res.generation))
    assert man["parent"] == "gen-1"
    assert man["stream"]["lateReplay"] == {"pairs": {key: 8}, "records": 8}
    assert delta_info(os.path.join(root, res.generation))
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == res.generation
    # Only the affected entities moved; everything else rides the delta.
    re_now = _resolved_re(root, imaps, eidx)
    np.testing.assert_array_equal(re_now[2:], w1[2:])
    assert np.abs(re_now[:2] - w1[:2]).max() > 0
    assert registry().counter("stream_late_replays_total").value == replays0 + 1
    assert (registry().counter("stream_late_replayed_pairs_total").value
            == pairs0 + 8)
    # The recovered cohort is measured: the quality plane holds all 8
    # pairs under the version that scored them, so the correction's lift
    # is attributable.
    qsnap = upd.stats()["quality"]
    assert [v for v in qsnap["versions"]
            if v["model_version"] == "gen-1"][0]["count"] == 8

    # Cursor discipline: the same sidecar replays nothing...
    assert upd.replay_late_labels() is None
    # ...a fresh updater resumes from the manifest, not memory...
    assert _updater(root, sdir, imaps, eidx,
                    late_replay_cadence_s=0.01,
                    late_replay_min_pairs=4).replay_late_labels() is None
    # ...pairs below the floor wait, and the next batch past it publishes
    # with the cursor advanced to the TOTAL pair count.
    _append_sidecar(sdir, _late_pair_lines(2, [2], seed=62))
    assert upd.replay_late_labels() is None
    _append_sidecar(sdir, _late_pair_lines(2, [3], seed=63, ts0=6000.0))
    res2 = upd.replay_late_labels()
    assert res2 is not None and res2.published and res2.records == 4
    man2 = load_generation_manifest(os.path.join(root, res2.generation))
    assert man2["stream"]["lateReplay"]["pairs"] == {key: 12}
    assert upd.stats()["late_replays"] == 2


def test_updater_fe_retrain_actuates(tmp_path):
    """With ``fe_retrain`` on, a raised ``stream_fe_retrain_wanted`` gauge
    actuates: the recent-record window retrains with the FE UNLOCKED and
    publishes a FULL generation (which is what resets FE age), under a
    cooldown so a sticky age bar cannot hot-loop publishes."""
    from photon_tpu_torch.io.model_io import (
        delta_info,
        load_generation_manifest,
        load_resolved_game_model,
    )
    from photon_tpu_torch.obs.metrics import registry

    root, sdir = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    _, imaps, eidx = _updater_root(root)
    _write_segment(sdir, 1, _segment_records(8, [0, 1], seed=97))
    upd = _updater(root, sdir, imaps, eidx,
                   fe_max_age_s=1e-9, fe_retrain=True,
                   fe_retrain_cooldown_s=3600.0, fe_retrain_min_records=4)

    retrains0 = registry().counter("stream_fe_retrains_total").value
    res = upd.run_once()
    assert res is not None and res.published and res.is_delta
    # The cycle's delta publish aged past the (instant) bar and actuated:
    # one extra FULL generation beyond the delta, FE unlocked.
    assert registry().counter("stream_fe_retrains_total").value == retrains0 + 1
    assert upd.stats()["fe_retrains"] == 1
    assert registry().gauge("stream_fe_retrain_wanted").value == 0.0
    with open(os.path.join(root, "LATEST")) as f:
        latest = f.read().strip()
    man = load_generation_manifest(os.path.join(root, latest))
    assert man["stream"]["feRetrain"]["records"] == 8
    assert man["stream"]["consumedThrough"] == 1  # cursor carried forward
    assert delta_info(os.path.join(root, latest)) is None  # FULL publish
    # The FE moved — it was unlocked for this generation only.
    child = load_resolved_game_model(
        os.path.join(root, latest), imaps, {"userId": eidx}, to_device=False
    )
    fe = np.asarray(child.models["global"].model.coefficients.means)
    assert np.abs(fe - np.linspace(-1, 1, D_FIX).astype(np.float32)).max() > 0

    # Cooldown: the bar is still expired next cycle, but nothing retrains.
    _write_segment(sdir, 2, _segment_records(8, [2], seed=98))
    res2 = upd.run_once()
    assert res2 is not None and res2.published
    assert registry().counter("stream_fe_retrains_total").value == retrains0 + 1
    assert upd.stats()["fe_retrains"] == 1


def test_late_replay_cursor_is_shard_granular_and_crash_independent(tmp_path):
    """Shard-granular replay cursors: each shard's ``stream.lateReplay``
    block carries its OWN shard tag, siblings never adopt each other's
    pair cursor, and a shard that crashed before ITS replay still sees
    every unconsumed pair afterwards — one shard's progress is never
    another shard's data loss."""
    from photon_tpu_torch.io.model_io import load_generation_manifest
    from photon_tpu_torch.stream.shard_router import shard_of_record, shard_ring
    from photon_tpu_torch.stream.updater import spool_dir_key

    root, sdir = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    _, imaps, eidx = _updater_root(root)
    ring = shard_ring(2)
    # Entities landing on each shard, derived from the live routing rule.
    by_shard = {0: [], 1: []}
    for e in range(N_ENTITIES):
        rec = {"entityIds": {"userId": f"user{e}"}}
        by_shard[shard_of_record(rec, ring)].append(e)
    assert by_shard[0] and by_shard[1]
    _append_sidecar(sdir, _late_pair_lines(4, by_shard[0][:2], seed=71))
    _append_sidecar(sdir, _late_pair_lines(4, by_shard[1][:2], seed=72))
    key = spool_dir_key(sdir)

    def shard(k):
        return _updater(root, sdir, imaps, eidx,
                        norm_drift_bound=1e12,
                        late_replay_cadence_s=0.01, late_replay_min_pairs=2,
                        num_shards=2, shard_index=k)

    # Shard 0 replays its 4 owned pairs and publishes a tagged cursor.
    upd0 = shard(0)
    res0 = upd0.replay_late_labels()
    assert res0 is not None and res0.published and res0.records == 4
    man = load_generation_manifest(os.path.join(root, res0.generation))
    late = man["stream"]["lateReplay"]
    assert late["pairs"] == {key: 8}  # cursor counts ALL sidecar pairs
    assert late["shard"] == {"index": 0, "of": 2}  # ...but is shard-tagged

    # Crash independence: shard 1 (restarting AFTER shard 0's publish)
    # must not adopt shard 0's cursor — its own pairs are unconsumed.
    upd1 = shard(1)
    assert upd1._replayed_pairs() == {}
    res1 = upd1.replay_late_labels()
    assert res1 is not None and res1.published and res1.records == 4

    # Both shards' cursor walks now resolve to their OWN chain.
    assert shard(0)._replayed_pairs() == {key: 8}
    assert shard(1)._replayed_pairs() == {key: 8}
    # Re-runs replay nothing on either shard (cursor floor holds).
    assert shard(0).replay_late_labels() is None
    assert shard(1).replay_late_labels() is None

    # Defense-in-depth: a lineage block whose OUTER shape matches this
    # worker but whose lateReplay tag names a sibling is skipped — the
    # inner tag, not block position, owns the cursor.
    upd = shard(0)
    foreign = {
        "consumedThrough": 0,
        "lateReplay": {"pairs": {key: 99},
                       "shard": {"index": 1, "of": 2}},
    }
    upd._stream_blocks = lambda: iter([foreign])
    assert upd._replayed_pairs() == {}


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def _ref_model(w_re):
    from photon_tpu.models.coefficients import Coefficients as JCoefficients
    from photon_tpu.models.game import FixedEffectModel as JFixed
    from photon_tpu.models.game import GameModel as JGame
    from photon_tpu.models.game import RandomEffectModel as JRandom
    from photon_tpu.models.glm import GeneralizedLinearModel as JGLM
    from photon_tpu.types import TaskType as JTask

    return JGame({
        "global": JFixed(JGLM(JCoefficients(np.linspace(-1, 1, D_FIX).astype(np.float32)),
                              JTask.LOGISTIC_REGRESSION), "global"),
        "per_user": JRandom(np.asarray(w_re, np.float32), "userId", "per_user", JTask.LOGISTIC_REGRESSION),
    })


def _ref_index_maps():
    from photon_tpu.data.index_map import IndexMap as JIndexMap

    return {"global": JIndexMap.build([f"g{j}" for j in range(D_FIX)]),
            "per_user": JIndexMap.build([f"r{j}" for j in range(D_RE)])}


def _ref_entity_index():
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex

    eidx = JEntityIndex()
    for e in range(N_ENTITIES):
        eidx.intern(f"user{e}")
    return eidx


def _ref_artifacts(root):
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex
    from photon_tpu.data.index_map import IndexMap as JIndexMap

    imaps = {shard: JIndexMap.load(os.path.join(root, f"index-map-{shard}.json")) for shard in ("global", "per_user")}
    return imaps, JEntityIndex.load(os.path.join(root, "entity-index-userId.json"))


def _fill_spool(engine, spool_dir, seed):
    """Score 12 requests with uids on ``engine`` (either package's), label
    them through its ``feedback_label`` and seal the spool."""
    r = np.random.default_rng(seed)
    for i in range(12):
        feats = {"global": r.normal(size=D_FIX).astype(np.float32),
                 "per_user": r.normal(size=D_RE).astype(np.float32)}
        fut = engine.submit(_request(engine, feats, {"userId": f"user{i % 4}"}, f"req{seed}-{i}"))
        fut.result(60.0)
    for i in range(12):
        assert engine.feedback_label(f"req{seed}-{i}", float(i % 3 == 0), ts=3000.0 + i)
    engine._feedback.flush()
    return [r2 for s in sealed_segments(spool_dir) for r2 in read_segment(os.path.join(spool_dir, s))]


def _request(engine, feats, ids, uid):
    mod = type(engine).__module__.rsplit(".", 1)[0]
    if mod.startswith("photon_tpu_torch"):
        from photon_tpu_torch.serve.batcher import ScoreRequest
    else:
        from photon_tpu.serve.batcher import ScoreRequest
    return ScoreRequest(feats, ids, 0.0, uid=uid)


def _ref_updater(root, sdir, imaps, eidx):
    from photon_tpu.estimators.config import FixedEffectCoordinateConfig, RandomEffectCoordinateConfig
    from photon_tpu.stream.updater import StreamingUpdater, StreamingUpdaterConfig
    from photon_tpu.types import TaskType as JTask

    return StreamingUpdater(StreamingUpdaterConfig(
        publish_root=root, spool_dir=sdir, task=JTask.LOGISTIC_REGRESSION,
        coordinate_configs=[FixedEffectCoordinateConfig("global", "global"),
                            RandomEffectCoordinateConfig("per_user", "userId", "per_user")],
        update_sequence=["global", "per_user"], cadence_s=0.01, min_records=4, locked_coordinates=["global"],
        num_iterations=1, norm_drift_bound=1000.0), imaps, {"userId": eidx})


def test_spools_and_delta_generations_cross_the_packages(tmp_path):
    """Each package's engine writes a spool of the same 12 labelled requests;
    each package's updater consumes both spools into a delta generation.
    The records agree field for field (scores within f32 1e-6); an updater
    gives the same model from either spool, bit for bit; and every published
    delta generation resolves in the other package's loader to the
    coefficients its own loader gives, bit for bit."""
    from photon_tpu.io import model_io as jio
    from photon_tpu.serve import ServeConfig as JServeConfig
    from photon_tpu.serve import ServingEngine as JServingEngine
    from photon_tpu.stream.spool import FeedbackSpool as JFeedbackSpool
    from photon_tpu.stream.spool import SpoolConfig as JSpoolConfig

    from photon_tpu_torch.io import model_io as tio
    from photon_tpu_torch.serve import ServeConfig, ServingEngine

    w1 = np.random.default_rng(7).normal(size=(N_ENTITIES, D_RE)).astype(np.float32)
    spools = {}
    engines = {
        "port": (ServingEngine(make_model(w1), entity_indexes={"userId": make_entity_index()},
                               index_maps=make_index_maps(),
                               config=ServeConfig(max_batch_size=4, device="cpu"), model_version="gen-1"),
                 FeedbackSpool, SpoolConfig),
        "ref": (JServingEngine(_ref_model(w1), entity_indexes={"userId": _ref_entity_index()},
                               index_maps=_ref_index_maps(), config=JServeConfig(max_batch_size=4),
                               model_version="gen-1"),
                JFeedbackSpool, JSpoolConfig),
    }
    for name, (eng, spool_cls, cfg_cls) in engines.items():
        sdir = str(tmp_path / f"spool-{name}")
        eng.attach_feedback(spool_cls(sdir, cfg_cls(segment_max_records=64)))
        spools[name] = (sdir, _fill_spool(eng, sdir, seed=5))
        eng.close()
    got, want = spools["port"][1], spools["ref"][1]
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert abs(a.pop("score") - b.pop("score")) <= 1e-6 * (1 + abs(b["label"]))
        a.pop("ts"), b.pop("ts")
        assert a == b

    models = {}
    for pkg in ("port", "ref"):
        for src in ("port", "ref"):
            root = str(tmp_path / f"pub-{pkg}-{src}")
            os.makedirs(root)
            _, imaps, eidx = _updater_root(root)
            if pkg == "port":
                upd = _updater(root, spools[src][0], imaps, eidx)
            else:
                jimaps, jeidx = _ref_artifacts(root)
                upd = _ref_updater(root, spools[src][0], jimaps, jeidx)
            res = upd.run_once()
            assert res is not None and res.published and res.is_delta and res.records == 12
            gen = os.path.join(root, res.generation)
            timaps, teidx = make_index_maps(), EntityIndex.load(os.path.join(root, "entity-index-userId.json"))
            jimaps, jeidx = _ref_artifacts(root)
            t = tio.load_resolved_game_model(gen, timaps, {"userId": teidx}, to_device=False)
            j = jio.load_resolved_game_model(gen, jimaps, {"userId": jeidx}, to_device=False)
            t_re = t.models["per_user"].coefficients.numpy()
            np.testing.assert_array_equal(t_re, np.asarray(j.models["per_user"].coefficients))
            np.testing.assert_array_equal(t.models["global"].model.coefficients.means.numpy(),
                                          np.asarray(j.models["global"].model.coefficients.means))
            np.testing.assert_array_equal(t_re[4:], w1[4:])
            models[pkg, src] = t_re
    for pkg in ("port", "ref"):
        np.testing.assert_array_equal(models[pkg, "port"], models[pkg, "ref"])


def test_records_to_batch_matches_the_reference():
    """The same joined records (dict, (indices, values) and dense features,
    known and new entities) give the reference's arrays exactly, and intern
    new entities into the same slots."""
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex
    from photon_tpu.data.index_map import IndexMap as JIndexMap
    from photon_tpu.stream.updater import records_to_batch as ref_records_to_batch

    from photon_tpu_torch.stream.updater import records_to_batch

    names = [f"g{j}" for j in range(D_FIX - 1)]
    recs = _segment_records(10, [0, 3, 5], seed=9)
    recs[1]["features"]["global"] = {"g0": 2.0, "missing": 9.0}
    recs[2]["features"]["per_user"] = [[0, 2], [1.5, -1.5]]
    recs[3]["entityIds"] = {"userId": "brand-new"}
    recs[4]["offset"] = 0.25
    del recs[5]["features"]["global"]
    outs = []
    for imap_cls, eidx_cls, fn in ((IndexMap, EntityIndex, records_to_batch),
                                   (JIndexMap, JEntityIndex, ref_records_to_batch)):
        imaps = {"global": imap_cls.build(names, add_intercept=True),
                 "per_user": imap_cls.build([f"r{j}" for j in range(D_RE)])}
        eidx = eidx_cls()
        for e in range(4):
            eidx.intern(f"user{e}")
        kw = {"device": "cpu"} if fn is records_to_batch else {}
        b = fn(recs, imaps, {"userId": eidx}, intern=True, **kw)
        outs.append(({k: np.asarray(v) for k, v in b.features.items()}, np.asarray(b.entity_ids["userId"]),
                     np.asarray(b.label), np.asarray(b.offset), np.asarray(b.weight), len(eidx)))
    (tf, tid, tl, to, tw, tn), (jf, jid, jl, jo, jw, jn) = outs
    for k in jf:
        assert tf[k].dtype == jf[k].dtype
        np.testing.assert_array_equal(tf[k], jf[k])
    assert tid.dtype == jid.dtype
    np.testing.assert_array_equal(tid, jid)
    for a, b in ((tl, jl), (to, jo), (tw, jw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tn == jn == 6


def test_engine_quality_lanes_count_every_joined_label(tmp_path):
    """The engine's quality plane: every joined label lands under the
    version that scored it, the pinned baseline re-scores each one (and
    stays resident past the version cap), each shadow candidate's lane
    re-scores it too; the counts in ``stats()["quality"]`` equal the labels
    joined, the baseline's re-scores equal the baseline's own scores, and
    nothing is captured after warm-up. The reference engine, fed the same
    traffic, keeps the same counts and AUCs within 1e-6."""
    from photon_tpu.serve import ServeConfig as JServeConfig
    from photon_tpu.serve import ServingEngine as JServingEngine
    from photon_tpu.stream.spool import FeedbackSpool as JFeedbackSpool
    from photon_tpu.stream.spool import SpoolConfig as JSpoolConfig

    from photon_tpu_torch.obs.metrics import registry
    from photon_tpu_torch.serve import ServeConfig, ServingEngine

    r = np.random.default_rng(12)
    ws = [r.normal(size=(N_ENTITIES, D_RE)).astype(np.float32) for _ in range(3)]
    n = 40
    feats = [{"global": r.normal(size=D_FIX).astype(np.float32), "per_user": r.normal(size=D_RE).astype(np.float32)}
             for _ in range(n)]
    snaps = {}
    for pkg in ("port", "ref"):
        if pkg == "port":
            eng = ServingEngine(make_model(ws[0]), entity_indexes={"userId": make_entity_index()},
                                index_maps=make_index_maps(),
                                config=ServeConfig(max_batch_size=4, max_versions=2, device="cpu"),
                                model_version="gen-1")
            eng.attach_feedback(FeedbackSpool(str(tmp_path / pkg), SpoolConfig(segment_max_records=64)))
            models = [make_model(w) for w in ws]
        else:
            eng = JServingEngine(_ref_model(ws[0]), entity_indexes={"userId": _ref_entity_index()},
                                 index_maps=_ref_index_maps(), config=JServeConfig(max_batch_size=4, max_versions=2),
                                 model_version="gen-1")
            eng.attach_feedback(JFeedbackSpool(str(tmp_path / pkg), JSpoolConfig(segment_max_records=64)))
            models = [_ref_model(w) for w in ws]
        eng.reload(models[1], "gen-2")  # gen-1 stays resident as the rollback parent
        eng.enable_quality_baseline("gen-1")
        eng.load_version(models[2], "gen-3")
        eng.start_shadow("gen-3", fraction=1.0)
        base0 = registry().counter("quality_baseline_scored_total").value
        for i in range(n):
            eng.submit(_request(eng, feats[i], {"userId": f"user{i % N_ENTITIES}"}, f"q{i}")).result(60.0)
        for i in range(n):
            assert eng.feedback_label(f"q{i}", float((i * 7) % 3 == 0), ts=5000.0 + i)
        st = eng.stats()
        assert sorted(st["versions"]) == ["gen-1", "gen-2", "gen-3"]  # baseline and shadow pinned over the cap
        q = st["quality"]
        by_version = {v["model_version"]: v for v in q["versions"]}
        assert {k: v["count"] for k, v in by_version.items()} == {"gen-1": n, "gen-2": n, "gen-3": n}
        assert q["baseline"] == "gen-1"
        if pkg == "port":
            assert registry().counter("quality_baseline_scored_total").value - base0 == n
            assert eng.retraces_since_warmup == 0
            # The baseline lane's scores are gen-1's own scores.
            pinned = [float(eng.score(feats[i], {"userId": f"user{i % N_ENTITIES}"}, model_version="gen-1"))
                      for i in range(n)]
            labels = np.asarray([float((i * 7) % 3 == 0) for i in range(n)])
            from photon_tpu_torch.obs.quality import QualityAccumulator, predict

            acc = QualityAccumulator()
            for s, y in zip(pinned, labels):
                acc.observe(predict(s, "logistic"), y)
            assert by_version["gen-1"]["auc"] == acc.auc()
        snaps[pkg] = by_version
        eng.close()
    for v, entry in snaps["ref"].items():
        got = snaps["port"][v]
        assert got["count"] == entry["count"]
        assert got["auc"] == pytest.approx(entry["auc"], abs=1e-6)
