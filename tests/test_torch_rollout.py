"""The port's rollout half (photon_tpu_torch/io/model_io.py generations,
the serving engine's version lanes, cli/game_serving.py's watcher), held as
tests/test_rollout.py holds the reference: its manifest, gate, poison,
engine-lane and watcher cases, on the CPU, within the port at atol 0. Then
the cross-package cases: a generation and a two-layer delta chain the
reference publishes, served by the port's ``load_engine`` with the
reference engine's scores (f32, 1e-5·(1 + |score|)); the port's manifests
verified by the reference's gate, their checksums and JSON byte for byte
the reference's. (The incremental cases of test_rollout.py wait for the
port of train/incremental.py.)

Every test that starts a watcher thread or an HTTP server joins it, with a
timeout, in its teardown.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

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
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import faults
from photon_tpu_torch.utils.faults import FaultPlan, FaultRule

T = torch.as_tensor
rng = np.random.default_rng(57)

D_FIX, D_RE, N_ENTITIES = 6, 4, 32


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """Every test starts AND ends with no fault plan: a leaked injector
    would poison unrelated tests through the process-global hook sites."""
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


def make_model(scale=1.0, seed=0):
    r = np.random.default_rng(seed)
    w_fix = (scale * np.linspace(-1, 1, D_FIX)).astype(np.float32)
    w_re = (scale * r.normal(size=(N_ENTITIES, D_RE))).astype(np.float32)
    return GameModel({
        "global": FixedEffectModel(
            GeneralizedLinearModel(
                Coefficients(T(w_fix)), TaskType.LOGISTIC_REGRESSION
            ),
            "shardA",
        ),
        "per_user": RandomEffectModel(
            T(w_re), "userId", "shardB", TaskType.LOGISTIC_REGRESSION
        ),
    })


def make_entity_index(n=N_ENTITIES):
    eidx = EntityIndex()
    for e in range(n):
        eidx.intern(f"user{e}")
    return eidx


def make_index_maps():
    return {
        "shardA": IndexMap.build([f"a{j}" for j in range(D_FIX)]),
        "shardB": IndexMap.build([f"b{j}" for j in range(D_RE)]),
    }


def batch_scores(model, xa, xb, users):
    n = len(users)
    b = GameBatch(
        label=torch.zeros(n), offset=torch.zeros(n), weight=torch.ones(n),
        features={"shardA": T(xa), "shardB": T(xb)},
        entity_ids={"userId": T(np.asarray(users), dtype=torch.int32)},
    )
    return GameTransformer(model).transform(b).numpy().astype(np.float32)


def _publish_gen(root, gen, scale, holdout=None, gate=True):
    """Training-side publication with a generation manifest: save, write
    the manifest (per-file checksums + holdout record), run the gate."""
    from photon_tpu_torch.io.model_io import (
        gate_and_publish,
        save_game_model,
        write_generation_manifest,
    )

    model = make_model(scale, seed=int(scale * 10))
    imaps = make_index_maps()
    eidx = make_entity_index()
    for shard, imap in imaps.items():
        imap.save(os.path.join(root, f"index-map-{shard}.json"))
    eidx.save(os.path.join(root, "entity-index-userId.json"))
    save_game_model(model, os.path.join(root, gen), imaps, {"userId": eidx},
                    sparsity_threshold=0.0)
    write_generation_manifest(os.path.join(root, gen), parent=None,
                              holdout_metrics=holdout or {"AUC": 0.9})
    if gate:
        res = gate_and_publish(root, gen)
        assert res.ok, res.reason
    return model


# ---------------------------------------------------------------------------
# Generation manifest + validation gate
# ---------------------------------------------------------------------------


def test_manifest_roundtrip_and_verify_ok(tmp_path):
    from photon_tpu_torch.io.model_io import (
        load_generation_manifest,
        verify_generation,
    )

    root = str(tmp_path)
    _publish_gen(root, "gen-1", 1.0, holdout={"AUC": 0.91})
    man = load_generation_manifest(os.path.join(root, "gen-1"))
    assert man["generation"] == "gen-1" and man["parent"] is None
    assert man["holdoutMetrics"] == {"AUC": 0.91}
    assert man["gate"]["status"] == "published"
    # Every payload file is checksummed; the manifest itself is excluded.
    assert man["files"] and all(len(h) == 64 for h in man["files"].values())
    res = verify_generation(os.path.join(root, "gen-1"))
    assert res.ok and res.reason is None
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-1"


def test_gate_refuses_checksum_mismatch_and_keeps_latest(tmp_path):
    from photon_tpu_torch.io.model_io import (
        gate_and_publish,
        load_generation_manifest,
        save_game_model,
        verify_generation,
        write_generation_manifest,
    )
    from photon_tpu_torch.io.model_io import PUBLISH_COUNTS

    root = str(tmp_path)
    _publish_gen(root, "gen-1", 1.0)
    # gen-2: bit-rot one payload file AFTER the manifest captured digests.
    model = make_model(2.0)
    save_game_model(model, os.path.join(root, "gen-2"), make_index_maps(),
                    {"userId": make_entity_index()}, sparsity_threshold=0.0)
    write_generation_manifest(os.path.join(root, "gen-2"), parent="gen-1",
                              holdout_metrics={"AUC": 0.9})
    man = load_generation_manifest(os.path.join(root, "gen-2"))
    victim = sorted(man["files"])[0]
    path = os.path.join(root, "gen-2", victim)
    with open(path, "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))

    res = verify_generation(os.path.join(root, "gen-2"))
    assert not res.ok and res.reason.startswith("checksum_mismatch:")

    before = PUBLISH_COUNTS["gate_failures"]
    gate = gate_and_publish(root, "gen-2")
    assert not gate.ok and "checksum_mismatch" in gate.reason
    assert PUBLISH_COUNTS["gate_failures"] == before + 1
    # The failing generation stays on disk (forensics) but is never LATEST.
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-1"
    man = load_generation_manifest(os.path.join(root, "gen-2"))
    assert man["gate"]["status"] == "rejected"
    assert "checksum_mismatch" in man["gate"]["reason"]


def test_gate_refuses_holdout_regression(tmp_path):
    from photon_tpu_torch.io.model_io import (
        gate_and_publish,
        save_game_model,
        write_generation_manifest,
    )

    root = str(tmp_path)
    _publish_gen(root, "gen-1", 1.0, holdout={"AUC": 0.9})
    model = make_model(2.0)
    save_game_model(model, os.path.join(root, "gen-2"), make_index_maps(),
                    {"userId": make_entity_index()}, sparsity_threshold=0.0)
    write_generation_manifest(os.path.join(root, "gen-2"), parent="gen-1",
                              holdout_metrics={"AUC": 0.5})
    gate = gate_and_publish(root, "gen-2")
    assert not gate.ok and gate.reason.startswith("holdout_regression:")
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-1"
    # Within tolerance passes: AUC is higher-is-better and 0.895 ≥ 0.9-0.02.
    write_generation_manifest(os.path.join(root, "gen-2"), parent="gen-1",
                              holdout_metrics={"AUC": 0.895})
    gate = gate_and_publish(root, "gen-2")
    assert gate.ok, gate.reason
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read().strip() == "gen-2"


def test_poison_list_and_generation_names(tmp_path):
    from photon_tpu_torch.io.model_io import (
        is_poisoned,
        load_poison_list,
        mark_poisoned,
        next_generation_name,
    )

    root = str(tmp_path)
    assert next_generation_name(root) == "gen-1"
    os.makedirs(os.path.join(root, "gen-1"))
    os.makedirs(os.path.join(root, "gen-7"))
    assert next_generation_name(root) == "gen-8"

    assert not is_poisoned(root, "gen-7")
    # Full paths and trailing slashes normalize to the basename.
    mark_poisoned(root, os.path.join(root, "gen-7") + "/", "shadow_divergence")
    assert is_poisoned(root, "gen-7")
    assert is_poisoned(root, os.path.join(root, "gen-7"))
    assert load_poison_list(root) == {"gen-7": "shadow_divergence"}


def test_mark_poisoned_concurrent_writers_lose_nothing(tmp_path):
    # The poison list is shared state under a publish root; the sidecar
    # flock must serialize read-modify-write cycles so concurrent writers
    # (watcher rollback racing the gate, or multiple servers) never drop
    # each other's entries.
    from photon_tpu_torch.io.model_io import load_poison_list, mark_poisoned

    root = str(tmp_path)
    n = 12
    threads = [
        threading.Thread(
            target=mark_poisoned, args=(root, f"gen-{i}", f"reason-{i}")
        )
        for i in range(n)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = load_poison_list(root)
    assert got == {f"gen-{i}": f"reason-{i}" for i in range(n)}


# ---------------------------------------------------------------------------
# Multi-version engine: pins, shadow scoring, promote/rollback
# ---------------------------------------------------------------------------


def _two_version_engine(shadow_fraction=0.0, **cfg):
    from photon_tpu_torch.serve import ServeConfig, ServingEngine

    m1, m2 = make_model(1.0, seed=1), make_model(3.0, seed=2)
    defaults = dict(max_batch_size=4, max_delay_ms=1.0, hot_bytes=1 << 30,
                    max_versions=3, shadow_fraction=shadow_fraction, device="cpu")
    defaults.update(cfg)
    eng = ServingEngine(
        m1, entity_indexes={"userId": make_entity_index()},
        index_maps=make_index_maps(), config=ServeConfig(**defaults),
        model_version="v1",
    )
    eng.load_version(m2, "v2")
    return eng, m1, m2


def _score_all(eng, xa, xb, n, version=None):
    return np.asarray([
        np.float32(eng.score(
            {"shardA": xa[i], "shardB": xb[i]}, {"userId": f"user{i}"},
            model_version=version,
        ))
        for i in range(n)
    ])


def test_engine_version_pins_are_bit_exact(tmp_path):
    eng, m1, m2 = _two_version_engine()
    try:
        n = 8
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        ref1 = batch_scores(m1, xa, xb, list(range(n)))
        ref2 = batch_scores(m2, xa, xb, list(range(n)))
        assert sorted(eng.versions) == ["v1", "v2"]
        # Unpinned → primary; pinned → that exact version, both bit-exact
        # with the batch path; the primary never moves.
        np.testing.assert_array_equal(_score_all(eng, xa, xb, n), ref1)
        np.testing.assert_array_equal(_score_all(eng, xa, xb, n, "v2"), ref2)
        assert eng.model_version == "v1"
        # Unknown pin fails the one request, on the caller's thread.
        with pytest.raises(ValueError, match="unknown model version"):
            eng.score({"shardA": xa[0], "shardB": xb[0]},
                      {"userId": "user0"}, model_version="nope")
        assert eng.retraces_since_warmup == 0
    finally:
        eng.close()


def test_engine_shadow_scores_without_touching_responses():
    eng, m1, m2 = _two_version_engine()
    try:
        n = 8
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        ref1 = batch_scores(m1, xa, xb, list(range(n)))
        ref2 = batch_scores(m2, xa, xb, list(range(n)))
        eng.start_shadow("v2", fraction=1.0)
        got = _score_all(eng, xa, xb, n)
        np.testing.assert_array_equal(got, ref1)  # responses untouched
        st = eng.shadow_stats()
        assert st["version"] == "v2" and st["count"] == n
        samples = eng.shadow_samples()
        assert len(samples) == n
        # Shadow scores are bit-exact with a direct pinned-version score,
        # and the recorded divergence is exactly |shadow - primary|.
        np.testing.assert_array_equal(
            np.asarray([np.float32(s["primary"]) for s in samples]), ref1
        )
        np.testing.assert_array_equal(
            np.asarray([np.float32(s["shadow"]) for s in samples]), ref2
        )
        for s in samples:
            assert s["divergence"] == abs(s["shadow"] - s["primary"])
        eng.stop_shadow()
        assert eng.shadow_stats()["version"] is None
        assert eng.retraces_since_warmup == 0
    finally:
        eng.close()


def test_engine_shadow_fraction_samples_deterministically():
    eng, _, _ = _two_version_engine()
    try:
        n = 16
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        eng.start_shadow("v2", fraction=0.25)
        _score_all(eng, xa, xb, n)
        # Fractional accumulator: exactly one in four primary requests is
        # mirrored — no RNG, so the count is exact, not approximate.
        assert eng.shadow_stats()["count"] == 4
    finally:
        eng.close()


def test_engine_shadow_diverge_fault_site():
    eng, _, _ = _two_version_engine()
    try:
        n = 4
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        eng.start_shadow("v2", fraction=1.0)
        faults.configure(FaultPlan(rules=(
            FaultRule("serve.shadow_diverge", kind="transient", p=1.0),
        )))
        got = _score_all(eng, xa, xb, n)
        assert np.isfinite(got).all()  # responses still served from primary
        # The injected +1.0 lands in the divergence record only.
        assert eng.shadow_stats()["max_divergence"] >= 1.0
    finally:
        eng.close()


def _three_version_engine():
    eng, m1, m2 = _two_version_engine(max_versions=4)
    m3 = make_model(5.0, seed=3)
    eng.load_version(m3, "v3")
    return eng, m1, m2, m3


def test_engine_n_way_shadow_lanes_are_independent_and_bit_exact():
    # Concurrent shadow candidates: every lane carries its own sample
    # accumulator, divergence record and counts.
    eng, m1, m2, m3 = _three_version_engine()
    try:
        n = 8
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        ref1 = batch_scores(m1, xa, xb, list(range(n)))
        ref2 = batch_scores(m2, xa, xb, list(range(n)))
        ref3 = batch_scores(m3, xa, xb, list(range(n)))
        before = {v: eng.counts["shadow_scored", v] for v in ("v2", "v3")}
        eng.start_shadow("v2", fraction=1.0)
        eng.start_shadow("v3", fraction=1.0)
        assert eng.shadow_versions == ["v2", "v3"]  # lane start order
        np.testing.assert_array_equal(_score_all(eng, xa, xb, n), ref1)
        # Every lane mirrors every primary request at fraction=1.0, and
        # each lane's samples are bit-exact with its own pinned model.
        for version, ref in (("v2", ref2), ("v3", ref3)):
            st = eng.shadow_stats(version)
            assert st["version"] == version and st["count"] == n
            samples = eng.shadow_samples(version)
            np.testing.assert_array_equal(
                np.asarray([np.float32(s["shadow"]) for s in samples]), ref
            )
            np.testing.assert_array_equal(
                np.asarray([np.float32(s["primary"]) for s in samples]), ref1
            )
        # Legacy no-argument view: newest lane's record, plus a candidates
        # map keyed by version so N lanes never alias into one series.
        legacy = eng.shadow_stats()
        assert legacy["version"] == "v3"
        assert set(legacy["candidates"]) == {"v2", "v3"}
        assert legacy["candidates"]["v2"]["count"] == n
        # Per-lane counts: each candidate owns its own.
        for v in ("v2", "v3"):
            assert eng.counts["shadow_scored", v] == before[v] + n
        assert eng.retraces_since_warmup == 0
    finally:
        eng.close()


def test_engine_shadow_lanes_sample_fractions_independently():
    eng, _, _, _ = _three_version_engine()
    try:
        n = 16
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        eng.start_shadow("v2", fraction=0.25)
        eng.start_shadow("v3", fraction=1.0)
        _score_all(eng, xa, xb, n)
        # Each lane keeps its own fractional accumulator: exact counts.
        assert eng.shadow_stats("v2")["count"] == 4
        assert eng.shadow_stats("v3")["count"] == n
    finally:
        eng.close()


def test_engine_stop_one_shadow_lane_keeps_the_rest():
    eng, _, _, _ = _three_version_engine()
    try:
        eng.start_shadow("v2", fraction=1.0)
        eng.start_shadow("v3", fraction=1.0)
        eng.stop_shadow("v2")
        assert eng.shadow_versions == ["v3"]
        eng.stop_shadow()  # legacy no-argument call clears EVERY lane
        assert eng.shadow_versions == []
        assert eng.shadow_stats()["version"] is None
    finally:
        eng.close()


def test_engine_promote_pops_only_the_winning_lane():
    # Round winner promotes; the losing candidates' lanes must survive so
    # the next round's observation window keeps its series intact.
    eng, m1, _, m3 = _three_version_engine()
    try:
        n = 6
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        eng.start_shadow("v2", fraction=1.0)
        eng.start_shadow("v3", fraction=1.0)
        eng.promote("v3")
        assert eng.model_version == "v3"
        assert eng.shadow_versions == ["v2"]  # loser keeps shadowing
        # The surviving lane now diverges against the NEW primary.
        np.testing.assert_array_equal(
            _score_all(eng, xa, xb, n),
            batch_scores(m3, xa, xb, list(range(n))),
        )
        assert eng.shadow_stats("v2")["count"] == n
        assert eng.retraces_since_warmup == 0
    finally:
        eng.close()


def test_engine_promote_rollback_and_eviction_keeps_parent():
    eng, m1, m2 = _two_version_engine(max_versions=2)
    try:
        n = 6
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        ref1 = batch_scores(m1, xa, xb, list(range(n)))
        ref2 = batch_scores(m2, xa, xb, list(range(n)))

        out = eng.promote("v2")
        assert out["parent"] == "v1" and eng.model_version == "v2"
        np.testing.assert_array_equal(_score_all(eng, xa, xb, n), ref2)
        assert eng.trips_since_promotion() == 0

        # Loading more versions must never evict the rollback target.
        eng.load_version(make_model(5.0, seed=5), "v3")
        eng.load_version(make_model(7.0, seed=7), "v4")
        assert "v1" in eng.versions and "v2" in eng.versions

        demoted = eng.rollback("test")
        assert demoted == "v2" and eng.model_version == "v1"
        np.testing.assert_array_equal(_score_all(eng, xa, xb, n), ref1)
        # No promotion on record anymore: a second rollback is a no-op.
        assert eng.rollback("again") is None
        assert eng.retraces_since_warmup == 0
        st = eng.stats()
        assert st["primary"] == "v1" and st["promotion"] is None
    finally:
        eng.close()


def test_engine_default_cap_keeps_adopting_after_promotion():
    # Regression: at the CLI-default max_versions=2, {primary + pinned
    # rollback parent} equals the cap — a never-settled promotion used to
    # make _evict_locked drop every newly loaded generation immediately
    # (load_version "succeeded", then start_shadow/promote raised), so the
    # rollout stopped adopting anything after the first promotion.
    eng, _, _ = _two_version_engine(max_versions=2)
    try:
        eng.promote("v2")
        eng.load_version(make_model(5.0, seed=5), "v3")
        assert "v3" in eng.versions  # never evict the just-loaded generation
        eng.start_shadow("v3", fraction=1.0)  # must not raise
        eng.promote("v3")
        assert eng.model_version == "v3"
        # The new promotion re-anchored the pin set to {v3, parent v2}:
        # the old parent v1 is evictable and the next load drops it.
        eng.load_version(make_model(7.0, seed=7), "v4")
        assert "v4" in eng.versions and "v1" not in eng.versions
        assert eng.retraces_since_warmup == 0
    finally:
        eng.close()


def test_engine_promotion_settles_after_window():
    eng, _, _ = _two_version_engine(max_versions=2, promotion_settle_s=0.05)
    try:
        eng.promote("v2")
        assert eng.stats()["promotion"] is not None
        time.sleep(0.1)
        # Window passed: monitoring stops, the parent pin releases...
        assert eng.trips_since_promotion() == 0
        assert eng.stats()["promotion"] is None
        # ...so the next load evicts the old parent instead of overflowing.
        eng.load_version(make_model(5.0, seed=5), "v3")
        assert sorted(eng.versions) == ["v2", "v3"]
    finally:
        eng.close()


def test_engine_records_actual_scoring_version_on_request():
    from photon_tpu_torch.serve.batcher import ScoreRequest

    eng, _, _ = _two_version_engine()
    try:
        xa = rng.normal(size=D_FIX).astype(np.float32)
        xb = rng.normal(size=D_RE).astype(np.float32)
        # Unpinned: the engine stamps the primary that actually scored it.
        req = ScoreRequest({"shardA": xa, "shardB": xb}, {"userId": "user0"})
        eng.submit(req).result()
        assert req.model_version == "v1"
        # Pinned: the stamp is the resolved pin.
        req2 = ScoreRequest({"shardA": xa, "shardB": xb}, {"userId": "user0"},
                            model_version="v2")
        eng.submit(req2).result()
        assert req2.model_version == "v2"
    finally:
        eng.close()


def test_http_model_version_header_pins_scoring():
    from http.server import ThreadingHTTPServer

    from photon_tpu_torch.cli.game_serving import make_handler

    eng, m1, m2 = _two_version_engine()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eng))
    server.daemon_threads = True
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    port = server.server_address[1]
    try:
        xa = rng.normal(size=D_FIX).astype(np.float32)
        xb = rng.normal(size=D_RE).astype(np.float32)
        ref1 = batch_scores(m1, xa[None], xb[None], [3])[0]
        ref2 = batch_scores(m2, xa[None], xb[None], [3])[0]
        body = json.dumps({
            "features": {"shardA": xa.tolist(), "shardB": xb.tolist()},
            "entityIds": {"userId": "user3"},
        }).encode()

        def post(headers):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/score", data=body,
                headers={"Content-Type": "application/json", **headers},
            )
            return json.loads(urllib.request.urlopen(req, timeout=10).read())

        got = post({})
        assert np.float32(got["score"]) == ref1
        assert got["modelVersion"] == "v1"
        got = post({"X-Model-Version": "v2"})
        assert np.float32(got["score"]) == ref2
        assert got["modelVersion"] == "v2"
        # An unknown pin is this request's 400, not an engine crash.
        with pytest.raises(urllib.error.HTTPError) as err:
            post({"X-Model-Version": "ghost"})
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        st.join(timeout=10)
        eng.close()
    assert not st.is_alive()


# ---------------------------------------------------------------------------
# Watcher rollout lifecycle: retry→poison, shadow→promote/abandon, rollback
# ---------------------------------------------------------------------------


def _watched_engine(root, **cfg):
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.serve import ServeConfig, ServingEngine

    imaps = make_index_maps()
    eidx = make_entity_index()
    model = load_game_model(os.path.join(root, "gen-1"), imaps,
                            {"userId": eidx}, device="cpu")
    defaults = dict(max_batch_size=4, max_delay_ms=1.0, hot_bytes=1 << 30,
                    max_versions=2, device="cpu")
    defaults.update(cfg)
    return ServingEngine(
        model, entity_indexes={"userId": eidx}, index_maps=imaps,
        config=ServeConfig(**defaults),
        model_version=os.path.join(root, "gen-1"),
    )


def _start_watcher(eng, root, opts):
    from photon_tpu_torch.cli.game_serving import _reload_watcher

    stop = threading.Event()
    t = threading.Thread(target=_reload_watcher,
                         args=(eng, root, 0.05, stop, opts), daemon=True)
    t.start()
    return stop, t


def _await(predicate, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def test_watcher_retries_then_poisons_unloadable_generation(tmp_path):
    from photon_tpu_torch.cli.game_serving import RolloutOptions
    from photon_tpu_torch.io.model_io import is_poisoned, load_poison_list

    root = str(tmp_path)
    _publish_gen(root, "gen-1", 1.0)
    eng = _watched_engine(root)
    opts = RolloutOptions(max_reload_attempts=2, backoff_s=0.01,
                          backoff_max_s=0.02)
    stop, t = _start_watcher(eng, root, opts)
    try:
        v0 = eng.model_version
        # Every reload attempt fails at the injected site: after
        # max_reload_attempts the generation is poisoned, not retried
        # forever, and the old model keeps serving.
        faults.configure(FaultPlan(rules=(
            FaultRule("serve.reload", kind="permanent", p=1.0),
        )))
        _publish_gen(root, "gen-2", 3.0)
        _await(lambda: is_poisoned(root, "gen-2"), msg="gen-2 poisoned")
        assert eng.model_version == v0
        assert "reload_failed" in load_poison_list(root)["gen-2"]
        # Fault cleared: the poison list still blocks re-installation.
        faults.reset()
        time.sleep(0.3)
        assert eng.model_version == v0
    finally:
        stop.set()
        t.join(timeout=10)
        eng.close()
    assert not t.is_alive(), "reload watcher did not stop"


def test_watcher_shadow_quota_then_promote(tmp_path):
    from photon_tpu_torch.cli.game_serving import RolloutOptions

    root = str(tmp_path)
    _publish_gen(root, "gen-1", 1.0)
    eng = _watched_engine(root, shadow_fraction=1.0)
    opts = RolloutOptions(shadow_fraction=1.0, shadow_quota=4,
                          divergence_bound=1e9)
    stop, t = _start_watcher(eng, root, opts)
    try:
        m2 = _publish_gen(root, "gen-2", 3.0)
        _await(lambda: eng.shadow_version is not None,
               msg="gen-2 installed as shadow")
        assert eng.model_version.endswith("gen-1")  # still a candidate
        n = 8
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        _score_all(eng, xa, xb, n)
        _await(lambda: eng.model_version.endswith("gen-2"),
               msg="shadow quota promotion")
        assert eng.shadow_version is None
        ref2 = batch_scores(m2, xa, xb, list(range(n)))
        np.testing.assert_array_equal(_score_all(eng, xa, xb, n), ref2)
        assert eng.retraces_since_warmup == 0
    finally:
        stop.set()
        t.join(timeout=10)
        eng.close()
    assert not t.is_alive(), "reload watcher did not stop"


def test_watcher_divergence_breach_abandons_and_poisons(tmp_path):
    from photon_tpu_torch.cli.game_serving import RolloutOptions
    from photon_tpu_torch.io.model_io import is_poisoned, load_poison_list

    root = str(tmp_path)
    m1 = _publish_gen(root, "gen-1", 1.0)
    eng = _watched_engine(root, shadow_fraction=1.0)
    # gen-2 scores genuinely differently (scale 3 vs 1): any mirrored
    # request blows the tiny divergence bound.
    opts = RolloutOptions(shadow_fraction=1.0, shadow_quota=1000,
                          divergence_bound=1e-6)
    stop, t = _start_watcher(eng, root, opts)
    try:
        _publish_gen(root, "gen-2", 3.0)
        _await(lambda: eng.shadow_version is not None, msg="shadow install")
        n = 8
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        _score_all(eng, xa, xb, n)
        _await(lambda: is_poisoned(root, "gen-2"),
               msg="divergence breach poisons the candidate")
        assert eng.model_version.endswith("gen-1")
        assert eng.shadow_version is None
        assert "shadow_divergence" in load_poison_list(root)["gen-2"]
        # The abandoned candidate never contaminated live responses.
        ref1 = batch_scores(m1, xa, xb, list(range(n)))
        np.testing.assert_array_equal(_score_all(eng, xa, xb, n), ref1)
    finally:
        stop.set()
        t.join(timeout=10)
        eng.close()
    assert not t.is_alive(), "reload watcher did not stop"


def test_watcher_breaker_trips_trigger_rollback(tmp_path):
    from photon_tpu_torch.cli.game_serving import RolloutOptions
    from photon_tpu_torch.io.model_io import is_poisoned

    root = str(tmp_path)
    m1 = _publish_gen(root, "gen-1", 1.0)
    # Short cooldown: the injected failures can also trip gen-1's breaker
    # (requests race the rollback), and the final parity probe below needs
    # it closed again.
    eng = _watched_engine(root, breaker_threshold=2, breaker_cooldown_s=0.2)
    opts = RolloutOptions(breaker_trip_bound=1, backoff_s=0.01)
    stop, t = _start_watcher(eng, root, opts)
    try:
        _publish_gen(root, "gen-2", 3.0)
        _await(lambda: eng.model_version.endswith("gen-2"),
               msg="direct promotion")
        n = 8
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        # Post-promotion store failures: callers degrade to FE-only (no
        # errors), the breaker trips, the watcher demotes to the parent.
        faults.configure(FaultPlan(rules=(
            FaultRule("serve.store_resolve", kind="transient", p=1.0,
                      max_count=8),
        )))
        got = _score_all(eng, xa, xb, n)
        assert np.isfinite(got).all()
        # The poison record is written after the in-engine demotion: await
        # the durable artifact, which implies the rollback happened.
        _await(lambda: is_poisoned(root, "gen-2"), msg="rollback + poison")
        assert eng.model_version.endswith("gen-1")

        # LATEST repointed to the parent: a restart serves gen-1 too.
        def _latest():
            with open(os.path.join(root, "LATEST")) as f:
                return f.read().strip()

        _await(lambda: _latest() == "gen-1", msg="LATEST repointed")
        faults.reset()
        time.sleep(0.5)  # poisoned: the watcher must not re-promote gen-2
        assert eng.model_version.endswith("gen-1")
        _score_all(eng, xa, xb, n)  # half-open probe closes the breaker
        ref1 = batch_scores(m1, xa, xb, list(range(n)))
        np.testing.assert_array_equal(_score_all(eng, xa, xb, n), ref1)
    finally:
        stop.set()
        t.join(timeout=10)
        eng.close()
    assert not t.is_alive(), "reload watcher did not stop"




# ---------------------------------------------------------------------------
# Generations across the two packages
# ---------------------------------------------------------------------------


def _reference(model):
    """The same coefficients as a reference GameModel (numpy leaves)."""
    from photon_tpu.models.coefficients import Coefficients as JCoefficients
    from photon_tpu.models.game import FixedEffectModel as JFixed
    from photon_tpu.models.game import GameModel as JGameModel
    from photon_tpu.models.game import RandomEffectModel as JRandom
    from photon_tpu.models.glm import GeneralizedLinearModel as JGLM
    from photon_tpu.types import TaskType as JTask

    fe, re_ = model.models["global"], model.models["per_user"]
    return JGameModel({
        "global": JFixed(JGLM(JCoefficients(fe.model.coefficients.means.numpy()), JTask.LOGISTIC_REGRESSION),
                         "shardA"),
        "per_user": JRandom(re_.coefficients.numpy(), "userId", "shardB", JTask.LOGISTIC_REGRESSION),
    })


def _reference_maps():
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex
    from photon_tpu.data.index_map import IndexMap as JIndexMap

    imaps = {"shardA": JIndexMap.build([f"a{j}" for j in range(D_FIX)]),
             "shardB": JIndexMap.build([f"b{j}" for j in range(D_RE)])}
    eidx = JEntityIndex()
    for e in range(N_ENTITIES):
        eidx.intern(f"user{e}")
    return imaps, eidx


def _delta_model(model, rows, scale):
    """``model`` with the per-user rows ``rows`` replaced."""
    w = model.models["per_user"].coefficients.clone()
    w[rows] = scale * T(np.random.default_rng(int(scale)).normal(size=(len(rows), D_RE)).astype(np.float32))
    return GameModel({**model.models, "per_user": RandomEffectModel(w, "userId", "shardB",
                                                                    TaskType.LOGISTIC_REGRESSION)})


def _serve_both(root, gen, n=24):
    """Scores of the same requests through the reference's and the port's
    load_engine on ``root/gen``."""
    from photon_tpu.serve import ScoreRequest as JScoreRequest
    from photon_tpu.serve import ServeConfig as JServeConfig
    from photon_tpu.serve.engine import load_engine as j_load_engine

    from photon_tpu_torch.serve import ScoreRequest, ServeConfig
    from photon_tpu_torch.serve.engine import load_engine

    g = np.random.default_rng(3)
    xa = g.normal(size=(n, D_FIX)).astype(np.float32)
    xb = g.normal(size=(n, D_RE)).astype(np.float32)
    keys = [f"user{u}" for u in g.integers(0, N_ENTITIES, size=n)]
    cfg = dict(max_batch_size=8, max_delay_ms=1.0, hot_bytes=1)
    port = load_engine(os.path.join(root, gen), artifacts_dir=root, config=ServeConfig(**cfg, device="cpu"))
    ref = j_load_engine(os.path.join(root, gen), artifacts_dir=root, config=JServeConfig(**cfg))
    try:
        got = [port.submit(ScoreRequest({"shardA": xa[i], "shardB": xb[i]}, {"userId": keys[i]})) for i in range(n)]
        want = [ref.submit(JScoreRequest({"shardA": xa[i], "shardB": xb[i]}, {"userId": keys[i]}))
                for i in range(n)]
        got = np.asarray([f.result(timeout=30) for f in got], np.float32)
        want = np.asarray([f.result(timeout=60) for f in want], np.float32)
        assert port.retraces_since_warmup == 0
    finally:
        port.close()
        ref.close()
    return got, want


def test_reference_delta_chain_is_served_by_the_port(tmp_path):
    """The reference publishes a generation and two delta layers on it (its
    save_delta_model, manifest and gate); the port resolves the chain to the
    reference's coefficients exactly, its gate passes them, and its engine
    scores like the reference's engine."""
    from photon_tpu.io import model_io as jio

    from photon_tpu_torch.io import model_io as tio

    root = str(tmp_path)
    imaps, eidx = _reference_maps()
    for shard, imap in imaps.items():
        imap.save(os.path.join(root, f"index-map-{shard}.json"))
    eidx.save(os.path.join(root, "entity-index-userId.json"))
    m1 = make_model(1.0, seed=4)
    jio.save_game_model(_reference(m1), os.path.join(root, "gen-1"), imaps, {"userId": eidx},
                        sparsity_threshold=0.0)
    jio.write_generation_manifest(os.path.join(root, "gen-1"), holdout_metrics={"AUC": 0.9})
    assert jio.gate_and_publish(root, "gen-1").ok
    m2 = _delta_model(m1, [1, 5, 9], 2.0)
    m3 = _delta_model(m2, [5, 20], 3.0)
    for gen, base, model, rows in (("gen-2", "gen-1", m2, [1, 5, 9]), ("gen-3", "gen-2", m3, [5, 20])):
        jio.save_delta_model(_reference(model), {"userId": np.asarray(rows)}, os.path.join(root, gen), imaps,
                             {"userId": eidx}, base=base)
        jio.write_generation_manifest(os.path.join(root, gen), parent=base, holdout_metrics={"AUC": 0.9})
        assert jio.gate_and_publish(root, gen).ok
    assert [os.path.basename(p) for p in tio.resolve_delta_chain(os.path.join(root, "gen-3"))] == \
        ["gen-1", "gen-2", "gen-3"]
    assert tio.verify_generation(os.path.join(root, "gen-3"), os.path.join(root, "gen-2")).ok
    tmaps = {k: IndexMap.load(os.path.join(root, f"index-map-{k}.json")) for k in imaps}
    resolved = tio.load_resolved_game_model(os.path.join(root, "gen-3"), tmaps,
                                            {"userId": EntityIndex.load(os.path.join(root,
                                                                                     "entity-index-userId.json"))},
                                            to_device=False)
    np.testing.assert_array_equal(resolved.models["per_user"].coefficients.numpy(),
                                  m3.models["per_user"].coefficients.numpy())
    payload = tio.read_delta_rows(os.path.join(root, "gen-3"), tmaps,
                                  {"userId": EntityIndex.load(os.path.join(root, "entity-index-userId.json"))})
    assert payload["base"] == "gen-2" and sorted(payload["re_rows"]["per_user"][0].tolist()) == [5, 20]
    got, want = _serve_both(root, "gen-3")
    assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want)))


def test_port_generations_verify_under_the_reference_byte_for_byte(tmp_path, monkeypatch):
    """The port's generation, manifest and delta layer pass the reference's
    gate and resolve there to the port's coefficients; both packages
    checksum a directory alike and write the same manifest bytes; and with
    the Avro sync markers fixed, the same model saved by either package
    has the same checksums."""
    from photon_tpu.io import model_io as jio

    from photon_tpu_torch.io import model_io as tio

    root = str(tmp_path / "pub")
    os.makedirs(root)
    m1 = _publish_gen(root, "gen-1", 1.0)
    imaps, eidx = make_index_maps(), make_entity_index()
    m2 = _delta_model(m1, [2, 3], 4.0)
    tio.save_delta_model(m2, {"userId": np.asarray([2, 3])}, os.path.join(root, "gen-2"), imaps, {"userId": eidx},
                         base="gen-1")
    tio.write_generation_manifest(os.path.join(root, "gen-2"), parent="gen-1", holdout_metrics={"AUC": 0.9})
    assert tio.gate_and_publish(root, "gen-2").ok
    for gen in ("gen-1", "gen-2"):
        d = os.path.join(root, gen)
        assert jio.verify_generation(d).ok
        assert jio.generation_checksums(d) == tio.generation_checksums(d)
    jimaps, jeidx = _reference_maps()
    jres = jio.load_resolved_game_model(os.path.join(root, "gen-2"), jimaps, {"userId": jeidx}, to_device=False)
    np.testing.assert_array_equal(np.asarray(jres.models["per_user"].coefficients),
                                  m2.models["per_user"].coefficients.numpy())
    got, want = _serve_both(root, "gen-2")
    assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want)))
    # Manifest JSON of one directory, byte for byte, at one clock reading.
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    d = os.path.join(root, "gen-1")
    texts = []
    for write in (tio.write_generation_manifest, jio.write_generation_manifest):
        write(d, parent="gen-0", holdout_metrics={"AUC": 0.91}, extra={"stream": {"oldestLabelTs": 1.5}})
        with open(os.path.join(d, tio.MANIFEST_FILE), "rb") as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    # The same model saved by both packages: equal checksums.
    monkeypatch.setattr(os, "urandom", lambda k: b"\x5a" * k)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tio.save_game_model(m1, tdir, imaps, {"userId": eidx}, sparsity_threshold=0.0)
    jio.save_game_model(_reference(m1), jdir, jimaps, {"userId": jeidx}, sparsity_threshold=0.0)
    assert tio.generation_checksums(tdir) == jio.generation_checksums(jdir)
