"""The port's online serving (photon_tpu_torch/serve, cli/game_serving.py)
held as tests/test_serving.py holds the reference: every case of that file,
on the CPU, plus the port's engine against the reference's engine.

Within the port the parity assertions are atol=0, as the reference's are:
a micro-batched score equals the batch path's (the full (E, d) tables
scored as one batch by the port's GameTransformer), whatever row bucket it
rides. On the CPU "no capture after warm-up" counts row buckets first
scored after warm-up. Against the reference engine (f32) the tolerance is
1e-5·(1 + |score|).

Every test that starts an HTTP server, a scorer or a subprocess waits with
timeouts of its own and joins what it started in its teardown.

"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.data.padding import bucket_grid, bucket_pow2, pad_game_batch
from photon_tpu_torch.estimators.game_transformer import GameTransformer
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.serve import (
    BackpressureError,
    DeadlineExceededError,
    HotColdEntityStore,
    MicroBatcher,
    ScoreRequest,
    ServeConfig,
    ServingEngine,
)
from photon_tpu_torch.types import TaskType

T = torch.as_tensor
rng = np.random.default_rng(41)

D_FIX, D_RE, N_ENTITIES = 6, 4, 64


def make_model(scale=1.0, n_entities=N_ENTITIES):
    w_fix = (scale * np.linspace(-1, 1, D_FIX)).astype(np.float32)
    w_re = (scale * rng.normal(size=(n_entities, D_RE))).astype(np.float32)
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


def batch_scores(model, xa, xb, users, offset=0.0):
    """Scores of the BATCH path: the full-table model scored as one n-row
    batch by the GameTransformer serving runs (atol=0 against served
    scores: the per-row reductions do not depend on the row count)."""
    n = len(users)
    b = GameBatch(
        label=torch.zeros(n),
        offset=torch.full((n,), offset),
        weight=torch.ones(n),
        features={"shardA": T(xa), "shardB": T(xb)},
        entity_ids={"userId": T(np.asarray(users), dtype=torch.int32)},
    )
    return GameTransformer(model).transform(b).numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# MicroBatcher (stub score_fn, pure threading semantics)
# ---------------------------------------------------------------------------


def test_batcher_flushes_on_size():
    batches = []

    def score(reqs):
        batches.append(len(reqs))
        return [r.offset for r in reqs]

    mb = MicroBatcher(score, max_batch_size=4, max_delay_s=10.0, queue_cap=64)
    futs = [mb.submit(ScoreRequest({}, offset=float(i))) for i in range(8)]
    assert [f.result(timeout=5) for f in futs] == [float(i) for i in range(8)]
    mb.close()
    # Size-triggered flushing: no batch above the cap, and the 10s deadline
    # never fired (the test finishes in milliseconds).
    assert sum(batches) == 8 and max(batches) <= 4


def test_batcher_flushes_on_deadline():
    mb = MicroBatcher(
        lambda reqs: [1.0] * len(reqs),
        max_batch_size=1000, max_delay_s=0.02, queue_cap=64,
    )
    t0 = time.monotonic()
    assert mb.submit(ScoreRequest({})).result(timeout=5) == 1.0
    # One request can never fill max_batch_size: the deadline flushed it.
    assert time.monotonic() - t0 < 2.0
    mb.close()


def test_batcher_sheds_on_backpressure():
    release = threading.Event()

    def slow(reqs):
        release.wait(5)
        return [0.0] * len(reqs)

    mb = MicroBatcher(slow, max_batch_size=1, max_delay_s=0.0, queue_cap=2)
    futs = [mb.submit(ScoreRequest({})) for _ in range(2)]
    shed = 0
    for _ in range(20):
        try:
            futs.append(mb.submit(ScoreRequest({})))
        except BackpressureError:
            shed += 1
    assert shed > 0  # depth was at cap while the flusher sat blocked
    release.set()
    for f in futs:
        assert f.result(timeout=10) == 0.0
    mb.close()


def test_batcher_expires_deadline_in_queue():
    release = threading.Event()

    def slow(reqs):
        release.wait(5)
        return [0.0] * len(reqs)

    mb = MicroBatcher(slow, max_batch_size=1, max_delay_s=0.0, queue_cap=64)
    blocker = mb.submit(ScoreRequest({}))  # occupies the flusher
    doomed = mb.submit(ScoreRequest({}), deadline_s=0.01)
    time.sleep(0.05)
    release.set()
    assert blocker.result(timeout=10) == 0.0
    # The doomed request expired while queued: it fails WITHOUT scorer time.
    with pytest.raises(DeadlineExceededError):
        doomed.result(timeout=10)
    mb.close()


def test_batcher_score_error_fails_batch_not_batcher():
    calls = []

    def flaky(reqs):
        calls.append(len(reqs))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return [2.0] * len(reqs)

    mb = MicroBatcher(flaky, max_batch_size=8, max_delay_s=0.005, queue_cap=8)
    bad = mb.submit(ScoreRequest({}))
    with pytest.raises(RuntimeError, match="boom"):
        bad.result(timeout=5)
    good = mb.submit(ScoreRequest({}))  # the batcher itself kept serving
    assert good.result(timeout=5) == 2.0
    mb.close()


# ---------------------------------------------------------------------------
# Hot/cold entity store
# ---------------------------------------------------------------------------


def test_store_pins_when_budget_covers_table():
    model = make_model()
    w_re = model.models["per_user"].coefficients.numpy()
    store = HotColdEntityStore(
        model, {"userId": make_entity_index()}, hot_bytes=1 << 30,
        device="cpu",
    )
    assert store.group("userId").pinned
    # Pinned: entity ids pass through as slots; unknown ids resolve -1.
    slots = store.resolve("userId", ["user3", "user0", "nope", 5])
    np.testing.assert_array_equal(slots, [3, 0, -1, 5])
    table = store.scoring_model().models["per_user"].coefficients.numpy()
    np.testing.assert_array_equal(table, w_re)


def test_store_lru_promotes_and_demotes():
    model = make_model()
    w_re = model.models["per_user"].coefficients.numpy()
    # ~0-byte budget: capacity floors at min_hot_rows=8 < 64 entities.
    store = HotColdEntityStore(
        model, {"userId": make_entity_index()}, hot_bytes=1, min_hot_rows=8, device="cpu"
    )
    group = store.group("userId")
    assert not group.pinned and group.capacity == 8

    slots = store.resolve("userId", [f"user{e}" for e in range(8)])
    assert sorted(slots) == list(range(8))
    table = store.scoring_model().models["per_user"].coefficients.numpy()
    for e in range(8):  # promoted rows hold the exact host coefficients
        np.testing.assert_array_equal(table[slots[e]], w_re[e])

    # Touch user0 (now MRU), then promote 7 fresh entities: the LRU victims
    # are users 1..7; user0 must survive in its slot, untouched.
    keep = store.resolve("userId", ["user0"])[0]
    slots2 = store.resolve("userId", [f"user{e}" for e in range(8, 15)])
    assert store.resolve("userId", ["user0"])[0] == keep
    table2 = store.scoring_model().models["per_user"].coefficients.numpy()
    np.testing.assert_array_equal(table2[keep], w_re[0])
    for j, e in enumerate(range(8, 15)):
        np.testing.assert_array_equal(table2[slots2[j]], w_re[e])


def test_store_overflow_batch_raises():
    store = HotColdEntityStore(
        make_model(), {"userId": make_entity_index()},
        hot_bytes=1, min_hot_rows=4, device="cpu",
    )
    # 5 unique entities in one batch > capacity 4: every resident slot is
    # in use by THIS batch, so there is no LRU victim to demote.
    with pytest.raises(RuntimeError, match="exhausted"):
        store.resolve("userId", [f"user{e}" for e in range(5)])


def test_store_cold_and_unknown_entities_resolve_minus_one():
    store = HotColdEntityStore(
        make_model(), {"userId": make_entity_index()},
        hot_bytes=1, min_hot_rows=8, device="cpu",
    )
    slots = store.resolve("userId", ["never-seen", -1, 10_000])
    np.testing.assert_array_equal(slots, [-1, -1, -1])
    assert store.resolve("noSuchType", ["x"]).tolist() == [-1]


# ---------------------------------------------------------------------------
# Hot/cold for PROJECTED (subspace) random-effect tables (satellite)
# ---------------------------------------------------------------------------

D_PROJ = 6
PROJ_ENTITIES = 24  # entity 23 is block -1 (cold: no model, scores 0)


def make_proj_model(n_entities=PROJ_ENTITIES, d_full=D_PROJ):
    """Fixed effect + one projected RE coordinate: 2 blocks with distinct
    column subspaces, entities alternating blocks, last entity modeless."""
    prng = np.random.default_rng(7)
    col_maps = [np.array([0, 1, 2], np.int32), np.array([2, 3, 4, 5], np.int32)]
    inv_maps = []
    for cmap in col_maps:
        inv = np.full(d_full, -1, np.int32)
        inv[cmap] = np.arange(len(cmap), dtype=np.int32)
        inv_maps.append(inv)
    entity_block = np.array(
        [e % 2 for e in range(n_entities)], np.int32
    )
    entity_block[-1] = -1
    entity_row = np.zeros(n_entities, np.int32)
    counts = [0, 0]
    for e in range(n_entities):
        b = int(entity_block[e])
        if b >= 0:
            entity_row[e] = counts[b]
            counts[b] += 1
    block_coefs = [
        prng.normal(size=(counts[b], len(col_maps[b]))).astype(np.float32)
        for b in range(2)
    ]
    from photon_tpu_torch.models.game import ProjectedRandomEffectModel

    proj = ProjectedRandomEffectModel(
        block_coefs=[T(b) for b in block_coefs],
        col_maps=[T(c) for c in col_maps],
        inv_maps=[T(i) for i in inv_maps],
        entity_block=T(entity_block),
        entity_row=T(entity_row),
        d_full=d_full, re_type="userId", feature_shard="shardB",
        task=TaskType.LOGISTIC_REGRESSION,
    )
    w_fix = np.linspace(-1, 1, D_FIX).astype(np.float32)
    return GameModel({
        "global": FixedEffectModel(
            GeneralizedLinearModel(
                Coefficients(T(w_fix)), TaskType.LOGISTIC_REGRESSION
            ),
            "shardA",
        ),
        "per_user_proj": proj,
    })


def _proj_batch(ids, xa, xb):
    n = len(ids)
    return GameBatch(
        label=torch.zeros(n),
        offset=torch.zeros(n),
        weight=torch.ones(n),
        features={"shardA": T(xa), "shardB": T(xb)},
        entity_ids={"userId": T(np.asarray(ids), dtype=torch.int32)},
    )


def test_store_projected_pins_when_budget_covers_blocks():
    model = make_proj_model()
    store = HotColdEntityStore(
        model, {"userId": make_entity_index(PROJ_ENTITIES)}, hot_bytes=1 << 30,
        device="cpu",
    )
    proj = store.proj_group("userId")
    assert proj is not None and proj.pinned
    assert "userId" in store.entity_re_types
    # Pinned: entity ids pass through as indices; the scoring model carries
    # the exact master tables and maps.
    ids = store.resolve("userId", ["user3", "nope", "user23"])
    np.testing.assert_array_equal(ids, [3, -1, 23])
    served = store.scoring_model().models["per_user_proj"]
    src = model.models["per_user_proj"]
    for b in range(2):
        np.testing.assert_array_equal(
            served.block_coefs[b].numpy(), src.block_coefs[b].numpy()
        )
    np.testing.assert_array_equal(
        served.entity_block.numpy(), src.entity_block.numpy()
    )


def test_store_projected_hot_cold_parity_demotion_and_zero_retraces():
    """Satellite: projected tables under a byte budget. Every micro-batch
    promotes its entities into per-block hot pools, demoted entities' map
    entries go cold (-1), and the served scores stay BIT-equal to the
    full-table batch path — with zero scorer retraces across promotions,
    demotions, and scoring-model swaps."""
    model = make_proj_model()
    ref_tr = GameTransformer(model)
    store = HotColdEntityStore(
        model, {"userId": make_entity_index(PROJ_ENTITIES)},
        hot_bytes=1, min_hot_rows=4, device="cpu",
    )
    proj = store.proj_group("userId")
    coord = proj.coords[0]
    assert not proj.pinned and coord.capacities == [4, 4]
    stats = store.stats()["userId"]
    assert stats["projected"] and not stats["pinned"]
    store.warm_uploads(4)

    from photon_tpu_torch.obs.metrics import registry

    demos0 = store.stats()["userId"]["demotions"]
    reg0 = registry().counter("serve_store_demotions_total", re_type="userId").value
    tr = GameTransformer(store.scoring_model())
    prng = np.random.default_rng(11)
    warm_traces = None
    # Cycle every entity (incl. the modeless one and an unknown key) in
    # batches of 4: 24 uniques through 4+4 hot rows forces demotion waves.
    keys = [f"user{e}" for e in range(PROJ_ENTITIES)] + ["nope"] * 4
    for start in range(0, len(keys), 4):
        group_keys = keys[start:start + 4]
        ids = store.resolve("userId", group_keys)
        true_ids = [
            int(k[4:]) if k.startswith("user") else -1 for k in group_keys
        ]
        np.testing.assert_array_equal(ids, true_ids)
        xa = prng.normal(size=(4, D_FIX)).astype(np.float32)
        xb = prng.normal(size=(4, D_PROJ)).astype(np.float32)
        batch = _proj_batch(ids, xa, xb)
        got = tr.transform(batch, model=store.scoring_model()).numpy()
        want = ref_tr.transform(_proj_batch(true_ids, xa, xb)).numpy()
        np.testing.assert_array_equal(got, want)  # atol=0: same program
        if warm_traces is None:
            warm_traces = tr.trace_count
    assert tr.trace_count == warm_traces  # swaps/promotions never retrace

    demos1 = store.stats()["userId"]["demotions"]
    assert demos1 - demos0 > 0
    # The registry counter moved with the store's own count.
    assert registry().counter("serve_store_demotions_total", re_type="userId").value - reg0 == demos1 - demos0
    # Hot pools hold at most capacity entities; every non-resident entity's
    # device map entry was scattered cold (-1) on demotion.
    dev_blk = coord.dev_entity_block.numpy()
    resident = set()
    for lru in coord.lrus:
        resident.update(lru.resident)
    for e in range(PROJ_ENTITIES):
        if int(coord.entity_block[e]) < 0 or e not in resident:
            assert dev_blk[e] == -1, e
        else:
            assert dev_blk[e] == int(coord.entity_block[e]), e

    # Re-promote long-demoted entities: parity still holds (round-trip
    # through demotion loses nothing; rows re-gather from the host master).
    ids = store.resolve("userId", ["user0", "user1", "user2", "user3"])
    xa = prng.normal(size=(4, D_FIX)).astype(np.float32)
    xb = prng.normal(size=(4, D_PROJ)).astype(np.float32)
    got = tr.transform(_proj_batch(ids, xa, xb), model=store.scoring_model()).numpy()
    want = ref_tr.transform(_proj_batch([0, 1, 2, 3], xa, xb)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tr.trace_count == warm_traces


# ---------------------------------------------------------------------------
# Engine: parity, zero retraces, reload
# ---------------------------------------------------------------------------


def make_engine(scale=1.0, **cfg):
    model = make_model(scale)
    defaults = dict(max_batch_size=8, max_delay_ms=1.0, hot_bytes=1, device="cpu")
    defaults.update(cfg)
    eng = ServingEngine(
        model,
        entity_indexes={"userId": make_entity_index()},
        config=ServeConfig(**defaults),
    )
    return eng, model


def test_engine_concurrent_parity_and_zero_retraces():
    eng, model = make_engine()
    n = 200
    xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
    xb = rng.normal(size=(n, D_RE)).astype(np.float32)
    users = rng.integers(-1, N_ENTITIES, size=n)
    expected = batch_scores(model, xa, xb, users, offset=0.25)

    results = [None] * n

    def worker(lo, hi):
        futs = [
            (i, eng.submit(ScoreRequest(
                {"shardA": xa[i], "shardB": xb[i]},
                {"userId": f"user{users[i]}" if users[i] >= 0 else "cold"},
                offset=0.25,
            )))
            for i in range(lo, hi)
        ]
        for i, f in futs:
            results[i] = np.float32(f.result(timeout=30))

    threads = [
        threading.Thread(target=worker, args=(lo, min(lo + 25, n)))
        for lo in range(0, n, 25)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    # Hot capacity is 8 of 64 entities (hot_bytes=1): these 200 requests
    # churned the LRU hard, and every score still equals the batch path's.
    np.testing.assert_array_equal(np.asarray(results, np.float32), expected)
    assert eng.retraces_since_warmup == 0, eng.stats()
    eng.close()


def test_engine_batch_size_invariance_bit_exact():
    """The same request must score bit-identically whether it rides a
    1-row, 3-row, or full batch — the property the batch-driver parity
    stage (ci.sh serve) builds on."""
    eng, _ = make_engine()
    xa = rng.normal(size=(8, D_FIX)).astype(np.float32)
    xb = rng.normal(size=(8, D_RE)).astype(np.float32)
    reqs = [
        ScoreRequest({"shardA": xa[i], "shardB": xb[i]}, {"userId": i})
        for i in range(8)
    ]
    solo = np.asarray([eng._score_batch([r])[0] for r in reqs], np.float32)
    grouped = np.asarray(eng._score_batch(reqs), np.float32)
    np.testing.assert_array_equal(solo, grouped)
    ragged = np.concatenate([
        np.asarray(eng._score_batch(reqs[:3]), np.float32),
        np.asarray(eng._score_batch(reqs[3:]), np.float32),
    ])
    np.testing.assert_array_equal(ragged, grouped)
    assert eng.retraces_since_warmup == 0
    eng.close()


def test_engine_dict_features_and_intercept():
    imap = IndexMap.build(
        [f"f{j}" for j in range(D_FIX - 1)], add_intercept=True
    )
    eng = ServingEngine(
        make_model(),
        entity_indexes={"userId": make_entity_index()},
        index_maps={"shardA": imap},
        config=ServeConfig(max_batch_size=4, max_delay_ms=1.0, device="cpu"),
    )
    named = {f"f{j}": 0.5 * j for j in range(D_FIX - 1)}
    dense = np.zeros(D_FIX, np.float32)
    for k, v in named.items():
        dense[imap.get_index(k)] = v
    dense[imap.get_index(IndexMap.INTERCEPT)] = 1.0  # dict path auto-sets it
    s_named = eng.score({"shardA": named}, {"userId": "user1"})
    s_dense = eng.score({"shardA": dense}, {"userId": "user1"})
    assert np.float32(s_named) == np.float32(s_dense)
    # Unknown feature names drop silently (batch reader parity).
    s_extra = eng.score(
        {"shardA": {**named, "not-a-feature": 9.9}}, {"userId": "user1"}
    )
    assert np.float32(s_extra) == np.float32(s_named)
    eng.close()


def test_engine_reload_is_zero_downtime_and_retrace_free():
    eng, model = make_engine()
    xa = rng.normal(size=(1, D_FIX)).astype(np.float32)
    xb = rng.normal(size=(1, D_RE)).astype(np.float32)
    req = dict(features={"shardA": xa[0], "shardB": xb[0]},
               entity_ids={"userId": "user2"})
    s1 = np.float32(eng.score(**req))
    assert s1 == batch_scores(model, xa, xb, [2])[0]

    model2 = make_model(scale=-3.0)
    info = eng.reload(model2, "v2")
    assert info["model_version"] == "v2" and eng.model_version == "v2"
    s2 = np.float32(eng.score(**req))
    assert s2 == batch_scores(model2, xa, xb, [2])[0]
    assert s2 != s1
    # The new generation warmed its own transformer BEFORE the swap, so the
    # retrace contract holds across the reload too.
    assert eng.retraces_since_warmup == 0
    eng.close()


def test_engine_rejects_bad_feature_width():
    eng, _ = make_engine()
    with pytest.raises(ValueError, match="expects"):
        eng.score({"shardA": np.zeros(D_FIX + 1, np.float32),
                   "shardB": np.zeros(D_RE, np.float32)})
    eng.close()


# ---------------------------------------------------------------------------
# Transformer warm-up / trace_count across mixed bucket shapes (satellite)
# ---------------------------------------------------------------------------


def _bucket(n):
    from photon_tpu_torch.data.random_effect import bucket_dim

    return bucket_dim(n)


def _batch_of(n):
    return GameBatch(
        label=torch.zeros(n),
        offset=torch.zeros(n),
        weight=torch.ones(n),
        features={
            "shardA": T(rng.normal(size=(n, D_FIX)).astype(np.float32)),
            "shardB": T(rng.normal(size=(n, D_RE)).astype(np.float32)),
        },
        entity_ids={
            "userId": T(rng.integers(0, N_ENTITIES, size=n).astype(np.int32))
        },
    )


def test_transformer_trace_count_reused_across_mixed_buckets():
    dev_model = make_model()
    tr = GameTransformer(dev_model)
    # Mixed bucket shapes, repeated: one "trace" per DISTINCT row count, zero
    # for repeats — trace_count counts shapes, not Python calls.
    for n in (8, 16, 8, 16, 32, 8, 32, 16):
        tr.transform(_batch_of(n))
    assert tr.trace_count == 3

    # warm_up covers the whole grid up front; subsequent mixed-shape
    # traffic padded onto the grid then never traces (the serving
    # startup contract).
    tr2 = GameTransformer(dev_model)
    traced = tr2.warm_up(_batch_of(1), bucket_grid(32))
    assert traced == len(set(bucket_grid(32)))
    before = tr2.trace_count
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 5, 7, 17):
        tr2.transform(pad_game_batch(_batch_of(n), _bucket(n)))
    assert tr2.trace_count == before


def test_bucket_grid_covers_every_dispatch_size():
    for max_n in (1, 2, 7, 8, 33, 64):
        grid = bucket_grid(max_n)
        for n in range(1, max_n + 1):
            assert _bucket(n) in grid
        assert grid == sorted(set(grid))
    assert bucket_pow2(0) == 1 and bucket_pow2(5) == 8


# ---------------------------------------------------------------------------
# HTTP front end (handler-level: real sockets, ephemeral port)
# ---------------------------------------------------------------------------


@pytest.fixture()
def http_server():
    from http.server import ThreadingHTTPServer

    from photon_tpu_torch.cli.game_serving import make_handler

    eng, model = make_engine(max_batch_size=4)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eng, None))
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server.server_address[1], model
    _stop_server(server, t, eng)


def _stop_server(server, thread, eng):
    """Teardown of an HTTP fixture: stop serving, join the server thread
    (bounded), close the engine."""
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    eng.close()
    assert not thread.is_alive(), "HTTP server thread did not stop"


def _post(port, path, payload: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=payload, method="POST"
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.read()


def test_http_score_and_health(http_server):
    port, model = http_server
    xa = rng.normal(size=D_FIX).astype(np.float32)
    xb = rng.normal(size=D_RE).astype(np.float32)
    body = json.dumps({
        "features": {"shardA": xa.tolist(), "shardB": xb.tolist()},
        "entityIds": {"userId": "user5"},
        "offset": 1.0,
    }).encode()
    out = json.loads(_post(port, "/v1/score", body))
    # float32 → python float → JSON → back is exact: parity survives HTTP.
    expected = batch_scores(model, xa[None], xb[None], [5], offset=1.0)[0]
    assert np.float32(out["score"]) == expected
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=10
    ) as resp:
        health = json.loads(resp.read())
    assert health["retraces_since_warmup"] == 0
    assert "userId" in health["store"]


def test_http_score_batch_jsonl_preserves_order(http_server):
    port, model = http_server
    n = 12
    xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
    xb = rng.normal(size=(n, D_RE)).astype(np.float32)
    users = np.arange(n)
    lines = "".join(
        json.dumps({
            "features": {"shardA": xa[i].tolist(), "shardB": xb[i].tolist()},
            "entityIds": {"userId": int(users[i])},
        }) + "\n"
        for i in range(n)
    )
    raw = _post(port, "/v1/score-batch", lines.encode()).decode()
    got = np.asarray(
        [json.loads(line)["score"] for line in raw.splitlines()], np.float32
    )
    np.testing.assert_array_equal(got, batch_scores(model, xa, xb, users))


def test_http_bad_request_is_400_not_crash(http_server):
    port, _ = http_server
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/score", data=b"not json", method="POST"
    )
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=10)
    assert err.value.code == 400


# ---------------------------------------------------------------------------
# Shared padding helper (dedupe satellite)
# ---------------------------------------------------------------------------


def test_pad_game_batch_identity_and_inertness():
    model = make_model()
    n = 5
    b = _batch_of(n)
    assert pad_game_batch(b, n) is b  # no-op → identity
    padded = pad_game_batch(b, 8)
    assert padded.n == 8
    np.testing.assert_array_equal(padded.weight.numpy()[n:], 0.0)
    np.testing.assert_array_equal(padded.entity_ids["userId"].numpy()[n:], -1)
    # Inert padding: real-row scores are unchanged by the extra rows.
    tr = GameTransformer(model)
    np.testing.assert_array_equal(
        tr.transform(padded).numpy()[:n], tr.transform(b).numpy()
    )


# ---------------------------------------------------------------------------
# Tenant admission: token buckets, priority classes, preemption
# ---------------------------------------------------------------------------


def test_token_bucket_exhaustion_and_recovery():
    from photon_tpu_torch.serve import TokenBucket

    clk = [0.0]
    b = TokenBucket(rate=5.0, clock=lambda: clk[0])
    assert all(b.try_acquire() for _ in range(5))  # burst = max(rate, 1)
    assert not b.try_acquire()  # exhausted
    clk[0] += 0.5  # refill is continuous, not epoch-based
    assert b.try_acquire() and b.try_acquire()
    assert not b.try_acquire()
    clk[0] += 100.0  # refill saturates at burst, never beyond
    assert sum(b.try_acquire() for _ in range(10)) == 5


def test_admission_quota_shed_and_recovery():
    from photon_tpu_torch.serve import AdmissionConfig, AdmissionController
    from photon_tpu_torch.serve.admission import QuotaExceededError

    clk = [0.0]
    ctl = AdmissionController(
        AdmissionConfig(tenant_qps={"t": 2.0}), clock=lambda: clk[0]
    )
    ctl.admit("t", "interactive", 0, 100)
    ctl.admit("t", "interactive", 0, 100)
    with pytest.raises(QuotaExceededError) as err:
        ctl.admit("t", "interactive", 0, 100)
    assert err.value.tenant == "t" and err.value.reason == "quota"
    # Quota errors ARE backpressure (same 429 path), with a finer kind.
    assert isinstance(err.value, BackpressureError)
    clk[0] += 1.0  # bucket refills → tenant recovers without restart
    ctl.admit("t", "interactive", 0, 100)
    snap = ctl.snapshot()["t"]
    assert snap["admitted"] == 3 and snap["shed"] == 1
    # Unlisted tenants are quota-exempt (no default_qps configured).
    for _ in range(50):
        ctl.admit("other", "interactive", 0, 100)
    assert ctl.snapshot()["other"]["shed"] == 0


def test_admission_batch_class_shed_above_queue_fraction():
    from photon_tpu_torch.serve import AdmissionConfig, AdmissionController
    from photon_tpu_torch.serve.admission import QuotaExceededError

    ctl = AdmissionController(AdmissionConfig(batch_queue_fraction=0.5))
    ctl.admit("t", "batch", 49, 100)  # below the fraction: admitted
    with pytest.raises(QuotaExceededError) as err:
        ctl.admit("t", "batch", 50, 100)  # at/above: batch sheds first
    assert err.value.reason == "batch_capacity"
    ctl.admit("t", "interactive", 99, 100)  # interactive unaffected


def test_batcher_interactive_preempts_queued_batch_at_cap():
    release = threading.Event()

    def slow(reqs):
        release.wait(5)
        return [r.offset for r in reqs]

    mb = MicroBatcher(slow, max_batch_size=1, max_delay_s=0.0, queue_cap=2)
    blocker = mb.submit(ScoreRequest({}, offset=0.0))  # occupies the flusher
    time.sleep(0.05)
    victims = [
        mb.submit(ScoreRequest({}, offset=1.0), priority="batch"),
        mb.submit(ScoreRequest({}, offset=2.0), priority="batch"),
    ]
    # Queue is at cap with batch-class work: an interactive submit evicts
    # the NEWEST queued batch request instead of shedding itself.
    vip = mb.submit(ScoreRequest({}, offset=3.0))
    with pytest.raises(BackpressureError, match="preempted"):
        victims[1].result(timeout=5)
    # ...but a batch-class submit at cap still sheds itself.
    with pytest.raises(BackpressureError):
        mb.submit(ScoreRequest({}, offset=4.0), priority="batch")
    release.set()
    assert blocker.result(timeout=10) == 0.0
    assert victims[0].result(timeout=10) == 1.0
    assert vip.result(timeout=10) == 3.0
    mb.close()


def _admitted_engine(**quota):
    from photon_tpu_torch.serve import AdmissionConfig

    model = make_model()
    eng = ServingEngine(
        model,
        entity_indexes={"userId": make_entity_index()},
        config=ServeConfig(
            max_batch_size=8, max_delay_ms=1.0, hot_bytes=1,
            admission=AdmissionConfig(**quota), device="cpu",
        ),
    )
    return eng, model


def test_engine_quota_429_recovery_and_tenant_stats():
    from photon_tpu_torch.serve.admission import QuotaExceededError

    eng, model = _admitted_engine(tenant_qps={"t1": 2.0})
    xa = rng.normal(size=D_FIX).astype(np.float32)
    xb = rng.normal(size=D_RE).astype(np.float32)
    req = {"features": {"shardA": xa.tolist(), "shardB": xb.tolist()},
           "entityIds": {"userId": "user3"}}
    from photon_tpu_torch.serve.frontend import request_from_json

    ok = [eng.submit(request_from_json(req), tenant="t1") for _ in range(2)]
    with pytest.raises(QuotaExceededError):
        eng.submit(request_from_json(req), tenant="t1")
    expected = batch_scores(model, xa[None], xb[None], [3])[0]
    for f in ok:
        assert np.float32(f.result(timeout=30)) == expected
    time.sleep(0.6)  # 2 qps → >1 token back: the tenant recovers
    assert np.float32(
        eng.submit(request_from_json(req), tenant="t1").result(timeout=30)
    ) == expected
    t = eng.stats()["tenants"]["t1"]
    assert t["admitted"] == 3 and t["shed"] == 1 and t["qps_limit"] == 2.0
    eng.close()


# ---------------------------------------------------------------------------
# Per-line error mapping in /v1/score-batch
# ---------------------------------------------------------------------------


def test_http_score_batch_maps_per_line_errors(http_server):
    port, model = http_server
    xa = rng.normal(size=(2, D_FIX)).astype(np.float32)
    xb = rng.normal(size=(2, D_RE)).astype(np.float32)
    good = [json.dumps({
        "features": {"shardA": xa[i].tolist(), "shardB": xb[i].tolist()},
        "entityIds": {"userId": i},
    }) for i in range(2)]
    body = "\n".join([good[0], "{not json", '{"no": "features"}', good[1]])
    raw = _post(port, "/v1/score-batch", body.encode()).decode()
    lines = [json.loads(s) for s in raw.splitlines()]
    assert len(lines) == 4  # one result per input line, in order
    expected = batch_scores(model, xa, xb, [0, 1])
    assert np.float32(lines[0]["score"]) == expected[0]
    assert np.float32(lines[3]["score"]) == expected[1]
    # Malformed lines are per-line 400s, NOT backpressure and NOT fatal.
    for bad in (lines[1], lines[2]):
        assert bad["code"] == 400 and bad["kind"] == "bad_request"


def test_http_tenant_quota_is_429_with_kind(http_server_quota):
    port, _ = http_server_quota
    body = json.dumps({
        "features": {
            "shardA": [0.0] * D_FIX, "shardB": [0.0] * D_RE
        },
        "entityIds": {"userId": "user1"},
    }).encode()

    def post(tenant):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/score", data=body, method="POST",
            headers={"X-Tenant": tenant},
        )
        return urllib.request.urlopen(req, timeout=10)

    post("t1").read()
    with pytest.raises(urllib.error.HTTPError) as err:
        post("t1")
    assert err.value.code == 429
    payload = json.loads(err.value.read())
    assert payload["kind"] == "quota" and payload["tenant"] == "t1"
    post("t2").read()  # other tenants unaffected by t1's quota


@pytest.fixture()
def http_server_quota():
    from http.server import ThreadingHTTPServer

    from photon_tpu_torch.cli.game_serving import make_handler

    eng, model = _admitted_engine(tenant_qps={"t1": 1.0})
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eng, None))
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server.server_address[1], model
    _stop_server(server, t, eng)


# ---------------------------------------------------------------------------
# Multi-process front end: IPC channel, LATEST-pointer reload, end to end
# ---------------------------------------------------------------------------


def test_scorer_ipc_parity_stats_and_error_mapping(tmp_path):
    from photon_tpu_torch.serve.frontend import (
        RemoteBackend,
        ScorerClient,
        ScorerServer,
        classify_exception,
        request_from_json,
    )

    eng, model = make_engine(max_batch_size=4)
    srv = ScorerServer(eng, str(tmp_path / "scorer.sock"))
    srv.start()
    cli = ScorerClient(str(tmp_path / "scorer.sock"), connect_timeout_s=30)
    try:
        n = 6
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        futs = [cli.submit_score({
            "features": {"shardA": xa[i].tolist(), "shardB": xb[i].tolist()},
            "entityIds": {"userId": i},
        }, None, "interactive") for i in range(n)]
        got = np.asarray(
            [np.float32(f.result(timeout=30)["score"]) for f in futs]
        )
        # Same engine, same jitted program: the IPC hop changes nothing.
        np.testing.assert_array_equal(
            got, batch_scores(model, xa, xb, list(range(n)))
        )
        # Errors cross the socket as (code, kind) and rebuild client-side.
        with pytest.raises(ValueError):
            cli.submit_score({"no": "features"}, None, "interactive").result(
                timeout=30
            )
        try:
            cli.submit_score({"no": "features"}, None, "interactive").result(
                timeout=30
            )
        except ValueError as exc:
            assert classify_exception(exc) == (400, "bad_request")
        stats = RemoteBackend(cli, worker_index=3).stats()
        assert stats["worker"] == 3 and stats["retraces_since_warmup"] == 0
    finally:
        cli.close()
        srv.close()
        eng.close()


def _publish_generation(root, gen, scale):
    """Training-side publication: save a generation + flip the fsync'd
    LATEST pointer (what train_glm/game_training do on final checkpoint)."""
    import os

    from photon_tpu_torch.io.model_io import publish_latest_pointer, save_game_model

    model = make_model(scale)
    imaps = {
        "shardA": IndexMap.build([f"a{j}" for j in range(D_FIX)]),
        "shardB": IndexMap.build([f"b{j}" for j in range(D_RE)]),
    }
    eidx = make_entity_index()
    for shard, imap in imaps.items():
        imap.save(os.path.join(root, f"index-map-{shard}.json"))
    eidx.save(os.path.join(root, "entity-index-userId.json"))
    # sparsity_threshold=0: keep all nonzero coefficients → exact round trip.
    save_game_model(model, os.path.join(root, gen), imaps, {"userId": eidx},
                    sparsity_threshold=0.0)
    publish_latest_pointer(root, gen)
    return model


def test_latest_pointer_resolution_and_reload_watcher(tmp_path):
    from photon_tpu_torch.cli.game_serving import _reload_watcher, resolve_model_dir
    from photon_tpu_torch.serve.engine import load_engine

    root = str(tmp_path)
    m1 = _publish_generation(root, "gen-1", 1.0)
    assert resolve_model_dir(root).endswith("gen-1")
    eng = load_engine(
        resolve_model_dir(root), artifacts_dir=root,
        config=ServeConfig(max_batch_size=4, hot_bytes=1, device="cpu"),
    )
    stop = threading.Event()
    t = threading.Thread(
        target=_reload_watcher, args=(eng, root, 0.05, stop), daemon=True
    )
    t.start()
    try:
        xa = rng.normal(size=D_FIX).astype(np.float32)
        xb = rng.normal(size=D_RE).astype(np.float32)
        feats = {"shardA": xa, "shardB": xb}
        ids = {"userId": "user7"}
        assert np.float32(eng.score(feats, ids)) == batch_scores(
            m1, xa[None], xb[None], [7]
        )[0]
        m2 = _publish_generation(root, "gen-2", 3.0)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if eng.model_version.endswith("gen-2"):
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"watcher never swapped: {eng.model_version}")
        # The swapped-in generation scores EXACTLY like its source model:
        # publish → LATEST → watcher → reload is lossless end to end.
        assert np.float32(eng.score(feats, ids)) == batch_scores(
            m2, xa[None], xb[None], [7]
        )[0]
        assert eng.retraces_since_warmup == 0  # reload never retraces
    finally:
        stop.set()
        t.join(timeout=10)
        eng.close()
    assert not t.is_alive(), "reload watcher did not stop"


def test_multiprocess_front_end_end_to_end(tmp_path):
    """The spawned-worker deployment shape, as a real subprocess: banner →
    parity → healthz → SIGTERM drain exits 0."""
    import signal
    import subprocess
    import sys

    root = str(tmp_path)
    model = _publish_generation(root, "gen-1", 1.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.cli.game_serving",
         "--model-input-dir", root, "--port", "0", "--workers", "1",
         "--max-batch-size", "4", "--queue-cap", "64", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        banner = {}

        def _read():
            banner["line"] = proc.stdout.readline()

        rt = threading.Thread(target=_read, daemon=True)
        rt.start()
        rt.join(timeout=120)
        assert banner.get("line"), "no startup banner within 120s"
        up = json.loads(banner["line"])
        assert up["workers"] == 1
        port = up["port"]
        n = 4
        xa = rng.normal(size=(n, D_FIX)).astype(np.float32)
        xb = rng.normal(size=(n, D_RE)).astype(np.float32)
        got = np.asarray([np.float32(json.loads(_post(port, "/v1/score", json.dumps({
            "features": {"shardA": xa[i].tolist(), "shardB": xb[i].tolist()},
            "entityIds": {"userId": i},
        }).encode()))["score"]) for i in range(n)])
        # Worker process → unix socket → scorer process scores EXACTLY what
        # the in-process batch path scores from the same published model.
        np.testing.assert_array_equal(
            got, batch_scores(model, xa, xb, list(range(n)))
        )
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10
        ) as resp:
            health = json.loads(resp.read())
        assert health["retraces_since_warmup"] == 0
        assert "worker" in health and health["model_version"].endswith("gen-1")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0  # graceful drain, clean exit
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


# ---------------------------------------------------------------------------
# The port against the reference engine, and HTTP against game_scoring
# ---------------------------------------------------------------------------


def _reference_model(model):
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


@pytest.mark.parametrize("hot_bytes", [1, 1 << 30])
def test_engine_matches_reference_engine(hot_bytes):
    """The same model and requests through the reference's ServingEngine
    and the port's, pinned and under LRU churn: f32 scores within
    1e-5·(1 + |score|)."""
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex
    from photon_tpu.serve import ScoreRequest as JScoreRequest
    from photon_tpu.serve import ServeConfig as JServeConfig
    from photon_tpu.serve import ServingEngine as JServingEngine

    model = make_model(scale=0.7)
    jidx = JEntityIndex()
    for e in range(N_ENTITIES):
        jidx.intern(f"user{e}")
    n = 96
    g = np.random.default_rng(5)
    xa = g.normal(size=(n, D_FIX)).astype(np.float32)
    xb = g.normal(size=(n, D_RE)).astype(np.float32)
    users = g.integers(-1, N_ENTITIES, size=n)
    keys = [f"user{u}" if u >= 0 else "cold" for u in users]
    offsets = g.normal(size=n).astype(np.float32)
    cfg = dict(max_batch_size=8, max_delay_ms=1.0, hot_bytes=hot_bytes)
    port = ServingEngine(model, entity_indexes={"userId": make_entity_index()}, config=ServeConfig(**cfg,
                                                                                                   device="cpu"))
    ref = JServingEngine(_reference_model(model), entity_indexes={"userId": jidx}, config=JServeConfig(**cfg))
    try:
        got = np.asarray([f.result(timeout=30) for f in [
            port.submit(ScoreRequest({"shardA": xa[i], "shardB": xb[i]}, {"userId": keys[i]}, float(offsets[i])))
            for i in range(n)]], np.float32)
        want = np.asarray([f.result(timeout=60) for f in [
            ref.submit(JScoreRequest({"shardA": xa[i], "shardB": xb[i]}, {"userId": keys[i]}, float(offsets[i])))
            for i in range(n)]], np.float32)
    finally:
        port.close()
        ref.close()
    assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want)))
    assert port.retraces_since_warmup == 0


def test_http_scores_equal_game_scoring_exactly(tmp_path):
    """A model trained by the port's game_training, served by its engine
    through HTTP /v1/score-batch (records as named feature dicts): every
    score equals game_scoring's on the same rows, atol 0, at a budget that
    pins every table and at one that churns the LRU."""
    from http.server import ThreadingHTTPServer

    from photon_tpu.io.avro import write_avro_records
    from photon_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA

    from photon_tpu_torch.cli import game_scoring, game_training
    from photon_tpu_torch.cli.game_serving import make_handler
    from photon_tpu_torch.data.index_map import IndexMap as TIndexMap
    from photon_tpu_torch.io.scores import load_scores
    from photon_tpu_torch.serve.engine import load_engine

    g = np.random.default_rng(31)
    recs = []
    for i in range(300):
        x = g.normal(size=4)
        u = int(g.integers(12))
        recs.append({"uid": str(i), "label": float(g.uniform() < 1 / (1 + np.exp(-(x.sum() + u / 6 - 1)))),
                     "features": [{"name": f"x{j}", "term": "", "value": float(x[j])} for j in range(4)],
                     "metadataMap": {"userId": f"u{u}"}, "weight": 1.0, "offset": 0.0})
    data = str(tmp_path / "train.avro")
    write_avro_records(data, TRAINING_EXAMPLE_SCHEMA, recs)
    shards = ["--feature-shard-configurations", "name=globalShard,feature.bags=features"]
    out = tmp_path / "out"
    game_training.main(["--input-paths", data, "--output-dir", str(out), *shards,
                        "--coordinate-configurations",
                        "name=global,feature.shard=globalShard,optimizer=LBFGS,reg.weights=1",
                        "name=perUser,feature.shard=globalShard,random.effect.type=userId,reg.weights=1",
                        "--update-sequence", "global,perUser", "--device", "cpu"])
    scored = tmp_path / "scored"
    game_scoring.main(["--input-paths", data, "--output-dir", str(scored), *shards, "--model-input-dir",
                       str(out / "best"), "--device", "cpu"])
    want = {str(r["uid"]): np.float32(r["predictionScore"]) for r in load_scores(str(scored / "scores.avro"))}
    lines = "".join(json.dumps({
        "features": {"globalShard": {TIndexMap.key(f["name"], f["term"]): f["value"] for f in r["features"]}},
        "entityIds": {"userId": r["metadataMap"]["userId"]}, "uid": r["uid"]}) + "\n" for r in recs)
    for hot_bytes in (1 << 30, 1):
        eng = load_engine(str(out / "best"), artifacts_dir=str(out),
                          config=ServeConfig(max_batch_size=8, hot_bytes=hot_bytes, device="cpu"))
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eng))
        server.daemon_threads = True
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            raw = _post(server.server_address[1], "/v1/score-batch", lines.encode()).decode()
            got = [np.float32(json.loads(line)["score"]) for line in raw.splitlines()]
            assert eng.stats()["store"]["userId"]["pinned"] == (hot_bytes > 1)
            assert eng.retraces_since_warmup == 0
        finally:
            _stop_server(server, t, eng)
        np.testing.assert_array_equal(np.asarray(got), np.asarray([want[r["uid"]] for r in recs]))


def test_serving_modules_import_no_jax():
    """The serve modules, the generation half of io/model_io.py and
    cli.game_serving load in a fresh interpreter without jax or the
    reference package."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(repo)!r}]\n"
        "import photon_tpu_torch.serve, photon_tpu_torch.serve.store, photon_tpu_torch.serve.engine\n"
        "import photon_tpu_torch.serve.frontend, photon_tpu_torch.serve.batcher, photon_tpu_torch.serve.admission\n"
        "import photon_tpu_torch.cli.game_serving\n"
        "from photon_tpu_torch.io.model_io import gate_and_publish, load_resolved_game_model, save_delta_model\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'photon_tpu') or k.startswith(('jax.', 'photon_tpu.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_unported_flags_and_routes_say_so(http_server):
    """The routes waiting for experiments answer 501; the telemetry and
    feedback flags and routes are ported: the flags get past the refusal,
    /metrics and /v1/traces answer 200, and /v1/feedback on a server with no
    spool answers 400 naming it (the reference's answer)."""
    from photon_tpu_torch.cli import game_serving

    for extra in (["--telemetry-out", "t.jsonl"], ["--otlp-endpoint", "http://h"], ["--slo-gate"],
                  ["--feedback-spool", "x", "--feedback-sample-fraction", "0.5", "--feedback-tenant-fractions",
                   "a=0.1", "--feedback-segment-records", "8", "--feedback-segment-age", "1",
                   "--feedback-join-ttl", "9"]):
        with pytest.raises(Exception) as exc:  # no model under "nowhere"
            game_serving.main(["--model-input-dir", "nowhere", "--device", "cpu", *extra])
        assert "not ported yet" not in str(exc.value)
    port, _ = http_server
    for route in ("/metrics", "/v1/traces"):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=10) as resp:
            assert resp.status == 200
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/experiment", timeout=10)
    assert err.value.code == 501
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, "/v1/feedback", json.dumps({"uid": "1", "label": 1.0}).encode())
    assert err.value.code == 400
    assert "feedback spool not enabled" in json.loads(err.value.read())["error"]


@pytest.mark.parametrize("workers", [0, 1])
def test_feedback_route_in_both_deployment_shapes(tmp_path, workers):
    """game_serving --feedback-spool as a subprocess, in process and behind
    a spawned HTTP worker: scored requests with uids join their labels from
    /v1/feedback (200, every label joined; a malformed item 400), /healthz
    carries the spool's block, and at SIGTERM the spool seals every joined
    record."""
    import os
    import signal
    import subprocess
    import sys

    from photon_tpu_torch.stream.spool import read_segment, sealed_segments

    root, spool = str(tmp_path / "pub"), str(tmp_path / "spool")
    os.makedirs(root)
    _publish_generation(root, "gen-1", 1.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.cli.game_serving", "--model-input-dir", root, "--port", "0",
         "--workers", str(workers), "--max-batch-size", "4", "--device", "cpu", "--feedback-spool", spool,
         "--feedback-segment-records", "3", "--feedback-segment-age", "0.5"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        banner = {}
        rt = threading.Thread(target=lambda: banner.setdefault("line", proc.stdout.readline()), daemon=True)
        rt.start()
        rt.join(timeout=120)
        assert banner.get("line"), "no startup banner within 120s"
        port = json.loads(banner["line"])["port"]
        n = 5
        for i in range(n):
            _post(port, "/v1/score", json.dumps({
                "features": {"shardA": rng.normal(size=D_FIX).tolist(), "shardB": rng.normal(size=D_RE).tolist()},
                "entityIds": {"userId": f"user{i}"}, "uid": f"req-{i}"}).encode())
        out = json.loads(_post(port, "/v1/feedback", json.dumps(
            {"labels": [{"uid": f"req-{i}", "label": float(i % 2)} for i in range(n)]}).encode()))
        assert out == {"joined": n, "dropped": 0}
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/v1/feedback", json.dumps({"labels": [{"uid": "x"}]}).encode())
        assert err.value.code == 400
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["feedback"]["pending_joins"] == 0
        assert health["retraces_since_warmup"] == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    recs = [r for s in sealed_segments(spool) for r in read_segment(os.path.join(spool, s))]
    assert sorted(r["uid"] for r in recs) == [f"req-{i}" for i in range(n)]
    assert all(r["modelVersion"].endswith("gen-1") for r in recs)
