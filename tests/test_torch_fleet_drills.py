"""The port's scorer fleet as processes (photon_tpu_torch/serve/fleet.py):
the two drills of tests/test_fleet.py — three replicas with parity, a
SIGKILL failover and a revive; TCP with a warm join and a warm leave —
plus the fleet against the reference's batch scoring and a generation the
reference wrote, and a replica that cannot start. Every replica here is a
spawned ``python -m photon_tpu_torch.serve.fleet --device cpu``.

Within the port the parity assertions are atol 0 (a routed score equals
the port's batch path bit for bit, or its FE-only score where the owner is
dead); against the reference's batch scoring (f32) the tolerance is
1e-5·(1 + |score|), as in tests/test_torch_serving.py.

Every test that starts a fleet gives its waits timeouts of their own and
shuts the fleet down in a ``finally``.
"""

import http.client
import json
import os
import time

import numpy as np
import pytest

from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.serve.fleet import FleetBackend, FleetHTTPFrontend, ScorerFleet

from test_torch_serving import D_FIX, D_RE, N_ENTITIES, _publish_generation, batch_scores, make_entity_index

CONNECT_TIMEOUT_S = 120.0
RESULT_TIMEOUT_S = 60.0
TOL = 1e-5


def _score_request(xa_row, xb_row, user, uid=None):
    return {
        "features": {
            "shardA": {f"a{j}": float(xa_row[j]) for j in range(D_FIX)},
            "shardB": {f"b{j}": float(xb_row[j]) for j in range(D_RE)},
        },
        "entityIds": {"userId": f"user{user}"},
        **({"uid": uid} if uid else {}),
    }


def _fleet(root, work, **kw):
    return ScorerFleet(os.path.join(root, "gen-1"), str(work), artifacts_dir=root, route_re_type="userId",
                       hot_bytes=1,  # force an unpinned, genuinely sharded store
                       max_batch_size=8, max_delay_ms=1.0, connect_timeout_s=CONNECT_TIMEOUT_S, device="cpu", **kw)


def _score_all(backend, xa, xb, users, uids=False):
    """Every row through ``backend.submit``; (scores, errors, replicas used)."""
    n = len(users)
    futs = [backend.submit(_score_request(xa[i], xb[i], users[i], uid=f"u{i}" if uids else None), "tenantA",
                           "interactive") for i in range(n)]
    out, errors, used = np.zeros(n, np.float32), 0, set()
    for i, f in enumerate(futs):
        try:
            res = f.result(RESULT_TIMEOUT_S)
            out[i] = res["score"]
            used.add(res["replica"])
        except Exception:  # noqa: BLE001 — counted, asserted zero
            errors += 1
    return out, errors, used


def _rows(n, seed=11):
    g = np.random.default_rng(seed)
    xa = g.normal(size=(n, D_FIX)).astype(np.float32)
    xb = g.normal(size=(n, D_RE)).astype(np.float32)
    return xa, xb, np.arange(n) % N_ENTITIES


def _publish_model(root, model):
    """A port model written as the generation ``gen-1`` of ``root`` by the
    port's writer, with LATEST flipped to it."""
    from photon_tpu_torch.io.model_io import publish_latest_pointer, save_game_model

    imaps = {"shardA": IndexMap.build([f"a{j}" for j in range(D_FIX)]),
             "shardB": IndexMap.build([f"b{j}" for j in range(D_RE)])}
    eidx = make_entity_index()
    for shard, imap in imaps.items():
        imap.save(os.path.join(root, f"index-map-{shard}.json"))
    eidx.save(os.path.join(root, "entity-index-userId.json"))
    save_game_model(model, os.path.join(root, "gen-1"), imaps, {"userId": eidx}, sparsity_threshold=0.0)
    publish_latest_pointer(root, "gen-1")


def _within_reference(got, ref):
    return bool(np.all(np.abs(got - ref) <= TOL * (1 + np.abs(ref))))


# ---------------------------------------------------------------------------
# The reference's drills
# ---------------------------------------------------------------------------


def test_fleet_three_replicas_parity_kill_revive(tmp_path):
    root = str(tmp_path / "pub")
    os.makedirs(root)
    model = _publish_generation(root, "gen-1", 1.0)
    fleet = _fleet(root, tmp_path / "work", spool_base=str(tmp_path / "spool"))
    try:
        fleet.start(["r0", "r1", "r2"])
        backend = FleetBackend(fleet.router)
        n = 32
        xa, xb, users = _rows(n)
        ref = batch_scores(model, xa, xb, users)
        ref_fe = batch_scores(model, xa, np.zeros_like(xb), np.full(n, -1))

        # Healthy fleet: bit parity with the batch path, all 3 serving.
        got, errors, used = _score_all(backend, xa, xb, users, uids=True)
        assert errors == 0 and used == {"r0", "r1", "r2"}
        np.testing.assert_array_equal(got, ref)

        # /healthz fleet snapshot + disjoint shard evidence.
        snap = fleet.fleet_snapshot()
        assert snap["states"] == {m: "live" for m in ("r0", "r1", "r2")}
        assert set(snap["readyS"]) == {"r0", "r1", "r2"} and all(0 < s < CONNECT_TIMEOUT_S
                                                                  for s in snap["readyS"].values())
        assert set(snap["shardRanges"]) == {"r0", "r1", "r2"}
        stats = fleet.router.replica_stats()
        owned = {rid: s["partition"]["re_types"]["userId"]["owned"] for rid, s in stats.items()}
        assert sum(owned.values()) == N_ENTITIES  # disjoint cover
        assert all(v < N_ENTITIES for v in owned.values())
        assert {s["device"] for s in stats.values()} == {"cpu"}

        # Feedback follows each uid to the replica that scored it.
        fb = backend.feedback({"labels": [{"uid": f"u{i}", "label": 1.0} for i in range(n)]})
        assert fb["joined"] == n and fb["dropped"] == 0

        # SIGKILL drill: zero caller errors; the dead member's keys score
        # FE-only (their RE rows are foreign everywhere else), everyone
        # else's stay exact.
        fleet.kill("r1")
        got2, errors2, used2 = _score_all(backend, xa, xb, users, uids=True)
        assert errors2 == 0 and "r1" not in used2
        r1_keys = [i for i in range(n) if fleet.ring.owner(f"user{users[i]}") == "r1"]
        assert r1_keys, "seed must give r1 a share of the test keys"
        for i in range(n):
            expect = ref_fe[i] if i in r1_keys else ref[i]
            assert got2[i] == expect, (i, got2[i], ref[i], ref_fe[i])

        # Revive: same id, same ring — exact scores re-home.
        fleet.revive("r1")
        got3, errors3, used3 = _score_all(backend, xa, xb, users, uids=True)
        assert errors3 == 0 and "r1" in used3
        np.testing.assert_array_equal(got3, ref)

        # HTTP surface: /v1/score routes through the ring and /healthz
        # carries the fleet block (ring version, shard ranges, states).
        http_fe = FleetHTTPFrontend(backend).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", http_fe.port, timeout=30)
            conn.request("POST", "/v1/score", body=json.dumps(_score_request(xa[0], xb[0], users[0])),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            body = json.loads(resp.read())
            assert np.float32(body["score"]) == ref[0]
            assert body["replica"] in {"r0", "r1", "r2"}
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            assert health["fleet"]["ringVersion"] == fleet.ring.version
            assert set(health["fleet"]["shardRanges"]) == {"r0", "r1", "r2"}
            assert health["fleet"]["states"]["r1"] == "live"
            conn.close()
        finally:
            http_fe.close()

        # Per-replica spool dirs exist for the updater's glob.
        assert {"r0", "r1", "r2"} <= set(os.listdir(str(tmp_path / "spool")))
    finally:
        fleet.shutdown()


def test_fleet_tcp_transport_parity_warm_join_and_leave(tmp_path):
    """Over TCP loopback: scores are bit-identical to the batch path (and
    therefore to the Unix-socket fleet), a warm join hands the newcomer its
    hot set before the ring flips, and a warm leave ships the departing
    shard's rows to the survivors so post-drain scoring stays EXACT. Zero
    caller errors throughout; per-peer RPC metrics flow; no replica
    captures after warm-up."""
    root = str(tmp_path / "pub")
    os.makedirs(root)
    model = _publish_generation(root, "gen-1", 1.0)
    fleet = _fleet(root, tmp_path / "work", spool_base=str(tmp_path / "spool"), transport="tcp")
    try:
        fleet.start(["r0", "r1"])
        assert all(fleet.socket_path(r).startswith("tcp://") for r in ("r0", "r1"))
        backend = FleetBackend(fleet.router)
        n = 24
        xa, xb, users = _rows(n)
        ref = batch_scores(model, xa, xb, users)

        got, errors, used = _score_all(backend, xa, xb, users)
        assert errors == 0 and used == {"r0", "r1"}
        np.testing.assert_array_equal(got, ref)  # TCP ≡ batch ≡ unix

        # Warm elastic join: the newcomer serves immediately and the fleet
        # still scores bit-exact.
        joined = fleet.join("r2", warm=True)
        assert set(joined) == {"rows", "promoted", "seconds"}
        got2, errors2, used2 = _score_all(backend, xa, xb, users)
        assert errors2 == 0 and "r2" in used2
        np.testing.assert_array_equal(got2, ref)

        # Warm drain: survivors inherited r2's rows BEFORE the flip, so
        # scoring stays exact — no FE-only window to wait out.
        left = fleet.leave("r2", warm=True, settle_s=10.0)
        assert set(left) == {"rows", "promoted", "seconds"}
        got3, errors3, used3 = _score_all(backend, xa, xb, users)
        assert errors3 == 0 and "r2" not in used3
        np.testing.assert_array_equal(got3, ref)

        # Per-peer RPC telemetry exists for the score path.
        lat = registry().find("fleet_rpc_latency_s", replica="r0", op="score")
        assert lat is not None and lat.count > 0
        snap = fleet.fleet_snapshot()
        assert snap["routerId"].startswith("router-")
        assert "fleet_split_brain" in snap["slo"]["objectives"]
        assert all(s["retraces_since_warmup"] == 0 for s in fleet.router.replica_stats().values())
    finally:
        fleet.shutdown()


# ---------------------------------------------------------------------------
# The port fleet against the reference
# ---------------------------------------------------------------------------


def test_fleet_scores_equal_batch_path_and_reference(tmp_path):
    """A reference model carried into the port (``interop.game_model``),
    written by the port and served by three replicas: every routed score
    equals the port's batch path at atol 0 and the reference's batch scoring
    of the same model within 1e-5·(1 + |score|); with a replica killed, its
    keys equal the port's FE-only batch scores and the reference's."""
    from test_serving import batch_scores as ref_batch_scores
    from test_serving import make_model as ref_make_model

    from photon_tpu_torch.interop import game_model

    ref_model = ref_make_model(0.8)
    model = game_model(ref_model, device="cpu")
    root = str(tmp_path / "pub")
    os.makedirs(root)
    _publish_model(root, model)
    n = 48
    xa, xb, users = _rows(n, seed=17)
    want = batch_scores(model, xa, xb, users)
    want_fe = batch_scores(model, xa, np.zeros_like(xb), np.full(n, -1))
    ref = ref_batch_scores(ref_model, xa, xb, users)
    ref_fe = ref_batch_scores(ref_model, xa, np.zeros_like(xb), np.full(n, -1))
    assert _within_reference(want, ref) and _within_reference(want_fe, ref_fe)
    fleet = _fleet(root, tmp_path / "work")
    try:
        fleet.start(["r0", "r1", "r2"])
        backend = FleetBackend(fleet.router)
        got, errors, used = _score_all(backend, xa, xb, users)
        assert errors == 0 and used == {"r0", "r1", "r2"}
        np.testing.assert_array_equal(got, want)
        assert _within_reference(got, ref)
        fleet.kill("r2")
        dead = np.array([fleet.ring.owner(f"user{u}") == "r2" for u in users])
        assert dead.any() and not dead.all()
        got2, errors2, _ = _score_all(backend, xa, xb, users)
        assert errors2 == 0
        np.testing.assert_array_equal(got2, np.where(dead, want_fe, want))
        assert _within_reference(got2, np.where(dead, ref_fe, ref))
    finally:
        fleet.shutdown()


def test_fleet_serves_a_generation_the_reference_wrote(tmp_path):
    """A generation written by the reference's ``save_game_model`` (and its
    LATEST pointer, index maps and entity index) served by a two-replica
    port fleet: every score equals the port's batch path on the same model
    carried across at atol 0, and the reference's batch scoring within
    1e-5·(1 + |score|)."""
    from test_serving import _publish_generation as ref_publish
    from test_serving import batch_scores as ref_batch_scores

    from photon_tpu_torch.cli.game_serving import resolve_model_dir
    from photon_tpu_torch.interop import game_model

    root = str(tmp_path / "pub")
    os.makedirs(root)
    ref_model = ref_publish(root, "gen-1", 1.3)
    assert resolve_model_dir(root).endswith("gen-1")
    model = game_model(ref_model, device="cpu")
    n = 40
    xa, xb, users = _rows(n, seed=19)
    want = batch_scores(model, xa, xb, users)
    fleet = _fleet(root, tmp_path / "work")
    try:
        fleet.start(["r0", "r1"])
        got, errors, used = _score_all(FleetBackend(fleet.router), xa, xb, users)
        assert errors == 0 and used == {"r0", "r1"}
        np.testing.assert_array_equal(got, want)
        assert _within_reference(got, ref_batch_scores(ref_model, xa, xb, users))
    finally:
        fleet.shutdown()


# ---------------------------------------------------------------------------
# No fallback: a replica that cannot start
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["cuda_without_a_card", "missing_model"])
def test_replica_that_cannot_start_raises_with_its_log(tmp_path, fault):
    """A replica asked for cuda on a host with no card visible exits
    non-zero, as every command line of the port does, and so does one
    whose model is missing: ``start`` raises at once with the end of its
    log, without waiting out the connect timeout or carrying on without
    the member."""
    root = str(tmp_path / "pub")
    os.makedirs(root)
    _publish_generation(root, "gen-1", 1.0)
    if fault == "cuda_without_a_card":
        fleet = ScorerFleet(os.path.join(root, "gen-1"), str(tmp_path / "work"), artifacts_dir=root,
                            route_re_type="userId", connect_timeout_s=CONNECT_TIMEOUT_S,
                            replica_env={"r1": {"CUDA_VISIBLE_DEVICES": ""}})
        assert fleet.device == "cuda"
        want = "no CUDA device is available"
    else:
        fleet = _fleet(root, tmp_path / "work")
        fleet.model_dir = os.path.join(root, "gen-missing")
        want = "gen-missing"
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError) as err:
            fleet.start(["r1"])
        assert time.monotonic() - t0 < CONNECT_TIMEOUT_S / 2
        assert "r1 exited with code" in str(err.value) and want in str(err.value)
        assert fleet.router.live_members() == []
    finally:
        fleet.shutdown()
