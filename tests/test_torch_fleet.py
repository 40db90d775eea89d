"""The port's scorer fleet without its process drills (photon_tpu_torch/
serve/{fleet,routing,store,admission}.py, stream/{spool,updater,
shard_router}.py), held as tests/test_fleet.py holds the reference: every
case of that file but its two process drills (those are in
tests/test_torch_fleet_drills.py), on the CPU, plus the port against the
reference where both compute the same thing: the ring's owners for one
snapshot (weighted too) and a replica's owned mask.

The ring assertions pin the two properties the whole subsystem leans on:
(1) same (members, vnodes, seed) snapshot → same assignment in ANY process
(blake2b, no Python hash randomization), and (2) a single join/leave moves
≤ 1/N + ε of keys. Within the port the parity assertions are atol 0, as
the reference's are.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.serve.routing import HashRing, moved_keys, route_key, stable_hash
from photon_tpu_torch.serve.store import HotColdEntityStore, StorePartition

from test_torch_serving import D_FIX, D_RE, N_ENTITIES, batch_scores, make_entity_index, make_model

REPO = Path(__file__).resolve().parent.parent
KEYS = [f"user{i}" for i in range(2000)]


def _run_code(code: str, *args) -> str:
    """``code`` in a fresh interpreter with the repository on its path."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True, env=env,
                          check=True, timeout=120).stdout


# ---------------------------------------------------------------------------
# Ring properties
# ---------------------------------------------------------------------------


def test_stable_hash_is_process_stable_and_seeded():
    # Pinned values: blake2b output must never drift across versions — a
    # drift would silently re-shard every fleet on upgrade.
    assert stable_hash("user0", 0) == stable_hash("user0", 0)
    assert stable_hash("user0", 0) != stable_hash("user0", 1)
    assert stable_hash("user0", 0) != stable_hash("user1", 0)
    out = _run_code("from photon_tpu_torch.serve.routing import stable_hash;"
                    "print(stable_hash('user0', 0), stable_hash('user0', 7))").split()
    assert int(out[0]) == stable_hash("user0", 0)
    assert int(out[1]) == stable_hash("user0", 7)


def test_ring_assignment_deterministic_across_processes():
    ring = HashRing(["r0", "r1", "r2"], vnodes=64, seed=3)
    out = _run_code("import json,sys;"
                    "from photon_tpu_torch.serve.routing import HashRing;"
                    "r=HashRing.from_snapshot(json.loads(sys.argv[1]));"
                    "print(json.dumps([r.owner(f'user{i}') for i in range(200)]))", json.dumps(ring.snapshot()))
    assert json.loads(out) == [ring.owner(f"user{i}") for i in range(200)]


def test_ring_snapshot_canonical_regardless_of_join_order():
    a = HashRing(["r0", "r1", "r2"], vnodes=32, seed=1)
    b = HashRing(["r2", "r0", "r1"], vnodes=32, seed=1)
    assert a.snapshot() == b.snapshot()
    assert [a.owner(k) for k in KEYS[:200]] == [b.owner(k) for k in KEYS[:200]]


def test_ring_join_moves_at_most_one_share_plus_eps():
    before = HashRing([f"r{i}" for i in range(4)], vnodes=64, seed=0)
    after = HashRing([f"r{i}" for i in range(5)], vnodes=64, seed=0)
    moved = moved_keys(before, after, KEYS)
    # Ideal: 1/5 of keys move (all TO the newcomer). ε covers vnode
    # placement variance at 64 vnodes.
    assert len(moved) / len(KEYS) <= 1 / 5 + 0.08
    assert all(after.owner(k) == "r4" for k in moved)


def test_ring_leave_moves_only_the_departed_shard():
    before = HashRing([f"r{i}" for i in range(4)], vnodes=64, seed=0)
    after = HashRing.from_snapshot(before.snapshot())
    after.remove("r1")
    moved = moved_keys(before, after, KEYS)
    assert len(moved) / len(KEYS) <= 1 / 4 + 0.08
    # Exactly the departed member's keys move; everyone else's stay put.
    assert all(before.owner(k) == "r1" for k in moved)
    assert sum(1 for k in KEYS if before.owner(k) == "r1") == len(moved)


def test_ring_balance_and_shard_ranges():
    ring = HashRing(["r0", "r1", "r2"], vnodes=128, seed=0)
    owners = [ring.owner(k) for k in KEYS]
    for m in ring.members:
        share = owners.count(m) / len(KEYS)
        assert 1 / 3 - 0.12 < share < 1 / 3 + 0.12
    ranges = ring.shard_ranges()
    assert set(ranges) == {"r0", "r1", "r2"}
    assert abs(sum(r["fraction"] for r in ranges.values()) - 1.0) < 1e-6


def test_ring_preference_starts_at_owner_and_covers_members():
    ring = HashRing(["r0", "r1", "r2", "r3"], vnodes=64, seed=0)
    for k in KEYS[:100]:
        pref = ring.preference(k)
        assert pref[0] == ring.owner(k)
        assert sorted(pref) == ["r0", "r1", "r2", "r3"]


def test_route_key_prefers_routing_type():
    assert route_key({"userId": "u1", "adId": "a9"}, "userId") == "u1"
    # Routing type absent: deterministic fallback (lexicographically first).
    assert route_key({"zz": "z1", "adId": "a9"}, "userId") == "a9"
    assert route_key({}, "userId") is None
    assert route_key(None, None) is None
    assert route_key({"userId": 7}, "userId") == "7"


def test_weighted_ring_proportional_ownership_and_movement_bounds():
    """Heterogeneous member weights: a weight-w member owns ~w shares of
    the hash space, snapshots round-trip bit-identically, and a weighted
    join still moves only (about) the joiner's share of keys."""
    ring = HashRing(["A", "B", "C"], vnodes=64, weights={"C": 3})
    owned = {m: 0 for m in ("A", "B", "C")}
    for k in KEYS:
        owned[ring.owner(k)] += 1
    # 5 total shares: A=1/5, B=1/5, C=3/5 (loose tolerance — vnode noise).
    assert abs(owned["C"] / len(KEYS) - 0.6) < 0.12
    assert abs(owned["A"] / len(KEYS) - 0.2) < 0.1
    assert abs(owned["B"] / len(KEYS) - 0.2) < 0.1
    fr = ring.shard_ranges()
    assert abs(fr["C"]["fraction"] - 0.6) < 0.12
    rebuilt = HashRing.from_snapshot(ring.snapshot())
    assert not moved_keys(ring, rebuilt, KEYS)
    assert rebuilt.member_vnodes("C") == 3 * 64
    after = HashRing.from_snapshot(ring.snapshot())
    after.add("D", weight=2)
    moved = moved_keys(ring, after, KEYS)
    assert len(moved) / len(KEYS) <= 2.0 / 7.0 + 0.08
    assert all(after.owner(k) == "D" for k in moved)
    # Uniform-weight snapshots stay in the legacy shape (no weights key).
    assert "weights" not in HashRing(["A", "B"], vnodes=64).snapshot()


# ---------------------------------------------------------------------------
# The port against the reference: ring owners and owned masks
# ---------------------------------------------------------------------------


def _ring_snapshots():
    g = np.random.default_rng(23)
    members = [f"r{i}" for i in range(int(g.integers(3, 6)))]
    uniform = HashRing(members, vnodes=int(g.integers(16, 96)), seed=int(g.integers(0, 1000)))
    weighted = HashRing(members, vnodes=int(g.integers(16, 96)), seed=int(g.integers(0, 1000)),
                        weights={m: int(w) for m, w in zip(members, g.integers(1, 4, size=len(members)))})
    weighted.add("late", weight=2)
    return {"uniform": uniform.snapshot(), "weighted": weighted.snapshot()}


@pytest.mark.parametrize("kind", ["uniform", "weighted"])
def test_ring_owners_match_the_reference(kind):
    """One snapshot, both packages' rings: the same owner and the same
    preference order for each of the 2000 keys, and the same shard ranges."""
    from photon_tpu.serve.routing import HashRing as JHashRing

    snap = _ring_snapshots()[kind]
    port, ref = HashRing.from_snapshot(snap), JHashRing.from_snapshot(snap)
    assert port.snapshot() == ref.snapshot() == snap
    assert [port.owner(k) for k in KEYS] == [ref.owner(k) for k in KEYS]
    assert [port.preference(k) for k in KEYS[:200]] == [ref.preference(k) for k in KEYS[:200]]
    assert port.shard_ranges() == ref.shard_ranges()


def test_partition_from_snapshot_owned_mask_matches_the_reference():
    """``partition_from_snapshot`` in both packages: the same owned mask for
    every member over named entities (through each package's entity index)
    and over bare indices, and the same routed type."""
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex
    from photon_tpu.serve.fleet import partition_from_snapshot as j_partition
    from photon_tpu.serve.store import _owned_mask as j_owned_mask

    from photon_tpu_torch.serve.fleet import partition_from_snapshot
    from photon_tpu_torch.serve.store import _owned_mask

    n = 500
    g = np.random.default_rng(29)
    names = [f"u{int(x)}" for x in g.choice(100000, size=n, replace=False)]
    jidx, tidx = JEntityIndex(), make_entity_index(0)
    for name in names:
        jidx.intern(name)
        tidx.intern(name)
    for snap in _ring_snapshots().values():
        cover = np.zeros(n, int)
        for member in snap["members"]:
            p = partition_from_snapshot(member, snap, "userId")
            j = j_partition(member, snap, "userId")
            assert p.re_types == j.re_types == ("userId",) and p.applies_to("userId")
            mask = _owned_mask(p, tidx, n)
            np.testing.assert_array_equal(mask, j_owned_mask(j, jidx, n))
            np.testing.assert_array_equal(_owned_mask(p, None, n), j_owned_mask(j, None, n))
            cover += mask
        np.testing.assert_array_equal(cover, np.ones(n, int))  # disjoint and complete


# ---------------------------------------------------------------------------
# Partition-aware store
# ---------------------------------------------------------------------------


def _ring2():
    return HashRing(["A", "B"], vnodes=64, seed=0)


def _owned_users(ring, member):
    return [e for e in range(N_ENTITIES) if ring.owner(f"user{e}") == member]


def test_partitioned_store_masks_foreign_entities():
    ring = _ring2()
    model = make_model()
    w_re = model.models["per_user"].coefficients.numpy()
    store = HotColdEntityStore(model, {"userId": make_entity_index()}, hot_bytes=1, min_hot_rows=8,
                               partition=StorePartition("A", ring, re_types=("userId",)), device="cpu")
    mine = _owned_users(ring, "A")[:6]
    theirs = _owned_users(ring, "B")[:6]
    slots = store.resolve("userId", [f"user{e}" for e in mine + theirs])
    assert all(s >= 0 for s in slots[: len(mine)])
    assert all(s == -1 for s in slots[len(mine):])  # foreign → FE-only
    table = store.scoring_model().models["per_user"].coefficients.numpy()
    for e, s in zip(mine, slots):
        np.testing.assert_array_equal(table[s], w_re[e])
    foreign = registry().find("serve_store_foreign_total", re_type="userId")
    assert foreign is not None and foreign.value >= len(theirs)
    stats = store.partition_stats()
    assert stats["replica_id"] == "A" and stats["ring_members"] == 2
    assert stats["re_types"]["userId"]["owned"] == len(_owned_users(ring, "A"))
    assert stats["re_types"]["userId"]["compacted"]


def test_partitioned_stores_are_disjoint_and_cover_everything():
    ring = _ring2()
    owned = {m: set(_owned_users(ring, m)) for m in ("A", "B")}
    assert not (owned["A"] & owned["B"])
    assert owned["A"] | owned["B"] == set(range(N_ENTITIES))
    # And the stores agree with the ring exactly.
    for member in ("A", "B"):
        store = HotColdEntityStore(make_model(), {"userId": make_entity_index()}, hot_bytes=1, min_hot_rows=40,
                                   partition=StorePartition(member, ring, re_types=("userId",)), device="cpu")
        for e in list(owned[member])[:10]:
            assert store.resolve("userId", [f"user{e}"])[0] >= 0
        other = "B" if member == "A" else "A"
        for e in list(owned[other])[:10]:
            assert store.resolve("userId", [f"user{e}"])[0] == -1


def test_partition_compacts_host_master():
    ring = _ring2()
    n_owned = len(_owned_users(ring, "A"))
    store = HotColdEntityStore(make_model(), {"userId": make_entity_index()}, hot_bytes=1, min_hot_rows=8,
                               partition=StorePartition("A", ring, re_types=("userId",)), device="cpu")
    stats = store.partition_stats()["re_types"]["userId"]
    # The host master holds ~1/N of the rows, keyed by the same hash.
    assert stats["host_rows"] == n_owned < N_ENTITIES


def test_set_partition_swaps_ownership_live():
    ring = _ring2()
    # compact_host=False so a later rebalance can re-home without a store
    # rebuild (rows are all still host-side).
    store = HotColdEntityStore(make_model(), {"userId": make_entity_index()}, hot_bytes=1, min_hot_rows=8,
                               partition=StorePartition("A", ring, re_types=("userId",), compact_host=False),
                               device="cpu")
    mine = _owned_users(ring, "A")[0]
    theirs = _owned_users(ring, "B")[0]
    assert store.resolve("userId", [f"user{mine}"])[0] >= 0
    assert store.resolve("userId", [f"user{theirs}"])[0] == -1
    # The ring shrinks to just this replica: everything becomes ours.
    solo = HashRing(["A"], vnodes=64, seed=0)
    store.set_partition(StorePartition("A", solo, re_types=("userId",), compact_host=False))
    assert store.resolve("userId", [f"user{theirs}"])[0] >= 0


def test_partitioned_scores_match_batch_reference():
    from photon_tpu_torch.serve import ScoreRequest, ServeConfig, ServingEngine

    g = np.random.default_rng(7)
    ring = _ring2()
    model = make_model()
    engine = ServingEngine(model, entity_indexes={"userId": make_entity_index()},
                           config=ServeConfig(max_batch_size=8, max_delay_ms=1.0, hot_bytes=1, device="cpu"),
                           partition=StorePartition("A", ring, re_types=("userId",)))
    try:
        mine = _owned_users(ring, "A")[:8]
        xa = g.normal(size=(len(mine), D_FIX)).astype(np.float32)
        xb = g.normal(size=(len(mine), D_RE)).astype(np.float32)
        ref = batch_scores(model, xa, xb, mine)
        futs = [engine.submit(ScoreRequest(features={"shardA": xa[i], "shardB": xb[i]},
                                           entity_ids={"userId": f"user{e}"})) for i, e in enumerate(mine)]
        got = np.array([f.result(30) for f in futs], np.float32)
        # Owned entities score bit-identical to the batch path.
        np.testing.assert_array_equal(got, ref)
    finally:
        engine.close()


def test_warm_handoff_kills_fe_only_window_bit_exact():
    """The leave-side warm handoff at store level: the departing owner
    exports its host rows against the future ring, the survivor imports
    them (appending to its compacted master + pre-promoting the hot set),
    and after the ring flips EVERY inherited key scores from bit-identical
    coefficients — no FE-only window, no re-stream from disk."""
    ring = HashRing(["A", "B"], vnodes=64, seed=0)
    model = make_model()
    w_re = model.models["per_user"].coefficients.numpy()

    def mk(member):
        return HotColdEntityStore(model, {"userId": make_entity_index()}, hot_bytes=1, min_hot_rows=8,
                                  partition=StorePartition(member, ring, re_types=("userId",)), device="cpu")

    store_a, store_b = mk("A"), mk("B")
    b_owned = _owned_users(ring, "B")
    assert len(b_owned) > 8
    store_b.resolve("userId", [f"user{e}" for e in b_owned[:5]])  # warm 5
    after = HashRing.from_snapshot(ring.snapshot())
    after.remove("B")

    payload = store_b.shard_export(after.snapshot(), target_member="A", include_cold=True)
    assert len(payload["groups"]) == 1
    grp = payload["groups"][0]
    assert len(grp["keys"]) == len(b_owned) and sum(grp["hot"]) == 5
    stats = store_a.shard_import(payload, upload_chunk=8)
    # Survivor's compacted master lacked every inherited row; the hot 5
    # are pre-promoted into the device cache before the flip.
    assert stats["rowsAdded"] == len(b_owned) and stats["promoted"] == 5
    assert stats["unknownKeys"] == 0

    store_a.set_partition(StorePartition("A", after, re_types=("userId",)))
    for start in range(0, len(b_owned), 6):
        chunk = b_owned[start:start + 6]
        slots = store_a.resolve("userId", [f"user{e}" for e in chunk])
        assert all(s >= 0 for s in slots)  # the FE-only window is gone
        table = store_a.scoring_model().models["per_user"].coefficients.numpy()
        for e, s in zip(chunk, slots):
            np.testing.assert_array_equal(table[s], w_re[e])
    # Idempotent: a re-delivered payload adds nothing new.
    again = store_a.shard_import(payload, upload_chunk=8)
    assert again["rowsAdded"] == 0
    assert again["rowsKnown"] == len(b_owned)


def test_join_handoff_exports_hot_set_only():
    """The join-side handoff trims to the hot set (include_cold=False):
    the newcomer builds its own host shard from disk, so incumbents ship
    cache WARMTH, not rows."""
    ring = _ring2()
    store_b = HotColdEntityStore(make_model(), {"userId": make_entity_index()}, hot_bytes=1, min_hot_rows=8,
                                 partition=StorePartition("B", ring, re_types=("userId",)), device="cpu")
    b_owned = _owned_users(ring, "B")
    future = HashRing.from_snapshot(ring.snapshot())
    future.add("C")
    movers = [e for e in b_owned if future.owner(f"user{e}") == "C"]
    stayers = [e for e in b_owned if future.owner(f"user{e}") == "B"]
    assert movers and stayers
    # Warm a mix of entities that move to C and entities that stay on B.
    warm = movers[:3] + stayers[:3]
    store_b.resolve("userId", [f"user{e}" for e in warm])
    payload = store_b.shard_export(future.snapshot(), target_member="C", include_cold=False)
    got = payload["groups"][0]["keys"]
    # Only the HOT entities actually moving to C ship; warm stayers and
    # cold movers do not.
    assert sorted(got) == sorted(f"user{e}" for e in movers[:3])
    assert all(payload["groups"][0]["hot"])


# ---------------------------------------------------------------------------
# Fleet-global admission ledger
# ---------------------------------------------------------------------------


def test_fleet_ledger_sheds_like_single_process_admission():
    from photon_tpu_torch.serve.admission import AdmissionConfig, FleetAdmissionLedger, QuotaExceededError

    clock = [0.0]
    ledger = FleetAdmissionLedger(AdmissionConfig(tenant_qps={"abuser": 2.0}, tenant_burst={"abuser": 2.0}),
                                  clock=lambda: clock[0])
    # The abusive tenant gets exactly its burst, fleet-wide — there is ONE
    # bucket no matter how many replicas will execute the work.
    admitted = shed = 0
    for _ in range(10):
        try:
            ledger.admit("abuser", "interactive")
            admitted += 1
        except QuotaExceededError:
            shed += 1
    assert admitted == 2 and shed == 8
    ledger.admit("anyone-else", "interactive")  # unnamed tenants unlimited
    snap = ledger.fleet_snapshot()
    assert snap["tenants"]["abuser"]["shed"] == 8
    assert snap["tenants"]["abuser"]["admitted"] == 2


def test_fleet_ledger_tracks_per_replica_inflight():
    from photon_tpu_torch.serve.admission import FleetAdmissionLedger

    ledger = FleetAdmissionLedger()
    ledger.begin("r0")
    ledger.begin("r0")
    ledger.begin("r1")
    assert ledger.inflight("r0") == 2
    assert ledger.inflight() == 3
    ledger.end("r0")
    ledger.end("r1")
    assert ledger.inflight("r0") == 1 and ledger.inflight("r1") == 0
    assert ledger.fleet_snapshot()["inflight"] == {"r0": 1}


def test_fleet_ledger_surfaces_per_tenant_quality():
    """Per-tenant ``quality_auc``/``auc_lift`` ride the fleet admission
    ledger into the ``/healthz`` tenants block — count-weighted across
    replicas and versions, baseline lane excluded."""
    from photon_tpu_torch.obs.quality import QualityConfig, QualityPlane
    from photon_tpu_torch.serve.admission import FleetAdmissionLedger, tenant_quality

    plane = QualityPlane(QualityConfig(min_events=1))
    plane.set_baseline("gen-base")
    g = np.random.default_rng(3)
    for tenant in ("tenantA", "tenantB"):
        for i in range(40):
            label = float(i % 2)
            # tenantA's scores separate the classes; tenantB's are noise.
            score = (label * 2.0 - 1.0) * 2.0 if tenant == "tenantA" else float(g.normal())
            plane.observe(score, label, model_version="gen-1", tenant=tenant, re_type="userId")
            plane.observe(float(g.normal()), label, model_version="gen-base", tenant=tenant, re_type="userId")
    per_tenant = tenant_quality([plane.snapshot()])
    assert set(per_tenant) == {"tenantA", "tenantB"}
    assert per_tenant["tenantA"]["quality_auc"] == 1.0
    assert per_tenant["tenantA"]["observations"] == 40
    # Lift vs the measured baseline lane is present and positive for the
    # separating model; the baseline lane itself contributed no tenant row.
    assert per_tenant["tenantA"]["auc_lift"] > 0.2

    ledger = FleetAdmissionLedger()
    ledger.admit("tenantA")
    ledger.update_quality(per_tenant)
    tenants = ledger.fleet_snapshot()["tenants"]
    assert tenants["tenantA"]["admitted"] == 1
    assert tenants["tenantA"]["quality_auc"] == 1.0
    assert tenants["tenantA"]["auc_lift"] > 0.2
    # Quality-only tenants still appear (zeroed admission counters).
    assert tenants["tenantB"]["admitted"] == 0
    assert "quality_auc" in tenants["tenantB"]
    # A replica that errored its stats scrape contributes nothing.
    assert tenant_quality([None, {"error": "boom"}]) == {}


# ---------------------------------------------------------------------------
# Metrics default labels (the `replica` label)
# ---------------------------------------------------------------------------


def test_metrics_default_labels_merge_and_reset():
    from photon_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.set_default_labels(replica="r7")
    reg.counter("fleet_test_total", op="score").inc()
    inst = reg.find("fleet_test_total", op="score")
    assert inst is not None and inst.label_dict() == {"op": "score", "replica": "r7"}
    # Explicit label wins on collision.
    reg.counter("fleet_test_total", replica="override").inc()
    assert reg.find("fleet_test_total", replica="override") is not None
    reg.reset()
    assert reg.default_labels() == {}


# ---------------------------------------------------------------------------
# Spool late labels + multi-dir updater merge
# ---------------------------------------------------------------------------


def test_spool_counts_late_labels_separately(tmp_path):
    from photon_tpu_torch.stream.spool import FeedbackSpool, SpoolConfig

    def _count(name):
        inst = registry().find(name)
        return inst.value if inst is not None else 0

    spool = FeedbackSpool(str(tmp_path / "spool"), SpoolConfig(join_ttl_s=0.01, segment_max_age_s=60.0))
    try:
        late0 = _count("feedback_label_late_total")
        unmatched0 = _count("feedback_labels_unmatched_total")
        assert spool.observe_scored("uid-late", score=0.5)
        time.sleep(0.03)
        spool.tick()  # TTL eviction moves uid-late to the expired set
        assert not spool.observe_label("uid-late", 1.0)  # late, not unknown
        assert not spool.observe_label("uid-never-seen", 1.0)
        assert _count("feedback_label_late_total") == late0 + 1
        assert _count("feedback_labels_unmatched_total") == unmatched0 + 1
        assert spool.stats()["expired_uids"] >= 1
    finally:
        spool.close()


def _write_sealed(directory, seq, records, mtime):
    from photon_tpu_torch.stream.spool import _sealed_name

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _sealed_name(seq))
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    os.utime(path, (mtime, mtime))
    return os.path.basename(path)


def test_updater_merges_spool_dirs_in_mtime_order(tmp_path):
    from photon_tpu_torch.stream.updater import (discover_spool_dirs, is_spool_glob, merge_pending_segments,
                                                 spool_dir_key)

    base = tmp_path / "spools"
    r0, r1 = str(base / "r0"), str(base / "r1")
    s_a = _write_sealed(r0, 1, [{"uid": "a"}], mtime=100.0)
    s_b = _write_sealed(r1, 1, [{"uid": "b"}], mtime=50.0)
    s_c = _write_sealed(r0, 2, [{"uid": "c"}], mtime=150.0)
    s_d = _write_sealed(r1, 2, [{"uid": "d"}], mtime=120.0)

    spec = str(base / "*")
    assert is_spool_glob(spec)
    dirs = discover_spool_dirs(spec)
    assert [spool_dir_key(d) for d in dirs] == ["r0", "r1"]

    merged = merge_pending_segments(dirs, {}, max_segments=10)
    assert [(spool_dir_key(d), fn) for d, fn in merged] == [("r1", s_b), ("r0", s_a), ("r1", s_d), ("r0", s_c)]
    # The cap takes a PREFIX of the merged order — per-dir seq prefixes
    # stay intact, so per-dir cursors remain sound.
    capped = merge_pending_segments(dirs, {}, max_segments=2)
    assert [(spool_dir_key(d), fn) for d, fn in capped] == [("r1", s_b), ("r0", s_a)]
    # Per-dir cursors filter independently.
    after = merge_pending_segments(dirs, {"r0": 1, "r1": 2}, max_segments=10)
    assert [(spool_dir_key(d), fn) for d, fn in after] == [("r0", s_c)]


def test_updater_single_dir_remains_legacy_shaped(tmp_path):
    # A plain (non-glob) spool_dir keeps the single-directory manifest
    # shape — scalar consumedThrough only — via the compatibility fallback.
    from photon_tpu_torch.stream.updater import discover_spool_dirs, is_spool_glob, spool_dir_key

    d = str(tmp_path / "solo")
    assert not is_spool_glob(d)
    assert discover_spool_dirs(d) == [d]
    assert spool_dir_key(d) == "solo"


# ---------------------------------------------------------------------------
# Transport, split brain, host-owned spill
# ---------------------------------------------------------------------------


def test_frame_roundtrip_byte_identical_over_unix_and_tcp():
    """The frame protocol carries the SAME bytes over AF_UNIX and TCP — the
    transport changes the pipe, never the encoding — and both decode back
    to the original message."""
    import socket as socket_mod
    import struct
    import threading

    from photon_tpu_torch.serve.frontend import _recv_frame, _send_frame

    msg = {"id": 7, "op": "score",
           "request": {"features": {"a": [1.5, -2.25]}, "entityIds": {"userId": "user3"}}, "tenant": "tenantA"}

    def capture(make_pair):
        a, b = make_pair()
        try:
            _send_frame(a, msg, threading.Lock())
            raw = b.recv(1 << 20)
            a2, b2 = make_pair()
            try:
                _send_frame(a2, msg, threading.Lock())
                decoded = _recv_frame(b2)
            finally:
                a2.close()
                b2.close()
            return raw, decoded
        finally:
            a.close()
            b.close()

    def unix_pair():
        return socket_mod.socketpair(socket_mod.AF_UNIX)

    def tcp_pair():
        srv = socket_mod.create_server(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        a = socket_mod.create_connection(("127.0.0.1", port))
        b, _ = srv.accept()
        srv.close()
        return a, b

    unix_raw, unix_msg = capture(unix_pair)
    tcp_raw, tcp_msg = capture(tcp_pair)
    assert unix_raw == tcp_raw  # byte-identical wire format
    assert unix_msg == tcp_msg == msg
    # And the frame really is length-prefixed big-endian + UTF-8 JSON.
    (n,) = struct.unpack(">I", unix_raw[:4])
    assert n == len(unix_raw) - 4
    assert json.loads(unix_raw[4:].decode()) == msg


def test_tcp_transport_requires_and_verifies_shared_secret():
    """TCP endpoints refuse to listen unauthenticated, reject a wrong
    shared secret with PermissionError (never retried), and serve a
    correct one — the HMAC handshake in both directions."""
    from photon_tpu_torch.serve.frontend import ScorerClient, ScorerServer

    with pytest.raises(ValueError):
        ScorerServer(None, "tcp://127.0.0.1:0")  # no secret, no listen
    srv = ScorerServer(None, "tcp://127.0.0.1:0", secret="s3cr3t")
    srv.start()
    try:
        assert srv.socket_path.startswith("tcp://127.0.0.1:")
        fails0 = registry().counter("fleet_auth_failures_total").value
        client = ScorerClient(srv.socket_path, connect_timeout_s=10, secret="s3cr3t")
        try:
            assert client.call("ping", timeout_s=10) == "pong"
        finally:
            client.close()
        t0 = time.monotonic()
        with pytest.raises(PermissionError):
            ScorerClient(srv.socket_path, connect_timeout_s=30, secret="wrong")
        # A bad secret fails FAST (no connect-retry loop) and is counted.
        assert time.monotonic() - t0 < 5.0
        assert registry().counter("fleet_auth_failures_total").value == fails0 + 1
    finally:
        srv.close()


@pytest.mark.parametrize("transport", ["unix", "tcp"])
def test_scorer_server_close_wakes_its_accept_loop(tmp_path, transport):
    """A scorer server closes at once after serving a connection: closing
    it wakes its accept loop, which would otherwise hold ``close`` (and a
    leaving or shut-down replica's exit) for the accept thread's join
    timeout."""
    from photon_tpu_torch.serve.frontend import ScorerClient, ScorerServer

    unix = transport == "unix"
    srv = ScorerServer(None, str(tmp_path / "s.sock") if unix else "tcp://127.0.0.1:0",
                       secret=None if unix else "s3cr3t")
    srv.start()
    client = ScorerClient(srv.socket_path, connect_timeout_s=10, secret=srv.secret)
    assert client.call("ping", timeout_s=10) == "pong"
    client.close()
    t0 = time.monotonic()
    srv.close()
    assert time.monotonic() - t0 < 1.0
    assert all(not t.is_alive() for t in srv._threads)


def test_split_brain_push_rejected_and_counted(tmp_path):
    """Two routers fighting over one replica: the second router's stale
    ring epoch is REJECTED (splitBrain=True), counted, and the replica
    stays on the first claimant's ring. A newer epoch from the second
    router is accepted — claims transfer forward, never backward."""
    from photon_tpu_torch.serve import ServeConfig, ServingEngine
    from photon_tpu_torch.serve.fleet import ReplicaScorerServer
    from photon_tpu_torch.serve.frontend import ScorerClient

    ring = _ring2()
    engine = ServingEngine(make_model(), entity_indexes={"userId": make_entity_index()},
                           config=ServeConfig(max_batch_size=8, max_delay_ms=1.0, hot_bytes=1, device="cpu"))
    sock = str(tmp_path / "replica.sock")
    server = ReplicaScorerServer(engine, sock, "A", route_re_type="userId")
    server.start()
    try:
        c1 = ScorerClient(sock, connect_timeout_s=10)
        c2 = ScorerClient(sock, connect_timeout_s=10)
        try:
            splits0 = registry().counter("fleet_split_brain_total").value
            snap = ring.snapshot()
            r1 = c1.call("ring", timeout_s=30, snapshot=snap, routerId="router-1")
            assert r1["splitBrain"] is False
            # Same epoch, different router: split brain — rejected.
            r2 = c2.call("ring", timeout_s=30, snapshot=snap, routerId="router-2")
            assert r2["splitBrain"] and r2["rejected"]
            assert r2["claimant"] == "router-1"
            assert registry().counter("fleet_split_brain_total").value == splits0 + 1
            info = c1.call("replica_info", timeout_s=30)
            assert info["ringClaimant"] == "router-1"
            assert info["ringVersion"] == snap["version"]
            # Router-2 pushes a NEWER epoch: legitimate takeover.
            newer = HashRing.from_snapshot(snap)
            newer.add("C")
            r3 = c2.call("ring", timeout_s=30, snapshot=newer.snapshot(), routerId="router-2")
            assert r3["splitBrain"] is False
            assert c1.call("replica_info", timeout_s=30)["ringClaimant"] == "router-2"
        finally:
            c1.close()
            c2.close()
    finally:
        server.close()
        engine.close()


def test_split_brain_burns_the_router_slo():
    """The router side of the guard: a rejected ring push records a bad
    event on the ``fleet_split_brain`` objective and the drill windows
    page within seconds — detection → page, not detection → log line."""
    from photon_tpu_torch.serve.admission import FleetAdmissionLedger
    from photon_tpu_torch.serve.fleet import FleetRouter

    router = FleetRouter(_ring2(), FleetAdmissionLedger(), "userId", router_id="router-x")
    for _ in range(3):
        router.slo.record_event("fleet_split_brain", good=False)
    snap = router.fleet_snapshot()
    assert snap["routerId"] == "router-x"
    assert snap["slo"]["objectives"]["fleet_split_brain"]["state"] == "page"


def test_spill_partition_rebalance_is_file_move(tmp_path):
    """Host-owned spill layout: shard k's files live under ``host-k/``;
    shrinking the ring re-homes departed partitions by ``os.replace`` —
    the SAME inodes appear under the survivors (a rename, provably not a
    data copy) and growing the ring moves nothing."""
    from photon_tpu_torch.algorithm.re_store import partition_spill_dir, rebalance_spill_layout
    from photon_tpu_torch.stream.shard_router import rebalance_updater_spill, shard_ring, updater_spill_dir

    root = str(tmp_path / "spill")
    inodes = {}
    for k in range(4):
        d = updater_spill_dir(root, k)
        assert d == os.path.join(root, f"host-{k}")
        path = os.path.join(d, f"block00000_features_{k}.npy")
        np.save(path, np.full((3, 2), float(k), np.float32))
        inodes[k] = os.stat(path).st_ino
    moves = rebalance_updater_spill(root, 4, 2)
    ring2 = shard_ring(2)
    # Every departed partition was adopted by its deterministic successor.
    assert set(moves) == {"updater:2", "updater:3"}
    for k in (2, 3):
        rec = moves[f"updater:{k}"]
        assert rec["moved"] == 1
        assert rec["successor"] == ring2.owner(f"updater:{k}")
        succ_dir = os.path.join(root, f"host-{rec['successor'].rsplit(':', 1)[1]}")
        moved_path = os.path.join(succ_dir, f"block00000_features_{k}.npy")
        assert os.path.exists(moved_path)
        # Same inode: a rename, not a copy — and bytes intact.
        assert os.stat(moved_path).st_ino == inodes[k]
        np.testing.assert_array_equal(np.load(moved_path), np.full((3, 2), float(k), np.float32))
        assert not os.path.isdir(os.path.join(root, f"host-{k}"))
    # Survivors kept their own files in place.
    for k in (0, 1):
        p = os.path.join(root, f"host-{k}", f"block00000_features_{k}.npy")
        assert os.stat(p).st_ino == inodes[k]
    # Growing adds members but moves no files (new shards start cold).
    assert rebalance_updater_spill(root, 2, 4) == {}
    # Name collisions keep both copies via the from-<k>__ prefix.
    d0 = partition_spill_dir(str(tmp_path / "c"), 0)
    d1 = partition_spill_dir(str(tmp_path / "c"), 1)
    np.save(os.path.join(d0, "x.npy"), np.zeros(1))
    np.save(os.path.join(d1, "x.npy"), np.ones(1))
    out = rebalance_spill_layout(str(tmp_path / "c"), HashRing(["0", "1"]), HashRing(["0"]))
    assert out["1"]["moved"] == 1
    assert os.path.exists(os.path.join(d0, "from-1__x.npy"))


# ---------------------------------------------------------------------------
# The module loads without the reference
# ---------------------------------------------------------------------------


def test_fleet_module_imports_no_jax():
    """``photon_tpu_torch.serve.fleet`` (and the package that exports it)
    load in a fresh interpreter without jax, the reference package or any
    module under the ``photon_tpu.`` prefix."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(REPO)!r}]\n"
        "import photon_tpu_torch.serve.fleet, photon_tpu_torch.serve\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'photon_tpu') or k.startswith(('jax.', 'photon_tpu.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
