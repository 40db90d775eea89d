"""Scorer fleet: N entity-sharded scorer processes behind one router (port
of photon_tpu/serve/fleet.py, without its relay server).

Photon ML's premise (PAPER.md §2.9) is that no single machine holds the
model; this module is the serving side of that claim. Topology:

- **One routing front end** (this process): owns the :class:`HashRing`,
  one framed-socket :class:`~photon_tpu_torch.serve.frontend.ScorerClient`
  per replica, and the
  :class:`~photon_tpu_torch.serve.admission.FleetAdmissionLedger` — the
  single coordinator for fleet-global tenant quotas (the frontend already
  sees every request, so the coordinator is free; no gossip).
- **N scorer replicas** (``python -m photon_tpu_torch.serve.fleet``), each
  a fresh interpreter started by ``subprocess.Popen`` (never a fork, so no
  CUDA context is inherited) with a CUDA context of its own on
  ``--device``: a full :class:`~photon_tpu_torch.serve.engine.ServingEngine`
  whose :class:`~photon_tpu_torch.serve.store.StorePartition` claims only
  the entities the ring assigns it. A replica's hot set is its DISJOINT
  ring shard — cache hit rate is a routing property, not a budget
  property. Replicas of one host share its card.

Degradation, never errors: a request landing on a replica that does not
own its entity (mis-route, membership churn, failover after a SIGKILL)
resolves that entity cold → the random effect contributes 0 → FE-only
score. The ``serve.replica_kill`` fault site (fired from the replica
heartbeat, targeted per replica via ``PHOTON_TPU_FAULT_PLAN`` in the
replica's environment) proves the full cycle: kill → router marks the
member dead → its shard fails over along the ring's preference order to
live successors (FE-only for the foreign entities) → revive → re-home to
exact scores. Elastic membership reuses the rollout watcher's settle
discipline: a leaving replica drains its in-flight work before the ring
drops it and the fleet re-partitions.

A replica that cannot start (no card for ``--device cuda``, a model that
does not load) makes ``start``, ``join`` or ``revive`` raise with the end
of its log: the fleet never carries on without it. The runbook lives in
README.md ("Fleet serving runbook").
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import socket as socket_mod
import subprocess
import sys
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from http.server import ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

from photon_tpu_torch.obs.metrics import registry, render_prometheus
from photon_tpu_torch.obs.slo import DRILL_PAGE_RULES, DRILL_WARN_RULES, Objective, SLOTracker
from photon_tpu_torch.obs.trace import flight_recorder, merge_trace_dumps
from photon_tpu_torch.serve.admission import INTERACTIVE, AdmissionConfig, FleetAdmissionLedger, tenant_quality
from photon_tpu_torch.serve.batcher import BackpressureError
from photon_tpu_torch.serve.frontend import (FLEET_SECRET_ENV, ScorerClient, ScorerServer, _stamp_labels,
                                             make_http_handler)
from photon_tpu_torch.serve.routing import HashRing, route_key
from photon_tpu_torch.serve.store import StorePartition
from photon_tpu_torch.utils import faults

logger = logging.getLogger("photon_tpu_torch")

# Router-side member states. DRAINING members finish in-flight work but
# receive no new requests; DEAD members are skipped until revived.
LIVE = "live"
DRAINING = "draining"
DEAD = "dead"

# Lines of a replica's log quoted when it fails to start.
LOG_TAIL_LINES = 40


def partition_from_snapshot(replica_id: str, snapshot: dict, route_re_type: Optional[str] = None,
                            compact_host: bool = True) -> StorePartition:
    """A replica's shard-ownership predicate from a ring snapshot. When a
    routing RE type is named, ONLY that type shards — secondary types stay
    fully replicated on every member, which is what makes a routed
    request's score bit-identical to the batch path's (the routed type
    is hot-or-cold exactly as a single process would have it; every other
    type is simply there)."""
    return StorePartition(replica_id=str(replica_id), ring=HashRing.from_snapshot(snapshot),
                          re_types=(route_re_type,) if route_re_type else None, compact_host=compact_host)


# ---------------------------------------------------------------------------
# Replica side
# ---------------------------------------------------------------------------


class ReplicaScorerServer(ScorerServer):
    """The per-replica IPC server: everything ``ScorerServer`` speaks
    (score/stats/reload/feedback/metrics/traces/ping) plus the fleet control
    plane — ``ring`` installs a new membership snapshot live (the
    elastic-join rebalance path), ``shard_export``/``shard_import`` carry
    the warm handoffs and ``replica_info`` answers the router's probes."""

    def __init__(self, engine, socket_path: str, replica_id: str, route_re_type: Optional[str] = None,
                 compact_host: bool = True):
        super().__init__(engine, socket_path)
        self.replica_id = str(replica_id)
        self.route_re_type = route_re_type
        self.compact_host = compact_host
        self.ring_version: Optional[int] = None
        # Split-brain guard: which router id last (successfully) claimed a
        # ring epoch on this replica. A DIFFERENT router pushing the same or
        # an older epoch is two coordinators fighting over one fleet — the
        # push is rejected and flagged so the routers' SLO planes can page.
        self.ring_claimant: Optional[str] = None

    def _dispatch(self, msg: dict, out) -> None:
        rid = msg.get("id")
        op = msg.get("op")
        if op == "ring":
            try:
                out.put(dict(id=rid, ok=True, result=self._op_ring(msg)))
            except Exception as exc:  # noqa: BLE001 — per-request failure
                out.put(self._error_payload(rid, exc))
            return
        if op == "shard_export":
            try:
                out.put(dict(id=rid, ok=True, result=self.engine.shard_export(
                    msg.get("snapshot") or {}, target_member=msg.get("targetMember"),
                    include_cold=bool(msg.get("includeCold", True)))))
            except Exception as exc:  # noqa: BLE001 — per-request failure
                out.put(self._error_payload(rid, exc))
            return
        if op == "shard_import":
            try:
                out.put(dict(id=rid, ok=True, result=self.engine.shard_import(msg.get("payload") or {})))
            except Exception as exc:  # noqa: BLE001 — per-request failure
                out.put(self._error_payload(rid, exc))
            return
        if op == "replica_info":
            try:
                out.put(dict(id=rid, ok=True, result=dict(
                    replica=self.replica_id, pid=os.getpid(), ringVersion=self.ring_version,
                    ringClaimant=self.ring_claimant, partition=self.engine.stats().get("partition"))))
            except Exception as exc:  # noqa: BLE001 — per-request failure
                out.put(self._error_payload(rid, exc))
            return
        # "metrics" (the per-replica counter/gauge scrape, every instrument
        # carrying the ``replica`` default label) and "traces" (the
        # flight-recorder ring) come from the ScorerServer base.
        super()._dispatch(msg, out)

    def _op_ring(self, msg: dict) -> dict:
        snap = msg.get("snapshot") or {}
        router_id = msg.get("routerId")
        version = int(snap.get("version", 0))
        if (router_id is not None and self.ring_claimant is not None and router_id != self.ring_claimant
                and self.ring_version is not None and version <= self.ring_version):
            registry().counter("fleet_split_brain_total").inc()
            logger.error("fleet replica %s: SPLIT BRAIN — router %s pushed ring v%d but router %s already claims "
                         "v%d; rejecting", self.replica_id, router_id, version, self.ring_claimant,
                         self.ring_version)
            return dict(splitBrain=True, rejected=True, claimant=self.ring_claimant, ringVersion=self.ring_version)
        partition = partition_from_snapshot(self.replica_id, snap, msg.get("routeReType", self.route_re_type),
                                            compact_host=self.compact_host)
        info = self.engine.set_partition(partition)
        self.ring_version = partition.ring.version
        if router_id is not None:
            self.ring_claimant = str(router_id)
        logger.info("fleet replica %s: installed ring v%s (%d members)", self.replica_id, partition.ring.version,
                    len(partition.ring))
        return dict(info, splitBrain=False)


def _replica_argparser() -> argparse.ArgumentParser:
    from photon_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(
        "photon-tpu-fleet-replica",
        description="One scorer-fleet replica: a ServingEngine owning the ring shard of its --replica-id on "
                    "--device, served over a framed Unix socket.",
    )
    p.add_argument("--socket", required=True,
                   help="framed-IPC endpoint: a Unix socket path, or tcp://host:port for the cross-host transport "
                        f"(the shared secret rides ${FLEET_SECRET_ENV}, never argv)")
    p.add_argument("--replica-id", required=True)
    p.add_argument("--model-dir", required=True)
    p.add_argument("--artifacts-dir", default=None)
    p.add_argument("--ring", required=True, help="ring snapshot JSON (members/vnodes/seed/version)")
    p.add_argument("--route-re-type", default=None, help="RE type the fleet shards; others stay replicated")
    p.add_argument("--no-compact-host", action="store_true",
                   help="keep the full host master per replica (re-homing without reload, at full host memory "
                        "per member)")
    p.add_argument("--hot-bytes", type=int, default=64 << 20)
    p.add_argument("--max-batch-size", type=int, default=64)
    p.add_argument("--max-delay-ms", type=float, default=2.0)
    p.add_argument("--queue-cap", type=int, default=1024)
    p.add_argument("--spool-dir", default=None,
                   help="BASE feedback spool dir; this replica spools into <base>/<replica-id> (the updater polls "
                        "the glob)")
    p.add_argument("--feedback-join-ttl", type=float, default=300.0)
    p.add_argument("--heartbeat-s", type=float, default=0.25,
                   help="fault-site heartbeat period (serve.replica_kill)")
    p.add_argument("--verbose", action="store_true")
    add_device_arg(p)
    return p


def replica_main(argv: Optional[Sequence[str]] = None) -> int:
    args = _replica_argparser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format=f"%(asctime)s {args.replica_id} %(levelname)s %(message)s")
    # Before ANY instrument exists: every serve metric this process emits
    # carries replica=<id>, so a merged fleet report stays attributable.
    registry().set_default_labels(replica=args.replica_id)

    from photon_tpu_torch.cli.common import resolve_device

    # A replica asked for cuda without a card exits non-zero here.
    device = str(resolve_device(args.device))
    snap = json.loads(args.ring)
    partition = partition_from_snapshot(args.replica_id, snap, args.route_re_type,
                                        compact_host=not args.no_compact_host)

    from photon_tpu_torch.serve.engine import ServeConfig, load_engine

    config = ServeConfig(max_batch_size=args.max_batch_size, max_delay_ms=args.max_delay_ms,
                         queue_cap=args.queue_cap, hot_bytes=args.hot_bytes, device=device)
    engine = load_engine(args.model_dir, args.artifacts_dir, config, partition=partition)

    if args.spool_dir:
        from photon_tpu_torch.stream.spool import FeedbackSpool, SpoolConfig

        spool_dir = os.path.join(args.spool_dir, args.replica_id)
        spool = FeedbackSpool(spool_dir, SpoolConfig(join_ttl_s=args.feedback_join_ttl))
        spool.start_auto_flush()
        engine.attach_feedback(spool)
        logger.info("fleet replica %s: spool at %s", args.replica_id, spool_dir)

    server = ReplicaScorerServer(engine, args.socket, args.replica_id, args.route_re_type,
                                 compact_host=not args.no_compact_host)
    server.ring_version = partition.ring.version
    server.start()

    stop = threading.Event()

    def _term(signum, frame):  # noqa: ARG001 — signal signature
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    # Machine-readable ready banner (the controller logs it; liveness is
    # established by the router's retry-connect, not by parsing this).
    print(json.dumps(dict(
        event="ready", replica=args.replica_id, pid=os.getpid(),
        # server.socket_path, not args.socket: a tcp://host:0 bind
        # advertises the resolved port.
        socket=server.socket_path, ringVersion=partition.ring.version, device=device,
        partition=engine.stats().get("partition"),
    )), flush=True)

    # Heartbeat: the serve.replica_kill fault site lives HERE, on the main
    # thread, so a plan rule (targeted per replica via the label) SIGKILLs
    # the whole process mid-traffic — the crash the failover drill needs.
    while not stop.is_set():
        faults.check("serve.replica_kill", label=args.replica_id)
        stop.wait(args.heartbeat_s)

    # SIGTERM drain: stop accepting, let in-flight batches finish.
    logger.info("fleet replica %s: draining", args.replica_id)
    server.close()
    engine.close(drain=True)
    logger.info("fleet replica %s: drained", args.replica_id)
    return 0


# ---------------------------------------------------------------------------
# Router side (the front-end process)
# ---------------------------------------------------------------------------


class FleetRouter:
    """Consistent-hash request routing over the replica set.

    Every request routes by its entity key's ring owner; a dead owner's
    traffic walks the ring's preference order to the first live member
    (which scores the foreign entities FE-only — degraded, never an
    error). Entity-less requests go to the least-loaded live member.
    A lost connection mid-flight retries the request on the next live
    candidate, so a SIGKILL'd replica costs zero caller errors.
    """

    UID_OWNER_CAP = 1 << 18  # uid → replica memory bound (feedback routing)

    def __init__(self, ring: HashRing, ledger: FleetAdmissionLedger, route_re_type: Optional[str] = None,
                 queue_cap: int = 1024, result_timeout_s: float = 120.0, router_id: Optional[str] = None,
                 secret: Optional[str] = None):
        self.ring = ring
        self.ledger = ledger
        self.route_re_type = route_re_type
        self.queue_cap = int(queue_cap)
        self.result_timeout_s = result_timeout_s
        # Stable per-router identity for the split-brain guard: every ring
        # push carries it, and a replica that already follows a DIFFERENT
        # router for this epoch rejects the push and says so.
        self.router_id = router_id or f"router-{os.getpid()}-{os.urandom(3).hex()}"
        self.secret = secret
        # Drill-scale burn windows: a sustained split-brain pages within
        # seconds (the same state machine the serve SLOs run).
        self.slo = SLOTracker(objectives=[Objective("fleet_split_brain", 0.999)], page_rules=DRILL_PAGE_RULES,
                              warn_rules=DRILL_WARN_RULES, min_events=1)
        self._lock = threading.RLock()
        self._clients: Dict[str, ScorerClient] = {}
        self._state: Dict[str, str] = {}
        self._uid_owner: "OrderedDict[str, str]" = OrderedDict()

    # -- membership ---------------------------------------------------------

    def attach(self, replica_id: str, socket_path: str, connect_timeout_s: float = 180.0) -> ScorerClient:
        """Connect (retrying while the replica warms) and mark live."""
        client = ScorerClient(socket_path, connect_timeout_s, secret=self.secret)
        with self._lock:
            old = self._clients.get(replica_id)
            self._clients[replica_id] = client
            self._state[replica_id] = LIVE
        if old is not None:
            old.close()
        return client

    def mark(self, replica_id: str, state: str) -> None:
        with self._lock:
            self._state[replica_id] = state

    def detach(self, replica_id: str) -> None:
        with self._lock:
            client = self._clients.pop(replica_id, None)
            self._state.pop(replica_id, None)
        if client is not None:
            client.close()

    def client(self, replica_id: str) -> Optional[ScorerClient]:
        with self._lock:
            return self._clients.get(replica_id)

    def states(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._state)

    def live_members(self) -> List[str]:
        with self._lock:
            return [m for m in self.ring.members if self._state.get(m) == LIVE and m in self._clients]

    def _on_conn_lost(self, replica_id: str) -> None:
        with self._lock:
            if self._state.get(replica_id) == LIVE:
                self._state[replica_id] = DEAD
                logger.warning("fleet: replica %s connection lost; marked dead (shard fails over FE-only)",
                               replica_id)

    # -- scoring ------------------------------------------------------------

    def _candidates(self, key: Optional[str]) -> List[str]:
        if key is not None:
            pref = self.ring.preference(key)
            with self._lock:
                return [m for m in pref if self._state.get(m) == LIVE and m in self._clients]
        live = self.live_members()
        # Entity-less requests are FE-only everywhere: least-loaded wins.
        return sorted(live, key=lambda m: self.ledger.inflight(m))

    def submit(self, raw_request: dict, tenant: Optional[str], priority: str = INTERACTIVE,
               model_version: Optional[str] = None, trace: Optional[dict] = None) -> Future:
        # Fleet-global admission: ONE ledger charge per request, before any
        # replica sees it — identical shed semantics at any fleet size.
        self.ledger.admit(tenant, priority, queue_depth=self.ledger.inflight(), queue_cap=self.queue_cap)
        entity_ids = raw_request.get("entityIds") if isinstance(raw_request, dict) else None
        key = route_key(entity_ids, self.route_re_type)
        cands = self._candidates(key)
        if not cands:
            raise BackpressureError("no live scorer replicas")
        dst: Future = Future()
        self._try(raw_request, tenant, priority, model_version, trace, cands, dst)
        return dst

    def _try(self, raw_request, tenant, priority, model_version, trace, cands: List[str], dst: Future) -> None:
        replica_id, rest = cands[0], cands[1:]
        client = self.client(replica_id)
        if client is None:
            self._advance(raw_request, tenant, priority, model_version, trace, replica_id, rest, dst,
                          ConnectionError(f"replica {replica_id} not attached"))
            return
        registry().counter("fleet_requests_total", replica=replica_id).inc()
        self.ledger.begin(replica_id)
        t0 = time.monotonic()
        try:
            src = client.submit_score(raw_request, tenant, priority, model_version, trace=trace)
        except ConnectionError as exc:
            self.ledger.end(replica_id)
            registry().counter("fleet_rpc_errors_total", replica=replica_id).inc()
            self._on_conn_lost(replica_id)
            self._advance(raw_request, tenant, priority, model_version, trace, replica_id, rest, dst, exc)
            return

        def _done(f: Future) -> None:
            self.ledger.end(replica_id)
            registry().histogram("fleet_rpc_latency_s", replica=replica_id, op="score").observe(
                time.monotonic() - t0)
            exc = f.exception()
            if isinstance(exc, ConnectionError):
                registry().counter("fleet_rpc_errors_total", replica=replica_id).inc()
                # The replica died with this request in flight. Scoring is
                # read-only → safe to replay on the next live candidate.
                self._on_conn_lost(replica_id)
                self._advance(raw_request, tenant, priority, model_version, trace, replica_id, rest, dst, exc)
            elif exc is not None:
                dst.set_exception(exc)
            else:
                res = dict(f.result() or {})
                res["replica"] = replica_id
                uid = raw_request.get("uid") if isinstance(raw_request, dict) else None
                if uid is not None:
                    self._record_uid(str(uid), replica_id)
                dst.set_result(res)

        src.add_done_callback(_done)

    def _advance(self, raw_request, tenant, priority, model_version, trace, failed_id: str, rest: List[str],
                 dst: Future, exc: BaseException) -> None:
        registry().counter("fleet_failover_total", replica=failed_id).inc()
        with self._lock:
            nxt = [m for m in rest if self._state.get(m) == LIVE and m in self._clients]
        if nxt:
            self._try(raw_request, tenant, priority, model_version, trace, nxt, dst)
        else:
            dst.set_exception(exc)

    def _record_uid(self, uid: str, replica_id: str) -> None:
        with self._lock:
            self._uid_owner[uid] = replica_id
            self._uid_owner.move_to_end(uid)
            while len(self._uid_owner) > self.UID_OWNER_CAP:
                self._uid_owner.popitem(last=False)

    def uid_owner(self, uid: str) -> Optional[str]:
        with self._lock:
            return self._uid_owner.get(uid)

    # -- control plane ------------------------------------------------------

    def rpc_call(self, replica_id: str, op: str, timeout_s: float = 30.0, **payload):
        """One timed control-plane RPC to a member: every call lands in the
        per-peer ``fleet_rpc_latency_s{replica,op}`` histogram, every
        failure in ``fleet_rpc_errors_total{replica}`` — the two signals a
        cross-host deployment alerts on. Raises on failure (callers decide
        whether a member failing the op is fatal)."""
        client = self.client(replica_id)
        if client is None:
            raise ConnectionError(f"replica {replica_id} not attached")
        t0 = time.monotonic()
        try:
            res = client.call(op, timeout_s=timeout_s, **payload)
        except Exception:
            registry().counter("fleet_rpc_errors_total", replica=replica_id).inc()
            raise
        finally:
            registry().histogram("fleet_rpc_latency_s", replica=replica_id, op=op).observe(time.monotonic() - t0)
        return res

    def broadcast_ring(self, timeout_s: float = 120.0) -> Dict[str, dict]:
        """Push the current ring snapshot to every live replica (each
        rebuilds its partition predicate in place). Returns per-replica
        results; a member failing the push is marked dead. Each reply
        feeds the ``fleet_split_brain`` SLO objective: a replica that
        rejects this router's claim because ANOTHER router owns the epoch
        is a bad event, and a sustained burn of those pages."""
        snap = self.ring.snapshot()
        out: Dict[str, dict] = {}
        for replica_id in self.live_members():
            try:
                res = self.rpc_call(replica_id, "ring", timeout_s=timeout_s, snapshot=snap,
                                    routeReType=self.route_re_type, routerId=self.router_id)
            except Exception as exc:  # noqa: BLE001 — per-member failure
                logger.warning("fleet: ring push to %s failed: %s", replica_id, exc)
                self._on_conn_lost(replica_id)
                out[replica_id] = dict(error=str(exc))
                continue
            split = bool((res or {}).get("splitBrain"))
            self.slo.record_event("fleet_split_brain", good=not split)
            if split:
                logger.error("fleet: replica %s rejected ring v%d — epoch claimed by router %s (split brain)",
                             replica_id, snap.get("version"), (res or {}).get("claimant"))
            out[replica_id] = res
        return out

    def replica_stats(self, timeout_s: float = 30.0) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for replica_id in self.live_members():
            try:
                out[replica_id] = self.rpc_call(replica_id, "stats", timeout_s=timeout_s)
            except Exception as exc:  # noqa: BLE001 — per-member failure
                out[replica_id] = dict(error=str(exc))
        try:
            self.ledger.update_quality(tenant_quality(
                res.get("quality") for res in out.values() if isinstance(res, dict)))
        except Exception:  # noqa: BLE001 — stats must never fail on obs
            pass
        return out

    def replica_metrics(self, timeout_s: float = 30.0) -> Dict[str, dict]:
        """Per-replica metrics scrape: ``{replica: {"ok": True, "metrics":
        [snapshot records]}}`` for members that answered, ``{"ok": False,
        "error": str}`` for members that died mid-scrape. A partial fleet
        scrape stays LABELED as partial — the merged ``/metrics`` render
        marks the missing member instead of silently presenting a smaller
        fleet as the whole one."""
        out: Dict[str, dict] = {}
        for replica_id in self.live_members():
            try:
                out[replica_id] = dict(ok=True, metrics=self.rpc_call(replica_id, "metrics",
                                                                      timeout_s=timeout_s) or [])
            except Exception as exc:  # noqa: BLE001 — per-member failure
                out[replica_id] = dict(ok=False, error=str(exc))
        return out

    def replica_traces(self, limit: Optional[int] = None, timeout_s: float = 30.0) -> List[dict]:
        """Every live member's kept flight-recorder trees (concatenated;
        callers merge by trace id). A member failing the scrape contributes
        nothing — trace dumps are diagnostics, not bookkeeping."""
        entries: List[dict] = []
        for replica_id in self.live_members():
            try:
                entries.extend(self.rpc_call(replica_id, "traces", timeout_s=timeout_s, limit=limit) or [])
            except Exception:  # noqa: BLE001 — per-member failure
                pass
        return entries

    def fleet_snapshot(self) -> dict:
        """The ``/healthz`` ``fleet`` block: ring version, per-replica
        shard ranges, member states, the global admission ledger, and this
        router's identity + split-brain SLO state."""
        try:
            self.slo.publish_metrics()
        except Exception:  # noqa: BLE001 — stats must never fail on obs
            pass
        return dict(
            ringVersion=self.ring.version,
            routerId=self.router_id,
            members=self.ring.members,
            states=self.states(),
            routeReType=self.route_re_type,
            shardRanges=self.ring.shard_ranges(),
            admission=self.ledger.fleet_snapshot(),
            slo=self.slo.snapshot(),
        )


class FleetBackend:
    """The ``make_http_handler`` backend for the fleet front end: submits
    route through the ring, ``/healthz`` carries the fleet snapshot,
    reloads broadcast, and feedback follows each uid back to the replica
    that scored it (so the label joins in the RIGHT per-replica spool)."""

    def __init__(self, router: FleetRouter, result_timeout_s: float = 120.0):
        self.router = router
        self.result_timeout_s = result_timeout_s

    def submit(self, raw_request: dict, tenant: Optional[str], priority: str, model_version: Optional[str] = None,
               trace: Optional[dict] = None) -> Future:
        return self.router.submit(raw_request, tenant, priority, model_version, trace=trace)

    def stats(self) -> dict:
        from photon_tpu_torch.obs.export import exporter_health

        return dict(
            fleet=self.router.fleet_snapshot(),
            replicas=self.router.replica_stats(),
            # Frontend-process exporter health: a dead collector must be
            # visible in /healthz without ever gating readiness.
            otlp_exporter=exporter_health(),
        )

    def metrics_snapshots(self) -> List[dict]:
        """Fleet-merged snapshot records: this process's instruments
        (``replica="frontend"``) plus every replica's (their own labels).
        A replica that failed the scrape shows up as
        ``fleet_scrape_failed{replica=...} 1`` — visible, not missing."""
        snaps = [_stamp_labels(s, replica="frontend") for s in registry().snapshot()]
        for replica_id, res in self.router.replica_metrics().items():
            if res.get("ok"):
                snaps.extend(_stamp_labels(s, replica=replica_id) for s in res.get("metrics") or [])
            else:
                snaps.append(dict(record="metric", metric="fleet_scrape_failed", type="gauge",
                                  labels={"replica": str(replica_id)}, value=1, stats=None))
        return snaps

    def metrics_text(self) -> str:
        return render_prometheus(self.metrics_snapshots())

    def traces(self, limit: Optional[int] = None) -> List[dict]:
        """One merged entry per trace id across the frontend process and
        every replica — a routed request's http/replica hops reassemble
        here."""
        entries = list(flight_recorder().traces(limit=limit))
        entries.extend(self.router.replica_traces(limit=limit))
        return merge_trace_dumps(entries)

    def reload(self, body: dict) -> dict:
        out: Dict[str, dict] = {}
        for replica_id in self.router.live_members():
            client = self.router.client(replica_id)
            if client is None:
                continue
            out[replica_id] = client.call("reload", timeout_s=600.0, modelDir=body.get("modelDir"),
                                          modelVersion=body.get("modelVersion"))
        return out

    def feedback(self, body: dict) -> dict:
        if not isinstance(body, dict):
            raise ValueError("feedback body must be a JSON object")
        items = body.get("labels")
        if items is None:
            items = [body]
        if not isinstance(items, list):
            raise ValueError("'labels' must be a list of {uid, label} objects")
        # Group by the replica that scored each uid; unknown uids (aged out
        # of the router's map, or scored before a restart) broadcast.
        grouped: Dict[Optional[str], List[dict]] = {}
        for item in items:
            uid = item.get("uid") if isinstance(item, dict) else None
            owner = self.router.uid_owner(str(uid)) if uid is not None else None
            grouped.setdefault(owner, []).append(item)
        joined = 0
        dropped = 0
        for owner, chunk in grouped.items():
            live = self.router.live_members()
            targets = [owner] if owner in live else live
            chunk_joined = 0
            for replica_id in targets:
                client = self.router.client(replica_id)
                if client is None:
                    continue
                try:
                    res = client.call("feedback", timeout_s=30.0, body={"labels": chunk})
                except Exception as exc:  # noqa: BLE001 — per-member failure
                    logger.warning("fleet: feedback to %s failed: %s", replica_id, exc)
                    continue
                chunk_joined += int(res.get("joined", 0))
                if chunk_joined >= len(chunk):
                    break  # broadcast resolved every uid already
            joined += chunk_joined
            dropped += max(0, len(chunk) - chunk_joined)
        return {"joined": joined, "dropped": dropped}


class FleetHTTPFrontend:
    """ThreadingHTTPServer speaking the standard serving API over a
    :class:`FleetBackend`, on a background thread. ``port`` is resolved
    after ``start`` (pass 0 to let the OS pick)."""

    def __init__(self, backend: FleetBackend, host: str = "127.0.0.1", port: int = 0):
        self.backend = backend
        self._httpd = ThreadingHTTPServer((host, port), make_http_handler(backend))
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "FleetHTTPFrontend":
        self._thread = threading.Thread(target=self._httpd.serve_forever, kwargs=dict(poll_interval=0.1),
                                        name="fleet-http", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        # shutdown() blocks forever unless serve_forever is running; a
        # frontend that was never start()ed still needs its socket closed.
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)


# ---------------------------------------------------------------------------
# Fleet controller (spawn / join / drain / kill / revive)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    """Reserve a loopback TCP port (bind-0, read, release). The replica
    re-binds it with SO_REUSEADDR moments later; the window is the same one
    every ephemeral-port test harness accepts."""
    s = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_STREAM)
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


class ScorerFleet:
    """Owns the replica subprocesses and the elastic-membership protocol.

    Lifecycle verbs: ``start`` (spawn + connect the initial set), ``join``
    (spawn with the post-join ring, wait ready, THEN flip routing — the
    warming replica never sees traffic early), ``leave`` (drain in-flight
    via the settle discipline, drop from the ring, broadcast, SIGTERM),
    ``kill`` (SIGKILL, ring UNCHANGED — the shard fails over FE-only along
    the preference order), ``revive`` (respawn the same id, reconnect,
    traffic re-homes to exact scores), ``shutdown``.

    Each replica runs its engine on ``device`` ("cuda" unless the caller
    asks for the CPU); replicas of one host share its card, each with a
    CUDA context of its own. ``start``, ``join`` and ``revive`` raise
    (with the end of the replica's log) when a replica exits before it is
    connectable or is not connectable within ``connect_timeout_s``.
    """

    def __init__(
        self,
        model_dir: str,
        workdir: str,
        artifacts_dir: Optional[str] = None,
        route_re_type: Optional[str] = None,
        vnodes: int = 64,
        seed: int = 0,
        hot_bytes: int = 64 << 20,
        max_batch_size: int = 64,
        max_delay_ms: float = 2.0,
        queue_cap: int = 1024,
        admission: Optional[AdmissionConfig] = None,
        spool_base: Optional[str] = None,
        compact_host: bool = True,
        result_timeout_s: float = 120.0,
        connect_timeout_s: float = 300.0,
        heartbeat_s: float = 0.25,
        replica_env: Optional[Dict[str, Dict[str, str]]] = None,
        transport: str = "unix",
        secret: Optional[str] = None,
        weights: Optional[Dict[str, int]] = None,
        device: str = "cuda",
    ):
        if transport not in ("unix", "tcp"):
            raise ValueError(f"transport must be unix|tcp, got {transport!r}")
        self.model_dir = model_dir
        self.artifacts_dir = artifacts_dir
        self.workdir = workdir
        self.route_re_type = route_re_type
        self.hot_bytes = int(hot_bytes)
        self.max_batch_size = int(max_batch_size)
        self.max_delay_ms = float(max_delay_ms)
        self.queue_cap = int(queue_cap)
        self.spool_base = spool_base
        self.compact_host = compact_host
        self.connect_timeout_s = connect_timeout_s
        self.heartbeat_s = float(heartbeat_s)
        self.transport = transport
        self.device = device
        # TCP needs the shared handshake secret on both ends; generate one
        # for loopback fleets when the environment doesn't provide it.
        if transport == "tcp" and not secret:
            secret = os.environ.get(FLEET_SECRET_ENV) or os.urandom(16).hex()
        self.secret = secret
        self._endpoints: Dict[str, str] = {}
        # Per-replica extra environment — how a drill targets ONE replica
        # with a PHOTON_TPU_FAULT_PLAN kill rule.
        self.replica_env = dict(replica_env or {})
        os.makedirs(workdir, exist_ok=True)
        self.ring = HashRing(vnodes=vnodes, seed=seed, weights=weights)
        self.ledger = FleetAdmissionLedger(admission)
        self.router = FleetRouter(self.ring, self.ledger, route_re_type, queue_cap=queue_cap,
                                  result_timeout_s=result_timeout_s,
                                  secret=self.secret if transport == "tcp" else None)
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs: Dict[str, object] = {}
        self._spawned_at: Dict[str, float] = {}  # monotonic time of each replica's latest spawn
        self._ready_s: Dict[str, float] = {}  # its spawn-to-connectable seconds

    # -- plumbing -----------------------------------------------------------

    def socket_path(self, replica_id: str) -> str:
        """The replica's framed-IPC endpoint: a workdir Unix socket path,
        or (``transport="tcp"``) a loopback ``tcp://`` endpoint with a port
        reserved at first use — the SAME frame protocol either way."""
        if self.transport == "tcp":
            ep = self._endpoints.get(replica_id)
            if ep is None:
                ep = f"tcp://127.0.0.1:{_free_port()}"
                self._endpoints[replica_id] = ep
            return ep
        return os.path.join(self.workdir, f"scorer-{replica_id}.sock")

    def log_path(self, replica_id: str) -> str:
        return os.path.join(self.workdir, f"scorer-{replica_id}.log")

    def log_tail(self, replica_id: str) -> str:
        """The last LOG_TAIL_LINES lines of a replica's log (every start
        appends to it)."""
        try:
            with open(self.log_path(replica_id), "rb") as f:
                text = f.read().decode("utf-8", "replace")
        except OSError:
            return ""
        return "\n".join(text.splitlines()[-LOG_TAIL_LINES:])

    def _spawn(self, replica_id: str, ring_snapshot: dict) -> subprocess.Popen:
        cmd = [
            sys.executable, "-m", "photon_tpu_torch.serve.fleet",
            "--socket", self.socket_path(replica_id),
            "--replica-id", replica_id,
            "--model-dir", self.model_dir,
            "--ring", json.dumps(ring_snapshot),
            "--hot-bytes", str(self.hot_bytes),
            "--max-batch-size", str(self.max_batch_size),
            "--max-delay-ms", str(self.max_delay_ms),
            "--queue-cap", str(self.queue_cap),
            "--heartbeat-s", str(self.heartbeat_s),
            "--device", self.device,
        ]
        if self.artifacts_dir:
            cmd += ["--artifacts-dir", self.artifacts_dir]
        if self.route_re_type:
            cmd += ["--route-re-type", self.route_re_type]
        if self.spool_base:
            cmd += ["--spool-dir", self.spool_base]
        if not self.compact_host:
            cmd += ["--no-compact-host"]
        env = dict(os.environ)
        if self.transport == "tcp" and self.secret:
            env[FLEET_SECRET_ENV] = self.secret
        # The replica must import photon_tpu_torch no matter the caller's
        # cwd: put the package's parent dir on its path explicitly.
        import photon_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(photon_tpu_torch.__file__)))
        parts = [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
        env.update(self.replica_env.get(replica_id, {}))
        log = open(self.log_path(replica_id), "ab")
        old_log = self._logs.pop(replica_id, None)
        if old_log is not None:
            try:
                old_log.close()
            except OSError:
                pass
        self._logs[replica_id] = log
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env)
        self._procs[replica_id] = proc
        self._spawned_at[replica_id] = time.monotonic()
        logger.info("fleet: spawned replica %s (pid %d) on %s", replica_id, proc.pid, self.device)
        return proc

    def _attach(self, replica_ids: Sequence[str]) -> None:
        """Connect the router to spawned replicas, polling each in turn while
        they warm (so each one's spawn-to-ready seconds, ``readyS`` of
        :meth:`fleet_snapshot`, are its own). No fallback: a replica that
        exits first, or is not connectable within ``connect_timeout_s``,
        raises with the end of its log."""
        pending = list(replica_ids)
        deadline = time.monotonic() + self.connect_timeout_s
        while pending:
            for replica_id in list(pending):
                code = self._procs[replica_id].poll()
                if code is not None:
                    raise RuntimeError(f"fleet replica {replica_id} exited with code {code} before it was ready; "
                                       f"the end of {self.log_path(replica_id)}:\n{self.log_tail(replica_id)}")
                try:
                    self.router.attach(replica_id, self.socket_path(replica_id), connect_timeout_s=0.0)
                except ConnectionError as exc:
                    if time.monotonic() >= deadline:
                        raise RuntimeError(f"fleet replica {replica_id} not reachable after "
                                           f"{self.connect_timeout_s:.0f}s ({exc}); the end of "
                                           f"{self.log_path(replica_id)}:\n{self.log_tail(replica_id)}") from exc
                    continue
                self._ready_s[replica_id] = time.monotonic() - self._spawned_at[replica_id]
                pending.remove(replica_id)
            if pending:
                time.sleep(0.05)

    # -- lifecycle ----------------------------------------------------------

    def start(self, replica_ids: Sequence[str]) -> "ScorerFleet":
        for replica_id in replica_ids:
            self.ring.add(replica_id)
        snap = self.ring.snapshot()
        for replica_id in replica_ids:
            self._spawn(replica_id, snap)
        self._attach(replica_ids)
        return self

    def join(self, replica_id: str, warm: bool = True, weight: Optional[int] = None) -> Optional[dict]:
        """Elastic join: the newcomer warms with the POST-join ring (its
        partition is right from birth), traffic flips only once it is
        connectable, then the incumbents re-partition.

        ``warm=True`` additionally streams each incumbent's HOT rows for
        the keys the new ring reassigns to the newcomer — BEFORE the ring
        flips — so the newcomer's first requests hit a warm cache instead
        of paying a cold-start miss storm (the join-side degradation
        window). ``warm=False`` is the measured-for-contrast cold path.
        Returns the warm handoff's rows, promotions and seconds (None when
        cold)."""
        future_ring = HashRing.from_snapshot(self.ring.snapshot())
        future_ring.add(replica_id, weight=weight)
        future_snap = future_ring.snapshot()
        self._spawn(replica_id, future_snap)
        self._attach([replica_id])
        moved = self._warm_handoff_to(replica_id, future_snap, include_cold=False) if warm else None
        self.ring.add(replica_id, weight=weight)  # newcomer already holds it
        self.router.broadcast_ring()
        logger.info("fleet: %s joined (ring v%d)", replica_id, self.ring.version)
        return moved

    def _handoff(self, source: str, target: str, snapshot: dict, include_cold: bool, moved: dict) -> None:
        """One warm-handoff leg: ``source``'s export of what moves to
        ``target`` under ``snapshot``, installed on ``target``; the rows and
        promotions it installed are added to ``moved``."""
        payload = self.router.rpc_call(source, "shard_export", timeout_s=120.0, snapshot=snapshot,
                                       targetMember=target, includeCold=include_cold)
        if not (payload or {}).get("groups"):
            return
        res = self.router.rpc_call(target, "shard_import", timeout_s=120.0, payload=payload)
        for stats in (res or {}).values():
            moved["rows"] += int(stats.get("rowsAdded", 0))
            moved["promoted"] += int(stats.get("promoted", 0))

    def _warm_handoff_to(self, newcomer: str, future_snap: dict, include_cold: bool) -> dict:
        """Stream every incumbent's handoff payload for ``newcomer`` (its
        owned entities moving there under ``future_snap``). Best-effort: a
        member failing its export degrades THAT slice to the cold path —
        membership changes must never hinge on a warm-up RPC. Returns the
        rows, promotions and seconds of the handoff."""
        t0 = time.monotonic()
        moved = dict(rows=0, promoted=0)
        for member in self.router.live_members():
            if member == newcomer:
                continue
            try:
                self._handoff(member, newcomer, future_snap, include_cold, moved)
            except Exception as exc:  # noqa: BLE001 — best-effort warm-up
                logger.warning("fleet: warm handoff %s->%s failed (cold for that slice): %s", member, newcomer,
                               exc)
        moved["seconds"] = time.monotonic() - t0
        logger.info("fleet: warm handoff to %s: %d rows, %d pre-promoted (%.2fs)", newcomer, moved["rows"],
                    moved["promoted"], moved["seconds"])
        return moved

    def leave(self, replica_id: str, settle_s: float = 30.0, warm: bool = True) -> Optional[dict]:
        """Graceful leave, same settle discipline as the rollout watcher:
        stop routing new work to the member, wait for its in-flight count
        to drain (bounded by ``settle_s``), re-partition the survivors,
        then SIGTERM (the replica's own drain finishes anything left).

        ``warm=True`` first streams the leaver's shard to its new owners,
        grouped per survivor under the post-leave ring — host rows AND the
        hot set. Without it, compacted survivors have no host rows for the
        inherited keys and serve them FE-only until a reload (the drain
        degradation window this kills). Returns the drain handoff's rows,
        promotions and seconds (None when cold)."""
        future_ring = HashRing.from_snapshot(self.ring.snapshot())
        if replica_id in future_ring:
            future_ring.remove(replica_id)
        future_snap = future_ring.snapshot()
        moved = None
        if warm and replica_id in self.ring:
            t0 = time.monotonic()
            moved = dict(rows=0, promoted=0)
            for survivor in self.router.live_members():
                if survivor == replica_id:
                    continue
                try:
                    self._handoff(replica_id, survivor, future_snap, True, moved)
                except Exception as exc:  # noqa: BLE001 — best-effort
                    logger.warning("fleet: warm handoff %s->%s failed (FE-only for that slice until reload): %s",
                                   replica_id, survivor, exc)
            moved["seconds"] = time.monotonic() - t0
            logger.info("fleet: drain handoff from %s: %d rows, %d pre-promoted (%.2fs)", replica_id,
                        moved["rows"], moved["promoted"], moved["seconds"])
        self.router.mark(replica_id, DRAINING)
        deadline = time.monotonic() + settle_s
        while self.ledger.inflight(replica_id) > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        if replica_id in self.ring:
            self.ring.remove(replica_id)
        self.router.broadcast_ring()
        self.router.detach(replica_id)
        proc = self._procs.pop(replica_id, None)
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        logger.info("fleet: %s left (ring v%d)", replica_id, self.ring.version)
        return moved

    def kill(self, replica_id: str) -> None:
        """SIGKILL a replica, ring unchanged — the crash drill. Its shard
        fails over FE-only to ring successors until ``revive``."""
        proc = self._procs.pop(replica_id, None)
        if proc is not None:
            proc.kill()
            proc.wait()
        self.router.mark(replica_id, DEAD)
        logger.info("fleet: %s SIGKILLed (shard failing over FE-only)", replica_id)

    def revive(self, replica_id: str) -> None:
        """Bring a dead member back under the same id: respawn with the
        CURRENT ring, reconnect, mark live — its keys re-home from
        FE-only fallback to exact scores with zero ring movement."""
        self._spawn(replica_id, self.ring.snapshot())
        self._attach([replica_id])
        logger.info("fleet: %s revived", replica_id)

    def reap(self) -> Dict[str, int]:
        """Collect exit codes of replicas that died on their own (the
        fault-plan kill path); marks them dead for the router."""
        out: Dict[str, int] = {}
        for replica_id, proc in list(self._procs.items()):
            code = proc.poll()
            if code is not None:
                out[replica_id] = code
                self._procs.pop(replica_id, None)
                self.router.mark(replica_id, DEAD)
        return out

    def fleet_snapshot(self) -> dict:
        snap = self.router.fleet_snapshot()
        snap["pids"] = {rid: proc.pid for rid, proc in self._procs.items()}
        snap["readyS"] = dict(self._ready_s)
        return snap

    def shutdown(self, timeout_s: float = 30.0) -> None:
        for replica_id in list(self.router.states()):
            self.router.detach(replica_id)
        for proc in list(self._procs.values()):
            proc.terminate()
        deadline = time.monotonic() + timeout_s
        for proc in list(self._procs.values()):
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._procs.clear()
        for log in self._logs.values():
            try:
                log.close()
            except OSError:
                pass
        self._logs.clear()


if __name__ == "__main__":
    sys.exit(replica_main())
