"""Copy of photon_tpu/stream/spool.py (host code; the port does not import it).

Serve-side feedback spool: scored requests joined with observed labels.

The write half of the streaming freshness loop. The serving engine lands
every (sampled) scored request here; when the caller later reports the
observed label for that request's ``uid``, the joined record is appended to
the active spool segment. Segments are JSONL, size/age-rotated, and sealed
with the replay-spool discipline from ``io/pipeline.py``: appends are
flushed line-by-line, sealing is flush + fsync + atomic rename from
``segment-N.part`` to ``segment-N.jsonl``. Consumers (the streaming
updater) read only sealed ``.jsonl`` segments, so a torn in-progress write
can never reach training; a crashed writer's orphaned ``.part`` is
recovered at exact record parity for every fully written line — the torn
tail (at most one record) is dropped and counted.

Failure containment mirrors the degradation policy of
``utils/resources``: label ingestion must never break serving. A full disk
(ENOSPC, via :class:`~photon_tpu_torch.utils.resources.DiskBudgetGuard`) or any
other write failure drops the record with a counter, not an exception.

Fault site ``serve.feedback`` (fired per observed label):

- ``transient`` / ``permanent`` — the label join is dropped and counted,
  the caller sees a clean False;
- ``torn`` — the active segment is abandoned mid-record (half a line, no
  newline), simulating a writer crash: recovery must seal the complete
  prefix and drop exactly the torn tail;
- ``enospc`` — the append path behaves as if the disk filled;
- ``kill`` — SIGKILL, the full crash simulation.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from photon_tpu_torch.utils import faults
from photon_tpu_torch.utils.resources import DiskBudgetGuard

logger = logging.getLogger(__name__)

SEGMENT_PREFIX = "segment-"
SEALED_SUFFIX = ".jsonl"
PART_SUFFIX = ".part"
WRITER_LOCK = "writer.lock"
# Sidecar reclaiming TTL-evicted joins: `evicted` lines carry the scored
# features, `late_label` lines the label that missed the window. Never
# listed as a segment (no SEGMENT_PREFIX) — the updater ignores it; a
# future backfill pass re-joins the pairs and publishes a corrective delta.
LATE_LABELS_FILE = "late-labels.jsonl"


@dataclasses.dataclass
class SpoolConfig:
    """Knobs for the spool's rotation, sampling, and join window."""

    # Rotation: seal the active segment after this many records or this age,
    # whichever first. Both bound label→consumable latency, which feeds
    # straight into model staleness.
    segment_max_records: int = 256
    segment_max_age_s: float = 5.0
    # Fraction of scored requests retained for the join (fractional
    # accumulator, deterministic). ``tenant_fractions`` overrides per tenant.
    sample_fraction: float = 1.0
    tenant_fractions: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Pending-join buffer: scored requests wait here for their label. A
    # label that arrives after eviction is an unmatched drop, counted.
    join_capacity: int = 65536
    join_ttl_s: float = 300.0


def segment_seq(name: str) -> int:
    """Sequence number of a segment file name (sealed or part)."""
    stem = os.path.basename(name)
    for suffix in (SEALED_SUFFIX, PART_SUFFIX):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
            break
    return int(stem[len(SEGMENT_PREFIX):])


def _sealed_name(seq: int) -> str:
    return f"{SEGMENT_PREFIX}{seq:08d}{SEALED_SUFFIX}"


def _part_name(seq: int) -> str:
    return f"{SEGMENT_PREFIX}{seq:08d}{PART_SUFFIX}"


def sealed_segments(directory: str) -> List[str]:
    """Sorted sealed segment file names (consumable set)."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        fn for fn in os.listdir(directory)
        if fn.startswith(SEGMENT_PREFIX) and fn.endswith(SEALED_SUFFIX)
    )


def read_segment(path: str) -> List[dict]:
    """Parse one sealed segment. Sealed segments are fully valid by
    construction; a bad line (bit-rot) is skipped and counted rather than
    poisoning the whole cycle."""
    from photon_tpu_torch.obs.metrics import registry

    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                registry().counter("feedback_spool_bad_lines_total").inc()
                logger.warning("unparseable spool line in %s", path)
    return out


def recover_segments(directory: str) -> Dict[str, int]:
    """Seal every orphaned ``.part`` in ``directory`` at exact record
    parity: the complete newline-terminated JSON prefix is rewritten
    (tmp + fsync + rename) as a sealed segment; the torn tail — at most one
    partially written record — is dropped and counted. An all-torn part is
    unlinked. Returns ``{sealed_name: record_count}``.

    Callers must hold (or have verified the absence of) the writer lock:
    the live writer recovers its own predecessor's parts at open; the
    consumer only recovers when it can take the lock itself."""
    from photon_tpu_torch.obs.metrics import registry

    out: Dict[str, int] = {}
    if not os.path.isdir(directory):
        return out
    for fn in sorted(os.listdir(directory)):
        if not (fn.startswith(SEGMENT_PREFIX) and fn.endswith(PART_SUFFIX)):
            continue
        path = os.path.join(directory, fn)
        good: List[str] = []
        torn = False
        with open(path, "rb") as f:
            for raw in f:
                if not raw.endswith(b"\n"):
                    torn = True  # crash mid-append: drop the tail record
                    break
                try:
                    json.loads(raw)
                except ValueError:
                    torn = True
                    break
                good.append(raw.decode())
        if not good:
            os.unlink(path)
            if torn:
                registry().counter("feedback_spool_torn_recovered_total").inc()
            continue
        sealed = os.path.join(directory, _sealed_name(segment_seq(fn)))
        tmp = sealed + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(good)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, sealed)
        os.unlink(path)
        if torn:
            registry().counter("feedback_spool_torn_recovered_total").inc()
        out[os.path.basename(sealed)] = len(good)
        logger.info(
            "recovered orphaned spool part %s -> %s (%d records%s)",
            fn, os.path.basename(sealed), len(good),
            ", torn tail dropped" if torn else "",
        )
    return out


class FeedbackSpool:
    """Single-writer feedback spool over one directory.

    Thread-safe: the serving engine's batcher thread calls
    :meth:`observe_scored`, frontend worker threads call
    :meth:`observe_label`, and the auto-flush thread seals on age."""

    def __init__(self, directory: str, config: Optional[SpoolConfig] = None):
        self.directory = directory
        self.config = config or SpoolConfig()
        os.makedirs(directory, exist_ok=True)
        self._guard = DiskBudgetGuard("feedback.spool")
        self._lock = threading.Lock()
        # Writer exclusivity: one spool directory, one live writer. The lock
        # file is held for the spool's lifetime; a consumer that can take it
        # knows no writer is alive and may recover orphaned parts itself.
        self._lockf = open(os.path.join(directory, WRITER_LOCK), "a")
        try:
            import fcntl

            fcntl.flock(self._lockf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:  # non-POSIX: best-effort, single-writer only
            pass
        except OSError:
            self._lockf.close()
            raise RuntimeError(
                f"feedback spool {directory!r} already has a live writer"
            )
        recover_segments(directory)
        seqs = [segment_seq(fn) for fn in os.listdir(directory)
                if fn.startswith(SEGMENT_PREFIX)
                and (fn.endswith(SEALED_SUFFIX) or fn.endswith(PART_SUFFIX))]
        self._seq = max(seqs, default=0) + 1
        self._part = None  # open file object for the active segment
        self._part_records = 0
        self._part_opened_at = 0.0
        # uid -> (enqueue time, scored record) awaiting its label, FIFO.
        self._pending: "dict" = {}
        # uids evicted past the join TTL: a label arriving for one of these
        # is LATE (a measured backfill candidate), not never-seen. Bounded
        # FIFO so the memory cost mirrors the pending buffer's.
        self._expired: "OrderedDict[str, float]" = OrderedDict()
        self._late_logged_seq = -1  # once-per-segment late-label log guard
        self._late_f = None  # late-labels.jsonl sidecar, opened on first use
        self._acc: Dict[str, float] = {}  # per-tenant sampling accumulator
        # Optional join subscriber: called with each successfully appended
        # joined record (score + label + provenance), OUTSIDE the spool
        # lock — the serving engine points the model-quality plane here.
        # Containment matches everything else on this path: a subscriber
        # failure is counted, never raised to the label caller.
        self.on_join = None
        self._flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False

    # -- write half -------------------------------------------------------

    def observe_scored(
        self,
        uid: Optional[str],
        features=None,
        entity_ids: Optional[dict] = None,
        offset: float = 0.0,
        score: float = 0.0,
        model_version: Optional[str] = None,
        tenant: Optional[str] = None,
        ts: Optional[float] = None,
        trace: Optional[dict] = None,
    ) -> bool:
        """Buffer one scored request for its label. Returns True when the
        request was retained (sampled in and buffered). ``trace`` is the
        request's cross-process trace context (``TraceContext.to_dict()``
        shape): stamped onto the record so the streaming updater's
        micro-generations can name the requests that fed them."""
        from photon_tpu_torch.obs.metrics import registry

        if uid is None:
            return False  # no join key: nothing to wait for
        fraction = self.config.tenant_fractions.get(
            tenant, self.config.sample_fraction
        ) if tenant is not None else self.config.sample_fraction
        if fraction <= 0.0:
            return False
        key = tenant or ""
        with self._lock:
            acc = self._acc.get(key, 0.0) + fraction
            if acc < 1.0:
                self._acc[key] = acc
                registry().counter("feedback_sampled_out_total").inc()
                return False
            self._acc[key] = acc - 1.0
            now = time.time()
            rec = {
                "ts": ts if ts is not None else now,
                "uid": str(uid),
                "tenant": tenant,
                "features": _jsonable_features(features),
                "entityIds": {
                    k: (v if isinstance(v, str) else int(v))
                    for k, v in (entity_ids or {}).items()
                },
                "offset": float(offset),
                "score": float(score),
                "modelVersion": model_version,
            }
            if trace is not None:
                rec["trace"] = {
                    "traceId": trace.get("traceId"),
                    "parentSpanId": trace.get("parentSpanId"),
                }
            self._pending[str(uid)] = (now, rec)
            self._evict_pending_locked(now)
        return True

    def _evict_pending_locked(self, now: float) -> None:
        from photon_tpu_torch.obs.metrics import registry

        cfg = self.config
        dropped = 0
        while self._pending:
            first_uid = next(iter(self._pending))
            t0, rec = self._pending[first_uid]
            over_capacity = len(self._pending) > cfg.join_capacity
            past_ttl = now - t0 > cfg.join_ttl_s
            if over_capacity or past_ttl:
                del self._pending[first_uid]
                dropped += 1
                if past_ttl:
                    self._expired[first_uid] = now
                    # Side-spool the scored half so the eviction is
                    # reclaimable: when its label eventually lands (the
                    # late path below writes the other half), a backfill
                    # pass can re-join the pair instead of losing the
                    # example.
                    self._spool_late_locked(
                        {"kind": "evicted", "evictedAt": now, "record": rec}
                    )
            else:
                break
        expired_cap = max(cfg.join_capacity, 1024)
        while len(self._expired) > expired_cap:
            self._expired.popitem(last=False)
        if dropped:
            registry().counter("feedback_join_dropped_total").inc(dropped)

    def late_labels_path(self) -> str:
        return os.path.join(self.directory, LATE_LABELS_FILE)

    def _spool_late_locked(self, obj: dict) -> bool:
        """Append one JSON line to the ``late-labels.jsonl`` sidecar.
        Best-effort by design: the sidecar reclaims data the join already
        gave up on, so a write failure drops with a counter and must never
        take down label ingestion (same containment contract as
        ``_append_locked``). Lines interleave two kinds keyed by uid —
        ``evicted`` (the scored features, written at TTL eviction) and
        ``late_label`` (the label, written when it finally arrives) — which
        is exactly the pair a future backfill pass re-joins."""
        from photon_tpu_torch.obs.metrics import registry

        try:
            self._guard.check()
            if self._late_f is None:
                self._late_f = open(self.late_labels_path(), "a")
            self._late_f.write(json.dumps(obj) + "\n")
            self._late_f.flush()
        except Exception as exc:  # noqa: BLE001 — containment, not rethrow
            self._guard.record(exc)
            registry().counter("feedback_late_spool_errors_total").inc()
            return False
        registry().counter("feedback_late_spooled_total").inc()
        return True

    def observe_label(
        self, uid: str, label: float, ts: Optional[float] = None
    ) -> bool:
        """Join an observed label with its buffered scored request and
        append the joined record to the active segment. Never raises to the
        caller (label ingestion must not break serving) — every failure
        mode drops with a counter. Returns True when the record landed."""
        from photon_tpu_torch.obs.metrics import registry

        rule = faults.injector().fire("serve.feedback", label=str(uid))
        if rule is not None:
            if rule.kind == "kill":
                import signal

                logger.error("fault serve.feedback: SIGKILL")
                os.kill(os.getpid(), signal.SIGKILL)
            if rule.kind == "torn":
                self._tear_active_segment()
                registry().counter("feedback_labels_dropped_total").inc()
                return False
            if rule.kind == "enospc":
                registry().counter("feedback_labels_dropped_total").inc()
                self._guard.record(faults.exception_for(rule, "serve.feedback"))
                return False
            # transient / permanent: the label-join drop
            registry().counter("feedback_labels_dropped_total").inc()
            logger.warning("fault serve.feedback: label join dropped (%s)",
                           rule.kind)
            return False
        with self._lock:
            entry = self._pending.pop(str(uid), None)
            if entry is None:
                if str(uid) in self._expired:
                    # The scored request WAS here; the label just missed the
                    # join window. Counted separately from never-seen uids so
                    # the planned backfill pass has a measured denominator —
                    # and side-spooled so that pass has the label itself,
                    # not just a count.
                    registry().counter("feedback_label_late_total").inc()
                    self._spool_late_locked({
                        "kind": "late_label",
                        "uid": str(uid),
                        "label": float(label),
                        "labelTs": ts if ts is not None else time.time(),
                    })
                    if self._late_logged_seq != self._seq:
                        self._late_logged_seq = self._seq
                        logger.warning(
                            "feedback: label for uid %s arrived after the "
                            "%.0fs join TTL; counting in "
                            "feedback_label_late_total (logged once per "
                            "segment)", uid, self.config.join_ttl_s,
                        )
                else:
                    registry().counter("feedback_labels_unmatched_total").inc()
                return False
            _t0, rec = entry
            rec = dict(rec)
            rec["label"] = float(label)
            rec["labelTs"] = ts if ts is not None else time.time()
            landed = self._append_locked(rec)
        if landed and self.on_join is not None:
            try:
                self.on_join(rec)
            except Exception:  # noqa: BLE001 — subscriber never hurts labels
                registry().counter("feedback_join_subscriber_errors_total").inc()
                logger.exception("feedback spool on_join subscriber failed")
        return landed

    def _append_locked(self, rec: dict) -> bool:
        from photon_tpu_torch.obs.metrics import registry

        now = time.time()
        try:
            self._guard.check()
            if self._part is None:
                path = os.path.join(self.directory, _part_name(self._seq))
                self._part = open(path, "a")
                self._part_records = 0
                self._part_opened_at = now
            self._part.write(json.dumps(rec) + "\n")
            self._part.flush()
        except Exception as exc:  # noqa: BLE001 — containment, not rethrow
            self._guard.record(exc)
            registry().counter("feedback_records_dropped_total").inc()
            logger.warning("feedback spool append failed: %s", exc)
            return False
        self._part_records += 1
        registry().counter("feedback_records_total").inc()
        if (self._part_records >= self.config.segment_max_records
                or now - self._part_opened_at >= self.config.segment_max_age_s):
            self._seal_locked()
        return True

    def _seal_locked(self) -> None:
        if self._part is None or self._part_records == 0:
            return
        part_path = self._part.name
        self._part.flush()
        os.fsync(self._part.fileno())
        self._part.close()
        os.replace(
            part_path,
            os.path.join(self.directory, _sealed_name(self._seq)),
        )
        self._part = None
        self._seq += 1

    def _tear_active_segment(self) -> None:
        """``torn`` fault: abandon the active segment mid-record, as a crash
        between ``write`` syscalls would. The half line is visible on disk;
        the writer moves on to a fresh sequence number (a restarted process
        would), and recovery must drop exactly the torn tail."""
        with self._lock:
            if self._part is None:
                path = os.path.join(self.directory, _part_name(self._seq))
                self._part = open(path, "a")
                self._part_records = 0
                self._part_opened_at = time.time()
            self._part.write('{"torn": tru')  # no newline, invalid JSON
            self._part.flush()
            self._part.close()
            self._part = None
            self._seq += 1
            logger.warning("fault serve.feedback: active segment torn")

    # -- lifecycle --------------------------------------------------------

    def flush(self) -> None:
        """Seal the active segment if it holds any records (makes them
        visible to the consumer immediately)."""
        with self._lock:
            self._seal_locked()

    def tick(self) -> None:
        """Age-based seal — call periodically so a quiet tenant's records
        don't sit invisible in an unsealed part past the age bound."""
        with self._lock:
            if (self._part is not None and self._part_records > 0
                    and time.time() - self._part_opened_at
                    >= self.config.segment_max_age_s):
                self._seal_locked()
            self._evict_pending_locked(time.time())

    def start_auto_flush(self) -> None:
        if self._flusher is not None:
            return
        interval = max(0.05, min(1.0, self.config.segment_max_age_s / 2.0))

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — flusher must survive
                    logger.exception("feedback spool tick failed")

        self._flusher = threading.Thread(
            target=loop, name="feedback-spool-flush", daemon=True
        )
        self._flusher.start()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
        with self._lock:
            self._seal_locked()
            if self._part is not None:  # empty part: discard
                path = self._part.name
                self._part.close()
                try:
                    os.unlink(path)
                except OSError:
                    pass
                self._part = None
            if self._late_f is not None:
                try:
                    self._late_f.close()
                except OSError:
                    pass
                self._late_f = None
        try:
            self._lockf.close()
        except OSError:
            pass

    def stats(self) -> dict:
        with self._lock:
            return {
                "pending_joins": len(self._pending),
                "expired_uids": len(self._expired),
                "active_records": self._part_records if self._part else 0,
                "next_seq": self._seq,
                "sealed": len(sealed_segments(self.directory)),
                "late_labels_path": self.late_labels_path(),
            }


def _jsonable_features(features):
    """Features as JSON: dict {key: value} and (indices, values) pairs pass
    through; dense per-shard vectors become lists."""
    import numpy as np

    if features is None:
        return None
    if isinstance(features, dict):
        out = {}
        for shard, val in features.items():
            if isinstance(val, dict):
                out[shard] = {str(k): float(v) for k, v in val.items()}
            elif (isinstance(val, tuple) and len(val) == 2):
                idx, vals = val
                out[shard] = [
                    [int(i) for i in np.asarray(idx).tolist()],
                    [float(v) for v in np.asarray(vals).tolist()],
                ]
            else:
                out[shard] = [float(v) for v in np.asarray(val).tolist()]
        return out
    return [float(v) for v in np.asarray(features).tolist()]


def read_late_pairs(path: str) -> List[dict]:
    """Re-join the late-labels sidecar: ``evicted`` lines carry the scored
    half (features, score, modelVersion), ``late_label`` lines the label
    that missed the join window. Matching halves (by uid) merge into full
    spool-shaped records — the same dict :meth:`FeedbackSpool.observe_label`
    would have appended had the label been on time. Unmatched halves are
    left in the file and pair up on a later pass. Ordering is deterministic
    — sorted by (labelTs, uid) — so a crashed-and-restarted replay pass
    rebuilds the identical training batch. Malformed lines skip with a
    counter (the sidecar is best-effort on the write side too)."""
    from photon_tpu_torch.obs.metrics import registry

    if not os.path.exists(path):
        return []
    evicted: Dict[str, dict] = {}
    labels: Dict[str, dict] = {}
    bad = 0
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                kind = obj.get("kind")
                if kind == "evicted" and isinstance(obj.get("record"), dict):
                    rec = obj["record"]
                    uid = str(rec.get("uid"))
                    # Last write wins: a uid re-scored and re-evicted pairs
                    # with the freshest features (file order is arrival
                    # order, so this stays deterministic).
                    evicted[uid] = rec
                elif kind == "late_label" and obj.get("uid") is not None:
                    labels[str(obj["uid"])] = obj
                else:
                    bad += 1
    except OSError:
        return []
    if bad:
        registry().counter("feedback_late_malformed_total").inc(bad)
    out: List[dict] = []
    for uid, rec in evicted.items():
        lab = labels.get(uid)
        if lab is None:
            continue
        joined = dict(rec)
        joined["label"] = float(lab.get("label") or 0.0)
        joined["labelTs"] = float(lab.get("labelTs") or 0.0)
        out.append(joined)
    out.sort(key=lambda r: (float(r.get("labelTs") or 0.0), str(r.get("uid"))))
    return out


def recover_orphan_parts(directory: str) -> Dict[str, int]:
    """Consumer-side recovery: seal orphaned parts only when no live writer
    holds the lock (take it non-blocking, recover, release). With a live
    writer present this is a no-op — the writer owns its parts."""
    lock_path = os.path.join(directory, WRITER_LOCK)
    if not os.path.isdir(directory):
        return {}
    try:
        lockf = open(lock_path, "a")
    except OSError:
        return {}
    try:
        try:
            import fcntl

            fcntl.flock(lockf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:
            pass
        except OSError:
            return {}  # live writer: leave its parts alone
        return recover_segments(directory)
    finally:
        lockf.close()
