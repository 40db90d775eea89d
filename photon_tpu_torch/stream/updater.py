"""Port of photon_tpu/stream/updater.py: the records become torch tensors on
the configured device; the rest is the reference's host code.

Continuous micro-generation updater: spool segments → warm-started
per-entity solves → gated delta publishes.

The consume half of the streaming freshness loop. A long-running
:class:`StreamingUpdater` polls the feedback spool for sealed segments,
batches their joined (features, label) records into an incremental update
(``train/incremental.py`` — warm start from the parent generation, active-set
per-entity solves, row-level merge), and publishes the result as a
per-entity DELTA layer (``io/model_io.py:save_delta_model``) through the
SAME validation gate and ``LATEST`` pointer full generations use. Serving
picks micro-generations up through the unchanged rollout watcher.

Consume-cursor discipline — the generation manifest IS the cursor. Each
published micro-generation records ``stream.consumedThrough`` (the highest
segment sequence it trained on) in its manifest, written durably BEFORE the
gate can flip ``LATEST``. Crash-resume is therefore double-apply-free by
construction:

- killed before the flip → ``LATEST`` (and so the cursor) is unchanged; the
  restarted updater reprocesses the same segments from the same parent,
  deterministically producing the same model;
- killed after the flip → the segments are recorded consumed and skipped.

There is no second cursor file to drift out of sync with the model lineage.
A gate-refused generation never moves the cursor (it is not in the
``LATEST`` lineage), so its segments are retried next cycle.

Fault site ``stream.consume`` fires once per consumed segment (labelled with
the segment name) and once more labelled ``train`` before the solve — a
``kill`` rule at the right call index crashes the updater mid-generation,
which is exactly what the resume-equivalence tests exercise. The late-label
replay pass uses its own site, ``stream.replay``, so replay cadence can
never shift ``stream.consume`` call indices out from under those tests.
"""

from __future__ import annotations

import dataclasses
import glob as glob_mod
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_tpu_torch.stream.spool import (
    LATE_LABELS_FILE,
    read_late_pairs,
    read_segment,
    recover_orphan_parts,
    sealed_segments,
    segment_seq,
)
from photon_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

_CURSOR_KEY = "consumedThrough"
_PER_SPOOL_KEY = "consumedPerSpool"


def discover_spool_dirs(spec: str) -> List[str]:
    """``spool_dir`` may be one directory or a GLOB over several (the fleet
    shape: each scorer replica spools into ``<base>/<replica-id>``, the
    updater polls ``<base>/*``). Sorted for deterministic cycle order; a
    replica joining mid-run is picked up on the next poll with no updater
    restart."""
    if is_spool_glob(spec):
        return sorted(d for d in glob_mod.glob(spec) if os.path.isdir(d))
    return [spec]


def is_spool_glob(spec: str) -> bool:
    return any(ch in spec for ch in "*?[")


def spool_dir_key(path: str) -> str:
    """Stable manifest key for one spool directory (its basename — the
    replica id in the fleet layout)."""
    return os.path.basename(os.path.normpath(path))


def merge_pending_segments(
    dirs: Sequence[str],
    cursors: Dict[str, int],
    max_segments: int,
) -> List[Tuple[str, str]]:
    """Unconsumed sealed segments across every spool dir, merged in mtime
    order (seal time ≈ label arrival time, so records from N replicas
    interleave roughly chronologically). Ties break on (dir key, seq).
    Within one dir mtimes are monotone in seq, so ANY prefix of the merged
    order contains a per-dir seq prefix — the per-dir cursors stay sound
    under the ``max_segments`` cap."""
    entries: List[Tuple[float, str, int, str, str]] = []
    for d in dirs:
        cursor = cursors.get(spool_dir_key(d), 0)
        for fn in sealed_segments(d):
            seq = segment_seq(fn)
            if seq <= cursor:
                continue
            try:
                mtime = os.path.getmtime(os.path.join(d, fn))
            except OSError:
                continue  # consumed and pruned between listdir and stat
            entries.append((mtime, spool_dir_key(d), seq, d, fn))
    entries.sort()
    return [(d, fn) for _, _, _, d, fn in entries[:max_segments]]


@dataclasses.dataclass
class StreamingUpdaterConfig:
    """Everything one streaming updater needs besides the loaded index
    artifacts. ``coordinate_configs`` / ``update_sequence`` / ``task`` are
    the same objects the batch drivers use — the updater runs the same
    estimator, just on spool-fed micro-batches."""

    publish_root: str
    spool_dir: str  # one directory, or a glob over per-replica spool dirs
    task: object
    coordinate_configs: Sequence
    update_sequence: Sequence[str]
    cadence_s: float = 5.0
    # Don't bother solving for fewer joined records than this; the segments
    # stay unconsumed and accumulate into the next cycle.
    min_records: int = 8
    max_segments_per_cycle: int = 64
    locked_coordinates: Sequence[str] = ()
    # Publish per-entity delta layers (full publish is the fallback when a
    # layer is not emittable). ``full_every=k`` forces every k-th publish to
    # be full, bounding delta-chain length; 0 never forces.
    delta_artifacts: bool = True
    full_every: int = 0
    # Every k-th record (deterministically) is held out for the gate's
    # regression bound instead of trained on; 0 disables holdout scoring.
    holdout_fraction: float = 0.0
    evaluators: Sequence[str] = ("AUC",)
    metric_tolerance: float = 0.02
    norm_drift_bound: float = 10.0
    num_iterations: int = 1
    re_convergence_tol: float = 1e-4
    # Out-of-core residency for the per-cycle fits (train/incremental.py
    # pass-through). Sharded workers spill under the host-owned layout
    # ``<re_spill_dir>/host-<shard_index>/`` so a shard-count rebalance is
    # a file move (shard_router.rebalance_updater_spill), not a re-stream.
    re_device_budget_mb: Optional[float] = None
    re_spill_dir: Optional[str] = None
    # Sharded freshness plane: this worker is shard ``shard_index`` of
    # ``num_shards``. Records route by hashing the SAME per-entity string
    # serving's ``_owned_mask`` hashes (stream/shard_router.py), so each
    # worker's working set is a disjoint entity subset and its delta layers
    # commute with every sibling's. (num_shards=1, shard_index=0) is the
    # single-updater plane byte-for-byte.
    num_shards: int = 1
    shard_index: int = 0
    shard_vnodes: int = 64
    shard_seed: int = 0
    route_re_type: Optional[str] = None
    # ``spool_dir`` already holds ONLY this shard's records (a materializing
    # router — shard_router.route_segments — split the raw spool upstream),
    # so skip read-side ring filtering and consume segments whole. Cursor
    # manifests stay shard-tagged: routed sub-spools keep the source
    # sequence numbers, so consumedThrough means the same thing.
    pre_routed: bool = False
    # Serialize the publish tail (save→manifest→gate→flip) under the
    # publish root's flock and rebase onto the live LATEST. None = auto:
    # on whenever sibling shards exist. Forcing True on a single updater
    # is safe (and protects against a concurrent batch publisher).
    serialize_publish: Optional[bool] = None
    # FE-drift trigger: the streaming plane locks the fixed effect, so its
    # age only grows. Past this bar the ``fe_age_s`` SLO objective starts
    # burning and the ``stream_fe_retrain_wanted`` gauge raises; with
    # ``fe_retrain`` on, the updater actually acts on it — a cooldown-
    # guarded full-publish generation with the FE coordinate unlocked,
    # trained on a bounded window of recent records.
    fe_max_age_s: float = 3600.0
    fe_retrain: bool = False
    fe_retrain_cooldown_s: float = 600.0
    fe_retrain_min_records: int = 32
    fe_retrain_window: int = 4096
    # Late-label replay correction pass: every ``late_replay_cadence_s``
    # seconds the updater re-joins the spool sidecar's (evicted, late_label)
    # halves and, once at least ``late_replay_min_pairs`` fresh pairs exist,
    # retrains the affected entities into a corrective delta published
    # through the UNCHANGED gate. 0 disables (the default — replay is
    # opt-in, exactly like holdout).
    late_replay_cadence_s: float = 0.0
    late_replay_min_pairs: int = 8
    # Where the micro-batches live and the solves run (cuda unless the
    # caller asks for the CPU).
    device: str = "cuda"


@dataclasses.dataclass
class CycleResult:
    """One ``run_once`` outcome (None is returned instead when there was
    nothing to consume)."""

    generation: str
    published: bool
    is_delta: bool
    gate_reason: Optional[str]
    segments: List[str]
    records: int
    consumed_through: int
    staleness_s: Optional[float]


def records_to_batch(records: List[dict], index_maps: Dict,
                     entity_indexes: Dict, intern: bool = True, device="cuda"):
    """Joined spool records → one training GameBatch on ``device``. Features
    densify exactly like the serving engine's request assembly (string keys
    through the shard's index map, intercept column set when the map has
    one), so the updater trains on the same vectors serving scored. New
    entity ids intern append-only into ``entity_indexes`` — existing slots
    never move. The arrays are built on the host and copied to the device
    once each; nothing is read back."""
    import torch

    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.data.index_map import IndexMap

    n = len(records)
    shard_dims = {shard: len(imap) for shard, imap in index_maps.items()}
    icpt = {
        shard: imap.get_index(IndexMap.INTERCEPT)
        if IndexMap.INTERCEPT in imap else -1
        for shard, imap in index_maps.items()
    }
    feats = {
        shard: np.zeros((n, d), np.float32) for shard, d in shard_dims.items()
    }
    eids = {
        re_type: np.full(n, -1, np.int64) for re_type in entity_indexes
    }
    label = np.zeros(n, np.float32)
    offset = np.zeros(n, np.float32)
    for i, rec in enumerate(records):
        label[i] = float(rec.get("label") or 0.0)
        offset[i] = float(rec.get("offset") or 0.0)
        for shard, d in shard_dims.items():
            row = feats[shard][i]
            j = icpt[shard]
            if j >= 0:
                row[j] = 1.0
            val = (rec.get("features") or {}).get(shard)
            if val is None:
                continue
            if isinstance(val, dict):
                imap = index_maps[shard]
                for k, v in val.items():
                    col = imap.get_index(k) if k in imap else -1
                    if 0 <= col < d:
                        row[col] = float(v)
            elif (isinstance(val, (list, tuple)) and len(val) == 2
                  and isinstance(val[0], (list, tuple))):
                idx = np.asarray(val[0], np.int64)
                vals = np.asarray(val[1], np.float32)
                ok = (idx >= 0) & (idx < d)
                row[idx[ok]] = vals[ok]
            else:
                arr = np.asarray(val, np.float32)
                if arr.shape != (d,):
                    raise ValueError(
                        f"spool record {i}: shard {shard!r} expects ({d},), "
                        f"got {arr.shape}"
                    )
                row[:] = arr
        for re_type, eidx in entity_indexes.items():
            key = (rec.get("entityIds") or {}).get(re_type)
            if key is None:
                continue
            if isinstance(key, str):
                eids[re_type][i] = (
                    eidx.intern(key) if intern else eidx.lookup(key)
                )
            else:
                eids[re_type][i] = int(key)
    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(a).to(dev)

    return GameBatch(
        label=put(label),
        offset=put(offset),
        weight=torch.ones(n, dtype=torch.float32, device=dev),
        features={s: put(a) for s, a in feats.items()},
        entity_ids={t: put(a.astype(np.int32)) for t, a in eids.items()},
    )


class StreamingUpdater:
    """Spool-consuming micro-generation publisher over one publish root."""

    def __init__(
        self,
        config: StreamingUpdaterConfig,
        index_maps: Dict,
        entity_indexes: Dict,
    ):
        self.config = config
        self.index_maps = index_maps
        self.entity_indexes = entity_indexes
        self._cycles = 0
        self._publishes = 0
        self._stop = threading.Event()
        # Busy-time accounting for the shard-scaling bench: wall seconds
        # spent inside cycles (busy) and inside the train+publish step
        # (train), plus records actually trained on. Σ_shards(records /
        # busy) is the aggregate-throughput number `--updater-shard-ab`
        # reports, mirroring the multichip busy-time methodology.
        self._busy_s = 0.0
        self._train_s = 0.0
        self._records_trained = 0
        if not (0 <= config.shard_index < max(1, config.num_shards)):
            raise ValueError(
                f"shard_index {config.shard_index} out of range for "
                f"num_shards {config.num_shards}"
            )
        self._ring = None
        if config.num_shards > 1:
            from photon_tpu_torch.stream.shard_router import shard_ring

            self._ring = shard_ring(
                config.num_shards,
                vnodes=config.shard_vnodes,
                seed=config.shard_seed,
            )
        # Updater-side SLO plane: cycle success ratio + published-model
        # freshness — the training half of the serve-side tracker, so
        # staleness is measurable when no server is running — plus the
        # locked-FE age objective feeding the retrain-wanted trigger.
        from photon_tpu_torch.obs.slo import SLOTracker, streaming_objectives

        self.slo = SLOTracker(
            objectives=streaming_objectives(
                fe_age_threshold_s=config.fe_max_age_s
            )
        )
        # Updater-side quality plane: holdout records (and replayed late
        # pairs) are scored-and-labelled examples keyed by the model
        # version that actually served them, so the training half measures
        # online quality even with no serving engine in-process. The
        # updater's SLO tracker carries no quality objectives by default —
        # record_event on an unknown objective is a no-op — so this is
        # measurement until a drill wires the rings in.
        from photon_tpu_torch.obs.quality import (
            QualityConfig,
            QualityPlane,
            task_name,
        )

        self.quality = QualityPlane(QualityConfig(task=task_name(config.task)))
        self._last_replay = 0.0
        self._replay_publishes = 0
        self._fe_retrains = 0
        self._last_fe_retrain: Optional[float] = None
        # Bounded window of recent train records feeding an FE retrain;
        # only populated when the actuation is enabled.
        from collections import deque

        self._fe_recent: "deque" = deque(maxlen=max(1, config.fe_retrain_window))

    # -- cursor ------------------------------------------------------------

    def _cursor_matches(self, stream: Dict) -> bool:
        """Whether a lineage ``stream`` block is THIS worker's cursor. A
        sharded worker's cursor chain is the subsequence of manifests
        tagged with its own ``shard`` identity — sibling shards' blocks are
        walked through exactly like batch publishes. Untagged blocks (the
        single-updater plane) count for every shard: they record
        segments the pre-shard plane fully consumed, so adopting them as a
        floor is what makes a 1→N reshard resume without re-training old
        traffic. A block from a DIFFERENT topology (other ``of``) is
        skipped — resharding N→M needs a drained spool or a fresh full
        publish (see README runbook)."""
        if _CURSOR_KEY not in stream and _PER_SPOOL_KEY not in stream:
            return False
        shard = stream.get("shard")
        if not shard:
            return True
        return (
            int(shard.get("of", 0)) == self.config.num_shards
            and int(shard.get("index", -1)) == self.config.shard_index
        )

    def _stream_blocks(self):
        """Yield the ``stream`` manifest blocks of the published lineage,
        newest first, walking parent links from ``LATEST``. Shared by every
        cursor lookup (segment cursor, replay-pairs cursor) so they all see
        the same chain with the same hop bound."""
        from photon_tpu_torch.cli.game_serving import resolve_model_dir
        from photon_tpu_torch.io.model_io import load_generation_manifest

        root = self.config.publish_root
        cur = resolve_model_dir(root)
        if cur == root:
            return
        for _ in range(128):
            manifest = load_generation_manifest(cur) or {}
            yield manifest.get("stream") or {}
            parent = manifest.get("parent")
            if not parent:
                return
            cur = os.path.join(root, parent)
            if not os.path.isdir(cur):
                return

    def _cursor_stream_info(self) -> Dict:
        """The most recent ``stream`` manifest block in the published
        lineage that belongs to THIS worker: the first matching block on
        the parent walk. A full (batch) publish — or a sibling shard's
        micro-generation — carries no matching record and is walked
        through; its parent chain still reaches this worker's last
        cursor."""
        for stream in self._stream_blocks():
            if self._cursor_matches(stream):
                return stream
        return {}

    def _replayed_pairs(self) -> Dict[str, int]:
        """Late-replay cursor: per-spool-dir COUNT of joined sidecar pairs
        already folded into the lineage. Same manifest-as-cursor discipline
        as segments — the count lands in the corrective generation's
        ``stream.lateReplay.pairs`` block before the gate can flip LATEST,
        so a crash before the flip deterministically re-replays the same
        pairs and a crash after skips them. The sidecar is append-only, so
        a pair count IS a stable prefix cursor."""
        for stream in self._stream_blocks():
            if not self._cursor_matches(stream):
                continue
            replay = stream.get("lateReplay") or {}
            # Shard-granular replay cursor: the block carries its OWN shard
            # tag (independent of the outer block's), so a sibling shard's
            # replay chain is never adopted even if a future manifest merge
            # drops the outer tag — each shard's crash-resume point is its
            # own last replay, full stop. Untagged blocks (pre-shard plane)
            # still count for every shard, same 1→N adoption rule as
            # segment cursors.
            tag = replay.get("shard")
            if tag and not (
                int(tag.get("of", 0)) == self.config.num_shards
                and int(tag.get("index", -1)) == self.config.shard_index
            ):
                continue
            pairs = replay.get("pairs")
            if pairs is not None:
                return {str(k): int(v) for k, v in pairs.items()}
        return {}

    def _re_spill_kwargs(self) -> Dict:
        """Out-of-core residency pass-through for the per-cycle fits.

        Sharded workers resolve their spill root through the host-owned
        layout (``host-<shard_index>/``) so a shard-count rebalance moves
        files (shard_router.rebalance_updater_spill) instead of
        re-streaming rows; the single-updater plane spills flat.
        """
        cfg = self.config
        out: Dict = {}
        if cfg.re_device_budget_mb is not None:
            out["re_device_budget_mb"] = cfg.re_device_budget_mb
        if cfg.re_spill_dir is not None:
            if cfg.num_shards > 1:
                from photon_tpu_torch.stream.shard_router import updater_spill_dir

                out["re_spill_dir"] = updater_spill_dir(
                    cfg.re_spill_dir, cfg.shard_index
                )
            else:
                out["re_spill_dir"] = cfg.re_spill_dir
        return out

    def consumed_through(self) -> int:
        """Highest spool segment sequence already folded into the published
        model lineage (max across spool dirs in the fleet layout — the
        legacy single-dir cursor reads identically)."""
        stream = self._cursor_stream_info()
        if _CURSOR_KEY in stream:
            return int(stream[_CURSOR_KEY])
        per_spool = stream.get(_PER_SPOOL_KEY) or {}
        return max((int(v) for v in per_spool.values()), default=0)

    def consumed_per_spool(self) -> Dict[str, int]:
        """Per-spool-dir cursors (keyed by dir basename = replica id). A
        legacy manifest carrying only the scalar cursor applies it to a
        single configured dir; against a multi-dir glob it contributes
        nothing (each dir starts from its own recorded cursor or 0)."""
        stream = self._cursor_stream_info()
        per_spool = {
            str(k): int(v)
            for k, v in (stream.get(_PER_SPOOL_KEY) or {}).items()
        }
        if (
            not per_spool and _CURSOR_KEY in stream
            and not is_spool_glob(self.config.spool_dir)
        ):
            per_spool[spool_dir_key(self.config.spool_dir)] = int(
                stream[_CURSOR_KEY]
            )
        return per_spool

    # -- one cycle ---------------------------------------------------------

    def run_once(self) -> Optional[CycleResult]:
        """Consume pending sealed segments into one gated micro-generation.
        Returns None when there is nothing (or not yet enough) to train on.

        With an OTLP exporter installed the whole cycle runs under a
        minted trace context (``stream/cycle`` root span), so the solve's
        span tree flows to the collector; a failed cycle finishes its
        trace with the error, making it a kept flight-recorder tree."""
        from photon_tpu_torch.obs.export import active_exporter

        if active_exporter() is None:
            return self._run_cycle()
        from photon_tpu_torch.obs.trace import (
            flight_recorder,
            mint_context,
            span,
            tracer,
        )

        ctx = mint_context()
        t0 = time.monotonic()
        err = None
        try:
            with tracer().attach_context(ctx), span("stream/cycle"):
                return self._run_cycle()
        except Exception as exc:
            err = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            flight_recorder().finish(
                ctx.trace_id, time.monotonic() - t0, error=err
            )

    def _run_cycle(self) -> Optional[CycleResult]:
        t_cycle = time.monotonic()
        try:
            return self._run_cycle_inner()
        finally:
            self._busy_s += time.monotonic() - t_cycle

    def _run_cycle_inner(self) -> Optional[CycleResult]:
        from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
        from photon_tpu_torch.obs.metrics import registry
        from photon_tpu_torch.train.incremental import incremental_update

        cfg = self.config
        dirs = discover_spool_dirs(cfg.spool_dir)
        for d in dirs:
            recover_orphan_parts(d)
        cursors = self.consumed_per_spool()
        # A glob spec is "multi" even when it currently matches one dir —
        # more replica spools may appear later, so per-spool cursors (and
        # dir-qualified segment names) are needed from the first cycle.
        multi = len(dirs) > 1 or is_spool_glob(cfg.spool_dir)
        pending_pairs = merge_pending_segments(
            dirs, cursors, cfg.max_segments_per_cycle
        )
        pending = [
            f"{spool_dir_key(d)}/{fn}" if multi else fn
            for d, fn in pending_pairs
        ]
        if not pending_pairs:
            return None
        records: List[dict] = []
        records_routed = 0
        if self._ring is not None and not cfg.pre_routed:
            # Mixed segments split at record level: keep the rows this
            # shard's ring slice owns, siblings pick up the rest from the
            # same sealed files. Routing happens on the RAW lines
            # (entityIds-only decode), so a shard pays a hash — not a full
            # json parse — for every foreign record; that is what lets
            # aggregate throughput scale with shard count when every
            # worker lists the same sealed bytes. The cursor still
            # advances over the WHOLE segment span consumed this cycle —
            # ownership is a property of rows, not files.
            from photon_tpu_torch.stream.shard_router import read_owned_segment

            for d, fn in pending_pairs:
                faults.check("stream.consume", label=fn)
                owned, total = read_owned_segment(
                    os.path.join(d, fn), self._ring, cfg.shard_index,
                    cfg.route_re_type,
                )
                records.extend(owned)
                records_routed += total
        else:
            for d, fn in pending_pairs:
                faults.check("stream.consume", label=fn)
                records.extend(read_segment(os.path.join(d, fn)))
            records_routed = len(records)
        if len(records) < cfg.min_records:
            return None
        self._cycles += 1
        reg = registry()
        reg.counter("stream_cycles_total").inc()
        if cfg.num_shards > 1:
            reg.counter(
                "stream_shard_cycles_total", shard=str(cfg.shard_index)
            ).inc()

        # Deterministic holdout split: every k-th record scores the gate's
        # regression bound instead of training. Determinism matters — a
        # crashed-and-restarted cycle must rebuild the identical split.
        train_recs, holdout_recs = records, []
        if cfg.holdout_fraction > 0.0:
            k = max(2, int(round(1.0 / cfg.holdout_fraction)))
            train_recs = [r for i, r in enumerate(records) if i % k != 0]
            holdout_recs = [r for i, r in enumerate(records) if i % k == 0]
            if not train_recs:
                train_recs, holdout_recs = records, []
        if holdout_recs:
            # Holdout records were scored by serving and never trained on —
            # an unbiased online-quality sample keyed by the version that
            # actually scored each one.
            self._observe_quality(holdout_recs)
        if cfg.fe_retrain:
            self._fe_recent.extend(train_recs)

        faults.check("stream.consume", label="train")
        t_train = time.monotonic()
        batch = records_to_batch(
            train_recs, self.index_maps, self.entity_indexes, intern=True,
            device=cfg.device,
        )
        valid_batch = None
        suite = None
        if holdout_recs:
            valid_batch = records_to_batch(
                holdout_recs, self.index_maps, self.entity_indexes,
                intern=False, device=cfg.device,
            )
            suite = EvaluationSuite(
                [EvaluatorSpec.parse(e) for e in cfg.evaluators],
                {k: len(v) for k, v in self.entity_indexes.items()},
            )

        # Per-dir cursors advance to the max seq consumed THIS cycle; dirs
        # with nothing new carry their prior cursor forward (an idle
        # replica's cursor must never regress to 0).
        new_cursors = dict(cursors)
        for d, fn in pending_pairs:
            key = spool_dir_key(d)
            new_cursors[key] = max(new_cursors.get(key, 0), segment_seq(fn))
        consumed = max(new_cursors.values())
        label_ts = [
            float(r["labelTs"]) for r in records if r.get("labelTs")
        ]
        oldest_label_ts = min(label_ts) if label_ts else None
        emit_delta = bool(cfg.delta_artifacts)
        if emit_delta and cfg.full_every > 0:
            emit_delta = (self._publishes + 1) % cfg.full_every != 0
        stream_info = {
            _CURSOR_KEY: consumed,
            "segments": pending,
            "records": len(records),
        }
        if cfg.num_shards > 1:
            # The shard identity tags this manifest as one link of THIS
            # worker's cursor chain — siblings and restarts walk past
            # non-matching blocks (see _cursor_matches).
            stream_info["shard"] = {
                "index": cfg.shard_index,
                "of": cfg.num_shards,
            }
            stream_info["recordsRouted"] = records_routed
        if multi:
            # Only the multi-dir (fleet) layout needs per-spool cursors;
            # single-dir manifests keep the unsharded shape byte-for-byte.
            stream_info[_PER_SPOOL_KEY] = new_cursors
        if oldest_label_ts is not None:
            stream_info["oldestLabelTs"] = oldest_label_ts
        # Trace linkage: the request traces that fed this micro-generation
        # (spool records carry the serve-side context). Bounded sample —
        # enough to jump from a published generation back into the flight
        # recorder / request logs, without growing manifests unboundedly.
        trace_ids = []
        seen_tids = set()
        for r in records:
            tid = (r.get("trace") or {}).get("traceId")
            if tid and tid not in seen_tids:
                seen_tids.add(tid)
                trace_ids.append(tid)
        if trace_ids:
            stream_info["traceCount"] = len(trace_ids)
            stream_info["traceIds"] = trace_ids[:32]

        serialize = cfg.serialize_publish
        if serialize is None:
            serialize = cfg.num_shards > 1
        result = incremental_update(
            cfg.publish_root,
            batch,
            self.index_maps,
            self.entity_indexes,
            cfg.task,
            cfg.coordinate_configs,
            cfg.update_sequence,
            valid_batch=valid_batch,
            evaluation_suite=suite,
            locked_coordinates=list(cfg.locked_coordinates),
            num_iterations=cfg.num_iterations,
            metric_tolerance=cfg.metric_tolerance,
            norm_drift_bound=cfg.norm_drift_bound,
            re_convergence_tol=cfg.re_convergence_tol,
            emit_delta=emit_delta,
            extra_manifest={"stream": stream_info},
            serialize_publish=bool(serialize),
            device=cfg.device,
            **self._re_spill_kwargs(),
        )
        self._train_s += time.monotonic() - t_train
        self._records_trained += len(records)
        reg.counter("stream_records_consumed_total").inc(len(records))
        shard_labels = (
            {"shard": str(cfg.shard_index)} if cfg.num_shards > 1 else None
        )
        if shard_labels:
            reg.counter(
                "stream_shard_records_total", **shard_labels
            ).inc(len(records))
        staleness = None
        if result.published:
            self._publishes += 1
            reg.counter("stream_publishes_total").inc()
            if shard_labels:
                reg.counter(
                    "stream_shard_publishes_total", **shard_labels
                ).inc()
                reg.gauge(
                    "stream_shard_consumed_through", **shard_labels
                ).set(consumed)
            if oldest_label_ts is not None:
                staleness = time.time() - oldest_label_ts
                reg.gauge("model_staleness_published_s").set(staleness)
                # Same metric name the serving side publishes, so one SLO
                # query covers both halves of the freshness loop — and the
                # updater's own staleness objective sees every publish.
                reg.gauge("model_staleness_s").set(staleness)
                reg.histogram("model_staleness_hist_s").observe(staleness)
                self.slo.record_staleness(staleness)
                if shard_labels:
                    # Per-shard freshness: one lagging shard is invisible
                    # in the fleet-wide staleness gauge (siblings keep it
                    # low) but pins its own label high.
                    reg.gauge(
                        "stream_shard_staleness_s", **shard_labels
                    ).set(staleness)
            self.slo.record_event("update_cycle", True)
        else:
            # A refused generation means the freshness loop made no
            # progress this cycle — that burns the cycle objective even
            # though containment worked as designed.
            self.slo.record_event("update_cycle", False)
            reg.counter("stream_gate_rejects_total").inc()
            logger.warning(
                "streaming generation %s refused by the gate (%s); segments "
                "through %d stay unconsumed and retry next cycle",
                result.generation, result.gate_reason, consumed,
            )
        self._observe_fe_age(reg)
        return CycleResult(
            generation=result.generation,
            published=result.published,
            is_delta=result.is_delta,
            gate_reason=result.gate_reason,
            segments=pending,
            records=len(records),
            consumed_through=consumed,
            staleness_s=staleness,
        )

    # -- model-quality plane (obs/quality.py) ------------------------------

    def _observe_quality(self, records: Sequence[dict]) -> None:
        """Feed scored-and-labelled spool records into the quality plane,
        each keyed by the model version that actually scored it (the
        serving engine stamped ``modelVersion`` at score time). Contained:
        quality measurement must never fail a training cycle."""
        try:
            for rec in records:
                ids = rec.get("entityIds") or {}
                self.quality.observe(
                    float(rec.get("score") or 0.0),
                    float(rec.get("label") or 0.0),
                    model_version=rec.get("modelVersion"),
                    tenant=rec.get("tenant"),
                    re_type=",".join(sorted(ids)) if ids else "",
                    ts=rec.get("ts"),
                    label_ts=rec.get("labelTs"),
                    trace_id=(rec.get("trace") or {}).get("traceId"),
                    slo=self.slo,
                )
            self.quality.publish()
        except Exception:  # noqa: BLE001 — measurement containment
            from photon_tpu_torch.obs.metrics import registry

            registry().counter("quality_observe_errors_total").inc()
            logger.exception("quality-plane observe failed; cycle continues")

    # -- late-label replay correction pass ---------------------------------

    def maybe_replay_late_labels(self) -> Optional[CycleResult]:
        """Cadence + containment wrapper around :meth:`replay_late_labels`.
        Called from the driver loop every iteration; a failed replay is
        counted and retried after the next cadence interval."""
        cfg = self.config
        if cfg.late_replay_cadence_s <= 0:
            return None
        now = time.monotonic()
        if now - self._last_replay < cfg.late_replay_cadence_s:
            return None
        self._last_replay = now
        try:
            return self.replay_late_labels()
        except Exception:  # noqa: BLE001 — replay containment
            from photon_tpu_torch.obs.metrics import registry

            registry().counter("stream_replay_failures_total").inc()
            logger.exception("late-label replay failed; will retry")
            return None

    def replay_late_labels(self) -> Optional[CycleResult]:
        """Re-join each spool dir's ``late-labels.jsonl`` sidecar, train the
        affected entities on the recovered (features, label) pairs, and
        publish the result as a corrective delta through the UNCHANGED
        gate. The per-dir count of joined pairs already consumed is the
        cursor, persisted in the generation's ``stream.lateReplay.pairs``
        manifest block alongside the carried-forward segment cursors — the
        same manifest-as-cursor crash-resume discipline as segments.
        Returns None when there are not yet enough fresh pairs."""
        from photon_tpu_torch.obs.metrics import registry
        from photon_tpu_torch.train.incremental import incremental_update

        cfg = self.config
        dirs = discover_spool_dirs(cfg.spool_dir)
        consumed_pairs = self._replayed_pairs()
        new_pairs = dict(consumed_pairs)
        fresh: List[dict] = []
        for d in dirs:
            pairs = read_late_pairs(os.path.join(d, LATE_LABELS_FILE))
            if not pairs:
                continue
            key = spool_dir_key(d)
            done = min(consumed_pairs.get(key, 0), len(pairs))
            new_pairs[key] = len(pairs)
            fresh.extend(pairs[done:])
        if self._ring is not None and not cfg.pre_routed and fresh:
            # Sharded plane: train only the rows this shard's ring slice
            # owns. The pair cursor still counts ALL pairs — each shard's
            # replay chain is shard-tagged, so siblings keep their own.
            from photon_tpu_torch.stream.shard_router import owned_records

            fresh = owned_records(
                fresh, self._ring, cfg.shard_index, cfg.route_re_type
            )
        if len(fresh) < max(1, cfg.late_replay_min_pairs):
            return None
        faults.check("stream.replay", label="train")
        reg = registry()
        t_train = time.monotonic()
        batch = records_to_batch(
            fresh, self.index_maps, self.entity_indexes, intern=True,
            device=cfg.device,
        )
        cursors = self.consumed_per_spool()
        multi = len(dirs) > 1 or is_spool_glob(cfg.spool_dir)
        late_block: Dict = {"pairs": new_pairs, "records": len(fresh)}
        if cfg.num_shards > 1:
            # Shard-granular cursor tag (see _replayed_pairs): the replay
            # block names its owner so sibling shards' cursor walks skip it
            # no matter how the outer block is interpreted.
            late_block["shard"] = {
                "index": cfg.shard_index,
                "of": cfg.num_shards,
            }
        stream_info: Dict = {
            _CURSOR_KEY: max(cursors.values(), default=0),
            "lateReplay": late_block,
        }
        if multi:
            stream_info[_PER_SPOOL_KEY] = cursors
        if cfg.num_shards > 1:
            stream_info["shard"] = {
                "index": cfg.shard_index,
                "of": cfg.num_shards,
            }
        serialize = cfg.serialize_publish
        if serialize is None:
            serialize = cfg.num_shards > 1
        result = incremental_update(
            cfg.publish_root,
            batch,
            self.index_maps,
            self.entity_indexes,
            cfg.task,
            cfg.coordinate_configs,
            cfg.update_sequence,
            locked_coordinates=list(cfg.locked_coordinates),
            num_iterations=cfg.num_iterations,
            metric_tolerance=cfg.metric_tolerance,
            norm_drift_bound=cfg.norm_drift_bound,
            re_convergence_tol=cfg.re_convergence_tol,
            emit_delta=bool(cfg.delta_artifacts),
            extra_manifest={"stream": stream_info},
            serialize_publish=bool(serialize),
            device=cfg.device,
            **self._re_spill_kwargs(),
        )
        self._train_s += time.monotonic() - t_train
        if result.published:
            self._publishes += 1
            self._replay_publishes += 1
            self._records_trained += len(fresh)
            reg.counter("stream_late_replays_total").inc()
            reg.counter("stream_late_replayed_pairs_total").inc(len(fresh))
            # The recovered cohort is scored-and-labelled — measure it, so
            # the correction's lift is attributable in the quality plane.
            self._observe_quality(fresh)
            logger.info(
                "late-label replay published %s: %d recovered pairs",
                result.generation, len(fresh),
            )
        else:
            reg.counter("stream_gate_rejects_total").inc()
            logger.warning(
                "late-label replay generation %s refused by the gate (%s); "
                "pairs stay unconsumed and retry next cadence",
                result.generation, result.gate_reason,
            )
        return CycleResult(
            generation=result.generation,
            published=result.published,
            is_delta=result.is_delta,
            gate_reason=result.gate_reason,
            segments=[],
            records=len(fresh),
            consumed_through=max(cursors.values(), default=0),
            staleness_s=None,
        )

    # -- FE-drift trigger scaffold ----------------------------------------

    def fe_age_s(self) -> Optional[float]:
        """Age of the locked fixed effect: seconds since the most recent
        lineage generation that actually persisted FE coefficients (a full
        publish, or a delta with ``include_fixed``). Delta layers from the
        streaming plane lock the FE, so under pure streaming this only
        grows — the drift signal the retrain trigger watches. None when
        there is no published lineage yet."""
        from photon_tpu_torch.cli.game_serving import resolve_model_dir
        from photon_tpu_torch.io.model_io import (
            FIXED_DIR,
            load_generation_manifest,
        )

        root = self.config.publish_root
        cur = resolve_model_dir(root)
        if cur == root:
            return None
        for _ in range(128):
            fe_dir = os.path.join(cur, FIXED_DIR)
            if os.path.isdir(fe_dir) and os.listdir(fe_dir):
                manifest = load_generation_manifest(cur) or {}
                born = manifest.get("createdAt")
                if born is None:
                    try:
                        born = os.path.getmtime(cur)
                    except OSError:
                        return None
                return max(0.0, time.time() - float(born))
            manifest = load_generation_manifest(cur) or {}
            parent = manifest.get("parent")
            if not parent:
                return None
            cur = os.path.join(root, parent)
            if not os.path.isdir(cur):
                return None
        return None

    def _observe_fe_age(self, reg) -> None:
        """Feed the ``fe_age_s`` objective (same multi-window burn
        machinery as staleness) and raise ``stream_fe_retrain_wanted``
        while the locked FE is past its age bar. With ``fe_retrain`` on the
        raised gauge actuates a cooldown-guarded FE full retrain instead of
        just asking for one."""
        age = self.fe_age_s()
        if age is None:
            return
        reg.gauge("stream_fe_age_s").set(age)
        self.slo.record_fe_age(age)
        wanted = 1.0 if age > float(self.config.fe_max_age_s) else 0.0
        reg.gauge("stream_fe_retrain_wanted").set(wanted)
        if wanted:
            logger.warning(
                "locked fixed effect is %.0fs old (bar %.0fs): "
                "stream_fe_retrain_wanted raised", age,
                self.config.fe_max_age_s,
            )
            self._maybe_fe_retrain(reg, age)

    def _maybe_fe_retrain(self, reg, age: float) -> None:
        """Actuate the raised retrain-wanted gauge: cooldown-guarded, floor
        on accumulated records, contained. The cooldown stamp is taken
        BEFORE the attempt so a failing retrain cannot hot-loop — it burns
        its cooldown like a successful one and the failure is counted."""
        cfg = self.config
        if not cfg.fe_retrain:
            return
        now = time.monotonic()
        if (
            self._last_fe_retrain is not None
            and now - self._last_fe_retrain < cfg.fe_retrain_cooldown_s
        ):
            return
        recs = list(self._fe_recent)
        if len(recs) < max(1, cfg.fe_retrain_min_records):
            return
        self._last_fe_retrain = now
        try:
            self._run_fe_retrain(reg, recs, age)
        except Exception:  # noqa: BLE001 — actuation containment
            reg.counter("stream_fe_retrain_failures_total").inc()
            logger.exception(
                "FE full retrain failed; cooldown %.0fs still applies",
                cfg.fe_retrain_cooldown_s,
            )

    def _run_fe_retrain(self, reg, recs: List[dict], age: float) -> None:
        """One FE full-retrain generation: the recent-record window trains
        with the fixed-effect coordinates UNLOCKED and publishes full
        (``emit_delta=False``) so the new generation persists FE
        coefficients — which is exactly what resets ``fe_age_s`` and drops
        the wanted gauge. Same gate, same manifest-as-cursor discipline
        (segment cursors carry forward; no segments are consumed here)."""
        from photon_tpu_torch.train.incremental import incremental_update

        cfg = self.config
        fe_ids = {
            getattr(c, "coordinate_id", None)
            for c in cfg.coordinate_configs
            if getattr(c, "re_type", None) is None
        }
        locked = [c for c in cfg.locked_coordinates if c not in fe_ids]
        batch = records_to_batch(
            recs, self.index_maps, self.entity_indexes, intern=True,
            device=cfg.device,
        )
        cursors = self.consumed_per_spool()
        multi = (
            len(discover_spool_dirs(cfg.spool_dir)) > 1
            or is_spool_glob(cfg.spool_dir)
        )
        stream_info: Dict = {
            _CURSOR_KEY: max(cursors.values(), default=0),
            "feRetrain": {"records": len(recs), "ageS": round(age, 3)},
        }
        if multi:
            stream_info[_PER_SPOOL_KEY] = cursors
        if cfg.num_shards > 1:
            stream_info["shard"] = {
                "index": cfg.shard_index,
                "of": cfg.num_shards,
            }
        serialize = cfg.serialize_publish
        if serialize is None:
            serialize = cfg.num_shards > 1
        t_train = time.monotonic()
        result = incremental_update(
            cfg.publish_root,
            batch,
            self.index_maps,
            self.entity_indexes,
            cfg.task,
            cfg.coordinate_configs,
            cfg.update_sequence,
            locked_coordinates=locked,
            num_iterations=cfg.num_iterations,
            metric_tolerance=cfg.metric_tolerance,
            norm_drift_bound=cfg.norm_drift_bound,
            re_convergence_tol=cfg.re_convergence_tol,
            emit_delta=False,
            extra_manifest={"stream": stream_info},
            serialize_publish=bool(serialize),
            device=cfg.device,
            **self._re_spill_kwargs(),
        )
        self._train_s += time.monotonic() - t_train
        if result.published:
            self._publishes += 1
            self._fe_retrains += 1
            reg.counter("stream_fe_retrains_total").inc()
            reg.gauge("stream_fe_retrain_wanted").set(0.0)
            logger.info(
                "FE full retrain published %s (%d records, FE was %.0fs "
                "old)", result.generation, len(recs), age,
            )
        else:
            reg.counter("stream_gate_rejects_total").inc()
            logger.warning(
                "FE retrain generation %s refused by the gate (%s)",
                result.generation, result.gate_reason,
            )

    # -- driver loop -------------------------------------------------------

    def run_forever(self, max_cycles: Optional[int] = None) -> int:
        """Poll-train-publish until :meth:`stop` (or ``max_cycles``
        publishes/attempts). Solver or IO failures inside one cycle are
        contained and counted — the loop survives to retry with the same
        unconsumed segments."""
        from photon_tpu_torch.obs.metrics import registry

        done = 0
        while not self._stop.is_set():
            try:
                result = self.run_once()
            except Exception:  # noqa: BLE001 — cycle containment
                registry().counter("stream_cycle_failures_total").inc()
                self.slo.record_event("update_cycle", False)
                logger.exception("streaming update cycle failed; retrying")
                result = None
            self.maybe_replay_late_labels()
            self.slo.publish_metrics()
            if result is not None:
                done += 1
                if max_cycles is not None and done >= max_cycles:
                    break
            self._stop.wait(self.config.cadence_s)
        return done

    def stop(self) -> None:
        self._stop.set()

    def stats(self) -> dict:
        out = {
            "cycles": self._cycles,
            "publishes": self._publishes,
            "consumed_through": self.consumed_through(),
            "busy_s": self._busy_s,
            "train_s": self._train_s,
            "records_trained": self._records_trained,
            "late_replays": self._replay_publishes,
            "fe_retrains": self._fe_retrains,
            "slo": self.slo.snapshot(),
            "quality": self.quality.snapshot(),
        }
        if self.config.num_shards > 1:
            out["shard"] = {
                "index": self.config.shard_index,
                "of": self.config.num_shards,
            }
        return out
