"""Online GAME serving engine: micro-batched scoring with zero-downtime model
reload (port of photon_tpu/serve/engine.py).

A :class:`~photon_tpu_torch.serve.batcher.MicroBatcher` admits and batches
requests, a :class:`~photon_tpu_torch.serve.store.HotColdEntityStore`
resolves entity ids to device-resident coefficient rows, and the batch
scorer's own model scoring (``GameTransformer``, models/game.py) produces
the scores, so a served score equals the batch driver's.

No capture or allocation after warm-up (the reference's "zero retraces"):

1. at warm-up each resident version captures ONE CUDA graph for each row
   bucket of ``bucket_grid(max_batch_size)``, over static input buffers of
   its own (features, entity slots, offsets) and the store's tables;
2. a live batch is assembled on the host, copied through pinned memory into
   its bucket's buffers (padding rows: zero features, entity -1) and the
   bucket's graph replayed;
3. a hot-store upload writes the tables' VALUES (``index_copy_``), so a
   promotion never moves a tensor a graph reads; a reload builds a new
   version with its own store and graphs.

``retraces_since_warmup`` counts graph captures after warm-up plus the
caching allocator's new segments since the last warm-up ended
(``torch.cuda.memory_stats()["segment.all.allocated"]``), summed over the
resident versions; 0 is the contract. On the CPU the same code runs
eagerly, and the counter counts row buckets first scored after warm-up.
Every CUDA call of the scoring path and every capture holds
``solve_cache.CAPTURE_LOCK``, so a capture (a reload's, or a training run's
in the same process) never sees another thread's CUDA work.

Reload is build-then-swap: the incoming model gets its own store, graphs and
warm-up while the old version serves; the swap happens under the engine's
lock. A failed build leaves the old version serving (:class:`ReloadError`,
``stats()['last_reload_error']``). Each RE type has a circuit breaker:
repeated ``resolve`` failures trip it, and its entities then resolve to -1
(fixed-effect-only scores on the warmed graphs) until a cooldown half-opens
it.

The reference's metrics and spans are published to the metrics registry and
the tracer (``stats()["counts"]`` carries the engine's counts too), and an
SLO tracker takes every completed request; ``stats()`` has its ``slo``
block. With a feedback spool attached (:meth:`ServingEngine.attach_feedback`),
every scored primary request, its score already on the host, is offered to
the spool's label join; each completed join feeds the model-quality plane
(``obs/quality.py``), and :meth:`ServingEngine.enable_quality_baseline`
re-scores labelled traffic on a pinned resident version so the ``quality``
block of ``stats()`` measures lift between two online curves.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_tpu_torch.algorithm.solve_cache import CAPTURE_LOCK
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.data.padding import bucket_grid
from photon_tpu_torch.data.random_effect import bucket_dim
from photon_tpu_torch.estimators.game_transformer import GameTransformer
from photon_tpu_torch.models.game import GameModel
from photon_tpu_torch.obs.export import exporter_health
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.obs.quality import QualityConfig, QualityPlane, task_name
from photon_tpu_torch.obs.report import telemetry_sink_health
from photon_tpu_torch.obs.slo import SLOTracker
from photon_tpu_torch.obs.trace import flight_recorder, tracer
from photon_tpu_torch.serve.admission import INTERACTIVE, AdmissionConfig, AdmissionController
from photon_tpu_torch.serve.batcher import MicroBatcher, ScoreRequest
from photon_tpu_torch.serve.store import HotColdEntityStore, StorePartition
from photon_tpu_torch.utils import faults, resources

logger = logging.getLogger(__name__)

__all__ = ["ReloadError", "ScoreRequest", "ServeConfig", "ServingEngine", "load_engine"]


class ReloadError(RuntimeError):
    """A reload failed to build or warm the new version. The old version is
    still serving: the error is a report, not an outage."""


@dataclasses.dataclass
class ServeConfig:
    max_batch_size: int = 64  # rounded UP onto the bucket_dim grid
    max_delay_ms: float = 2.0  # the oldest request's longest queue dwell
    queue_cap: int = 1024  # admission bound; beyond it submits shed
    hot_bytes: int = 64 << 20  # device budget for cached RE tables
    default_deadline_ms: Optional[float] = None  # per request unless given
    breaker_threshold: int = 3  # consecutive resolve failures to trip
    breaker_cooldown_s: float = 30.0  # open duration before a half-open probe
    admission: Optional[AdmissionConfig] = None  # per-tenant quotas and classes
    max_versions: int = 2  # resident versions (primary + candidates)
    shadow_fraction: float = 0.0  # of primary traffic re-scored on a shadow
    # Of label-joined records re-scored on EACH shadow candidate (its
    # online-quality lane); 1.0 gives every candidate a dense stream.
    shadow_quality_fraction: float = 1.0
    # A promotion is settled (rollback parent unpinned, breaker-trip window
    # closed) this many seconds after promote(); <= 0 keeps the parent
    # pinned until the next promote or rollback.
    promotion_settle_s: float = 300.0
    # Split every dense hot table into this many entity segments by the
    # sharded trainer's plan (parallel/entity_shard.py), on the engine's
    # device. None: one table a coordinate.
    device_shards: Optional[int] = None
    device: str = "cuda"


class _Breaker:
    """Per-RE-type circuit breaker (single writer: the engine's lock)."""

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self.failures = 0
        self.open_until = 0.0
        self.trips = 0

    @property
    def open(self) -> bool:
        return time.monotonic() < self.open_until

    def record_failure(self) -> bool:
        """Count one failure; True when it trips the breaker (the threshold
        reached, or a failed half-open probe after a cooldown)."""
        half_open_probe = self.open_until > 0.0 and not self.open
        self.failures += 1
        if half_open_probe or self.failures >= self.threshold:
            self.open_until = time.monotonic() + self.cooldown_s
            self.failures = 0
            self.trips += 1
            return True
        return False

    def record_success(self) -> None:
        self.failures = 0
        self.open_until = 0.0


def _segments(device: torch.device) -> int:
    """Allocator segments allocated so far on ``device`` (0 on the CPU)."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get("segment.all.allocated", 0))


class _Bucket:
    """One row bucket's static inputs (device, and pinned host mirrors),
    its output, and on the card its CUDA graph."""

    def __init__(self, rows: int, shard_dims: Dict[str, int], re_types: Sequence[str], device: torch.device):
        pin = device.type == "cuda"
        host = lambda shape, dt: torch.zeros(shape, dtype=dt, pin_memory=pin)  # noqa: E731
        self.rows = rows
        self.h_feats = {s: host((rows, d), torch.float32) for s, d in shard_dims.items()}
        self.h_ids = {rt: host((rows,), torch.int32) for rt in re_types}
        self.h_offset = host((rows,), torch.float32)
        self.h_out = host((rows,), torch.float32)
        self.batch = GameBatch(
            label=torch.zeros(rows, device=device), offset=torch.zeros(rows, device=device),
            weight=torch.ones(rows, device=device),
            features={s: torch.zeros((rows, d), device=device) for s, d in shard_dims.items()},
            entity_ids={rt: torch.full((rows,), -1, dtype=torch.int32, device=device) for rt in re_types})
        self.out: Optional[torch.Tensor] = None
        self.graph = None

    def load(self, feats: Dict[str, np.ndarray], ids: Dict[str, np.ndarray], offset: np.ndarray) -> None:
        """The assembled rows into the pinned mirrors (padding rows inert:
        zero features and offset, entity -1), then into the device
        buffers."""
        n = offset.shape[0]
        for s, h in self.h_feats.items():
            a = h.numpy()
            a[:n] = feats[s]
            a[n:] = 0.0
        for rt, h in self.h_ids.items():
            a = h.numpy()
            a[:n] = ids[rt]
            a[n:] = -1
        o = self.h_offset.numpy()
        o[:n] = offset
        o[n:] = 0.0
        b = self.batch
        for s, h in self.h_feats.items():
            b.features[s].copy_(h, non_blocking=True)
        for rt, h in self.h_ids.items():
            b.entity_ids[rt].copy_(h, non_blocking=True)
        b.offset.copy_(self.h_offset, non_blocking=True)


class _Scorer:
    """One version's scorer over its store's tables: a CUDA graph a row
    bucket on the card, the same steps eagerly on the CPU."""

    def __init__(self, store: HotColdEntityStore, shard_dims: Dict[str, int], device: torch.device):
        self.store, self.device = store, device
        self.shard_dims = dict(shard_dims)
        self.transformer = GameTransformer(store.scoring_model())
        self.buckets: Dict[int, _Bucket] = {}
        self.warm = False
        self.captures = 0  # graphs captured (and, on the CPU, buckets first scored)
        self.captures_after_warmup = 0
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.info: Dict[str, object] = {}

    def _bucket(self, rows: int) -> _Bucket:
        b = self.buckets.get(rows)
        if b is not None:
            return b
        b = self.buckets[rows] = _Bucket(rows, self.shard_dims, self.store.entity_re_types, self.device)
        self.captures += 1
        if self.warm:
            self.captures_after_warmup += 1
            logger.warning("serving: row bucket %d first seen after warm-up", rows)
        if self.device.type == "cuda":
            with CAPTURE_LOCK, torch.cuda.device(self.device):
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):  # warm-up: plans, library handles
                    self.transformer.transform(b.batch)
                torch.cuda.current_stream(self.device).wait_stream(side)
                b.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(b.graph, pool=self.pool):
                    b.out = self.transformer.transform(b.batch)
        return b

    def warm_up(self, max_batch: int) -> None:
        t0 = time.perf_counter()
        for rows in bucket_grid(max_batch):
            self._bucket(rows)
        self.warm = True
        self.info = dict(warm_up_s=time.perf_counter() - t0, graphs=len(self.buckets) if self.pool else 0,
                         buckets=sorted(self.buckets))

    def score(self, feats: Dict[str, np.ndarray], ids: Dict[str, np.ndarray], offset: np.ndarray) -> np.ndarray:
        n = offset.shape[0]
        b = self._bucket(bucket_dim(n))
        b.load(feats, ids, offset)
        if b.graph is not None:
            b.graph.replay()
            b.h_out.copy_(b.out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            return b.h_out.numpy()[:n].copy()
        return self.transformer.transform(b.batch).numpy()[:n].copy()


@dataclasses.dataclass
class _State:
    """Everything that swaps at once on a reload."""

    store: HotColdEntityStore
    scorer: _Scorer
    model_version: str


def _features_from_json(features: Dict) -> Dict:
    """Inverse of the spool's ``_jsonable_features``: dicts pass through,
    (indices, values) pairs become sparse tuples, dense lists float32
    vectors (the shapes ``_dense_row`` takes)."""
    out: Dict[str, object] = {}
    for shard, val in (features or {}).items():
        if isinstance(val, dict):
            out[shard] = val
        elif isinstance(val, (list, tuple)) and len(val) == 2 and isinstance(val[0], (list, tuple)):
            out[shard] = (np.asarray(val[0], np.int64), np.asarray(val[1], np.float32))
        else:
            out[shard] = np.asarray(val, np.float32)
    return out


def _model_task(model: GameModel):
    """The GLM task of the model (the quality plane's link): the first
    task found on any coordinate."""
    for m in getattr(model, "models", {}).values():
        task = getattr(m, "task", None) or getattr(getattr(m, "model", None), "task", None)
        if task is not None:
            return task
    return None


class _ShadowLane:
    """Per-candidate shadow accounting: its traffic fraction, its own
    fractional-sampling accumulator (the N-way split stays exact and
    RNG-free) and its own divergence record."""

    __slots__ = ("fraction", "acc", "count", "div_sum", "div_max", "samples", "quality_acc", "started_at", "seq")

    def __init__(self, fraction: float, seq: int):
        self.fraction = float(fraction)
        self.acc = 0.0
        self.quality_acc = 0.0  # label re-score accumulator (quality lane)
        self.count = 0
        self.div_sum = 0.0
        self.div_max = 0.0
        self.samples: deque = deque(maxlen=256)
        self.started_at = time.time()
        self.seq = seq  # start order; the newest answers the single-shadow API

    def stats(self, version: str) -> Dict:
        return dict(version=version, fraction=self.fraction, count=self.count, max_divergence=self.div_max,
                    mean_divergence=self.div_sum / self.count if self.count else 0.0)


class ServingEngine:
    """In-process serving core; cli/game_serving.py adds the HTTP front end.

    ``model`` is the HOST master (``load_resolved_game_model(...,
    to_device=False)``): the store decides what lives on the device,
    ``config.device`` (cuda unless the caller asks for the CPU).
    """

    def __init__(self, model: GameModel, entity_indexes: Optional[Dict[str, EntityIndex]] = None,
                 index_maps: Optional[Dict[str, IndexMap]] = None, config: Optional[ServeConfig] = None,
                 model_version: str = "0", partition: Optional[StorePartition] = None):
        self.config = config or ServeConfig()
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("serving on cuda needs a CUDA card; pass ServeConfig(device='cpu') for the CPU")
        self.max_batch = bucket_dim(int(self.config.max_batch_size))
        self._partition = partition
        self._entity_indexes = dict(entity_indexes or {})
        self._index_maps = dict(index_maps or {})
        self._shard_dims = model.feature_shard_dims()
        self._intercept_col = {shard: (self._index_maps[shard].get_index(IndexMap.INTERCEPT)
                                       if shard in self._index_maps else -1) for shard in self._shard_dims}
        self._lock = threading.RLock()
        self._reloads = 0
        self._reload_failures = 0
        self._last_reload_error: Optional[str] = None
        self._breakers: Dict[str, _Breaker] = {}
        self.counts: "collections.Counter" = collections.Counter()
        self.admission = AdmissionController(self.config.admission)
        self._segments_mark = 0
        state = self._build_state(model, model_version)
        self._states: Dict[str, _State] = {state.model_version: state}
        self._primary: str = state.model_version
        self._shadows: Dict[str, _ShadowLane] = {}
        self._shadow_seq = 0
        self._shadow_fraction = float(self.config.shadow_fraction)
        self._promotion: Optional[Dict] = None
        # Feedback spool (streaming freshness loop): when attached, every
        # scored primary request is offered to the spool's label join.
        self._feedback = None
        # SLO plane: availability and latency fed per completion, staleness
        # sampled against the last primary change.
        self.slo = SLOTracker()
        # Model-quality plane: streaming AUC/calibration over the spool's
        # joined (score, label) pairs, keyed by (model_version, tenant,
        # re_type); ``enable_quality_baseline`` adds the frozen-baseline lane.
        self.quality = QualityPlane(QualityConfig(task=task_name(_model_task(model))))
        self._quality_baseline: Optional[str] = None
        self._quality_fraction = 1.0
        self._quality_acc = 0.0  # fractional-sampling accumulator
        self._last_model_update = time.time()
        self.batcher = MicroBatcher(self._score_batch, max_batch_size=self.max_batch,
                                    max_delay_s=self.config.max_delay_ms / 1000.0, queue_cap=self.config.queue_cap)

    # -- state construction (startup and reload share it) -------------------

    def _build_state(self, model: GameModel, version: str) -> _State:
        """Store, scorer and the FULL warm-up of one version, off the
        engine's lock. A device OOM releases the partial build and retries
        once; a second one raises ``DeviceMemoryError``."""

        def build() -> _State:
            faults.check("serve.warm_up", label=version)
            store = HotColdEntityStore(model, self._entity_indexes, hot_bytes=self.config.hot_bytes,
                                       min_hot_rows=self.max_batch, partition=self._partition,
                                       device_shards=self.config.device_shards, device=self.device)
            return self._warm(store, version)

        with tracer().span("serve/warm_up"):
            try:
                return resources.oom_retry(build, site="serve.warm_up", counter="serve_warmup_oom_retries_total")
            except Exception as exc:
                if not resources.is_device_oom(exc):
                    raise
                raise resources.DeviceMemoryError(
                    f"serve engine: device OOM warming up model version {version!r} even after retry. Shrink "
                    "--hot-bytes-mb or --max-batch-size, evict serving versions, or add device memory.") from exc

    def _warm(self, store: HotColdEntityStore, version: str) -> _State:
        store.warm_uploads(self.max_batch)
        scorer = _Scorer(store, self._shard_dims, self.device)
        scorer.warm_up(self.max_batch)
        registry().gauge("serve_warmup_traces").set(scorer.captures)
        with self._lock:
            self._segments_mark = _segments(self.device)
        return _State(store, scorer, version)

    # -- request assembly ---------------------------------------------------

    def _dense_row(self, shard: str, value) -> np.ndarray:
        """One request's feature payload → dense (d,) float32 (a dict of
        names or columns, an (indices, values) pair, or a dense vector,
        taken verbatim). Serving always densifies."""
        d = self._shard_dims[shard]
        row = np.zeros(d, np.float32)
        icpt = self._intercept_col.get(shard, -1)
        if icpt >= 0:
            row[icpt] = 1.0
        if value is None:
            return row
        if isinstance(value, dict):
            imap = self._index_maps.get(shard)
            for k, v in value.items():
                if isinstance(k, str):
                    if imap is None:
                        raise ValueError(f"string feature keys need an index map for shard {shard!r}")
                    j = imap.get_index(k)
                else:
                    j = int(k)
                if 0 <= j < d:
                    row[j] = v  # unknown features drop (batch-path parity)
            return row
        if (isinstance(value, (tuple, list)) and len(value) == 2 and not np.isscalar(value[0])
                and np.ndim(value[0]) == 1 and np.ndim(value[1]) == 1 and len(value[0]) == len(value[1])
                and len(value[0]) != d):
            idx = np.asarray(value[0], np.int64)
            vals = np.asarray(value[1], np.float32)
            ok = (idx >= 0) & (idx < d)
            row[idx[ok]] = vals[ok]
            return row
        arr = np.asarray(value, np.float32)
        if arr.shape != (d,):
            raise ValueError(f"shard {shard!r} expects a ({d},) vector, got {arr.shape}")
        return arr

    def _assemble(self, requests: List[ScoreRequest], store: HotColdEntityStore):
        feats = {shard: np.stack([self._dense_row(shard, r.features.get(shard)) for r in requests])
                 for shard in self._shard_dims}
        ids = {}
        for rt in store.entity_re_types:
            keys = [r.entity_ids.get(rt, -1) for r in requests]
            slots, degraded = self._resolve_guarded(store, rt, keys)
            ids[rt] = slots
            if degraded:
                for r in requests:
                    r.degraded = True
            elif self._partition is not None and self._partition.applies_to(rt):
                for r, key in zip(requests, keys):
                    if key != -1 and not self._partition.owns(key):
                        r.degraded = True
        return feats, ids, np.asarray([r.offset for r in requests], np.float32)

    def _breaker(self, re_type: str) -> _Breaker:
        b = self._breakers.get(re_type)
        if b is None:
            b = self._breakers[re_type] = _Breaker(self.config.breaker_threshold, self.config.breaker_cooldown_s)
        return b

    def _resolve_guarded(self, store: HotColdEntityStore, re_type: str, keys: List) -> tuple:
        """``store.resolve`` behind the type's breaker; an open breaker or a
        failed resolve degrades this batch's type to -1 (fixed-effect only).
        Returns (slots, degraded)."""
        breaker = self._breaker(re_type)
        if breaker.open:
            self._count("degraded_requests", re_type, len(keys))
            return np.full(len(keys), -1, np.int32), True
        try:
            slots = store.resolve(re_type, keys)
        except Exception as exc:  # noqa: BLE001 — degrade, never crash
            self._count("store_errors", re_type)
            if breaker.record_failure():
                registry().counter("serve_breaker_trips_total", re_type=re_type).inc()
                logger.warning("serving: circuit breaker for RE type %r OPEN for %.1fs after resolve failure: %s",
                               re_type, breaker.cooldown_s, exc)
            else:
                logger.warning("serving: resolve failed for RE type %r (%d/%d to breaker trip): %s", re_type,
                               breaker.failures, breaker.threshold, exc)
            self._count("degraded_requests", re_type, len(keys))
            return np.full(len(keys), -1, np.int32), True
        breaker.record_success()
        return slots, False

    # -- the batcher's score_fn --------------------------------------------

    @property
    def _state(self) -> _State:
        return self._states[self._primary]

    def _resolve_version(self, pin: Optional[str]) -> str:
        """A version pin → resident key: exact, else by basename; unknown
        pins raise ValueError (HTTP 400)."""
        if pin is None:
            return self._primary
        pin = str(pin)
        if pin in self._states:
            return pin
        for key in self._states:
            if os.path.basename(str(key).rstrip("/")) == pin:
                return key
        raise ValueError(f"unknown model version {pin!r}; resident: {sorted(self.versions)}")

    def _score_on(self, state: _State, requests: List[ScoreRequest]) -> np.ndarray:
        with tracer().span("score"):
            faults.check("serve.score")
            with CAPTURE_LOCK:
                feats, ids, offset = self._assemble(requests, state.store)
                return state.scorer.score(feats, ids, offset)

    def _score_batch(self, requests: List[ScoreRequest]) -> Sequence[float]:
        with self._lock:  # against promote/reload swaps; resolve is single-writer
            out = np.zeros(len(requests), np.float32)
            groups: Dict[str, List[int]] = {}
            for i, r in enumerate(requests):
                key = r.model_version or self._primary
                if key not in self._states:
                    # A pin evicted between submit and flush: the primary answers.
                    self._count("pin_fallbacks")
                    logger.warning("serving: pinned version %r evicted before flush; scoring on primary %r", key,
                                   self._primary)
                    key = self._primary
                    r.degraded = True
                r.model_version = key  # the version that actually scores it
                groups.setdefault(key, []).append(i)
            for key, idxs in groups.items():
                sub = [requests[i] for i in idxs]
                scores = self._score_on(self._states[key], sub)
                out[idxs] = scores
                if key == self._primary:
                    if self._shadows:
                        self._maybe_shadow_score(sub, scores)
                    if self._feedback is not None:
                        self._record_feedback(sub, scores)
            return out

    def _record_feedback(self, requests: List[ScoreRequest], scores: np.ndarray) -> None:
        """Land scored primary requests (their scores already on the host)
        in the feedback spool's label join. A spool failure counts and never
        reaches the caller or the scoring path."""
        spool = self._feedback
        if spool is None:
            return
        try:
            for r, s in zip(requests, scores):
                if r.uid is None:
                    continue  # no join key: the label could never match
                spool.observe_scored(uid=r.uid, features=r.features, entity_ids=r.entity_ids, offset=r.offset,
                                     score=float(s), model_version=r.model_version,
                                     tenant=getattr(r, "tenant", None), trace=getattr(r, "trace", None))
        except Exception as exc:  # noqa: BLE001 — feedback never hurts callers
            registry().counter("feedback_errors_total").inc()
            logger.warning("serving: feedback spool observe failed: %s", exc)

    def _maybe_shadow_score(self, requests: List[ScoreRequest], primary_scores: np.ndarray) -> None:
        """Re-score a deterministic fraction of primary traffic on each
        shadow lane, recording divergence; responses are untouched and a
        shadow failure is "no sample". The fault site
        ``serve.shadow_diverge`` (label: the candidate's basename) perturbs
        a lane's scores."""
        reg = registry()
        for key, lane in list(self._shadows.items()):
            if key not in self._states:
                continue
            take: List[int] = []
            for i in range(len(requests)):
                lane.acc += lane.fraction
                if lane.acc >= 1.0:
                    lane.acc -= 1.0
                    take.append(i)
            if not take:
                continue
            short = os.path.basename(key.rstrip("/"))
            try:
                shadow = np.asarray(self._score_on(self._states[key], [requests[i] for i in take]), np.float32)
            except Exception as exc:  # noqa: BLE001 — never hurts callers
                self._count("shadow_errors", short)
                logger.warning("serving: shadow scoring on %r failed: %s", key, exc)
                continue
            if faults.injector().fire("serve.shadow_diverge", label=short) is not None:
                shadow = shadow + 1.0
            # The candidate label keeps concurrent lanes' series apart.
            hist = reg.histogram("serve_shadow_divergence", model_version=short)
            for j, i in enumerate(take):
                p, s = float(primary_scores[i]), float(shadow[j])
                div = abs(s - p)
                hist.observe(div)
                lane.count += 1
                lane.div_sum += div
                lane.div_max = max(lane.div_max, div)
                lane.samples.append(dict(uid=requests[i].uid, primary=p, shadow=s, divergence=div))
            self._count("shadow_scored", short, len(take))

    # -- public API ---------------------------------------------------------

    def submit(self, request: ScoreRequest, deadline_s: Optional[float] = None, tenant: Optional[str] = None,
               priority: str = INTERACTIVE, model_version: Optional[str] = None):
        """Admit (quota and priority class), then enqueue. Shed requests
        raise on THIS thread (``QuotaExceededError``/``BackpressureError``,
        HTTP 429); admitted ones return a Future. ``model_version`` (or
        ``request.model_version``) pins a resident version; an unknown pin
        raises ValueError here."""
        pin = model_version or request.model_version
        if pin is not None:
            with self._lock:
                request.model_version = self._resolve_version(pin)
        if tenant is not None:
            request.tenant = tenant
        if deadline_s is None and self.config.default_deadline_ms is not None:
            deadline_s = self.config.default_deadline_ms / 1000.0
        self.admission.admit(tenant, priority, queue_depth=self.batcher.queue_depth, queue_cap=self.config.queue_cap)
        t0 = time.monotonic()
        fut = self.batcher.submit(request, deadline_s, priority=priority)

        def _observe_done(f):
            dt = time.monotonic() - t0
            # A traced request stamps its trace id as an exemplar on the
            # tenant-latency histogram: the scrape's link to its span tree.
            tr = getattr(request, "trace", None)
            tid = tr.get("traceId") if isinstance(tr, dict) else None
            self.admission.observe_latency(tenant, dt, trace_id=tid)
            # SLO feed, host arithmetic only: availability (admitted
            # requests that errored), latency of successes, and staleness
            # against the last primary change.
            try:
                ok = f.exception() is None
            except Exception:  # noqa: BLE001 — a cancelled future counts bad
                ok = False
            self.slo.record_request(ok, dt if ok else None)
            self.slo.record_staleness(time.time() - self._last_model_update)

        fut.add_done_callback(_observe_done)
        return fut

    def score(self, features: Dict[str, object], entity_ids: Optional[Dict[str, object]] = None, offset: float = 0.0,
              deadline_s: Optional[float] = None, tenant: Optional[str] = None, priority: str = INTERACTIVE,
              model_version: Optional[str] = None) -> float:
        """One request, blocking."""
        return self.submit(ScoreRequest(features, dict(entity_ids or {}), offset), deadline_s, tenant=tenant,
                           priority=priority, model_version=model_version).result()

    @property
    def model_version(self) -> str:
        return self._primary

    @property
    def versions(self) -> List[str]:
        return list(self._states)

    @property
    def shadow_version(self) -> Optional[str]:
        """The most recently started shadow candidate (None without one)."""
        lane = self._newest_shadow_locked()
        return lane[0] if lane else None

    @property
    def shadow_versions(self) -> List[str]:
        """Every active shadow candidate, oldest lane first."""
        with self._lock:
            return sorted(self._shadows, key=lambda k: self._shadows[k].seq)

    def _newest_shadow_locked(self) -> Optional[Tuple[str, _ShadowLane]]:
        if not self._shadows:
            return None
        key = max(self._shadows, key=lambda k: self._shadows[k].seq)
        return key, self._shadows[key]

    @property
    def retraces_since_warmup(self) -> int:
        """0 is the contract: graph captures (CPU: new row buckets) after
        warm-up, summed over the resident versions, plus the allocator's
        new segments since the last warm-up ended."""
        with self._lock:
            captures = sum(s.scorer.captures_after_warmup for s in self._states.values())
            return captures + max(0, _segments(self.device) - self._segments_mark)

    def _total_trips(self) -> int:
        return sum(b.trips for b in self._breakers.values())

    def _maybe_settle_promotion_locked(self) -> None:
        """``promotion_settle_s`` after promote() the promotion is adopted:
        the rollback parent unpins and breaker trips stop counting."""
        promo = self._promotion
        settle = float(self.config.promotion_settle_s or 0.0)
        if promo is None or settle <= 0:
            return
        if time.time() - promo["at"] >= settle:
            self._promotion = None
            logger.info("serving: promotion of %r settled after %.0fs; parent %r no longer pinned", promo["version"],
                        settle, promo["parent"])

    def _evict_locked(self, protect: Optional[str] = None) -> None:
        """Drop the oldest versions beyond ``max_versions``; the primary,
        the shadows, the promotion's parent, the quality baseline and
        ``protect`` are never evicted (residency may exceed the cap
        instead)."""
        cap = max(int(self.config.max_versions), 1)
        self._maybe_settle_promotion_locked()
        keep = {self._primary, protect, self._quality_baseline}
        keep.update(self._shadows)
        if self._promotion is not None:
            keep.add(self._promotion["parent"])
        for key in list(self._states):
            if len(self._states) <= cap:
                break
            if key in keep:
                continue
            del self._states[key]
            logger.info("serving: evicted resident version %r", key)
        if len(self._states) > cap:
            logger.warning("serving: %d versions resident over max_versions=%d (primary/shadow/rollback-parent/"
                           "loading are never evicted)", len(self._states), cap)

    def _install(self, new_state: _State, version: str) -> None:
        with self._lock:
            self._states[version] = new_state
            self._evict_locked(protect=version)
            resident = version in self._states
        if not resident:  # backstop: _evict_locked protects it
            self._reload_failures += 1
            registry().counter("serve_reload_failures_total").inc()
            self._last_reload_error = f"{version}: evicted during load"
            raise ReloadError(f"reload to {version!r} failed: evicted during load")
        self._last_reload_error = None

    def _failed(self, version: str, exc: BaseException, what: str):
        self._reload_failures += 1
        registry().counter("serve_reload_failures_total").inc()
        self._last_reload_error = f"{version}: {exc}"
        logger.warning("serving: %s of %r failed (%s); resident versions unchanged", what, version, exc)
        return ReloadError(f"{what} to {version!r} failed: {exc}")

    def load_version(self, model: GameModel, model_version: Optional[str] = None) -> Dict:
        """Build and warm ``model`` as a RESIDENT version without touching
        the primary; traffic can pin to it at once. A failed build raises
        :class:`ReloadError` and changes nothing resident."""
        self._reloads += 1
        version = model_version or f"reload-{self._reloads}"
        t0 = time.perf_counter()
        try:
            faults.check("serve.reload")
            new_state = self._build_state(model, version)
        except Exception as exc:  # noqa: BLE001 — keep serving what we have
            raise self._failed(version, exc, "reload") from exc
        build_s = time.perf_counter() - t0
        self._install(new_state, version)
        self._count("reloads")
        return dict(model_version=version, store=new_state.store.stats(), build_s=build_s,
                    warm_up=dict(new_state.scorer.info))

    def load_delta_version(self, base_version: str, delta: Dict, model_version: str) -> Dict:
        """A delta micro-generation as a RESIDENT version: the delta
        (``io.model_io.read_delta_rows``) overlays a clone of a resident
        base's store (no disk load of the full model), and the clone gets
        its own graphs. :class:`ReloadError` when the base is not resident
        or the delta does not apply in place."""
        self._reloads += 1
        version = model_version
        try:
            faults.check("serve.reload")
            with self._lock:
                base_key = self._resolve_version(base_version)
                base_state = self._states[base_key]
                with tracer().span("serve/delta_apply"):
                    store = base_state.store.clone_with_delta(delta.get("re_rows") or {},
                                                              delta.get("fixed") or {})
            new_state = self._warm(store, version)
        except Exception as exc:  # noqa: BLE001 — keep serving what we have
            raise self._failed(version, exc, "delta load") from exc
        self._install(new_state, version)
        self._count("delta_loads")
        return dict(model_version=version, base=base_key, store=new_state.store.stats())

    def unload_version(self, model_version: str) -> bool:
        """Drop one resident version now, with its store and graphs; the
        primary, a shadow, the promotion's parent and the quality baseline
        stay. True when it was dropped."""
        with self._lock:
            self._maybe_settle_promotion_locked()
            try:
                key = self._resolve_version(model_version)
            except ValueError:
                return False
            keep = {self._primary, self._quality_baseline, *self._shadows}
            if self._promotion is not None:
                keep.add(self._promotion["parent"])
            if key in keep:
                return False
            del self._states[key]
        logger.info("serving: unloaded resident version %r", key)
        return True

    # -- feedback spool (streaming freshness loop) --------------------------

    def attach_feedback(self, spool) -> None:
        """Attach a :class:`~photon_tpu_torch.stream.spool.FeedbackSpool`:
        scored primary requests land in its label join and
        :meth:`feedback_label` completes it. The engine owns the spool from
        here (closed with the engine)."""
        self._feedback = spool
        # Every completed join also feeds the quality plane (called outside
        # the spool's lock; failures count, never raise).
        spool.on_join = self._on_feedback_join

    def feedback_label(self, uid: str, label: float, ts: Optional[float] = None) -> bool:
        """Report the observed label of a scored request; True when the
        joined record landed in the spool."""
        if self._feedback is None:
            raise ValueError("feedback spool not enabled on this engine")
        return self._feedback.observe_label(uid, label, ts)

    # -- model-quality plane (obs/quality.py) -------------------------------

    def enable_quality_baseline(self, model_version: str, fraction: float = 1.0) -> None:
        """Pin a resident version as the quality plane's FROZEN BASELINE: a
        deterministic ``fraction`` of labelled traffic is re-scored on it
        (a failure is "no sample"), so per-version lift is the difference of
        two measured curves over the same requests. The version stays
        resident while it is the baseline."""
        with self._lock:
            key = self._resolve_version(model_version)
        self._quality_baseline = key
        self._quality_fraction = float(fraction)
        self._quality_acc = 0.0
        self.quality.set_baseline(key)
        logger.info("serving: quality baseline pinned to %r (fraction %.3f)", key, fraction)

    def _on_feedback_join(self, rec: dict) -> None:
        """One joined (score, label) record → the quality plane, plus the
        frozen baseline's re-score when one is pinned."""
        ids = rec.get("entityIds") or {}
        re_type = ",".join(sorted(ids)) if ids else ""
        tenant = rec.get("tenant")
        trace_id = (rec.get("trace") or {}).get("traceId")
        label = float(rec.get("label") or 0.0)
        self.quality.observe(score=float(rec.get("score") or 0.0), label=label, model_version=rec.get("modelVersion"),
                             tenant=tenant, re_type=re_type, ts=rec.get("ts"), label_ts=rec.get("labelTs"),
                             trace_id=trace_id, slo=self.slo)
        rec_version = os.path.basename(str(rec.get("modelVersion") or "").rstrip("/"))
        self._candidate_quality_lanes(rec, label, tenant, re_type, trace_id, rec_version)
        base = self._quality_baseline
        if base is None:
            return
        if rec_version == os.path.basename(str(base).rstrip("/")):
            return  # the baseline scored it already
        self._quality_acc += self._quality_fraction
        if self._quality_acc < 1.0:
            return
        self._quality_acc -= 1.0
        try:
            score = self._baseline_score(rec, base)
        except Exception as exc:  # noqa: BLE001 — the lane never hurts callers
            registry().counter("quality_baseline_errors_total").inc()
            logger.warning("serving: baseline quality re-score on %r failed: %s", base, exc)
            return
        self.quality.observe(score=score, label=label, model_version=base, tenant=tenant, re_type=re_type,
                             ts=rec.get("ts"), label_ts=rec.get("labelTs"), trace_id=trace_id,
                             slo=self.slo)  # a no-op for the baseline key
        registry().counter("quality_baseline_scored_total").inc()

    def _candidate_quality_lanes(self, rec: dict, label: float, tenant, re_type: str, trace_id,
                                 rec_version: str) -> None:
        """Re-score one joined label on every shadow candidate and feed the
        quality plane under that candidate's version (no SLO feed: a bad
        candidate burns its own series, never the primary's gate)."""
        if not self._shadows:
            return
        frac = float(self.config.shadow_quality_fraction)
        if frac <= 0.0:
            return
        for key, lane in list(self._shadows.items()):
            short = os.path.basename(str(key).rstrip("/"))
            if short == rec_version:
                continue  # the candidate scored it already (pinned traffic)
            lane.quality_acc += frac
            if lane.quality_acc < 1.0:
                continue
            lane.quality_acc -= 1.0
            try:
                score = self._baseline_score(rec, key)
            except Exception as exc:  # noqa: BLE001 — never hurts callers
                registry().counter("quality_candidate_errors_total", model_version=short).inc()
                logger.warning("serving: candidate quality re-score on %r failed: %s", key, exc)
                continue
            self.quality.observe(score=score, label=label, model_version=key, tenant=tenant, re_type=re_type,
                                 ts=rec.get("ts"), label_ts=rec.get("labelTs"), trace_id=trace_id, slo=None)
            registry().counter("quality_candidate_scored_total", model_version=short).inc()

    def _baseline_score(self, rec: dict, base: str) -> float:
        """Score one spool record on a resident version, past admission and
        the SLO feed (an internal measurement spends no quota); it pads onto
        the warmed buckets, so the zero-capture contract holds."""
        req = ScoreRequest(_features_from_json(rec.get("features") or {}), dict(rec.get("entityIds") or {}),
                           float(rec.get("offset") or 0.0))
        with self._lock:
            key = self._resolve_version(base)
            return float(self._score_on(self._states[key], [req])[0])

    def start_shadow(self, model_version: str, fraction: Optional[float] = None) -> None:
        """Mirror a deterministic sample of primary traffic onto a resident
        candidate: each call ADDS a lane (or resets an existing one's
        record)."""
        with self._lock:
            key = self._resolve_version(model_version)
            if key == self._primary:
                raise ValueError("cannot shadow the primary onto itself")
            frac = float(fraction) if fraction is not None else self._shadow_fraction
            self._shadow_fraction = frac
            self._shadow_seq += 1
            self._shadows[key] = _ShadowLane(frac, self._shadow_seq)
        logger.info("serving: shadowing %.3f of primary traffic onto %r (%d lane(s))", frac, key, len(self._shadows))

    def stop_shadow(self, model_version: Optional[str] = None) -> None:
        """Stop one lane, or every lane when no version is given."""
        with self._lock:
            if model_version is None:
                self._shadows.clear()
                return
            self._shadows.pop(self._resolve_version(model_version), None)

    def shadow_stats(self, model_version: Optional[str] = None) -> Dict:
        """One lane's divergence record, or the newest lane's with a
        ``candidates`` map of every lane."""
        with self._lock:
            if model_version is not None:
                key = self._resolve_version(model_version)
                lane = self._shadows.get(key)
                if lane is None:
                    return dict(version=None, count=0, max_divergence=0.0, mean_divergence=0.0)
                return lane.stats(key)
            per_lane = {k: lane.stats(k) for k, lane in self._shadows.items()}
            newest = self._newest_shadow_locked()
            if newest is None:
                return dict(version=None, count=0, max_divergence=0.0, mean_divergence=0.0, candidates=per_lane)
            out = newest[1].stats(newest[0])
            out["candidates"] = per_lane
            return out

    def shadow_samples(self, model_version: Optional[str] = None) -> List[Dict]:
        """Recent (uid, primary, shadow) pairs of one lane (or the newest)."""
        with self._lock:
            if model_version is not None:
                lane = self._shadows.get(self._resolve_version(model_version))
                return list(lane.samples) if lane else []
            newest = self._newest_shadow_locked()
            return list(newest[1].samples) if newest else []

    def promote(self, model_version: str) -> Dict:
        """Make a resident version the primary, the previous primary its
        ROLLBACK PARENT (pinned against eviction); the swap is under the
        engine's lock, and the version is already warm."""
        t0 = time.perf_counter()
        with self._lock:
            key = self._resolve_version(model_version)
            if key == self._primary:
                return dict(model_version=key, parent=None)
            parent = self._primary
            self._promotion = dict(version=key, parent=parent, at=time.time(), trips_at=self._total_trips())
            self._primary = key
            self._shadows.pop(key, None)
            self._last_model_update = time.time()
        self._count("promotions")
        logger.info("serving: promoted %r (parent %r)", key, parent)
        return dict(model_version=key, parent=parent, swap_s=time.perf_counter() - t0)

    def trips_since_promotion(self) -> int:
        """Breaker trips since the last promote (0 without one, or once it
        settled): the watcher's rollback signal."""
        with self._lock:
            self._maybe_settle_promotion_locked()
            promo = self._promotion
            return self._total_trips() - promo["trips_at"] if promo else 0

    def promotion_in_window(self) -> bool:
        with self._lock:
            self._maybe_settle_promotion_locked()
            return self._promotion is not None

    def rollback(self, reason: str = "") -> Optional[str]:
        """Demote the promoted version back to its parent; returns the
        demoted version, or None without a promotion to unwind."""
        with self._lock:
            promo = self._promotion
            if promo is None or promo["parent"] not in self._states:
                return None
            demoted = self._primary
            self._primary = promo["parent"]
            self._promotion = None
            self._shadows.clear()
        self._count("rollbacks")
        logger.warning("serving: rolled back %r -> %r (%s)", demoted, self._primary, reason or "no reason given")
        return demoted

    def reload(self, model: GameModel, model_version: Optional[str] = None) -> Dict:
        """Zero-downtime swap to ``model``: load it as a resident version,
        then promote it. A failure raises :class:`ReloadError` and leaves
        the old version serving."""
        out = self.load_version(model, model_version)
        with tracer().span("serve/reload_swap"):
            out["swap_s"] = self.promote(out["model_version"]).get("swap_s", 0.0)
        return out

    def set_partition(self, partition: Optional[StorePartition]) -> Dict:
        """Swap the fleet's ownership predicate on every resident store."""
        with self._lock:
            self._partition = partition
            for state in self._states.values():
                state.store.set_partition(partition)
            stats = self._state.store.partition_stats()
        return dict(partition=stats, versions=sorted(self._states))

    def shard_export(self, target_snapshot: Dict, target_member: Optional[str] = None,
                     include_cold: bool = True) -> Dict:
        """Warm-handoff export from the primary's store, under the lock."""
        with self._lock, CAPTURE_LOCK:
            return self._state.store.shard_export(target_snapshot, target_member=target_member,
                                                  include_cold=include_cold)

    def shard_import(self, payload: Dict) -> Dict:
        """Install a peer's handoff payload on every resident store, in
        uploads no larger than the warmed staging buffers."""
        with self._lock, CAPTURE_LOCK:
            return {v: s.store.shard_import(payload, upload_chunk=self.max_batch) for v, s in self._states.items()}

    def stats(self) -> Dict:
        state = self._state
        degraded = sorted(rt for rt, b in self._breakers.items() if b.open)
        trips = self.trips_since_promotion()
        promo = self._promotion
        return dict(
            model_version=state.model_version,
            versions=sorted(self._states),
            primary=self._primary,
            shadow=self.shadow_version,
            shadows=self.shadow_versions,
            shadow_stats=self.shadow_stats(),
            promotion=dict(promo) if promo else None,
            trips_since_promotion=trips,
            queue_depth=self.batcher.queue_depth,
            max_batch_size=self.max_batch,
            trace_count=state.scorer.captures,
            retraces_since_warmup=self.retraces_since_warmup,
            warm_up={k: dict(s.scorer.info) for k, s in self._states.items()},
            store=state.store.stats(),
            uploads=state.store.upload_stats(),
            partition=state.store.partition_stats(),
            degraded=bool(degraded) or self._last_reload_error is not None,
            degraded_re_types=degraded,
            breaker_trips={rt: b.trips for rt, b in self._breakers.items() if b.trips},
            reload_failures=self._reload_failures,
            last_reload_error=self._last_reload_error,
            tenants=self.admission.snapshot(),
            feedback=self._feedback.stats() if self._feedback is not None else None,
            batcher=self.batcher.stats(),
            counts={(" ".join(k) if isinstance(k, tuple) else k): v for k, v in self.counts.items()},
            device=str(self.device),
            slo=self._slo_block(),
            quality=self._quality_block(),
            telemetry_sink=telemetry_sink_health(),
            flight_recorder=flight_recorder().stats(),
            otlp_exporter=exporter_health(),
        )

    def _slo_block(self) -> Dict:
        """The ``/healthz`` SLO block; also the flush point that mirrors the
        burn rates and states into gauges, so ``/metrics`` carries them."""
        self.slo.record_staleness(time.time() - self._last_model_update)
        try:
            self.slo.publish_metrics()
        except Exception:  # noqa: BLE001 — stats never fail on telemetry
            pass
        snap = self.slo.snapshot()
        snap["model_staleness_now_s"] = time.time() - self._last_model_update
        return snap

    def _quality_block(self) -> Dict:
        """The ``/healthz`` quality block; also the flush point that mirrors
        the windowed per-version AUC/ECE/lift into ``quality_*`` gauges."""
        try:
            self.quality.publish()
        except Exception:  # noqa: BLE001 — stats never fail on telemetry
            pass
        return self.quality.snapshot()

    def _count(self, name: str, label: Optional[str] = None, n: int = 1) -> None:
        """Add ``n`` to an engine count and to its registry counter (the
        reference's name, labelled by RE type or candidate version)."""
        metric, label_key = _COUNTERS[name]
        if label is None:
            self.counts[name] += n
            registry().counter(metric).inc(n)
        else:
            self.counts[name, label] += n
            registry().counter(metric, **{label_key: label}).inc(n)

    def close(self, drain: bool = True) -> None:
        self.batcher.close(drain=drain)
        if self._feedback is not None:
            try:
                self._feedback.close()
            except Exception:  # noqa: BLE001 — close must not raise
                logger.exception("serving: feedback spool close failed")


# The engine's counts: (registry counter, its label key).
_COUNTERS = {
    "degraded_requests": ("serve_requests_degraded_total", "re_type"),
    "store_errors": ("serve_store_errors_total", "re_type"),
    "pin_fallbacks": ("serve_pin_fallback_total", None),
    "shadow_errors": ("serve_shadow_errors_total", "model_version"),
    "shadow_scored": ("serve_shadow_scored_total", "model_version"),
    "reloads": ("serve_model_reloads_total", None),
    "delta_loads": ("serve_delta_loads_total", None),
    "promotions": ("serve_promotions_total", None),
    "rollbacks": ("serve_rollbacks_total", None),
}


def load_engine(model_dir: str, artifacts_dir: Optional[str] = None, config: Optional[ServeConfig] = None,
                model_version: Optional[str] = None, partition: Optional[StorePartition] = None) -> ServingEngine:
    """An engine from a trained model directory, as the batch scoring
    driver reads it: index maps and entity indexes from ``artifacts_dir``
    (default: the model directory's parent, the training output), the model
    (its delta chain resolved) loaded as a host master."""
    from photon_tpu_torch.io.model_io import (delta_info, load_resolved_game_model, model_re_types,
                                              read_model_metadata, resolve_delta_chain)

    artifacts = artifacts_dir or os.path.dirname(model_dir.rstrip("/"))
    # A delta generation's coordinates and shards are the whole chain's.
    layers = resolve_delta_chain(model_dir) if delta_info(model_dir) is not None else [model_dir]
    meta: Dict[str, object] = {"coordinates": {}}
    for layer in layers:
        for cid, info in read_model_metadata(layer).get("coordinates", {}).items():
            meta["coordinates"].setdefault(cid, info)
    index_maps: Dict[str, IndexMap] = {}
    for coord in meta["coordinates"].values():
        shard = coord.get("featureShard")
        path = os.path.join(artifacts, f"index-map-{shard}.json")
        if shard and shard not in index_maps and os.path.exists(path):
            index_maps[shard] = IndexMap.load(path)
    entity_indexes: Dict[str, EntityIndex] = {}
    for re_type in model_re_types(meta):
        path = os.path.join(artifacts, f"entity-index-{re_type}.json")
        if os.path.exists(path):
            entity_indexes[re_type] = EntityIndex.load(path)
    model = load_resolved_game_model(model_dir, index_maps, entity_indexes, to_device=False)
    engine = ServingEngine(model, entity_indexes=entity_indexes, index_maps=index_maps, config=config,
                           model_version=model_version or model_dir.rstrip("/"), partition=partition)
    engine.artifacts_dir = artifacts
    return engine
