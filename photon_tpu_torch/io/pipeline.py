"""Pipelined ingest → device data path (port of photon_tpu/io/pipeline.py):
decode, assembly and host-to-device copies overlap each other and the
card's compute.

Stages (each its own thread when ``overlap=True``):

    decode    stream_avro_columnar: container blocks → ColumnarRows chunks
    assemble  ColumnarRows → GameBatch of CPU tensors (vectorized IndexMap
              lookups and scatters; cumulative entity interning keeps this
              stage strictly in chunk order), bucket-padded on the host
              where asked (data/padding.py works on CPU tensors)
    h2d       the chunk's tensors copied into pinned host memory, then to
              the device with ``non_blocking`` copies on a dedicated copy
              stream, an event recorded after them

Every inter-stage queue is bounded at ``depth`` chunks (backpressure), so
host memory holds at most ``3·depth + in-flight`` chunks whatever the file
size. Per-stage busy, starved and backpressured walls, items, bytes and
queue depths land in ``utils/timed.py``'s ``PipelineStats``. ``overlap=False``
runs the same stage functions inline on the consumer's thread: the chunks
are bit-identical either way.

Where the card differs from the reference's ``jax.device_put``:

- a device chunk is handed to the consumer only after the consumer's
  current stream has waited on the chunk's copy event, and every device
  tensor of the chunk is ``record_stream``-ed onto that stream, so the
  caching allocator cannot recycle a chunk's memory (allocated on the copy
  stream) while the consumer's kernels still read it; the pinned source
  buffers stay referenced by the chunk (and, through the caching host
  allocator, by the copy's event) until the copy has completed;
- the h2d thread selects its device explicitly (``torch.cuda.device``): the
  current device is per thread;
- the stage threads are joined when the stream ends, is abandoned or fails
  (``_run_staged``'s ``finally``). A CUDA call from another thread during a
  CUDA graph capture invalidates the capture (algorithm/solve_cache.py
  captures in the default "global" mode), so a consumer must exhaust or
  close the stream before it captures anything: the training drivers
  materialize the whole batch (``materialize_game_batch``) before they fit.

The reference's spans (``pipeline-stage/<thread>``, ``pipeline/<label>``)
and registry counters (``pipeline_*``, ``dead_letter_*``, ``replay_*``) are
published at its sites and under its names.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import queue
import tempfile
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.obs.trace import current_span_path, record_span, tracer
from photon_tpu_torch.utils import faults, resources
from photon_tpu_torch.utils.timed import PipelineStats, StageStats, record_pipeline

logger = logging.getLogger("photon_tpu_torch")

# Queue bound between stages, in chunks: double buffering (the reference's
# measured default).
DEFAULT_QUEUE_DEPTH = 2

_DONE = object()
_SKIP = object()  # _retry_or_skip verdict: drop this chunk, keep streaming

# Errors worth retrying: filesystem hiccups and injected transients
# (faults.TransientInjectedFault is an OSError on purpose).
TRANSIENT_ERRORS = (OSError, TimeoutError)

MAX_RETRIES_ENV = "PHOTON_TPU_PIPELINE_MAX_RETRIES"
SKIP_BUDGET_ENV = "PHOTON_TPU_PIPELINE_SKIP_BUDGET"
DEAD_LETTER_ENV = "PHOTON_TPU_PIPELINE_DEAD_LETTER"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Transient-failure handling for pipeline stages: exponential backoff
    with deterministic seeded jitter on ``TRANSIENT_ERRORS``, then a bounded
    poisoned-chunk skip budget shared across all stages of one run.
    ``skip_budget=0`` (default) fails fast."""

    max_retries: int = 2
    dead_letter_path: Optional[str] = None  # JSONL sidecar for skipped chunks
    backoff_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.25
    skip_budget: int = 0
    seed: int = 0


def default_retry_policy() -> RetryPolicy:
    """Env-tunable default: PHOTON_TPU_PIPELINE_MAX_RETRIES / _SKIP_BUDGET /
    _DEAD_LETTER."""
    p = RetryPolicy()
    mr = os.environ.get(MAX_RETRIES_ENV, "").strip()
    sb = os.environ.get(SKIP_BUDGET_ENV, "").strip()
    dl = os.environ.get(DEAD_LETTER_ENV, "").strip()
    if mr:
        p = dataclasses.replace(p, max_retries=int(mr))
    if sb:
        p = dataclasses.replace(p, skip_budget=int(sb))
    if dl:
        p = dataclasses.replace(p, dead_letter_path=dl)
    return p


class _SkipBudget:
    """Pipeline-wide poisoned-chunk budget (thread-safe). With a
    ``dead_letter_path`` every consumed skip appends one JSONL record naming
    the dropped chunk."""

    def __init__(self, limit: int, dead_letter_path: Optional[str] = None):
        self.limit = int(limit)
        self.used = 0
        self.dead_letter_path = dead_letter_path
        self._lock = threading.Lock()

    def try_consume(self) -> bool:
        with self._lock:
            if self.used >= self.limit:
                return False
            self.used += 1
            return True

    def dead_letter(self, stage: str, item, exc: BaseException) -> None:
        if not self.dead_letter_path:
            return
        record = dict(stage=stage, chunk=getattr(item, "index", None), rows=getattr(item, "n", None),
                      error=f"{type(exc).__name__}: {exc}", ts=time.time())
        # A failing sidecar append must never mask the chunk error the
        # caller is handling: dead letters are observability.
        guard = resources.DiskBudgetGuard("deadletter.write")
        try:
            with self._lock:
                with open(self.dead_letter_path, "a") as f:
                    guard.check()
                    f.write(json.dumps(record) + "\n")
        except OSError as exc2:
            guard.record(exc2)
            try:
                registry().counter("dead_letter_write_failures_total").inc()
            except Exception:
                pass
            logger.exception("could not append dead-letter record to %s", self.dead_letter_path)


def _with_retries(fn: Callable, item, policy: RetryPolicy, name: str, stop: Optional[threading.Event],
                  rng: np.random.Generator):
    """``fn(item)``, retrying TRANSIENT_ERRORS with jittered exponential
    backoff; the wait respects the stop event (no hang on shutdown)."""
    delay = policy.backoff_s
    attempt = 0
    while True:
        try:
            return fn(item)
        except TRANSIENT_ERRORS as exc:
            attempt += 1
            if attempt > policy.max_retries:
                raise
            sleep = delay * (1.0 + policy.jitter * float(rng.random()))
            registry().counter("pipeline_retries_total", stage=name).inc()
            logger.warning("pipeline stage %s: transient failure (attempt %d/%d), retrying in %.3fs: %s",
                           name, attempt, policy.max_retries, sleep, exc)
            if stop is not None:
                if stop.wait(sleep):
                    raise  # shutting down: abandon the remaining retries
            else:
                time.sleep(sleep)
            delay = min(delay * 2.0, policy.backoff_max_s)


def _retry_or_skip(fn: Callable, item, policy: RetryPolicy, name: str, stop: Optional[threading.Event],
                   rng: np.random.Generator, skips: _SkipBudget):
    """Retries, then the skip budget: a chunk that keeps failing is dropped
    (``_SKIP``) while budget remains, else the error propagates."""
    try:
        return _with_retries(fn, item, policy, name, stop, rng)
    except Exception as exc:  # noqa: BLE001 — budget decision, then re-raise
        if skips.try_consume():
            registry().counter("pipeline_chunks_skipped_total", stage=name).inc()
            skips.dead_letter(name, item, exc)
            logger.warning("pipeline stage %s: skipping poisoned chunk after retries (%s); skip budget %d/%d used",
                           name, exc, skips.used, skips.limit)
            return _SKIP
        raise


@dataclasses.dataclass
class BatchChunk:
    """One pipeline chunk: ``batch`` holds CPU tensors after assemble and
    device tensors after h2d. ``n`` is the valid row count (before
    padding); the batch's uids are already renumbered globally. A device
    chunk carries its copy event and pinned source buffers until the
    consumer has waited on it (``_consume``)."""

    batch: object  # GameBatch
    n: int
    index: int
    event: Optional[object] = None
    pinned: Optional[list] = None


def _batch_tensors(batch) -> List[torch.Tensor]:
    out = [batch.label, batch.offset, batch.weight]
    for f in batch.features.values():
        out.extend(f.tensors() if isinstance(f, SparseFeatures) else [f])
    out.extend(batch.entity_ids.values())
    if batch.uid is not None:
        out.append(batch.uid)
    return out


def chunk_nbytes(chunk: BatchChunk) -> int:
    """Host bytes of a chunk's tensors (replay-cache budget accounting)."""
    return sum(t.numel() * t.element_size() for t in _batch_tensors(chunk.batch))


def columnar_nbytes(cols) -> int:
    total = 0
    for group in (cols.numeric, cols.longs, cols.strings):
        total += sum(a.nbytes for a in group.values())
    for b in cols.bags.values():
        total += b.offsets.nbytes + b.key_ids.nbytes + b.values.nbytes
    total += cols.meta_rows.nbytes + cols.meta_keys.nbytes + cols.meta_vals.nbytes
    return total


# ---------------------------------------------------------------------------
# Thread plumbing: bounded queues + stop event + error forwarding.
# ---------------------------------------------------------------------------


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put respecting shutdown; False when the pipeline stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _get(q: "queue.Queue", stop: threading.Event):
    """Get respecting shutdown; _DONE when the pipeline stopped."""
    while not stop.is_set():
        try:
            return q.get(timeout=0.05)
        except queue.Empty:
            continue
    return _DONE


def _source_thread(make_iter: Callable[[], Iterator], out_q: "queue.Queue", stage: StageStats,
                   stop: threading.Event, nbytes_of: Callable, name: str, source_hook: Optional[Callable],
                   policy: RetryPolicy, rng: np.random.Generator, skips: _SkipBudget) -> None:
    gen = None
    try:
        gen = make_iter()
        while True:
            t0 = time.perf_counter()
            try:
                item = next(gen)
            except StopIteration:
                break
            if source_hook is not None:
                # The per-chunk hook runs outside next(): a retry re-runs
                # only the hook (a generator that raised cannot resume).
                item = _retry_or_skip(source_hook, item, policy, name, stop, rng, skips)
                if item is _SKIP:
                    continue
            stage.add_busy(time.perf_counter() - t0, nbytes_of(item))
            t1 = time.perf_counter()
            if not _put(out_q, item, stop):
                return
            stage.add_wait_out(time.perf_counter() - t1)
            stage.sample_depth(out_q.qsize())
        _put(out_q, _DONE, stop)
    except BaseException as exc:  # noqa: BLE001 — forwarded to the consumer
        _put(out_q, _Failure(exc), stop)
    finally:
        close = getattr(gen, "close", None)
        if close is not None:
            close()  # shuts the decode block pool on abandonment


def _stage_thread(fn: Callable, in_q: "queue.Queue", out_q: "queue.Queue", stage: StageStats,
                  stop: threading.Event, nbytes_of: Callable, name: str, policy: RetryPolicy,
                  rng: np.random.Generator, skips: _SkipBudget) -> None:
    try:
        while True:
            t0 = time.perf_counter()
            item = _get(in_q, stop)
            stage.add_wait_in(time.perf_counter() - t0)
            if item is _DONE:
                _put(out_q, _DONE, stop)
                return
            if isinstance(item, _Failure):
                _put(out_q, item, stop)
                return
            t1 = time.perf_counter()
            out = _retry_or_skip(fn, item, policy, name, stop, rng, skips)
            if out is _SKIP:
                continue
            stage.add_busy(time.perf_counter() - t1, nbytes_of(out))
            t2 = time.perf_counter()
            if not _put(out_q, out, stop):
                return
            stage.add_wait_out(time.perf_counter() - t2)
            stage.sample_depth(out_q.qsize())
    except BaseException as exc:  # noqa: BLE001 — forwarded to the consumer
        _put(out_q, _Failure(exc), stop)


def _consume(item):
    """Hand a chunk to the consumer's thread: a device chunk's copies are
    ordered before the consumer's stream's later work, and its tensors are
    marked as used by that stream (``record_stream``)."""
    if isinstance(item, BatchChunk) and item.event is not None:
        consumer = torch.cuda.current_stream(item.batch.label.device)
        consumer.wait_event(item.event)
        for t in _batch_tensors(item.batch):
            t.record_stream(consumer)
    return item


def _run_staged(make_source: Callable[[], Iterator], source_nbytes: Callable, stages: List, stats: PipelineStats,
                depth: int, overlap: bool, source_name: str = "decode", retry: Optional[RetryPolicy] = None,
                source_hook: Optional[Callable] = None) -> Iterator:
    """Compose source + transform stages into one output iterator, threaded
    (bounded queues) or inline: the same functions in the same order give
    the same results. ``retry`` adds transient backoff and a shared skip
    budget to every stage (and to ``source_hook``, run per source item)."""
    policy = retry if retry is not None else default_retry_policy()
    skips = _SkipBudget(policy.skip_budget, policy.dead_letter_path)
    # Per-stage RNGs: independent, deterministic jitter streams.
    src_rng = np.random.default_rng(policy.seed)
    stage_rngs = [np.random.default_rng(policy.seed + i + 1) for i in range(len(stages))]

    if not overlap:
        src_stage = stats.stage(source_name)
        stage_objs = [(stats.stage(name), fn, nb, stage_rngs[i]) for i, (name, fn, nb) in enumerate(stages)]
        gen = make_source()
        try:
            for item in gen:
                if source_hook is not None:
                    item = _retry_or_skip(source_hook, item, policy, source_name, None, src_rng, skips)
                    if item is _SKIP:
                        continue
                # The source's busy time is folded into the consumer's
                # iteration in serial mode; the transforms are timed.
                src_stage.add_busy(0.0, source_nbytes(item))
                skipped = False
                for stage, fn, nb, rng in stage_objs:
                    t0 = time.perf_counter()
                    item = _retry_or_skip(fn, item, policy, stage.name, None, rng, skips)
                    if item is _SKIP:
                        skipped = True
                        break
                    stage.add_busy(time.perf_counter() - t0, nb(item))
                if not skipped:
                    yield _consume(item)
        finally:
            close = getattr(gen, "close", None)
            if close is not None:
                close()
        return

    stop = threading.Event()
    # The parent span path, captured here: the generator body first runs on
    # the consumer's first next(), so this is the consumer's innermost open
    # span. Stage threads carry it explicitly (thread-local nesting cannot
    # cross threads), which keeps the trace tree connected.
    parent = current_span_path()

    def spanned(target):
        def run(*args):
            with tracer().span(f"pipeline-stage/{threading.current_thread().name}", parent=parent):
                target(*args)

        return run

    # Each queue slot pins one decoded host chunk: under host memory
    # pressure drop to single buffering for this run.
    depth = resources.tightened_depth(depth)
    queues = [queue.Queue(maxsize=depth) for _ in range(len(stages) + 1)]
    threads = [threading.Thread(
        target=spanned(_source_thread),
        args=(make_source, queues[0], stats.stage(source_name), stop, source_nbytes, source_name, source_hook,
              policy, src_rng, skips),
        name=f"photon-pipe-{source_name}", daemon=True)]
    for i, (name, fn, nbytes_of) in enumerate(stages):
        threads.append(threading.Thread(
            target=spanned(_stage_thread),
            args=(fn, queues[i], queues[i + 1], stats.stage(name), stop, nbytes_of, name, policy, stage_rngs[i],
                  skips),
            name=f"photon-pipe-{name}", daemon=True))
    for t in threads:
        t.start()
    out_q = queues[-1]
    try:
        while True:
            # A timed get, so the consumer notices every stage thread dying
            # without a _DONE/_Failure reaching this queue.
            try:
                item = out_q.get(timeout=0.05)
            except queue.Empty:
                if stop.is_set():
                    return
                if not any(t.is_alive() for t in threads) and out_q.empty():
                    raise RuntimeError("pipeline stage threads exited without completing the stream")
                continue
            if item is _DONE:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield _consume(item)
    finally:
        # Joined before the consumer goes on: no stage thread may touch the
        # card during a later graph capture.
        stop.set()
        for t in threads:
            t.join(timeout=10.0)


class StageWorker:
    """One pipeline stage outside a source → consumer chain: a bounded input
    queue, one worker thread, StageStats accounting, and the worker's
    failure raised at the next ``submit`` or at ``close``. ``submit`` blocks
    while the worker is ``depth`` items behind. Items are processed in
    submission order."""

    def __init__(self, name: str, fn: Callable, stage: StageStats, depth: int = DEFAULT_QUEUE_DEPTH,
                 nbytes_of: Callable = lambda item, out: 0):
        self.name = name
        self._fn = fn
        self._stage = stage
        self._nbytes = nbytes_of
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._failure: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=f"photon-pipe-{name}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            t0 = time.perf_counter()
            item = _get(self._q, self._stop)
            self._stage.add_wait_in(time.perf_counter() - t0)
            if item is _DONE:
                return
            t1 = time.perf_counter()
            try:
                out = self._fn(item)
            except BaseException as exc:  # noqa: BLE001 — forwarded to the submitter
                self._failure = exc
                self._stop.set()
                return
            self._stage.add_busy(time.perf_counter() - t1, self._nbytes(item, out))

    def submit(self, item) -> None:
        """Enqueue one item (blocking under backpressure); raises the
        worker's failure if it already died."""
        if self._failure is not None:
            raise self._failure
        t0 = time.perf_counter()
        if not _put(self._q, item, self._stop):
            if self._failure is not None:
                raise self._failure
            raise RuntimeError(f"stage worker {self.name!r} stopped")
        self._stage.add_wait_out(time.perf_counter() - t0)
        self._stage.sample_depth(self._q.qsize())

    def close(self, timeout: float = 600.0) -> None:
        """Drain the queue, stop the worker, and re-raise any failure."""
        _put(self._q, _DONE, self._stop)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self._stop.set()
            raise RuntimeError(f"stage worker {self.name!r} did not drain within {timeout}s")
        if self._failure is not None:
            raise self._failure

    def abort(self) -> None:
        """Stop without draining (error-path cleanup); never raises."""
        self._stop.set()


# ---------------------------------------------------------------------------
# Concrete stages: decode → assemble → h2d over GameBatch chunks.
# ---------------------------------------------------------------------------


def _bucket_pad_host(chunk: BatchChunk, pad_rows_to: int) -> BatchChunk:
    """Rows pad to the next ``pad_rows_to`` multiple (weight-0 rows, entity
    id -1) and sparse nnz widths to the next power of two, on the host, so
    the consumer meets few shapes (data/padding.py)."""
    from photon_tpu_torch.data.padding import pad_feature_matrix, pad_game_batch

    n = chunk.n
    target = int(np.ceil(n / pad_rows_to) * pad_rows_to) if n else pad_rows_to
    batch = pad_game_batch(chunk.batch, target)
    if batch is chunk.batch:
        # No row added: a sparse shard still buckets its nnz width.
        batch = dataclasses.replace(batch, features={k: pad_feature_matrix(v, 0) for k, v in batch.features.items()})
    return BatchChunk(batch, n, chunk.index)


def _make_h2d(device, pad_rows_to: Optional[int]) -> Callable[[BatchChunk], BatchChunk]:
    """The h2d stage for ``device``: on the CPU the host chunk itself (only
    padded); on the card pinned copies on a copy stream of its own."""
    device = torch.device(device)
    if device.type != "cuda":
        return (lambda c: _bucket_pad_host(c, pad_rows_to)) if pad_rows_to else (lambda c: c)
    stream = torch.cuda.Stream(device)

    def h2d(chunk: BatchChunk) -> BatchChunk:
        if pad_rows_to:
            chunk = _bucket_pad_host(chunk, pad_rows_to)
        # The current device is per thread: select it here.
        with torch.cuda.device(device):
            pinned: list = []

            def put(t: torch.Tensor) -> torch.Tensor:
                p = t.pin_memory()
                pinned.append(p)
                return p.to(device, non_blocking=True)

            with torch.cuda.stream(stream):
                b = chunk.batch
                features = {}
                for k, f in b.features.items():
                    if isinstance(f, SparseFeatures):
                        features[k] = SparseFeatures(
                            put(f.indices), put(f.values), f.dim,
                            None if f.csc_order is None else put(f.csc_order),
                            None if f.csc_segments is None else put(f.csc_segments))
                    else:
                        features[k] = put(f)
                batch = dataclasses.replace(
                    b, label=put(b.label), offset=put(b.offset), weight=put(b.weight), features=features,
                    entity_ids={k: put(v) for k, v in b.entity_ids.items()},
                    uid=None if b.uid is None else put(b.uid))
                event = torch.cuda.Event()
                event.record(stream)
        return BatchChunk(batch, chunk.n, chunk.index, event, pinned)

    return h2d


def _faulted(site: str, fn: Callable) -> Callable:
    """Prefix a stage function with a fault hook (before ``fn``, so an
    injected transient retries the whole call on the same item)."""

    def wrapped(item):
        faults.check(site)
        return fn(item)

    return wrapped


def _source_fault_hook(item):
    faults.check("ingest.source")
    return item


def _host_shard_configs(shard_configs: Dict, device) -> Dict:
    """The shard configurations with each transpose plan resolved for the
    chunks' final ``device``, so host assembly builds what a read onto the
    device would."""
    return {k: dataclasses.replace(c, transpose_plan=c.resolved_transpose_plan(device))
            for k, c in shard_configs.items()}


def _make_assembler(shard_configs, index_maps, entity_id_columns, entity_indexes, intern_new_entities,
                    column_names, device):
    """ColumnarRows → host BatchChunk closure. Stateful (entity interning is
    cumulative, uids renumber globally): exactly one assembler consumes the
    chunk stream, in order. Its state advances only after a chunk fully
    assembles, so a retry is safe."""
    from photon_tpu_torch.io.data_reader import _columnar_to_game_batch

    configs = _host_shard_configs(shard_configs, device)
    state = {"uid_base": 0, "index": 0, "eidx": entity_indexes}

    def assemble(cols) -> BatchChunk:
        batch, state["eidx"] = _columnar_to_game_batch(
            cols, configs, index_maps, entity_id_columns, state["eidx"], intern_new_entities, column_names,
            device="cpu")
        batch = dataclasses.replace(
            batch, uid=torch.arange(state["uid_base"], state["uid_base"] + cols.n, dtype=torch.int64))
        out = BatchChunk(batch, cols.n, state["index"])
        state["uid_base"] += cols.n
        state["index"] += 1
        return out

    return assemble


def assemble_host_batches(cols_iter: Iterator, shard_configs: Dict, index_maps: Dict,
                          entity_id_columns: Optional[Dict[str, str]] = None, entity_indexes: Optional[Dict] = None,
                          intern_new_entities: bool = True, column_names=None,
                          device="cuda") -> Iterator[BatchChunk]:
    """Assemble a ColumnarRows iterator (e.g. a ChunkReplayCache replay)
    into host GameBatch chunks, for ``device``, with globally renumbered
    uids; strictly in order."""
    assemble = _make_assembler(shard_configs, index_maps, entity_id_columns,
                               entity_indexes if entity_indexes is not None else {}, intern_new_entities,
                               column_names, device)
    for cols in cols_iter:
        yield assemble(cols)


def stream_host_batches(paths: Sequence[str], shard_configs: Dict, index_maps: Dict,
                        entity_id_columns: Optional[Dict[str, str]] = None, entity_indexes: Optional[Dict] = None,
                        intern_new_entities: bool = True, chunk_rows: int = 1 << 16, column_names=None,
                        decode_workers: Optional[int] = None, device="cuda") -> Iterator[BatchChunk]:
    """Decode + assemble inline (no threads): host GameBatch chunks with
    globally renumbered uids (the replay-cache fill path)."""
    from photon_tpu_torch.io.columnar import stream_avro_columnar
    from photon_tpu_torch.io.data_reader import _expand_paths

    yield from assemble_host_batches(
        stream_avro_columnar(_expand_paths(paths), chunk_rows, workers=decode_workers), shard_configs, index_maps,
        entity_id_columns, entity_indexes, intern_new_entities, column_names, device)


def stream_device_batches(paths: Sequence[str], shard_configs: Dict, index_maps: Dict,
                          entity_id_columns: Optional[Dict[str, str]] = None, entity_indexes: Optional[Dict] = None,
                          intern_new_entities: bool = True, chunk_rows: int = 1 << 16, column_names=None,
                          decode_workers: Optional[int] = None, depth: int = DEFAULT_QUEUE_DEPTH,
                          pad_rows_to: Optional[int] = None, overlap: bool = True, telemetry_label: str = "ingest",
                          stats: Optional[PipelineStats] = None, retry: Optional[RetryPolicy] = None,
                          device="cuda") -> Iterator[BatchChunk]:
    """The full pipeline, decode → assemble → h2d, yielding GameBatch
    chunks on ``device``. ``pad_rows_to`` pads every chunk to a row-count
    multiple and buckets sparse nnz widths (leave None when the chunks will
    be concatenated). ``overlap=False`` runs the stages inline. ``retry``
    (default :func:`default_retry_policy`) governs backoff and the skip
    budget. Telemetry lands under ``telemetry_label``."""
    from photon_tpu_torch.io.columnar import stream_avro_columnar
    from photon_tpu_torch.io.data_reader import _expand_paths

    if stats is None:
        stats = PipelineStats(overlapped=overlap)
    else:
        stats.overlapped = overlap
    record_pipeline(telemetry_label, stats)
    expanded = _expand_paths(paths)
    assemble = _make_assembler(shard_configs, index_maps, entity_id_columns,
                               entity_indexes if entity_indexes is not None else {}, intern_new_entities,
                               column_names, device)

    def source():
        return stream_avro_columnar(expanded, chunk_rows, workers=decode_workers)

    stages = [
        ("assemble", _faulted("ingest.assemble", assemble), chunk_nbytes),
        ("h2d", _faulted("ingest.h2d", _make_h2d(device, pad_rows_to)), lambda c: 0),
    ]
    source_hook = _source_fault_hook if faults.active("ingest.source") else None
    t0 = time.perf_counter()
    try:
        yield from _run_staged(source, columnar_nbytes, stages, stats, depth, overlap, retry=retry,
                               source_hook=source_hook)
    finally:
        stats.wall_s = time.perf_counter() - t0
        stats.log(telemetry_label)
        _finalize_pipeline_telemetry(telemetry_label, stats)


def _finalize_pipeline_telemetry(label: str, stats: PipelineStats) -> None:
    """Flush one pipeline run into the run report: the stage metrics into
    the registry and one externally timed span over the whole stream. It
    runs in a ``finally`` while a pipeline failure may be propagating, and
    never masks that exception."""
    try:
        stats.publish(label)
        record_span(f"pipeline/{label}", stats.wall_s)
    except Exception:
        logger.exception("pipeline telemetry publish failed for %s", label)


def device_chunks_from(host_chunks: Callable[[], Iterator[BatchChunk]], depth: int = DEFAULT_QUEUE_DEPTH,
                       pad_rows_to: Optional[int] = None, overlap: bool = True, telemetry_label: str = "replay",
                       stats: Optional[PipelineStats] = None, retry: Optional[RetryPolicy] = None,
                       device="cuda") -> Iterator[BatchChunk]:
    """Only the h2d stage, over a callable that returns a host-chunk
    iterator (a replay-cache pass): decode and assembly are already paid."""
    if stats is None:
        stats = PipelineStats(overlapped=overlap)
    else:
        stats.overlapped = overlap
    record_pipeline(telemetry_label, stats)
    stages = [("h2d", _faulted("ingest.h2d", _make_h2d(device, pad_rows_to)), lambda c: 0)]
    t0 = time.perf_counter()
    try:
        yield from _run_staged(host_chunks, chunk_nbytes, stages, stats, depth, overlap, source_name="assemble",
                               retry=retry)
    finally:
        stats.wall_s = time.perf_counter() - t0
        stats.log(telemetry_label)
        _finalize_pipeline_telemetry(telemetry_label, stats)


def materialize_game_batch(chunks: Iterator[BatchChunk]):
    """Concatenate device chunks (from a source without ``pad_rows_to``)
    into one GameBatch; every chunk is held until the concatenation."""
    from photon_tpu_torch.io.data_reader import concat_game_batches

    batches = [c.batch for c in chunks]
    if not batches:
        raise ValueError("streaming ingest read zero data blocks")
    return concat_game_batches(batches)


class ChunkReplayCache:
    """Host-side chunk cache for multi-pass streaming: decode once, replay
    many.

    The first pass pulls from ``source_factory()`` and keeps each chunk in
    memory while the running total stays within ``byte_budget``. Past the
    budget the overflow spills to a spool file under ``spill_dir`` (the
    memory prefix stays), so later passes replay memory + disk in the
    original order and the decode is paid once; host memory stays bounded
    by the budget plus one chunk. ``spill_dir="auto"`` makes a temporary
    directory at the first spill; ``None`` drops the cache and re-streams
    every pass instead. A spool write failure (ENOSPC) falls back to
    re-streaming; a torn spool found on replay re-streams that pass from the
    source, skipping the chunks already yielded.

    Single consumer: passes must not interleave. A pass abandoned midway
    leaves the cache incomplete (and deletes its spool); the next pass
    re-streams.
    """

    def __init__(self, source_factory: Callable[[], Iterator], byte_budget: int = 1 << 30,
                 nbytes: Callable = chunk_nbytes, spill_dir: Optional[str] = "auto"):
        self._factory = source_factory
        self.byte_budget = int(byte_budget)
        self._nbytes = nbytes
        self._spill_dir = spill_dir
        self._guard = resources.DiskBudgetGuard("spool.write")
        self._spool_path: Optional[str] = None
        self._spool_count = 0
        self._spool_seq = 0
        self._chunks: List = []
        self._complete = False
        self.spilled = False
        self.cached_bytes = 0
        self.spilled_bytes = 0
        self.source_passes = 0
        self.replay_passes = 0

    def _reset_cache(self) -> None:
        self._chunks, self.cached_bytes = [], 0
        self.spilled_bytes = 0
        self._spool_count = 0
        if self._spool_path is not None:
            try:
                os.unlink(self._spool_path)
            except OSError:
                pass
            self._spool_path = None

    def _open_spool(self):
        if self._spill_dir == "auto":
            self._spill_dir = tempfile.mkdtemp(prefix="photon-replay-")
        os.makedirs(self._spill_dir, exist_ok=True)
        self._spool_path = os.path.join(self._spill_dir, f"spool-{self._spool_seq:04d}.pkl")
        self._spool_seq += 1
        return open(self._spool_path, "wb")

    def _read_spool(self) -> Iterator:
        with open(self._spool_path, "rb") as fh:
            for _ in range(self._spool_count):
                yield pickle.load(fh)

    def _spill_failed(self, exc: OSError, spool) -> None:
        """A spool write failed midway: close and delete the partial spool,
        stop caching and disable disk spill for this cache's lifetime (this
        pass keeps yielding from the source; later passes re-stream)."""
        if spool is not None:
            try:
                spool.close()
            except OSError:
                pass
        self._guard.record(exc)
        try:
            registry().counter("replay_spill_fallbacks_total").inc()
        except Exception:
            pass
        logger.warning("replay-cache spool write failed under %s; falling back to re-streaming from source "
                       "(decode re-paid each pass): %s", self._spill_dir, exc)
        self._reset_cache()
        self._spill_dir = None
        self.spilled = True

    def close(self) -> None:
        """Drop the cache and delete any spool file."""
        self._complete = False
        self._reset_cache()

    def _recover_torn_spool(self, exc: Exception, already_yielded: int):
        """A replay pass hit a torn spool: decode order is deterministic, so
        re-stream the source and skip the chunks this pass already yielded."""
        reg = registry()
        reg.counter("replay_spool_torn_total").inc()
        logger.warning("torn replay spool %s after %d chunk(s); re-streaming this pass from source: %s",
                       self._spool_path, already_yielded, exc)
        self._complete = False
        self._reset_cache()
        self.source_passes += 1
        reg.counter("replay_cache_source_passes_total").inc()
        for i, chunk in enumerate(self._factory()):
            if i >= already_yielded:
                yield chunk

    def __iter__(self) -> Iterator:
        reg = registry()
        if self._complete:
            self.replay_passes += 1
            reg.counter("replay_cache_replay_passes_total").inc()
            yield from self._chunks
            if self._spool_count:
                yielded = len(self._chunks)
                spool_iter = self._read_spool()
                while True:
                    try:
                        chunk = next(spool_iter)
                    except StopIteration:
                        break
                    except (OSError, EOFError, pickle.UnpicklingError, ValueError) as exc:
                        yield from self._recover_torn_spool(exc, yielded)
                        return
                    yield chunk
                    yielded += 1
            return
        self.source_passes += 1
        reg.counter("replay_cache_source_passes_total").inc()
        self._reset_cache()
        # A memory-only cache that overflowed once never tries again; a
        # disk-backed one retries (a fresh pass rebuilds prefix and spool).
        caching = not self.spilled or self._spill_dir is not None
        spool = None
        finished = False
        try:
            for chunk in self._factory():
                if caching:
                    cost = self._nbytes(chunk)
                    # Host memory pressure tightens the budget.
                    over = self.cached_bytes + cost > self.byte_budget or resources.memory_pressure()
                    if spool is None and over:
                        if self._spill_dir is None:
                            self.spilled, caching = True, False
                            self._reset_cache()
                            reg.counter("replay_cache_spills_total").inc()
                        else:
                            try:
                                self._guard.check()
                                spool = self._open_spool()
                            except OSError as exc:
                                self._spill_failed(exc, spool)
                                spool, caching = None, False
                            else:
                                self.spilled = True
                                reg.counter("replay_cache_spills_total").inc()
                    if caching:
                        if spool is None:
                            self._chunks.append(chunk)
                            self.cached_bytes += cost
                        else:
                            try:
                                self._guard.check()
                                pickle.dump(chunk, spool, protocol=pickle.HIGHEST_PROTOCOL)
                                spool.flush()
                            except OSError as exc:
                                self._spill_failed(exc, spool)
                                spool, caching = None, False
                            else:
                                self._spool_count += 1
                                self.spilled_bytes += cost
                                reg.counter("replay_cache_spilled_bytes_total").inc(cost)
                yield chunk
            finished = True
        finally:
            if spool is not None:
                spool.close()
            if finished and caching:
                self._complete = True
            elif not finished:
                self._reset_cache()
            reg.gauge("replay_cache_cached_bytes").set(self.cached_bytes)
            reg.gauge("replay_cache_spilled_bytes").set(self.spilled_bytes)
            reg.gauge("replay_cache_spilled").set(int(self.spilled))
