"""The port's ingest pipeline, replay cache and streaming ingest
(io/pipeline.py, io/data_reader.py's streaming half) against the JAX package
on the CPU.

The cases of the reference's tests/test_pipeline.py, tests/test_streaming_ingest.py
and tests/test_big_ingest.py (which keeps its PHOTON_BIG_INGEST_GB skip), the
pipeline cases of tests/test_faults.py and the replay-cache and dead-letter
cases of tests/test_resources.py, ported to the port's API. Where a
reference case asserts a metrics-registry counter (spilled bytes, spool
fallbacks, torn spools, dead-letter write failures), the port's case
asserts the same behaviour without the counter. The reference's
retrace-count case becomes a bucket-shape case: PyTorch compiles nothing,
so what it holds is that padding buckets the shapes and leaves the valid
rows' scores exact.

Beside them: ``stream_merged`` + ``concat_game_batches`` bit for bit with
``read_merged`` and with the reference's ``stream_merged``, over dense and
padded-sparse shards; the streamed drivers (``train_glm`` against the
reference driver within the f32 1e-3 of the driver tests, with a replay
cache that spills; ``game_training`` and ``game_scoring``, overlapped and
serial, against their own whole-file reads, exactly).

The host-to-device stage proper (pinned buffers, the copy stream and its
event) runs only on the card: tests/test_torch_gpu.py holds it.
"""

import glob
import json
import os
import pickle
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_tpu.io.avro import write_avro_records
from photon_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA

from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.estimators.game_transformer import GameTransformer
from photon_tpu_torch.io import columnar
from photon_tpu_torch.io.columnar import _load_lib, stream_avro_columnar, stream_blocks
from photon_tpu_torch.io.data_reader import FeatureShardConfig, concat_game_batches, read_merged, stream_merged
from photon_tpu_torch.io.pipeline import (
    BatchChunk,
    ChunkReplayCache,
    RetryPolicy,
    assemble_host_batches,
    columnar_nbytes,
    device_chunks_from,
    materialize_game_batch,
    stream_device_batches,
    stream_host_batches,
)
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import FixedEffectModel, GameModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import faults, resources
from photon_tpu_torch.utils.faults import FaultPlan, FaultRule
from photon_tpu_torch.utils.timed import PipelineStats

REPO = Path(__file__).resolve().parent.parent
rng = np.random.default_rng(7)
CPU = "cpu"

native_available = pytest.mark.skipif(_load_lib() is None, reason="no C++ toolchain for the native decoder")

CFG = {"s": FeatureShardConfig(feature_bags=["features"])}
IDS = {"userId": "userId"}


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv(faults.FAULT_PLAN_ENV, raising=False)
    faults.reset()
    resources.stop_watchdog()
    yield
    faults.reset()
    resources.stop_watchdog()


def _plan(*rules, seed=0):
    return faults.configure(FaultPlan(seed=seed, rules=tuple(rules)))


def _write(path, n=1000, d=12, block_rows=50, codec="null", users=17):
    records = []
    for i in range(n):
        nnz = int(rng.integers(1, d))
        idx = rng.choice(d, size=nnz, replace=False)
        records.append({
            "uid": str(i), "label": float(i % 2),
            "features": [{"name": f"f{j}", "term": "", "value": float(rng.normal())} for j in idx],
            "metadataMap": {"userId": f"u{i % users}"}, "weight": 1.0 + (i % 3), "offset": 0.25 * (i % 4),
        })
    write_avro_records(str(path), TRAINING_EXAMPLE_SCHEMA, records, codec=codec, block_records=block_rows)
    return records


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_batches_identical(a, b):
    for name in ("label", "weight", "offset", "uid"):
        np.testing.assert_array_equal(_np(getattr(a, name)), _np(getattr(b, name)))
    for k in a.features:
        fa, fb = a.features[k], b.features[k]
        if isinstance(fa, SparseFeatures):
            assert fa.dim == fb.dim and fa.has_plan == fb.has_plan
            for x, y in zip(fa.tensors(), fb.tensors()):
                np.testing.assert_array_equal(_np(x), _np(y))
        else:
            np.testing.assert_array_equal(_np(fa), _np(fb))
    for k in a.entity_ids:
        np.testing.assert_array_equal(_np(a.entity_ids[k]), _np(b.entity_ids[k]))


def _no_pipe_threads(deadline_s=5.0):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if not [t for t in threading.enumerate() if t.name.startswith("photon-pipe-") and t.is_alive()]:
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------------
# The staged pipeline (reference tests/test_pipeline.py)
# ---------------------------------------------------------------------------


@native_available
@pytest.mark.parametrize("pad_rows_to", [None, 256])
def test_overlap_bit_identical_to_serial(tmp_path, pad_rows_to):
    path = tmp_path / "p.avro"
    _write(path, n=1000)
    _, imaps, _ = read_merged([str(path)], CFG, entity_id_columns=IDS, device=CPU)

    def run(overlap):
        eidx = {}
        chunks = list(stream_device_batches([str(path)], CFG, imaps, entity_id_columns=IDS, entity_indexes=eidx,
                                            chunk_rows=256, pad_rows_to=pad_rows_to, overlap=overlap,
                                            telemetry_label=f"test-overlap-{overlap}", device=CPU))
        return chunks, eidx

    threaded, eidx_t = run(True)
    serial, eidx_s = run(False)
    assert len(threaded) == len(serial) >= 3
    for a, b in zip(threaded, serial):
        assert a.n == b.n and a.index == b.index
        _assert_batches_identical(a.batch, b.batch)
        if pad_rows_to:
            assert a.batch.n % pad_rows_to == 0
    assert eidx_t["userId"].ids() == eidx_s["userId"].ids()
    assert _no_pipe_threads()


@native_available
def test_pipeline_error_reaches_consumer_and_threads_exit(tmp_path):
    path = tmp_path / "bad.avro"
    _write(path, n=500)
    raw = path.read_bytes()
    path.write_bytes(raw[: len(raw) - 40])  # truncate inside the last block
    good = tmp_path / "good.avro"
    _write(good, n=500)
    _, imaps, _ = read_merged([str(good)], CFG, device=CPU)
    with pytest.raises(Exception):
        list(stream_device_batches([str(path)], CFG, imaps, chunk_rows=64, overlap=True,
                                   telemetry_label="test-error", device=CPU))
    assert _no_pipe_threads()


@native_available
def test_abandoned_pipeline_shuts_down_threads(tmp_path):
    path = tmp_path / "a.avro"
    _write(path, n=2000)
    _, imaps, _ = read_merged([str(path)], CFG, device=CPU)
    gen = stream_device_batches([str(path)], CFG, imaps, chunk_rows=64, depth=1, overlap=True,
                                telemetry_label="test-abandon", device=CPU)
    assert next(gen).n > 0
    gen.close()
    assert _no_pipe_threads()


@native_available
def test_materialize_matches_slurp(tmp_path):
    path = tmp_path / "m.avro"
    _write(path, n=700)
    full, imaps, _ = read_merged([str(path)], CFG, entity_id_columns=IDS, device=CPU)
    merged = materialize_game_batch(stream_device_batches([str(path)], CFG, imaps, entity_id_columns=IDS,
                                                          chunk_rows=128, telemetry_label="test-materialize",
                                                          device=CPU))
    assert merged.n == full.n
    _assert_batches_identical(merged, full)


def test_materialize_empty_stream_raises():
    with pytest.raises(ValueError, match="zero data blocks"):
        materialize_game_batch(iter(()))


def _fake_chunks(k=5, rows=10):
    """Chunks whose batch holds only a float64 label of ``rows`` rows
    (``chunk_nbytes``: 8·rows bytes)."""
    empty = torch.zeros(0)
    return [BatchChunk(GameBatch(label=torch.full((rows,), float(i), dtype=torch.float64), offset=empty,
                                 weight=empty, features={}, entity_ids={}), rows, i) for i in range(k)]


def test_replay_cache_replays_without_second_decode():
    pulls = {"n": 0}
    chunks = _fake_chunks()

    def factory():
        pulls["n"] += 1
        yield from chunks

    cache = ChunkReplayCache(factory, byte_budget=1 << 20)
    first, second = list(cache), list(cache)
    assert pulls["n"] == 1 and cache.source_passes == 1 and cache.replay_passes == 1 and not cache.spilled
    assert [c.index for c in first] == [c.index for c in second] == list(range(5))
    assert all(a is b for a, b in zip(first, second))  # the same host chunks, no copies


def test_replay_cache_spills_over_budget_and_restreams():
    """spill_dir=None: over budget, drop the cache and re-stream every pass."""
    chunks = _fake_chunks(k=4, rows=100)  # 800 B a chunk
    pulls = {"n": 0}

    def factory():
        pulls["n"] += 1
        yield from chunks

    cache = ChunkReplayCache(factory, byte_budget=1000, spill_dir=None)
    assert len(list(cache)) == 4
    assert cache.spilled and cache.cached_bytes == 0
    assert len(list(cache)) == 4
    assert pulls["n"] == 2 and cache.replay_passes == 0


def test_replay_cache_spills_to_disk_and_replays(tmp_path):
    """Over budget the overflow spools to disk, and every later pass replays
    the memory prefix and the spool in order: decode is paid once (the
    reference's spilled-bytes counter is the cache's ``spilled_bytes``)."""
    chunks = _fake_chunks(k=4, rows=100)
    pulls = {"n": 0}

    def factory():
        pulls["n"] += 1
        yield from chunks

    cache = ChunkReplayCache(factory, byte_budget=1000, spill_dir=str(tmp_path))
    first = list(cache)
    assert pulls["n"] == 1 and cache.spilled
    assert cache.cached_bytes <= 1000 and cache.spilled_bytes == 3 * 800
    second = list(cache)
    assert pulls["n"] == 1 and cache.replay_passes == 1
    assert [c.index for c in second] == [c.index for c in first]
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.batch.label.numpy(), b.batch.label.numpy())
    cache.close()
    assert not any(tmp_path.glob("spool-*.pkl"))


def test_replay_cache_disk_spill_abandoned_pass_retries(tmp_path):
    pulls = {"n": 0}

    def factory():
        pulls["n"] += 1
        yield from _fake_chunks(k=4, rows=100)

    cache = ChunkReplayCache(factory, byte_budget=1000, spill_dir=str(tmp_path))
    it = iter(cache)
    for _ in range(3):
        next(it)  # past the spill point
    it.close()
    assert not any(tmp_path.glob("spool-*.pkl"))
    assert len(list(cache)) == 4 and pulls["n"] == 2
    assert len(list(cache)) == 4 and pulls["n"] == 2


def test_replay_cache_abandoned_pass_restreams():
    pulls = {"n": 0}

    def factory():
        pulls["n"] += 1
        yield from _fake_chunks()

    cache = ChunkReplayCache(factory, byte_budget=1 << 20)
    it = iter(cache)
    next(it)
    it.close()
    assert not cache.spilled and cache.cached_bytes == 0
    assert len(list(cache)) == 5 and pulls["n"] == 2
    assert len(list(cache)) == 5 and pulls["n"] == 2


@native_available
def test_replay_then_assemble_matches_direct_stream(tmp_path):
    path = tmp_path / "r.avro"
    _write(path, n=600)
    _, imaps, _ = read_merged([str(path)], CFG, device=CPU)
    cache = ChunkReplayCache(lambda: stream_avro_columnar([str(path)], chunk_rows=128), byte_budget=1 << 26,
                             nbytes=columnar_nbytes)
    out = [materialize_game_batch(device_chunks_from(lambda: assemble_host_batches(iter(cache), CFG, imaps,
                                                                                   device=CPU),
                                                     telemetry_label="test-replay", device=CPU))
           for _pass in range(2)]
    assert cache.source_passes == 1 and cache.replay_passes == 1
    direct = materialize_game_batch(device_chunks_from(
        lambda: stream_host_batches([str(path)], CFG, imaps, chunk_rows=128, device=CPU),
        telemetry_label="test-direct", device=CPU))
    for merged in out:
        _assert_batches_identical(merged, direct)


@native_available
def test_streamed_scoring_buckets_shapes_and_matches_whole_batch(tmp_path):
    """Streamed chunks (a ragged tail among them) padded to the chunk rows
    meet fewer shapes than there are chunks, and the padding rows leave
    the valid rows' scores exactly those of the whole batch."""
    path = tmp_path / "t.avro"
    _write(path, n=1000, block_rows=50)
    full, imaps, _ = read_merged([str(path)], CFG, device=CPU)
    w = torch.from_numpy(rng.normal(size=(len(imaps["s"]),)).astype(np.float32))
    model = GameModel({"global": FixedEffectModel(GeneralizedLinearModel(Coefficients(w),
                                                                         TaskType.LINEAR_REGRESSION), "s")})
    transformer = GameTransformer(model)
    chunks = list(stream_device_batches([str(path)], CFG, imaps, chunk_rows=256, pad_rows_to=256,
                                        telemetry_label="test-buckets", device=CPU))
    assert len(chunks) >= 3 and chunks[-1].n < 256
    shapes = {c.batch.n for c in chunks}
    assert len(shapes) < len(chunks)
    scores = np.concatenate([transformer.transform(c.batch).numpy()[: c.n] for c in chunks])
    np.testing.assert_array_equal(scores, GameTransformer(model).transform(full).numpy())


# ---------------------------------------------------------------------------
# Retries, skip budget, fault hooks (the pipeline cases of tests/test_faults.py)
# ---------------------------------------------------------------------------


def _staged(stage_fn, items, policy, overlap):
    from photon_tpu_torch.io.pipeline import _run_staged

    return list(_run_staged(lambda: iter(items), lambda x: 0, [("work", stage_fn, lambda x: 0)],
                            PipelineStats(overlapped=overlap), 2, overlap, retry=policy))


@pytest.mark.parametrize("overlap", [True, False])
def test_pipeline_transient_retry_then_succeed(overlap):
    attempts = Counter()

    def flaky(x):
        attempts[x] += 1
        if x == 2 and attempts[x] <= 2:
            raise TimeoutError("transient hiccup")
        return x * 10

    out = _staged(flaky, range(5), RetryPolicy(max_retries=2, backoff_s=0.001, backoff_max_s=0.002), overlap)
    assert out == [0, 10, 20, 30, 40] and attempts[2] == 3


@pytest.mark.parametrize("overlap", [True, False])
def test_pipeline_skip_budget_drops_poisoned_chunk(overlap):
    def poisoned(x):
        if x == 1:
            raise RuntimeError("poisoned chunk")
        return x

    assert _staged(poisoned, range(4), RetryPolicy(max_retries=1, backoff_s=0.001, skip_budget=1), overlap) == [0, 2, 3]


def test_pipeline_exhausted_budget_raises_promptly():
    def poisoned(x):
        if x >= 1:
            raise RuntimeError(f"poisoned chunk {x}")
        return x

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="poisoned chunk 2"):
        _staged(poisoned, range(4), RetryPolicy(max_retries=0, backoff_s=0.001, skip_budget=1), overlap=True)
    assert time.monotonic() - t0 < 30


def test_ingest_fault_plan_injects_and_recovers():
    """An injected transient at the real ``ingest.h2d`` hook is retried and
    the stream completes in order."""
    _plan(FaultRule("ingest.h2d", kind="transient", at=(0,)))
    chunks = _fake_chunks(k=3, rows=4)
    out = list(device_chunks_from(lambda: iter(chunks), retry=RetryPolicy(max_retries=2, backoff_s=0.001),
                                  device=CPU))
    assert [int(c.batch.label[0]) for c in out] == [0, 1, 2]
    assert faults.injector().counts() == {"ingest.h2d": 1}


def test_stage_worker_processes_in_order_and_raises_its_failure():
    """A StageWorker runs its items in submission order on its own thread,
    counts them, and raises the worker's failure at the next submit or at
    close."""
    from photon_tpu_torch.io.pipeline import StageWorker
    from photon_tpu_torch.utils.timed import StageStats

    seen = []
    stage = StageStats("d2h")
    worker = StageWorker("d2h", seen.append, stage, depth=1)
    for i in range(5):
        worker.submit(i)
    worker.close()
    assert seen == list(range(5)) and stage.items == 5

    def fail(x):
        if x == 1:
            raise ValueError("bad item")

    worker = StageWorker("d2h-fail", fail, StageStats("d2h-fail"), depth=1)
    with pytest.raises(ValueError, match="bad item"):
        for i in range(50):
            worker.submit(i)
            time.sleep(0.01)
        worker.close()
    worker.abort()
    assert _no_pipe_threads()


def test_retry_policy_env_overrides(monkeypatch):
    from photon_tpu_torch.io.pipeline import DEAD_LETTER_ENV, MAX_RETRIES_ENV, SKIP_BUDGET_ENV, default_retry_policy

    monkeypatch.setenv(MAX_RETRIES_ENV, "5")
    monkeypatch.setenv(SKIP_BUDGET_ENV, "3")
    monkeypatch.setenv(DEAD_LETTER_ENV, "/x/dl.jsonl")
    p = default_retry_policy()
    assert (p.max_retries, p.skip_budget, p.dead_letter_path) == (5, 3, "/x/dl.jsonl")


# ---------------------------------------------------------------------------
# Replay spool and dead letters under resource faults (tests/test_resources.py)
# ---------------------------------------------------------------------------


class _Chunk:
    def __init__(self, i):
        self.index = i
        self.data = np.full(64, float(i))


def _chunks(n=6):
    def factory():
        for i in range(n):
            yield _Chunk(i)

    return factory


def _indices(it):
    return [c.index for c in it]


def _replay_cache(spill):
    # The budget fits exactly two 512-byte chunks; the rest spools.
    return ChunkReplayCache(_chunks(), byte_budget=2 * 64 * 8 + 1, nbytes=lambda c: c.data.nbytes, spill_dir=spill)


def test_replay_spool_enospc_falls_back_to_restream(tmp_path):
    spill = str(tmp_path / "spill")
    cache = _replay_cache(spill)
    _plan(FaultRule("spool.write", kind="enospc", at=(0,)))
    assert _indices(cache) == list(range(6))
    assert cache.spilled
    assert glob.glob(os.path.join(spill, "spool-*.pkl")) == []
    assert _indices(cache) == list(range(6))
    assert cache.source_passes == 2  # the fallback re-streams: decode re-paid


def test_replay_torn_spool_recovers_with_exact_parity(tmp_path):
    spill = str(tmp_path / "spill")
    cache = _replay_cache(spill)
    assert _indices(cache) == list(range(6))
    spools = glob.glob(os.path.join(spill, "spool-*.pkl"))
    assert len(spools) == 1
    with open(spools[0], "rb") as f:
        first = pickle.load(f)
        intact = f.tell()
    assert first.index == 2
    with open(spools[0], "rb+") as f:
        f.truncate(intact + 7)
    assert _indices(cache) == list(range(6))
    assert cache.source_passes == 2  # the torn pass re-streamed from the source
    assert glob.glob(os.path.join(spill, "spool-*.pkl")) == []
    assert _indices(cache) == list(range(6))
    assert _indices(cache) == list(range(6))


def test_dead_letter_write_failure_does_not_mask_chunk_error(tmp_path):
    from photon_tpu_torch.io.pipeline import _SkipBudget

    dl = str(tmp_path / "letters.jsonl")
    _plan(FaultRule("deadletter.write", kind="enospc", p=1.0))
    budget = _SkipBudget(2, dl)
    budget.dead_letter("decode", _Chunk(1), RuntimeError("original"))  # swallowed
    assert not os.path.exists(dl) or os.path.getsize(dl) == 0
    budget.dead_letter("decode", _Chunk(2), RuntimeError("original"))
    faults.reset()
    budget.dead_letter("decode", _Chunk(3), RuntimeError("original"))
    with open(dl) as f:
        lines = f.readlines()
    assert len(lines) == 1 and json.loads(lines[0])["chunk"] == 3


def test_replay_cache_stops_caching_under_memory_pressure(tmp_path):
    wd = resources.start_watchdog(limit_bytes=1 << 62, interval_s=3600)
    _plan(FaultRule("rss.sample", kind="rss", p=1.0, message="soft"))
    wd.sample()
    cache = _replay_cache(str(tmp_path / "spill"))
    assert _indices(cache) == list(range(6))
    assert cache.cached_bytes == 0 and cache.spilled


# ---------------------------------------------------------------------------
# Streaming ingest (reference tests/test_streaming_ingest.py)
# ---------------------------------------------------------------------------


def test_stream_blocks_is_incremental(tmp_path):
    path = tmp_path / "s.avro"
    _write(path, n=500, block_rows=50)
    schema, gen = stream_blocks(str(path))
    assert schema["name"].endswith("TrainingExampleAvro")
    first = next(gen)
    assert first[0] == 50 and len(first[1]) > 0
    assert first[0] + sum(c for c, _ in gen) == 500


@native_available
@pytest.mark.parametrize("chunk_rows", [64, 256, 10_000])
def test_stream_merged_parity_with_slurp(tmp_path, chunk_rows):
    path = tmp_path / "p.avro"
    _write(path, n=1000, block_rows=97, codec="deflate", users=23)
    full, imaps, eidx_full = read_merged([str(path)], CFG, entity_id_columns=IDS, device=CPU)
    eidx_stream = {}
    chunks = list(stream_merged([str(path)], CFG, imaps, entity_id_columns=IDS, entity_indexes=eidx_stream,
                                chunk_rows=chunk_rows, device=CPU))
    if chunk_rows < 1000:
        assert len(chunks) > 1 and all(c.n <= chunk_rows + 97 for c in chunks)
    merged = concat_game_batches(chunks)
    assert merged.n == full.n == 1000
    _assert_batches_identical(merged, full)
    assert eidx_stream["userId"].ids() == eidx_full["userId"].ids()


@native_available
def test_stream_avro_columnar_chunk_sizes(tmp_path):
    path = tmp_path / "c.avro"
    _write(path, n=640, block_rows=64)
    sizes = [c.n for c in stream_avro_columnar([str(path)], chunk_rows=128)]
    assert sum(sizes) == 640 and all(s >= 128 for s in sizes[:-1]) and max(sizes) <= 128 + 64


@native_available
def test_stream_merged_requires_native(tmp_path, monkeypatch):
    """Streaming is a hard error without the native decoder, never a
    whole-file fallback."""
    path = tmp_path / "x.avro"
    _write(path, n=10)
    monkeypatch.setattr(columnar, "_load_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native decoder"):
        list(stream_merged([str(path)], CFG, {}, chunk_rows=4, device=CPU))


@native_available
def test_corrupt_container_never_crashes_the_process(tmp_path):
    path = tmp_path / "ok.avro"
    _write(path, n=200, block_rows=50)
    good = path.read_bytes()
    mut_rng = np.random.default_rng(99)
    bad = tmp_path / "bad.avro"
    outcomes = {"ok": 0, "raised": 0}
    for trial in range(50):
        data = bytearray(good)
        if trial % 2 == 0:
            for _ in range(int(mut_rng.integers(1, 5))):
                pos = int(mut_rng.integers(0, len(data)))
                data[pos] ^= 1 << int(mut_rng.integers(0, 8))
        else:
            data = data[:int(mut_rng.integers(16, len(data)))]
        bad.write_bytes(bytes(data))
        try:
            batch, _, _ = read_merged([str(bad)], CFG, device=CPU)
            assert batch.n >= 0
            outcomes["ok"] += 1
        except Exception:  # noqa: BLE001 — any Python error is acceptable
            outcomes["raised"] += 1
    assert outcomes["raised"] > 0, outcomes


@native_available
@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("chunk_rows", [64, 300, 10_000])
def test_parallel_stream_bit_identical_to_serial(tmp_path, chunk_rows, codec):
    path = tmp_path / "par.avro"
    _write(path, n=1200, block_rows=53, codec=codec)
    serial = list(stream_avro_columnar([str(path)], chunk_rows=chunk_rows, workers=1))
    parallel = list(stream_avro_columnar([str(path)], chunk_rows=chunk_rows, workers=4))
    assert len(serial) == len(parallel)
    for s, p in zip(serial, parallel):
        assert s.n == p.n and s.intern == p.intern
        for group in ("numeric", "longs", "strings"):
            for k in getattr(s, group):
                np.testing.assert_array_equal(getattr(s, group)[k], getattr(p, group)[k])
        for k in s.bags:
            for part in ("offsets", "key_ids", "values"):
                np.testing.assert_array_equal(getattr(s.bags[k], part), getattr(p.bags[k], part))
        for part in ("meta_rows", "meta_keys", "meta_vals"):
            np.testing.assert_array_equal(getattr(s, part), getattr(p, part))


@native_available
def test_abandoned_stream_shuts_down_decode_pool(tmp_path, monkeypatch):
    import concurrent.futures as cf

    shutdowns = []

    class SpyPool(cf.ThreadPoolExecutor):
        def shutdown(self, wait=True, *, cancel_futures=False):
            shutdowns.append({"wait": wait, "cancel_futures": cancel_futures})
            super().shutdown(wait=wait, cancel_futures=cancel_futures)

    monkeypatch.setattr(cf, "ThreadPoolExecutor", SpyPool)
    path = tmp_path / "abandon.avro"
    _write(path, n=2000, block_rows=20)
    gen = stream_avro_columnar([str(path)], chunk_rows=40, workers=4)
    assert next(gen).n > 0
    assert shutdowns == []
    gen.close()
    assert shutdowns == [{"wait": True, "cancel_futures": True}]
    assert not any(t.is_alive() for t in threading.enumerate()
                   if t.name.startswith("SpyPool") or "ThreadPoolExecutor" in t.name)


@native_available
def test_parallel_stream_malformed_block_raises(tmp_path):
    path = tmp_path / "bad.avro"
    _write(path, n=300, block_rows=50)
    raw = bytearray(path.read_bytes())
    raw[-40] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(Exception):
        list(stream_avro_columnar([str(path)], chunk_rows=64, workers=4))


@native_available
@pytest.mark.parametrize("chunk_rows", [64, 256, 10_000])
@pytest.mark.parametrize("shard", ["dense", "sparse"])
def test_stream_merged_matches_slurp_and_reference(tmp_path, shard, chunk_rows):
    """``stream_merged`` + ``concat_game_batches`` equal ``read_merged`` bit
    for bit (a padded-sparse shard with its transpose plan), and equal the
    reference's ``stream_merged`` + ``concat_game_batches`` (whose unused
    sparse slots are -1 where the port's are 0)."""
    from photon_tpu.io.data_reader import FeatureShardConfig as JShardConfig
    from photon_tpu.io.data_reader import concat_game_batches as j_concat
    from photon_tpu.io.data_reader import read_merged as j_read_merged
    from photon_tpu.io.data_reader import stream_merged as j_stream_merged

    path = tmp_path / "p.avro"
    _write(path, n=1000, block_rows=97, codec="deflate", users=23)
    limit = 4096 if shard == "dense" else 4
    cfg = {"s": FeatureShardConfig(dense_dim_limit=limit, transpose_plan=shard == "sparse")}
    jcfg = {"s": JShardConfig(dense_dim_limit=limit, transpose_plan=False)}
    full, imaps, _ = read_merged([str(path)], cfg, entity_id_columns=IDS, device=CPU)
    merged = concat_game_batches(list(stream_merged([str(path)], cfg, imaps, entity_id_columns=IDS, entity_indexes={},
                                                    chunk_rows=chunk_rows, device=CPU)))
    _assert_batches_identical(merged, full)
    _, jmaps, _ = j_read_merged([str(path)], jcfg, entity_id_columns=IDS)
    jmerged = j_concat(list(j_stream_merged([str(path)], jcfg, jmaps, entity_id_columns=IDS, entity_indexes={},
                                            chunk_rows=chunk_rows)))
    for name in ("label", "weight", "offset", "uid"):
        np.testing.assert_array_equal(_np(getattr(merged, name)), np.asarray(getattr(jmerged, name)))
    np.testing.assert_array_equal(_np(merged.entity_ids["userId"]), np.asarray(jmerged.entity_ids["userId"]))
    f, g = merged.features["s"], jmerged.features["s"]
    if shard == "sparse":
        ref_idx = np.asarray(g.indices)
        np.testing.assert_array_equal(_np(f.indices), np.where(ref_idx < 0, 0, ref_idx))
        np.testing.assert_array_equal(_np(f.values), np.asarray(g.values))
    else:
        np.testing.assert_array_equal(_np(f), np.asarray(g))


# ---------------------------------------------------------------------------
# Streamed drivers
# ---------------------------------------------------------------------------


def _glm_records(n, d, seed):
    r = np.random.default_rng(seed)
    w_true = r.normal(size=d) * 1.5
    recs = []
    for i in range(n):
        x = r.normal(size=d)
        x[r.uniform(size=d) < 0.2] = 0.0
        recs.append({"uid": str(i), "label": float(r.uniform() < 1 / (1 + np.exp(-x @ w_true))),
                     "features": [{"name": f"f{j}", "term": "t" if j % 4 == 0 else "", "value": float(x[j])}
                                  for j in range(d) if x[j] != 0.0],
                     "metadataMap": None, "weight": None, "offset": None})
    return recs


@native_available
@pytest.mark.parametrize("replay_mb", [1024, 0], ids=["in-memory", "spilled"])
def test_streamed_train_glm_matches_reference(tmp_path, replay_mb):
    """``train_glm --stream-ingest-chunk-rows`` in the port equals the
    reference driver's on the same Avro file (f32, 1e-3), with the replay
    cache held in memory or spilled to disk; the streamed data are bit for
    bit the slurped data (the same losses as the port's whole-file run)."""
    from photon_tpu.cli import train_glm as j_train_glm

    from photon_tpu_torch.cli import train_glm

    train = tmp_path / "t.avro"
    write_avro_records(str(train), TRAINING_EXAMPLE_SCHEMA, _glm_records(600, 9, seed=3), block_records=50)
    valid = tmp_path / "v.avro"
    write_avro_records(str(valid), TRAINING_EXAMPLE_SCHEMA, _glm_records(200, 9, seed=4), block_records=50)
    argv = ["--training-data", str(train), "--validation-data", str(valid), "--regularization-weights", "10,1,0.1",
            "--stream-ingest-chunk-rows", "128", "--replay-cache-mb", str(replay_mb)]
    want = j_train_glm.run(j_train_glm.build_parser().parse_args(argv + ["--output-dir", str(tmp_path / "j")]))
    got = train_glm.main(argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    slurped = train_glm.main(argv[:6] + ["--output-dir", str(tmp_path / "s"), "--device", "cpu"])
    assert got["best_lambda"] == want["best_lambda"]
    for g, w, s in zip(got["models"], want["models"], slurped["models"]):
        assert g["lambda"] == w["lambda"]
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-3)
        assert g["loss"] == s["loss"] and g["iterations"] == s["iterations"]
        assert g["validation"]["Area under ROC"] == pytest.approx(w["validation"]["Area under ROC"], abs=1e-3)
    ing = got["ingest"]
    assert ing["decode_passes"] == 1 and ing["replay_passes"] == 1 and ing["rows"] == 600
    assert ing["spilled"] == (replay_mb == 0)
    assert not glob.glob(str(tmp_path / "photon-replay-*"))


def _game_files(tmp_path):
    from test_torch_game_drivers import SHARDS, _records, _write

    from photon_tpu_torch.cli import feature_indexing

    d = tmp_path / "data"
    d.mkdir()
    train = _write(d / "train.avro", _records(400, 23, list(range(8))))
    valid = _write(d / "valid.avro", _records(200, 24, list(range(10))))
    feature_indexing.main(["--input-paths", train, "--output-dir", str(d / "index"), *SHARDS])
    return train, valid, str(d / "index")


@native_available
def test_streamed_game_drivers_match_whole_file_reads(tmp_path):
    """game_training with --stream-ingest-chunk-rows trains the model of the
    whole-file read exactly; game_scoring streamed (overlapped and serial)
    writes the whole-file read's scores exactly, with the pipeline's
    stages in its output; a stream without --feature-index-dir exits."""
    from test_torch_game_drivers import GLOBAL, PER_ITEM, PER_USER, SHARDS, _coefficient_records

    from photon_tpu_torch.cli import game_scoring, game_training
    from photon_tpu_torch.io.avro import read_avro_records
    from photon_tpu_torch.io.scores import load_scores

    train, valid, index = _game_files(tmp_path)
    argv = ["--input-paths", train, "--validation-paths", valid, *SHARDS, "--coordinate-configurations", GLOBAL,
            PER_USER, PER_ITEM, "--update-sequence", "global,perUser,perItem", "--coordinate-descent-iterations", "2",
            "--evaluators", "AUC", "--feature-index-dir", index, "--device", "cpu"]
    whole = game_training.main(argv + ["--output-dir", str(tmp_path / "whole")])
    streamed = game_training.main(argv + ["--output-dir", str(tmp_path / "streamed"),
                                          "--stream-ingest-chunk-rows", "64"])
    assert streamed == whole
    assert (_coefficient_records(tmp_path / "streamed" / "best", read_avro_records)
            == _coefficient_records(tmp_path / "whole" / "best", read_avro_records))
    with pytest.raises(SystemExit, match="requires --feature-index-dir"):
        game_training.main(argv[:-4] + ["--device", "cpu", "--output-dir", str(tmp_path / "x"),
                                        "--stream-ingest-chunk-rows", "64"])

    score = ["--input-paths", valid, *SHARDS, "--model-input-dir", str(tmp_path / "whole" / "best"),
             "--evaluators", "AUC", "--device", "cpu"]
    base = game_scoring.main(score + ["--output-dir", str(tmp_path / "s0")])
    want = load_scores(str(tmp_path / "s0" / "scores.avro"))
    for i, extra in enumerate((["--ingest-queue-depth", "1"], ["--serial-ingest"])):
        out = game_scoring.main(score + ["--output-dir", str(tmp_path / f"s{i + 1}"),
                                         "--stream-ingest-chunk-rows", "48", *extra])
        assert out["numScored"] == base["numScored"] == 200
        assert out["metrics"] == base["metrics"]
        assert set(out["ingestPipeline"]["stages"]) == {"decode", "assemble", "h2d", "compute"}
        assert out["ingestPipeline"]["overlapped"] == (extra[0] != "--serial-ingest")
        assert load_scores(str(tmp_path / f"s{i + 1}" / "scores.avro")) == want
    assert _no_pipe_threads()


@native_available
def test_streamed_scoring_maps_stream_errors_to_advice(tmp_path, monkeypatch):
    from test_torch_game_drivers import GLOBAL, SHARDS

    from photon_tpu_torch.cli import game_scoring, game_training

    train, valid, index = _game_files(tmp_path)
    game_training.main(["--input-paths", train, *SHARDS, "--coordinate-configurations", GLOBAL, "--update-sequence",
                        "global", "--output-dir", str(tmp_path / "m"), "--device", "cpu"])
    monkeypatch.setattr(columnar, "_load_lib", lambda: None)
    with pytest.raises(SystemExit, match="drop --stream-ingest-chunk-rows"):
        game_scoring.main(["--input-paths", valid, *SHARDS, "--model-input-dir", str(tmp_path / "m" / "best"),
                           "--output-dir", str(tmp_path / "s"), "--stream-ingest-chunk-rows", "64", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Bounded RSS on a huge file (reference tests/test_big_ingest.py)
# ---------------------------------------------------------------------------

BIG_GB = float(os.environ.get("PHOTON_BIG_INGEST_GB", "0"))

_CHILD = r"""
import json, sys, time
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.io.data_reader import FeatureShardConfig, stream_merged

path = sys.argv[1]
imaps = {"s": IndexMap.build([IndexMap.key(f"f{j}") for j in range(48)])}

def peak_mb():
    for line in open("/proc/self/status"):
        if line.startswith("VmHWM"):
            return int(line.split()[1]) / 1024.0
    return float("nan")

cfg = {"s": FeatureShardConfig(feature_bags=["features"])}
eidx = {}
base_mb = peak_mb()
rows = 0
t0 = time.perf_counter()
for chunk in stream_merged([path], cfg, imaps, entity_id_columns={"userId": "userId"}, entity_indexes=eidx,
                           chunk_rows=1 << 16, device="cpu"):
    rows += chunk.n  # dropped at once: bounded memory is the contract
print(json.dumps({"rows": rows, "secs": round(time.perf_counter() - t0, 2), "base_mb": round(base_mb, 1),
                  "peak_mb": round(peak_mb(), 1), "entities": len(eidx["userId"].ids())}))
"""


@pytest.mark.skipif(BIG_GB <= 0, reason="set PHOTON_BIG_INGEST_GB to run")
@native_available
def test_streaming_ingest_bounded_rss_on_huge_file(tmp_path):
    """One encoded container body replicated to PHOTON_BIG_INGEST_GB,
    streamed in a fresh process whose peak RSS must stay far below the
    file."""
    import io as _io

    from photon_tpu_torch.io.columnar import _read_header

    target = int(BIG_GB * (1 << 30))
    path = str(tmp_path / "huge.avro")
    base = path + ".base"
    n, d = 1 << 16, 48
    r = np.random.default_rng(7)
    records = [{"uid": str(i), "label": float(i % 2),
                "features": [{"name": f"f{j}", "term": "", "value": float(r.standard_normal())}
                             for j in r.choice(d, size=12, replace=False)],
                "metadataMap": {"userId": f"u{i % 4096}"}, "weight": 1.0, "offset": 0.0} for i in range(n)]
    write_avro_records(base, TRAINING_EXAMPLE_SCHEMA, records, block_records=8192)
    with open(base, "rb") as f:
        blob = f.read()
    os.unlink(base)
    *_rest, body_off = _read_header(_io.BytesIO(blob))
    header, body = blob[:body_off], blob[body_off:]
    repeats = max(1, int(np.ceil((target - len(header)) / len(body))))
    with open(path, "wb") as f:
        f.write(header)
        for _ in range(repeats):
            f.write(body)
    out = subprocess.run([sys.executable, "-c", _CHILD, path], capture_output=True, text=True, timeout=3600,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rows"] == n * repeats
    assert res["peak_mb"] - res["base_mb"] < 3072, res
