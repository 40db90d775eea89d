"""Copy of photon_tpu/io/columnar.py (framework-free; the port does not import
it), apart from where the native library is built and the whole-file read's
concurrent block decode (``read_avro_columnar(workers=)``).

Columnar Avro ingest: native block decode + vectorized batch assembly.

The row-oriented reader (io/avro.py + io/data_reader.py) walks every record
field by field in Python. This module decodes container blocks into COLUMNS
in one C++ pass (photon_tpu_torch/native/avro_decode.cpp, a copy of the
reference's decoder): numeric columns, interned string columns, feature bags
as CSR (offsets/key-ids/values) and metadata triplets, with all string
interning done natively. Python's remaining work is vectorized numpy: one
IndexMap lookup per DISTINCT feature key, one scatter per shard.

The library is built at first use with ``g++ -O2 -std=c++17 -shared -fPIC``
into ``BUILD_DIR`` (the repo's gitignored ``build/torch_native/``), under a
name that carries the hash of the source, so a changed source builds anew and
nothing is ever rebuilt in place: the compiler writes a file of its own
process and ``os.replace`` moves the finished library into place, so
processes that load it at once never see a partial file. ``read_avro_columnar``
returns None when the library cannot be built or loaded, or the writer schema
is outside the supported program; ``load_error()`` says why (callers fall
back to the rows).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_tpu_torch.io.avro import MAGIC, SYNC_SIZE, _Codec, _META_SCHEMA, _Reader

# Program opcodes (avro_decode.cpp header).
_OP_DOUBLE, _OP_OPT_DOUBLE, _OP_STR, _OP_OPT_STR = 0, 1, 2, 3
_OP_BAG, _OP_OPT_MAP, _OP_MAP, _OP_FLOAT, _OP_LONG = 4, 5, 6, 7, 8


@dataclasses.dataclass
class FeatureBagColumn:
    offsets: np.ndarray  # (n+1,) int64 CSR row offsets
    key_ids: np.ndarray  # (nnz,) int32 interned feature keys
    values: np.ndarray  # (nnz,) float64


@dataclasses.dataclass
class ColumnarRows:
    """Struct-of-arrays view of a training-row file set."""

    n: int
    numeric: Dict[str, np.ndarray]  # field -> float64, NaN where null
    longs: Dict[str, np.ndarray]  # long fields -> exact int64 (ids > 2^53)
    strings: Dict[str, np.ndarray]  # field -> int32 intern ids, -1 null
    bags: Dict[str, FeatureBagColumn]
    meta_rows: np.ndarray  # (m,) int32 record index
    meta_keys: np.ndarray  # (m,) int32 intern ids (metadata key)
    meta_vals: np.ndarray  # (m,) int32 intern ids (metadata value)
    intern: List[str]  # id -> string

    def meta_column(self, name: str) -> np.ndarray:
        """Per-record intern id of metadataMap[name] (-1 where absent)."""
        out = np.full(self.n, -1, np.int32)
        try:
            key_id = self.intern.index(name)
        except ValueError:
            return out
        sel = self.meta_keys == key_id
        out[self.meta_rows[sel]] = self.meta_vals[sel]
        return out


BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_native"
SOURCE = Path(__file__).resolve().parent.parent / "native" / "avro_decode.cpp"


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libavro_decode_{digest}.so"


_lib = None
_lib_failed: Optional[str] = None


def load_error() -> Optional[str]:
    """Why the native decoder could not be built or loaded (None: it was, or
    it was not tried yet)."""
    return _lib_failed


def _build(so: Path) -> None:
    """Compile the decoder to a file of this process, then move it into place."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed is not None:
        return _lib
    so = _lib_path()
    if not so.exists():
        try:
            _build(so)
        except FileNotFoundError:
            _lib_failed = "g++ not found"
            return None
        except subprocess.CalledProcessError as exc:
            _lib_failed = f"g++ exited {exc.returncode}: {exc.stderr.strip()[:500]}"
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as exc:
        _lib_failed = f"cannot load {so}: {exc}"
        return None
    lib.avro_dec_new.restype = ctypes.c_void_p
    lib.avro_dec_new.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.avro_dec_block.restype = ctypes.c_int
    lib.avro_dec_block.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
    ]
    for name, res in [
        ("avro_dec_num_records", ctypes.c_int64),
        ("avro_dec_numeric", ctypes.POINTER(ctypes.c_double)),
        ("avro_dec_longcol", ctypes.POINTER(ctypes.c_int64)),
        ("avro_dec_strcol", ctypes.POINTER(ctypes.c_int32)),
        ("avro_dec_bag_len", ctypes.c_int64),
        ("avro_dec_bag_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("avro_dec_bag_keys", ctypes.POINTER(ctypes.c_int32)),
        ("avro_dec_bag_values", ctypes.POINTER(ctypes.c_double)),
        ("avro_dec_meta_len", ctypes.c_int64),
        ("avro_dec_meta_rows", ctypes.POINTER(ctypes.c_int32)),
        ("avro_dec_meta_keys", ctypes.POINTER(ctypes.c_int32)),
        ("avro_dec_meta_vals", ctypes.POINTER(ctypes.c_int32)),
        ("avro_dec_intern_count", ctypes.c_int64),
        ("avro_dec_intern_blob_len", ctypes.c_int64),
        ("avro_dec_intern_blob", ctypes.POINTER(ctypes.c_char)),
        ("avro_dec_intern_offsets", ctypes.POINTER(ctypes.c_int64)),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]
            if name in ("avro_dec_numeric", "avro_dec_longcol", "avro_dec_strcol",
                        "avro_dec_bag_len", "avro_dec_bag_offsets",
                        "avro_dec_bag_keys", "avro_dec_bag_values")
            else [ctypes.c_void_p]
        )
    lib.avro_dec_free.argtypes = [ctypes.c_void_p]
    lib.avro_dec_free.restype = None
    _lib = lib
    return lib


def _type_name(t) -> Optional[str]:
    if isinstance(t, str):
        return t
    if isinstance(t, dict):
        return t.get("type")
    return None


def _is_feature_bag(t) -> bool:
    if not (isinstance(t, dict) and t.get("type") == "array"):
        return False
    items = t.get("items")
    if isinstance(items, str):  # by-name reference to a prior record def
        return items.split(".")[-1] in ("FeatureAvro", "NameTermValueAvro")
    if not (isinstance(items, dict) and items.get("type") == "record"):
        return False
    fields = items.get("fields", [])
    return (
        len(fields) == 3
        and [f["name"] for f in fields] == ["name", "term", "value"]
        and [_type_name(f["type"]) for f in fields] == ["string", "string", "double"]
    )


def compile_program(schema) -> Optional[Tuple[bytes, List[str]]]:
    """Writer schema → (opcode bytes, field names), or None if unsupported."""
    if not (isinstance(schema, dict) and schema.get("type") == "record"):
        return None
    ops: List[int] = []
    names: List[str] = []
    for f in schema.get("fields", []):
        t = f["type"]
        if t == "double":
            ops.append(_OP_DOUBLE)
        elif t == "float":
            ops.append(_OP_FLOAT)
        elif t in ("int", "long"):
            ops.append(_OP_LONG)
        elif t == "string":
            ops.append(_OP_STR)
        elif isinstance(t, list) and t == ["null", "double"]:
            ops.append(_OP_OPT_DOUBLE)
        elif isinstance(t, list) and t == ["null", "string"]:
            ops.append(_OP_OPT_STR)
        elif _is_feature_bag(t):
            ops.append(_OP_BAG)
        elif (
            isinstance(t, list)
            and len(t) == 2
            and t[0] == "null"
            and isinstance(t[1], dict)
            and t[1].get("type") == "map"
            and t[1].get("values") == "string"
        ):
            ops.append(_OP_OPT_MAP)
        elif isinstance(t, dict) and t.get("type") == "map" and t.get("values") == "string":
            ops.append(_OP_MAP)
        else:
            return None
        names.append(f["name"])
    return bytes(ops), names


_HEADER_PROBE = 1 << 16  # initial read: magic + metadata map + sync


def _read_header(f):
    """Parse an object-container header from an open file. Returns
    (schema, codec, sync, byte offset of the first block)."""
    buf = f.read(_HEADER_PROBE)
    if buf[:4] != MAGIC:
        raise ValueError("not an Avro object container file")
    while True:  # metadata map can exceed the probe; grow geometrically
        try:
            r = _Reader(buf)
            r.pos = 4
            meta = _Codec(_META_SCHEMA).decode(r)
            sync = r.read_fixed(SYNC_SIZE)
            if len(sync) != SYNC_SIZE:  # silently-short slice = truncated
                raise IndexError("truncated header")
            break
        except (IndexError, ValueError):
            more = f.read(len(buf))
            if not more:
                raise
            buf += more
    f.seek(r.pos)  # rewind to the first block (probe over-read)
    import json

    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec}")
    return schema, codec, sync, r.pos


def _read_block_varint(f) -> Optional[int]:
    """Read one zigzag varint directly from a file (None at clean EOF)."""
    shift = 0
    acc = 0
    first = f.read(1)
    if not first:
        return None
    b = first[0]
    while True:
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        nxt = f.read(1)
        if not nxt:
            raise ValueError("truncated varint in container block header")
        b = nxt[0]
    return (acc >> 1) ^ -(acc & 1)


def stream_raw_blocks(path: str):
    """(schema, codec, generator of (count, COMPRESSED bytes)) — reads the
    file incrementally so host memory stays bounded by ONE block, not the
    file (the reference streams per partition,
    AvroDataReader.scala:165-209). Decompression is left to the consumer
    so parallel decoders can decompress off the reader's thread.

    The header parse opens/closes the file immediately; the generator
    reopens it lazily on first consumption — an UNSTARTED generator holds
    no file descriptor, so compiling schemas for thousands of paths never
    exhausts the FD limit."""
    with open(path, "rb") as f:
        schema, codec, sync, _pos = _read_header(f)
        start = f.tell()

    def gen():
        with open(path, "rb") as f:
            f.seek(start)
            while True:
                count = _read_block_varint(f)
                if count is None:
                    return
                size = _read_block_varint(f)
                data = f.read(size)
                if len(data) != size:
                    raise ValueError("truncated container block")
                if f.read(SYNC_SIZE) != sync:
                    raise ValueError("bad sync marker (corrupt file)")
                yield count, data

    return schema, codec, gen()


def _inflate(codec: str, data: bytes) -> bytes:
    """Undo a container block's codec (the avro writer's inverse)."""
    return zlib.decompress(data, -15) if codec == "deflate" else data


def stream_blocks(path: str):
    """(schema, generator of (count, decompressed bytes)): the
    decompressed-block view of ``stream_raw_blocks`` (same laziness)."""
    schema, codec, raw = stream_raw_blocks(path)

    def gen():
        for count, data in raw:
            yield count, _inflate(codec, data)

    return schema, gen()


def _extract_columns(lib, ctx, program, names) -> ColumnarRows:
    """Copy a decode context's accumulated columns out into numpy arrays."""
    n = int(lib.avro_dec_num_records(ctx))

    def arr(ptr, count, dtype):
        if count == 0:
            return np.empty(0, dtype)
        return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)

    numeric: Dict[str, np.ndarray] = {}
    longs: Dict[str, np.ndarray] = {}
    strings: Dict[str, np.ndarray] = {}
    bags: Dict[str, FeatureBagColumn] = {}
    for i, op in enumerate(program):
        fname = names[i]
        if op in (_OP_DOUBLE, _OP_OPT_DOUBLE, _OP_FLOAT, _OP_LONG):
            numeric[fname] = arr(lib.avro_dec_numeric(ctx, i), n, np.float64)
            if op == _OP_LONG:
                longs[fname] = arr(lib.avro_dec_longcol(ctx, i), n, np.int64)
        elif op in (_OP_STR, _OP_OPT_STR):
            strings[fname] = arr(lib.avro_dec_strcol(ctx, i), n, np.int32)
        elif op == _OP_BAG:
            nnz = int(lib.avro_dec_bag_len(ctx, i))
            bags[fname] = FeatureBagColumn(
                offsets=arr(lib.avro_dec_bag_offsets(ctx, i), n + 1, np.int64),
                key_ids=arr(lib.avro_dec_bag_keys(ctx, i), nnz, np.int32),
                values=arr(lib.avro_dec_bag_values(ctx, i), nnz, np.float64),
            )
    m = int(lib.avro_dec_meta_len(ctx))
    meta_rows = arr(lib.avro_dec_meta_rows(ctx), m, np.int32)
    meta_keys = arr(lib.avro_dec_meta_keys(ctx), m, np.int32)
    meta_vals = arr(lib.avro_dec_meta_vals(ctx), m, np.int32)

    n_intern = int(lib.avro_dec_intern_count(ctx))
    blob_len = int(lib.avro_dec_intern_blob_len(ctx))
    blob = ctypes.string_at(lib.avro_dec_intern_blob(ctx), blob_len)
    offs = arr(lib.avro_dec_intern_offsets(ctx), n_intern + 1, np.int64)
    intern = [
        blob[offs[i]:offs[i + 1]].decode("utf-8") for i in range(n_intern)
    ]
    return ColumnarRows(
        n=n, numeric=numeric, longs=longs, strings=strings, bags=bags,
        meta_rows=meta_rows, meta_keys=meta_keys, meta_vals=meta_vals,
        intern=intern,
    )


def _compile_for_paths(paths: Sequence[str]):
    """(program, names, list of per-path (codec, raw-block generator)) or
    None when any schema falls outside the supported program / schemas
    differ."""
    program = names = None
    gens = []
    for path in paths:
        schema, codec, gen = stream_raw_blocks(path)
        compiled = compile_program(schema)
        if compiled is None or (
            program is not None
            and (compiled[0] != program or compiled[1] != names)
        ):
            gen.close()
            for _c, g in gens:
                g.close()
            return None
        if program is None:
            program, names = compiled
        gens.append((codec, gen))
    return program, names, gens


def read_avro_columnar(paths: Sequence[str], workers: Optional[int] = None) -> Optional[ColumnarRows]:
    """Decode container files into columns via the native decoder. Blocks
    stream through a bounded window (one decompressed block serially, 2 ×
    ``workers`` concurrently), never the file. Returns None when the native
    path is unavailable or the schema is outside the supported program
    (callers fall back to rows).

    ``workers`` > 1 (default: one a core, at most 16) decodes the blocks
    concurrently, as ``stream_avro_columnar`` does, and merges them: the
    same columns, bit for bit, as the serial pass (which the reference
    always takes)."""
    lib = _load_lib()
    if lib is None:
        return None
    if workers is None:
        workers = min(16, _available_cores())
    if workers > 1:
        try:
            parts = list(stream_avro_columnar(paths, chunk_rows=np.iinfo(np.int64).max, workers=workers))
        except ValueError:
            return None  # outside the program, or malformed: Python-codec fallback
        if parts:
            return parts[0]
    compiled = _compile_for_paths(paths)
    if compiled is None:
        return None
    program, names, gens = compiled

    ctx = lib.avro_dec_new(program, len(program))
    try:
        for codec, gen in gens:
            for count, data in gen:
                data = _inflate(codec, data)
                rc = lib.avro_dec_block(ctx, data, len(data), count)
                if rc != 0:
                    return None  # malformed vs program: Python-codec fallback
        return _extract_columns(lib, ctx, program, names)
    finally:
        lib.avro_dec_free(ctx)
        for _c, g in gens:
            g.close()


def _cgroup_quota_cores() -> Optional[int]:
    """Cores granted by the cgroup CPU controller, or None when unlimited.

    sched_getaffinity over-reports in quota-limited containers (a pod
    pinned to 2 CPUs of quota still sees every host core in its mask), so
    the decode pool would oversubscribe and thrash. v2 reads
    ``cpu.max`` ("<quota> <period>" or "max ..."); v1 reads
    ``cpu.cfs_quota_us`` / ``cpu.cfs_period_us`` (-1 = unlimited).
    Fractional quotas round UP: 1.5 CPUs of quota decodes with 2 workers.
    """
    for quota_path, period_path in (
        ("/sys/fs/cgroup/cpu.max", None),  # v2: one file, "quota period"
        (
            "/sys/fs/cgroup/cpu/cpu.cfs_quota_us",  # v1 pair
            "/sys/fs/cgroup/cpu/cpu.cfs_period_us",
        ),
    ):
        try:
            with open(quota_path) as f:
                first = f.read().split()
            if period_path is None:
                quota_s, period_s = first[0], first[1]
            else:
                quota_s = first[0]
                with open(period_path) as f:
                    period_s = f.read().split()[0]
            if quota_s in ("max", "-1"):
                return None
            quota, period = int(quota_s), int(period_s)
            if quota <= 0 or period <= 0:
                return None
            return max(1, -(-quota // period))  # ceil division
        except (OSError, ValueError, IndexError):
            continue
    return None


def _available_cores() -> int:
    """Cores available to THIS process: PHOTON_TPU_DECODE_WORKERS env
    override first, else min(affinity mask, cgroup CPU quota) — the quota
    bound because sched_getaffinity over-reports in quota-limited
    containers (sched_getaffinity is Linux-only; cpu_count is the
    portable fallback)."""
    env = os.environ.get("PHOTON_TPU_DECODE_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass  # malformed override: fall through to detection
    cores = None
    getaff = getattr(os, "sched_getaffinity", None)
    if getaff is not None:
        try:
            cores = max(1, len(getaff(0)))
        except OSError:  # pragma: no cover - exotic platforms
            pass
    if cores is None:
        cores = max(1, os.cpu_count() or 1)
    quota = _cgroup_quota_cores()
    if quota is not None:
        cores = min(cores, quota)
    return max(1, cores)


def merge_columnar(parts: Sequence[ColumnarRows]) -> ColumnarRows:
    """Concatenate per-block/per-chunk ColumnarRows into one, re-interning
    strings into a single table (first-occurrence order over parts, which
    matches what a serial decode of the same blocks would produce)."""
    if len(parts) == 1:
        return parts[0]
    table: Dict[str, int] = {}
    intern: List[str] = []
    luts = []
    for p in parts:
        lut = np.empty(len(p.intern) + 1, np.int32)  # [-1] slot for nulls
        lut[-1] = -1
        for i, s in enumerate(p.intern):
            idx = table.get(s)
            if idx is None:
                idx = len(intern)
                table[s] = idx
                intern.append(s)
            lut[i] = idx
        luts.append(lut)

    n = sum(p.n for p in parts)
    row_off = np.cumsum([0] + [p.n for p in parts])
    numeric = {
        k: np.concatenate([p.numeric[k] for p in parts])
        for k in parts[0].numeric
    }
    longs = {
        k: np.concatenate([p.longs[k] for p in parts]) for k in parts[0].longs
    }
    strings = {
        k: np.concatenate([lut[p.strings[k]] for p, lut in zip(parts, luts)])
        for k in parts[0].strings
    }
    bags = {}
    for k in parts[0].bags:
        offs_parts, keys_parts, vals_parts = [], [], []
        nnz_off = 0
        for p, lut in zip(parts, luts):
            b = p.bags[k]
            offs_parts.append(
                (b.offsets if nnz_off == 0 else b.offsets[1:]) + nnz_off
            )
            keys_parts.append(lut[b.key_ids])
            vals_parts.append(b.values)
            nnz_off += int(b.offsets[-1])
        bags[k] = FeatureBagColumn(
            offsets=np.concatenate(offs_parts),
            key_ids=np.concatenate(keys_parts),
            values=np.concatenate(vals_parts),
        )
    meta_rows = np.concatenate([
        p.meta_rows + np.int32(row_off[i]) for i, p in enumerate(parts)
    ])
    meta_keys = np.concatenate([
        lut[p.meta_keys] for p, lut in zip(parts, luts)
    ])
    meta_vals = np.concatenate([
        lut[p.meta_vals] for p, lut in zip(parts, luts)
    ])
    return ColumnarRows(
        n=n, numeric=numeric, longs=longs, strings=strings, bags=bags,
        meta_rows=meta_rows, meta_keys=meta_keys, meta_vals=meta_vals,
        intern=intern,
    )


def stream_avro_columnar(
    paths: Sequence[str],
    chunk_rows: int = 1 << 16,
    workers: Optional[int] = None,
):
    """Yield ColumnarRows chunks of >= chunk_rows rows (block-aligned):
    the streaming ingest path. Host
    memory is bounded by one chunk + a bounded window of in-flight blocks,
    never the file. Raises (rather than returning None) when the native
    decoder or schema can't serve the stream — streaming callers need a
    hard error, not a silent slurp.

    ``workers`` > 1 decodes container blocks CONCURRENTLY — zlib and the
    native decoder both release the GIL, and blocks are independent (the
    Spark-partition analogue, AvroDataReader.scala:165-209), so decode
    scales with cores while results are merged back in file order
    (bit-identical to the serial path, parity-tested). Default: one worker
    per available core."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native decoder unavailable for streaming ingest")
    compiled = _compile_for_paths(paths)
    if compiled is None:
        raise ValueError(
            "schema outside the native columnar program (or heterogeneous "
            "schemas); streaming ingest unavailable"
        )
    program, names, gens = compiled
    if workers is None:
        workers = min(16, _available_cores())

    def decode_one(codec: str, count: int, data: bytes) -> ColumnarRows:
        data = _inflate(codec, data)
        ctx = lib.avro_dec_new(program, len(program))
        try:
            rc = lib.avro_dec_block(ctx, data, len(data), count)
            if rc != 0:
                raise ValueError("malformed container block")
            return _extract_columns(lib, ctx, program, names)
        finally:
            lib.avro_dec_free(ctx)

    def blocks():
        for codec, gen in gens:
            for count, data in gen:
                yield codec, count, data

    try:
        if workers <= 1:
            # Serial: one long-lived ctx accumulates blocks per chunk (no
            # merge cost, identical output).
            ctx = lib.avro_dec_new(program, len(program))
            try:
                for codec, count, data in blocks():
                    data = _inflate(codec, data)
                    rc = lib.avro_dec_block(ctx, data, len(data), count)
                    if rc != 0:
                        raise ValueError("malformed container block")
                    if int(lib.avro_dec_num_records(ctx)) >= chunk_rows:
                        yield _extract_columns(lib, ctx, program, names)
                        lib.avro_dec_free(ctx)
                        ctx = lib.avro_dec_new(program, len(program))
                if int(lib.avro_dec_num_records(ctx)) > 0:
                    yield _extract_columns(lib, ctx, program, names)
            finally:
                lib.avro_dec_free(ctx)
            return

        import collections
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers)
        try:
            pending = collections.deque()  # futures in FILE ORDER
            buffered: List[ColumnarRows] = []
            buffered_rows = 0
            source = blocks()

            def drain(fut):
                nonlocal buffered_rows
                part = fut.result()
                buffered.append(part)
                buffered_rows += part.n

            exhausted = False
            while not exhausted or pending:
                while not exhausted and len(pending) < 2 * workers:
                    try:
                        codec, count, data = next(source)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(pool.submit(decode_one, codec, count, data))
                if pending:
                    drain(pending.popleft())
                if buffered_rows >= chunk_rows:
                    yield merge_columnar(buffered)
                    buffered, buffered_rows = [], 0
            if buffered:
                yield merge_columnar(buffered)
        finally:
            # An abandoned generator or a decode error must not block on
            # (or waste) the ~2*workers queued read-ahead blocks.
            pool.shutdown(wait=True, cancel_futures=True)
    finally:
        for _c, g in gens:
            g.close()
