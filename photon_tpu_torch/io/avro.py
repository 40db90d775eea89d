"""Copy of photon_tpu/io/avro.py (framework-free; the port does not import it).

Minimal Avro object-container codec (pure Python, stdlib only).

Role parity: the reference's data plane is Avro-on-HDFS via the Java Avro
library (photon-client data/avro/AvroUtils.scala, AvroDataReader.scala). This
image has no Avro package, so the framework ships its own schema-driven
binary codec implementing the public Avro 1.x spec subset the reference's
schemas need: records, unions, arrays, maps, strings/bytes, all primitive
types, null/deflate block codecs, object container files with sync markers.

Not a copy of any implementation — written from the published format spec.
A C++ accelerated decode path can replace the inner loop later (SURVEY.md
§2.9 optional Avro decode acceleration).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterable, Iterator, List, Optional, Sequence, Union

MAGIC = b"Obj\x01"
SYNC_SIZE = 16

Schema = Union[str, dict, list]


def parse_schema(schema: Union[str, dict, list]) -> Schema:
    if isinstance(schema, str) and schema.strip().startswith(("{", "[")):
        return json.loads(schema)
    return schema


def _named_types(schema: Schema, acc: Dict[str, dict]) -> None:
    """Collect named record/enum/fixed definitions for by-name references."""
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed") and "name" in schema:
            acc[schema["name"]] = schema
            ns = schema.get("namespace")
            if ns:
                acc[f"{ns}.{schema['name']}"] = schema
        if t == "record":
            for f in schema.get("fields", []):
                _named_types(f["type"], acc)
        elif t == "array":
            _named_types(schema["items"], acc)
        elif t == "map":
            _named_types(schema["values"], acc)
    elif isinstance(schema, list):
        for s in schema:
            _named_types(s, acc)


# ---------------------------------------------------------------------------
# Binary encoding primitives (Avro spec: zigzag varints, little-endian IEEE)
# ---------------------------------------------------------------------------


def _write_long(out: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)  # zigzag
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes((b | 0x80,)))
        else:
            out.write(bytes((b,)))
            return


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read_long(self) -> int:
        b = self.buf
        pos = self.pos
        shift = 0
        acc = 0
        while True:
            byte = b[pos]
            pos += 1
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        self.pos = pos
        return (acc >> 1) ^ -(acc & 1)  # un-zigzag

    def read_bytes(self) -> bytes:
        n = self.read_long()
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_fixed(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out


# ---------------------------------------------------------------------------
# Schema-driven encode/decode
# ---------------------------------------------------------------------------


class _Codec:
    def __init__(self, schema: Schema):
        self.schema = parse_schema(schema)
        self.named: Dict[str, dict] = {}
        _named_types(self.schema, self.named)

    # --- decode ---

    def decode(self, r: _Reader, schema: Optional[Schema] = None) -> Any:
        s = self.schema if schema is None else schema
        if isinstance(s, str):
            if s in self.named:
                return self.decode(r, self.named[s])
            return self._decode_primitive(r, s)
        if isinstance(s, list):  # union
            idx = r.read_long()
            return self.decode(r, s[idx])
        t = s["type"]
        if t == "record":
            return {f["name"]: self.decode(r, f["type"]) for f in s["fields"]}
        if t == "array":
            out: List[Any] = []
            while True:
                n = r.read_long()
                if n == 0:
                    break
                if n < 0:
                    r.read_long()  # block byte size, unused
                    n = -n
                for _ in range(n):
                    out.append(self.decode(r, s["items"]))
            return out
        if t == "map":
            m: Dict[str, Any] = {}
            while True:
                n = r.read_long()
                if n == 0:
                    break
                if n < 0:
                    r.read_long()
                    n = -n
                for _ in range(n):
                    k = r.read_bytes().decode("utf-8")
                    m[k] = self.decode(r, s["values"])
            return m
        if t == "enum":
            return s["symbols"][r.read_long()]
        if t == "fixed":
            return r.read_fixed(s["size"])
        if isinstance(t, (dict, list)):
            return self.decode(r, t)
        return self._decode_primitive(r, t)

    def _decode_primitive(self, r: _Reader, t: str) -> Any:
        if t == "null":
            return None
        if t == "boolean":
            v = r.buf[r.pos]
            r.pos += 1
            return bool(v)
        if t in ("int", "long"):
            return r.read_long()
        if t == "float":
            (v,) = struct.unpack_from("<f", r.buf, r.pos)
            r.pos += 4
            return v
        if t == "double":
            (v,) = struct.unpack_from("<d", r.buf, r.pos)
            r.pos += 8
            return v
        if t == "bytes":
            return r.read_bytes()
        if t == "string":
            return r.read_bytes().decode("utf-8")
        raise ValueError(f"unknown avro type {t!r}")

    # --- encode ---

    def encode(self, out: io.BytesIO, datum: Any, schema: Optional[Schema] = None) -> None:
        s = self.schema if schema is None else schema
        if isinstance(s, str):
            if s in self.named:
                return self.encode(out, datum, self.named[s])
            return self._encode_primitive(out, datum, s)
        if isinstance(s, list):  # union: pick first matching branch
            idx = self._union_index(datum, s)
            _write_long(out, idx)
            return self.encode(out, datum, s[idx])
        t = s["type"]
        if t == "record":
            for f in s["fields"]:
                try:
                    self.encode(out, datum[f["name"]], f["type"])
                except KeyError:
                    if "default" in f:
                        self.encode(out, f["default"], f["type"])
                    else:
                        raise
            return
        if t == "array":
            items = list(datum)
            if items:
                _write_long(out, len(items))
                for it in items:
                    self.encode(out, it, s["items"])
            _write_long(out, 0)
            return
        if t == "map":
            if datum:
                _write_long(out, len(datum))
                for k, v in datum.items():
                    self._encode_primitive(out, k, "string")
                    self.encode(out, v, s["values"])
            _write_long(out, 0)
            return
        if t == "enum":
            _write_long(out, s["symbols"].index(datum))
            return
        if t == "fixed":
            out.write(datum)
            return
        if isinstance(t, (dict, list)):
            return self.encode(out, datum, t)
        return self._encode_primitive(out, datum, t)

    def _union_index(self, datum: Any, union: list) -> int:
        for i, s in enumerate(union):
            name = s if isinstance(s, str) else s.get("type")
            if datum is None and name == "null":
                return i
            if datum is not None and name != "null":
                return i
        raise ValueError(f"no union branch for {datum!r} in {union!r}")

    def _encode_primitive(self, out: io.BytesIO, datum: Any, t: str) -> None:
        if t == "null":
            return
        if t == "boolean":
            out.write(b"\x01" if datum else b"\x00")
        elif t in ("int", "long"):
            _write_long(out, int(datum))
        elif t == "float":
            out.write(struct.pack("<f", float(datum)))
        elif t == "double":
            out.write(struct.pack("<d", float(datum)))
        elif t == "bytes":
            _write_long(out, len(datum))
            out.write(datum)
        elif t == "string":
            b = datum.encode("utf-8")
            _write_long(out, len(b))
            out.write(b)
        else:
            raise ValueError(f"unknown avro type {t!r}")


# ---------------------------------------------------------------------------
# Object container files
# ---------------------------------------------------------------------------

_META_SCHEMA = {"type": "map", "values": "bytes"}


class AvroWriter:
    """Writes an Avro object-container file (codec: null or deflate).
    ``sync``: the file's 16-byte sync marker (default random, as the spec
    suggests; a writer that must give the same bytes for the same records
    passes one derived from them, see :func:`content_sync`)."""

    def __init__(self, path_or_file, schema: Schema, codec: str = "deflate",
                 block_records: int = 4096, sync: Optional[bytes] = None):
        self._own = isinstance(path_or_file, (str, os.PathLike))
        self.f: BinaryIO = open(path_or_file, "wb") if self._own else path_or_file
        self.codec = codec
        self.block_records = block_records
        self._codec = _Codec(schema)
        if sync is not None and len(sync) != SYNC_SIZE:
            raise ValueError(f"a sync marker has {SYNC_SIZE} bytes, got {len(sync)}")
        self.sync = sync if sync is not None else os.urandom(SYNC_SIZE)
        self._buf = io.BytesIO()
        self._count = 0
        self._write_header(schema)

    def _write_header(self, schema: Schema) -> None:
        self.f.write(MAGIC)
        meta = io.BytesIO()
        mc = _Codec(_META_SCHEMA)
        mc.encode(
            meta,
            {
                "avro.schema": json.dumps(parse_schema(schema)).encode(),
                "avro.codec": self.codec.encode(),
            },
        )
        self.f.write(meta.getvalue())
        self.f.write(self.sync)

    def append(self, datum: Any) -> None:
        self._codec.encode(self._buf, datum)
        self._count += 1
        if self._count >= self.block_records:
            self._flush_block()

    def _flush_block(self) -> None:
        if self._count == 0:
            return
        data = self._buf.getvalue()
        if self.codec == "deflate":
            data = zlib.compress(data)[2:-1]  # raw deflate (no zlib header)
        head = io.BytesIO()
        _write_long(head, self._count)
        _write_long(head, len(data))
        self.f.write(head.getvalue())
        self.f.write(data)
        self.f.write(self.sync)
        self._buf = io.BytesIO()
        self._count = 0

    def close(self) -> None:
        self._flush_block()
        if self._own:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AvroReader:
    """Reads an Avro object-container file; iterates decoded records."""

    def __init__(self, path_or_file):
        self._own = isinstance(path_or_file, (str, os.PathLike))
        self.f: BinaryIO = open(path_or_file, "rb") if self._own else path_or_file
        raw = self.f.read()
        if raw[:4] != MAGIC:
            raise ValueError("not an Avro object container file")
        r = _Reader(raw)
        r.pos = 4
        meta = _Codec(_META_SCHEMA).decode(r)
        self.schema = json.loads(meta["avro.schema"].decode())
        self.codec = meta.get("avro.codec", b"null").decode()
        if self.codec not in ("null", "deflate"):
            raise ValueError(f"unsupported avro codec {self.codec}")
        self.sync = r.read_fixed(SYNC_SIZE)
        self._r = r
        self._codec = _Codec(self.schema)

    def __iter__(self) -> Iterator[Any]:
        r = self._r
        n_total = len(r.buf)
        while r.pos < n_total:
            count = r.read_long()
            size = r.read_long()
            data = r.read_fixed(size)
            if self.codec == "deflate":
                data = zlib.decompress(data, -15)
            br = _Reader(data)
            for _ in range(count):
                yield self._codec.decode(br)
            sync = r.read_fixed(SYNC_SIZE)
            if sync != self.sync:
                raise ValueError("bad sync marker (corrupt file)")

    def close(self) -> None:
        if self._own:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_avro_records(path: str) -> List[Any]:
    with AvroReader(path) as r:
        return list(r)


def content_sync(schema: Schema, records: Sequence[Any]) -> bytes:
    """A sync marker derived from the schema and the records, so that the
    same records give the same file bytes (and checksums) run to run."""
    h = hashlib.sha256(json.dumps(parse_schema(schema), sort_keys=True).encode())
    for rec in records:
        h.update(json.dumps(rec, sort_keys=True, default=repr).encode())
    return h.digest()[:SYNC_SIZE]


def write_avro_records(path: str, schema: Schema, records: Iterable[Any],
                       codec: str = "deflate",
                       block_records: int = 4096, sync: Optional[bytes] = None) -> None:
    with AvroWriter(path, schema, codec, block_records, sync=sync) as w:
        for rec in records:
            w.append(rec)
