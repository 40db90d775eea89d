"""Native mmap feature index store: builder, ctypes reader and pure-Python
reader (port of photon_tpu/data/native_index.py; framework-free, the port
does not import it).

Parity target: the reference's PalDB off-heap partitioned index (feature
name → index and index → name in N hash-partitioned store files,
memory-mapped per reader so huge feature spaces never enter the Python
heap). The store format is in photon_tpu_torch/native/index_store.cpp (a
copy of the reference's); the builder writes the files from Python, and the
files are byte for byte the reference's for the same index map.

The reader uses the C++ library (ctypes) or a pure-Python mmap reader of the
same files: ``use_native=None`` (the default) takes the library when it
builds and loads, else the pure reader; ``True`` insists on the library
(a failed build or load raises); ``False`` takes the pure reader. Which
reader was taken is logged. The library is built at first use with ``g++
-O2 -std=c++17 -shared -fPIC`` into ``BUILD_DIR`` (the repo's gitignored
``build/torch_native/``) under a name that carries the hash of the source:
the compiler writes a file of its own process and ``os.replace`` moves the
finished library into place, so processes that build at once never load a
partial file (the rule of io/columnar.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import mmap
import os
import struct
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_MAGIC = 0x50494458
_ENTRY = struct.Struct("<QIII")  # hash, value, key_off, key_len
_REV = struct.Struct("<II")

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_MASK = (1 << 64) - 1

BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_native"
SOURCE = Path(__file__).resolve().parent.parent / "native" / "index_store.cpp"


def _fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libindex_store_{digest}.so"


class NativeLibraryError(RuntimeError):
    """The store's C++ library could not be built or loaded."""


def build_native_lib(force: bool = False) -> str:
    """Compile the C++ store reader (unless its library for this source is
    there already) and return the library's path; raises
    :class:`NativeLibraryError` when there is no compiler or it fails."""
    so = _lib_path()
    if so.exists() and not force:
        return str(so)
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    except FileNotFoundError as exc:
        raise NativeLibraryError("g++ not found") from exc
    except subprocess.CalledProcessError as exc:
        raise NativeLibraryError(f"g++ exited {exc.returncode}: {exc.stderr.strip()[:500]}") from exc
    finally:
        if tmp.exists():
            tmp.unlink()
    return str(so)


def _load_lib(so: str):
    lib = ctypes.CDLL(so)
    lib.pidx_open.restype = ctypes.c_void_p
    lib.pidx_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pidx_get_index.restype = ctypes.c_int64
    lib.pidx_get_index.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.pidx_get_name.restype = ctypes.c_int64
    lib.pidx_get_name.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p)]
    lib.pidx_get_indices.restype = None
    lib.pidx_get_indices.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64),
    ]
    lib.pidx_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeIndexMapBuilder:
    """Writes the partitioned store files (PalDBIndexMapBuilder role)."""

    def __init__(self, store_dir: str, num_partitions: int = 4):
        self.store_dir = store_dir
        self.num_partitions = num_partitions

    def build(self, index_map) -> None:
        os.makedirs(self.store_dir, exist_ok=True)
        parts: List[List[Tuple[int, int, bytes]]] = [[] for _ in range(self.num_partitions)]
        total = 0
        for key, value in index_map.items():
            kb = key.encode("utf-8")
            h = _fnv1a64(kb)
            parts[h % self.num_partitions].append((h, value, kb))
            total = max(total, value + 1)

        rev = np.zeros((total, 2), np.uint32)
        for pi, entries in enumerate(parts):
            entries.sort(key=lambda e: e[0])
            blob = bytearray()
            packed = bytearray()
            for slot, (h, value, kb) in enumerate(entries):
                packed += _ENTRY.pack(h, value, len(blob), len(kb))
                rev[value] = (pi, slot)
                blob += kb
            with open(os.path.join(self.store_dir, f"part-{pi}.bin"), "wb") as f:
                f.write(struct.pack("<II", _MAGIC, len(entries)))
                f.write(bytes(packed))
                f.write(bytes(blob))
        with open(os.path.join(self.store_dir, "reverse.bin"), "wb") as f:
            f.write(struct.pack("<II", _MAGIC, total))
            f.write(rev.astype("<u4").tobytes())
        with open(os.path.join(self.store_dir, "meta.json"), "w") as f:
            json.dump({"numPartitions": self.num_partitions, "size": total}, f)


class _PurePart:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        self.mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, self.n = struct.unpack_from("<II", self.mm, 0)
        assert magic == _MAGIC, f"bad store file {path}"
        self.keys_off = 8 + self.n * _ENTRY.size
        # The hashes as a numpy view, for a vectorized binary search.
        raw = np.frombuffer(self.mm, dtype=np.uint8, count=self.n * _ENTRY.size, offset=8)
        self.table = raw.view(np.dtype([("hash", "<u8"), ("value", "<u4"), ("off", "<u4"), ("len", "<u4")]))

    def entry(self, slot: int):
        return self.table[slot]

    def key_bytes(self, off: int, length: int) -> bytes:
        start = self.keys_off + off
        return self.mm[start:start + length]

    def close(self):
        # Drop the numpy views into the mmap before closing it.
        self.table = None
        self.mm.close()
        self._f.close()


class NativeIndexMap:
    """Reader over a partitioned store (PalDBIndexMap role): the C++
    library or the pure-Python reader, over the same files (module
    docstring for ``use_native``)."""

    def __init__(self, store_dir: str, use_native: Optional[bool] = None):
        with open(os.path.join(store_dir, "meta.json")) as f:
            meta = json.load(f)
        self.store_dir = store_dir
        self.num_partitions = meta["numPartitions"]
        self._size = meta["size"]
        self._lib = None
        self._handle = None
        why = "use_native=False"
        if use_native is None or use_native:
            try:
                lib = _load_lib(build_native_lib())
                handle = lib.pidx_open(store_dir.encode(), self.num_partitions)
                if not handle:
                    raise NativeLibraryError(f"pidx_open could not open {store_dir}")
                self._lib, self._handle = lib, handle
            except (NativeLibraryError, OSError) as exc:
                if use_native:
                    raise
                why = str(exc)
        if self._lib is None:
            self._parts = [_PurePart(os.path.join(store_dir, f"part-{i}.bin")) for i in range(self.num_partitions)]
            with open(os.path.join(store_dir, "reverse.bin"), "rb") as f:
                raw = f.read()
            magic, total = struct.unpack_from("<II", raw, 0)
            assert magic == _MAGIC
            self._rev = np.frombuffer(raw, dtype="<u4", offset=8).reshape(total, 2)
            logger.info("index store %s: pure-Python reader (%s)", store_dir, why)
        else:
            logger.info("index store %s: native reader", store_dir)

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def __len__(self) -> int:
        return self._size

    def get_index(self, key: str) -> int:
        kb = key.encode("utf-8")
        if self._lib is not None:
            return int(self._lib.pidx_get_index(self._handle, kb, len(kb)))
        h = _fnv1a64(kb)
        part = self._parts[h % self.num_partitions]
        lo = int(np.searchsorted(part.table["hash"], np.uint64(h), side="left"))
        for i in range(lo, part.n):
            e = part.entry(i)
            if int(e["hash"]) != h:
                break
            if part.key_bytes(int(e["off"]), int(e["len"])) == kb:
                return int(e["value"])
        return -1

    def get_indices(self, keys: List[str]) -> np.ndarray:
        """Batched lookup (the ingest hot path)."""
        if self._lib is not None:
            blobs = [k.encode("utf-8") for k in keys]
            offsets = np.zeros(len(blobs) + 1, np.int64)
            np.cumsum([len(b) for b in blobs], out=offsets[1:])
            blob = b"".join(blobs)
            out = np.empty(len(blobs), np.int64)
            self._lib.pidx_get_indices(self._handle, blob, offsets, len(blobs), out)
            return out
        return np.array([self.get_index(k) for k in keys], np.int64)

    def get_feature_name(self, index: int) -> Optional[str]:
        if self._lib is not None:
            ptr = ctypes.c_char_p()
            n = self._lib.pidx_get_name(self._handle, index, ctypes.byref(ptr))
            if n < 0:
                return None
            return ctypes.string_at(ptr, n).decode("utf-8")
        if index < 0 or index >= self._rev.shape[0]:
            return None
        pi, slot = (int(x) for x in self._rev[index])
        part = self._parts[pi]
        e = part.entry(slot)
        return part.key_bytes(int(e["off"]), int(e["len"])).decode("utf-8")

    def close(self):
        if self._lib is not None:
            self._lib.pidx_close(self._handle)
            self._lib = None
        elif hasattr(self, "_parts"):
            for p in self._parts:
                p.close()
