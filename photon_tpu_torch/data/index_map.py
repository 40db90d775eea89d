"""Copy of photon_tpu/data/index_map.py (framework-free; the port does not import it).

Feature and entity index maps.

Parity targets: reference ``IndexMap`` trait (photon-api index/IndexMap.scala:
22-46), in-heap ``DefaultIndexMap``, and the PalDB off-heap partitioned store
(index/PalDBIndexMap.scala:43-240). The TPU rebuild's native mmap store
(C++ hash-partitioned string→int store) plugs in behind the same interface;
this module provides the in-memory implementation plus the interning logic
used at ingest.

``EntityIndex`` is the TPU-new piece: random-effect entity ids are interned
to dense [0, E) indices at ingest, which is what turns the reference's
RDD joins into XLA gathers.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class IndexMap:
    """Bidirectional feature-name ↔ index map (DefaultIndexMap role).

    Feature identity follows the reference's NameAndTerm convention:
    a feature key is "name\x01term" (AvroDataReader feature-bag semantics);
    the intercept is the reserved key ``INTERCEPT``.
    """

    INTERCEPT = "(INTERCEPT)"
    DELIM = "\x01"

    def __init__(self, name_to_index: Optional[Dict[str, int]] = None):
        self._fwd: Dict[str, int] = dict(name_to_index or {})
        self._rev: Optional[List[str]] = None

    @staticmethod
    def key(name: str, term: str = "") -> str:
        return f"{name}{IndexMap.DELIM}{term}" if term else name

    def __len__(self) -> int:
        return len(self._fwd)

    def __contains__(self, key: str) -> bool:
        return key in self._fwd

    def get_index(self, key: str) -> int:
        """-1 for unknown features (reference IndexMap.getIndex semantics)."""
        return self._fwd.get(key, -1)

    def get_feature_name(self, index: int) -> Optional[str]:
        if self._rev is None:
            rev: List[str] = [""] * len(self._fwd)
            for k, i in self._fwd.items():
                rev[i] = k
            self._rev = rev
        if 0 <= index < len(self._rev):
            return self._rev[index]
        return None

    def items(self) -> Iterator[Tuple[str, int]]:
        return iter(self._fwd.items())

    @staticmethod
    def build(keys: Iterable[str], add_intercept: bool = False) -> "IndexMap":
        """Build from distinct feature keys (FeatureIndexingDriver /
        generateIndexMapLoaders distinct-scan role). Sorted for determinism."""
        distinct = sorted(set(keys))
        if add_intercept and IndexMap.INTERCEPT not in distinct:
            distinct.append(IndexMap.INTERCEPT)
        return IndexMap({k: i for i, k in enumerate(distinct)})

    # --- persistence (JSON; the C++ mmap store replaces this for huge maps) ---

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self._fwd, f)

    @staticmethod
    def load(path: str) -> "IndexMap":
        with open(path) as f:
            return IndexMap(json.load(f))


class EntityIndex:
    """Interns random-effect entity ids (strings) to dense [0, E) ints."""

    def __init__(self):
        self._fwd: Dict[str, int] = {}
        self._rev: List[str] = []

    def __len__(self) -> int:
        return len(self._rev)

    def intern(self, entity_id: str) -> int:
        idx = self._fwd.get(entity_id)
        if idx is None:
            idx = len(self._rev)
            self._fwd[entity_id] = idx
            self._rev.append(entity_id)
        return idx

    def lookup(self, entity_id: str) -> int:
        """-1 for entities unseen at training time (cold start)."""
        return self._fwd.get(entity_id, -1)

    def entity_id(self, index: int) -> str:
        return self._rev[index]

    def ids(self) -> List[str]:
        return list(self._rev)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self._rev, f)

    @staticmethod
    def load(path: str) -> "EntityIndex":
        ei = EntityIndex()
        with open(path) as f:
            for eid in json.load(f):
                ei.intern(eid)
        return ei
