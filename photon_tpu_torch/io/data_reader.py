"""Avro training data → GameBatch, with feature-bag merging per shard (port
of the row path of photon_tpu/io/data_reader.py).

N source feature bags are merged into one matrix per feature shard, index
maps are created by a distinct scan or supplied, the intercept is injected,
and entity ids are interned from the metadataMap or a top-level field. The
rows are decoded by the pure-Python codec (io/avro.py) and assembled on the
host; the finished arrays go to ``device`` once.

A shard of at most ``dense_dim_limit`` columns becomes a dense matrix; a
wider one a padded-sparse ``SparseFeatures`` (one slot a feature of the
row, the intercept included), with the transpose plan where the shard's
``transpose_plan`` (or, when None, ``default_transpose_plan`` of the
device) asks for it. Not ported yet: the native columnar decoder
(``use_columnar=True``, the reference's default).
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_tpu_torch.data.batch import Features, SparseFeatures, default_transpose_plan
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.io.avro import AvroReader

INTERCEPT_KEY = IndexMap.INTERCEPT

# Reserved columns (reference InputColumnsNames)
RESPONSE, OFFSET, WEIGHT, UID, META = "response", "offset", "weight", "uid", "metadataMap"


@dataclasses.dataclass(frozen=True)
class InputColumnsNames:
    """Custom names for the reserved columns (reference InputColumnsNames)."""

    response: str = RESPONSE
    offset: str = OFFSET
    weight: str = WEIGHT
    uid: str = UID
    metadata: str = META


@dataclasses.dataclass
class FeatureShardConfig:
    """Bags merged into one shard + intercept flag (reference
    FeatureShardConfiguration)."""

    feature_bags: Sequence[str] = ("features",)
    has_intercept: bool = True
    # The widest shard read as a dense matrix; wider shards are padded-sparse.
    dense_dim_limit: int = 4096
    # The rmatvec lowering of a padded-sparse shard: True attaches the
    # transpose plan (segment sum), False keeps the scatter-add, None takes
    # data/batch.py::default_transpose_plan of the device.
    transpose_plan: Optional[bool] = None

    def resolved_transpose_plan(self, device) -> bool:
        return default_transpose_plan(device) if self.transpose_plan is None else bool(self.transpose_plan)


def _feature_key(f: dict) -> str:
    return IndexMap.key(f["name"], f.get("term") or "")


def _expand_paths(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(globlib.glob(os.path.join(p, "*.avro"))))
        else:
            out.extend(sorted(globlib.glob(p)) or [p])
    return out


def read_avro_rows(paths: Sequence[str]) -> List[dict]:
    rows: List[dict] = []
    for path in _expand_paths(paths):
        with AvroReader(path) as r:
            rows.extend(r)
    return rows


def _row_get(row: dict, names: Sequence[str]):
    """First present (non-None) value among candidate column names."""
    for name in names:
        v = row.get(name)
        if v is not None:
            return v
    return None


def _label_columns(response_col: str) -> Tuple[str, ...]:
    """Label resolution order: 'label' then 'response' by default; a custom
    response column always wins."""
    if response_col != RESPONSE:
        return (response_col, "label", RESPONSE)
    return ("label", RESPONSE)


def _row_label(row: dict, response_col: str = RESPONSE) -> float:
    v = _row_get(row, _label_columns(response_col))
    return float(v) if v is not None else 0.0


def build_index_maps(
    rows: List[dict],
    shard_configs: Dict[str, FeatureShardConfig],
) -> Dict[str, IndexMap]:
    """Distinct-scan index map creation (sorted keys, intercept last)."""
    maps: Dict[str, IndexMap] = {}
    for shard, cfg in shard_configs.items():
        keys = set()
        for row in rows:
            for bag in cfg.feature_bags:
                for f in row.get(bag) or []:
                    keys.add(_feature_key(f))
        maps[shard] = IndexMap.build(keys, add_intercept=cfg.has_intercept)
    return maps


def rows_to_game_batch(
    rows: List[dict],
    shard_configs: Dict[str, FeatureShardConfig],
    index_maps: Dict[str, IndexMap],
    entity_id_columns: Optional[Dict[str, str]] = None,  # RE type -> id column
    entity_indexes: Optional[Dict[str, EntityIndex]] = None,
    intern_new_entities: bool = True,
    column_names: Optional[InputColumnsNames] = None,
    device="cuda",
) -> Tuple[GameBatch, Dict[str, EntityIndex]]:
    """Merge feature bags per shard, inject intercepts, intern entity ids
    (metadataMap first, then a top-level field). A feature repeated in a row
    keeps its last value in a dense shard and adds up in a sparse one, as in
    the reference."""
    n = len(rows)
    entity_id_columns = entity_id_columns or {}
    entity_indexes = entity_indexes if entity_indexes is not None else {}
    cn = column_names or InputColumnsNames()

    def as_t(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=device)

    label = np.array([_row_label(r, cn.response) for r in rows], np.float32)
    offset = np.array(
        [float(_row_get(r, (cn.offset, OFFSET)) or 0.0) for r in rows], np.float32
    )
    weight = np.array(
        [
            float(v) if (v := _row_get(r, (cn.weight, WEIGHT))) is not None else 1.0
            for r in rows
        ],
        np.float32,
    )

    features: Dict[str, Features] = {}
    for shard, cfg in shard_configs.items():
        imap = index_maps[shard]
        d = len(imap)
        icpt = imap.get_index(INTERCEPT_KEY) if cfg.has_intercept else -1
        sparse_rows = []
        for row in rows:
            ix: List[int] = []
            vs: List[float] = []
            for bag in cfg.feature_bags:
                for f in row.get(bag) or []:
                    j = imap.get_index(_feature_key(f))
                    if j >= 0:
                        ix.append(j)
                        vs.append(float(f["value"]))
            if icpt >= 0:
                ix.append(icpt)
                vs.append(1.0)
            sparse_rows.append((ix, vs))
        if d <= cfg.dense_dim_limit:
            X = np.zeros((n, d), np.float32)
            for i, (ix, vs) in enumerate(sparse_rows):
                X[i, ix] = vs
            features[shard] = as_t(X)
        else:
            sf = SparseFeatures.from_rows(sparse_rows, d, device=device)
            features[shard] = sf.with_transpose_plan() if cfg.resolved_transpose_plan(device) else sf

    entity_ids: Dict[str, torch.Tensor] = {}
    for re_type, col in entity_id_columns.items():
        eidx = entity_indexes.setdefault(re_type, EntityIndex())
        ids = np.empty(n, np.int32)
        for i, row in enumerate(rows):
            meta = _row_get(row, (cn.metadata, META)) or {}
            raw = meta.get(col, row.get(col))
            if raw is None:
                ids[i] = -1
            elif intern_new_entities:
                ids[i] = eidx.intern(str(raw))
            else:
                ids[i] = eidx.lookup(str(raw))
        entity_ids[re_type] = as_t(ids)

    batch = GameBatch(
        label=as_t(label),
        offset=as_t(offset),
        weight=as_t(weight),
        features=features,
        entity_ids=entity_ids,
        uid=as_t(np.arange(n, dtype=np.int64)),
    )
    return batch, entity_indexes


def read_merged(
    paths: Sequence[str],
    shard_configs: Dict[str, FeatureShardConfig],
    index_maps: Optional[Dict[str, IndexMap]] = None,
    entity_id_columns: Optional[Dict[str, str]] = None,
    entity_indexes: Optional[Dict[str, EntityIndex]] = None,
    intern_new_entities: bool = True,
    use_columnar: bool = False,
    column_names: Optional[InputColumnsNames] = None,
    device="cuda",
) -> Tuple[GameBatch, Dict[str, IndexMap], Dict[str, EntityIndex]]:
    """DataReader.readMerged role: Avro files → GameBatch on ``device`` (+
    the index maps created when not supplied). Only the row path is ported:
    ``use_columnar=True`` raises."""
    if use_columnar:
        raise NotImplementedError("the native columnar Avro decoder is not ported yet")
    rows = read_avro_rows(paths)
    if index_maps is None:
        index_maps = build_index_maps(rows, shard_configs)
    batch, entity_indexes = rows_to_game_batch(
        rows, shard_configs, index_maps, entity_id_columns, entity_indexes,
        intern_new_entities, column_names, device,
    )
    return batch, index_maps, entity_indexes
