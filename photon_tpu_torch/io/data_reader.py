"""Avro training data → GameBatch, with feature-bag merging per shard (port
of photon_tpu/io/data_reader.py: its columnar and row paths, and the
streaming half, ``stream_merged`` and ``concat_game_batches``).

N source feature bags are merged into one matrix per feature shard, index
maps are created by a distinct scan or supplied, the intercept is injected,
and entity ids are interned from the metadataMap or a top-level field.
``read_merged`` decodes through the native columnar decoder
(io/columnar.py) by default, as the reference does, and assembles the batch
with vectorized numpy on the host; the finished arrays go to ``device``
once. The row path (the pure-Python codec of io/avro.py) is the host
fallback: it runs where the decoder cannot be built or loaded, or the writer
schema is outside its program. A fallback logs one warning for each reason,
and ``READ_PATHS`` counts every read by the path it took.

A shard of at most ``dense_dim_limit`` columns becomes a dense matrix; a
wider one a padded-sparse ``SparseFeatures`` (one slot a feature of the
row, the intercept in the row's last used slot, unused slots index 0 and
value 0), with the transpose plan where the shard's ``transpose_plan`` (or,
when None, ``default_transpose_plan`` of the device) asks for it. Both paths
build the same tensors bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import glob as globlib
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_tpu_torch.data.batch import Features, SparseFeatures, default_transpose_plan
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.io.avro import AvroReader

logger = logging.getLogger(__name__)

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


class ReadPaths:
    """Reads of ``read_merged`` by the path they took: ``counts["columnar"]``
    (the native decoder) and ``counts["rows"]`` (the host fallback), with the
    reason of each fallback in ``reasons``."""

    def __init__(self) -> None:
        self.counts: collections.Counter = collections.Counter()
        self.reasons: collections.Counter = collections.Counter()
        self._warned: set = set()

    def reset(self) -> None:
        self.counts.clear()
        self.reasons.clear()

    def fallback(self, reason: str) -> None:
        self.counts["rows"] += 1
        self.reasons[reason] += 1
        if reason not in self._warned:
            self._warned.add(reason)
            logger.warning("Avro read falls back to the pure-Python row decoder: %s", reason)


READ_PATHS = ReadPaths()


def _columnar_index_maps(cols, shard_configs: Dict[str, FeatureShardConfig]) -> Dict[str, IndexMap]:
    """Distinct-scan index maps over the decoded bags' interned keys."""
    maps: Dict[str, IndexMap] = {}
    for shard, cfg in shard_configs.items():
        ids: List[np.ndarray] = [cols.bags[bag].key_ids for bag in cfg.feature_bags if bag in cols.bags]
        uniq = np.unique(np.concatenate(ids)) if ids else np.empty(0, np.int32)
        maps[shard] = IndexMap.build((cols.intern[i] for i in uniq), add_intercept=cfg.has_intercept)
    return maps


def _columnar_to_game_batch(
    cols,
    shard_configs: Dict[str, FeatureShardConfig],
    index_maps: Dict[str, IndexMap],
    entity_id_columns: Optional[Dict[str, str]] = None,
    entity_indexes: Optional[Dict[str, EntityIndex]] = None,
    intern_new_entities: bool = True,
    column_names: Optional[InputColumnsNames] = None,
    device="cuda",
) -> Tuple[GameBatch, Dict[str, EntityIndex]]:
    """``rows_to_game_batch`` over native-decoded columns: one IndexMap
    lookup per DISTINCT key, numpy scatters for the matrices, one copy of
    each finished array to ``device``."""
    n = cols.n
    entity_id_columns = entity_id_columns or {}
    entity_indexes = entity_indexes if entity_indexes is not None else {}
    cn = column_names or InputColumnsNames()

    def as_t(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=device)

    def _num_col(names):
        for name in names:
            if name in cols.numeric:
                return cols.numeric[name]
        return None

    label_col = _num_col(_label_columns(cn.response))
    label = np.nan_to_num(np.zeros(n, np.float64) if label_col is None else label_col, nan=0.0).astype(np.float32)
    off_col = _num_col((cn.offset, OFFSET))
    offset = np.zeros(n, np.float32) if off_col is None else np.nan_to_num(off_col, nan=0.0).astype(np.float32)
    wt_col = _num_col((cn.weight, WEIGHT))
    weight = np.ones(n, np.float32) if wt_col is None else np.nan_to_num(wt_col, nan=1.0).astype(np.float32)

    features: Dict[str, Features] = {}
    for shard, cfg in shard_configs.items():
        imap = index_maps[shard]
        d = len(imap)
        icpt = imap.get_index(INTERCEPT_KEY) if cfg.has_intercept else -1
        # One lookup per distinct interned string (metadata strings resolve
        # to -1 and are masked out below).
        feat_of = np.fromiter((imap.get_index(s) for s in cols.intern), np.int32, count=len(cols.intern))
        row_idx_parts, col_idx_parts, val_parts = [], [], []
        for bag_name in cfg.feature_bags:
            bag = cols.bags.get(bag_name)
            if bag is None or bag.key_ids.size == 0:
                continue
            rows_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(bag.offsets))
            j = feat_of[bag.key_ids]
            ok = j >= 0
            row_idx_parts.append(rows_of[ok])
            col_idx_parts.append(j[ok])
            val_parts.append(bag.values[ok].astype(np.float32))
        rows_all = np.concatenate(row_idx_parts) if row_idx_parts else np.empty(0, np.int64)
        cols_all = np.concatenate(col_idx_parts) if col_idx_parts else np.empty(0, np.int32)
        vals_all = np.concatenate(val_parts) if val_parts else np.empty(0, np.float32)
        if d <= cfg.dense_dim_limit:
            X = np.zeros((n, d), np.float32)
            X[rows_all, cols_all] = vals_all  # a repeated key: the last wins, as on the row path
            if icpt >= 0:
                X[:, icpt] = 1.0
            features[shard] = as_t(X)
        else:
            # Padded-sparse, without a loop over rows: a row's entries in bag
            # and record order, then the intercept. Unused slots keep index
            # 0 (the reference's columnar path pads -1; the port's
            # SparseFeatures pads 0, as its row path does).
            counts = np.bincount(rows_all, minlength=n).astype(np.int64)
            if icpt >= 0:
                counts += 1
            max_nnz = max(int(counts.max()) if n else 1, 1)
            order = np.argsort(rows_all, kind="stable")
            r_s, c_s, v_s = rows_all[order], cols_all[order], vals_all[order]
            starts = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(r_s, minlength=n), out=starts[1:])
            pos = np.arange(r_s.size, dtype=np.int64) - starts[r_s]
            indices = np.zeros((n, max_nnz), np.int32)
            values = np.zeros((n, max_nnz), np.float32)
            indices[r_s, pos] = c_s
            values[r_s, pos] = v_s
            if icpt >= 0:
                slot = counts - 1
                indices[np.arange(n), slot] = icpt
                values[np.arange(n), slot] = 1.0
            sf = SparseFeatures(as_t(indices), as_t(values), d)
            features[shard] = sf.with_transpose_plan() if cfg.resolved_transpose_plan(device) else sf

    entity_ids: Dict[str, torch.Tensor] = {}
    for re_type, col in entity_id_columns.items():
        eidx = entity_indexes.setdefault(re_type, EntityIndex())
        raw = cols.meta_column(col)
        if col in cols.strings:  # top-level field fallback
            raw = np.where(raw >= 0, raw, cols.strings[col])
        ids = np.full(n, -1, np.int32)
        present = np.unique(raw[raw >= 0])
        lut = np.full(len(cols.intern), -1, np.int32)
        for iid in present:
            s = cols.intern[iid]
            lut[iid] = eidx.intern(s) if intern_new_entities else eidx.lookup(s)
        sel = raw >= 0
        ids[sel] = lut[raw[sel]]
        if col in cols.numeric:
            # A numeric top-level id interns str(raw) as the row path does:
            # "123" for a long (from the exact int64 column: doubles would
            # merge ids past 2^53), "123.0" for a double. One intern per
            # distinct value.
            num = cols.longs.get(col, cols.numeric[col])
            exact = col in cols.longs
            fill = (ids < 0) & (np.ones(n, bool) if exact else np.isfinite(num))
            if fill.any():
                uniq, inv = np.unique(num[fill], return_inverse=True)
                mapped = np.fromiter(
                    (eidx.intern(s) if intern_new_entities else eidx.lookup(s)
                     for s in (str(int(v)) if exact else str(float(v)) for v in uniq)),
                    np.int32, count=len(uniq))
                ids[fill] = mapped[inv]
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
    use_columnar: bool = True,
    column_names: Optional[InputColumnsNames] = None,
    device="cuda",
) -> Tuple[GameBatch, Dict[str, IndexMap], Dict[str, EntityIndex]]:
    """DataReader.readMerged role: Avro files → GameBatch on ``device`` (+
    the index maps created when not supplied). Decodes through the native
    columnar decoder unless ``use_columnar`` is False; the row path is the
    fallback where the decoder cannot serve the files (module docstring)."""
    if use_columnar:
        from photon_tpu_torch.io import columnar

        try:
            cols = columnar.read_avro_columnar(_expand_paths(paths))
        except (ValueError, OSError) as exc:
            cols, reason = None, f"the columnar decode failed ({exc})"
        else:
            reason = (f"the native decoder is unavailable ({columnar.load_error()})" if columnar.load_error()
                      else "the writer schema is outside the native decoder's program, or a block did not decode")
        if cols is not None:
            READ_PATHS.counts["columnar"] += 1
            if index_maps is None:
                index_maps = _columnar_index_maps(cols, shard_configs)
            batch, entity_indexes = _columnar_to_game_batch(
                cols, shard_configs, index_maps, entity_id_columns, entity_indexes, intern_new_entities,
                column_names, device)
            return batch, index_maps, entity_indexes
        READ_PATHS.fallback(reason)
    else:
        READ_PATHS.counts["rows"] += 1
    rows = read_avro_rows(paths)
    if index_maps is None:
        index_maps = build_index_maps(rows, shard_configs)
    batch, entity_indexes = rows_to_game_batch(
        rows, shard_configs, index_maps, entity_id_columns, entity_indexes,
        intern_new_entities, column_names, device,
    )
    return batch, index_maps, entity_indexes


def stream_merged(
    paths: Sequence[str],
    shard_configs: Dict[str, FeatureShardConfig],
    index_maps: Dict[str, IndexMap],
    entity_id_columns: Optional[Dict[str, str]] = None,
    entity_indexes: Optional[Dict[str, EntityIndex]] = None,
    intern_new_entities: bool = True,
    chunk_rows: int = 1 << 16,
    column_names: Optional[InputColumnsNames] = None,
    workers: Optional[int] = None,
    device="cuda",
):
    """Chunked ``read_merged``: yields GameBatch chunks on ``device``, host
    memory bounded by one chunk (and a bounded window of in-flight blocks),
    never the dataset. ``index_maps`` must be supplied (a stream cannot be
    distinct-scanned first); entity ids intern cumulatively across chunks
    through ``entity_indexes``; each chunk's uids count from 0
    (``concat_game_batches`` renumbers them). ``workers`` caps the
    concurrent block decode. The stream decodes natively or raises: it
    never falls back to the row codec."""
    from photon_tpu_torch.io.columnar import stream_avro_columnar

    entity_indexes = entity_indexes if entity_indexes is not None else {}
    for cols in stream_avro_columnar(_expand_paths(paths), chunk_rows, workers=workers):
        batch, entity_indexes = _columnar_to_game_batch(
            cols, shard_configs, index_maps, entity_id_columns, entity_indexes, intern_new_entities,
            column_names, device)
        yield batch


def concat_game_batches(batches: List[GameBatch]) -> GameBatch:
    """Concatenate chunk batches into one GameBatch on the chunks' device.
    Padded-sparse shards re-pad to the widest chunk and get the transpose
    plan of the whole when every part had one; uids renumber globally."""
    if not batches:
        raise ValueError("no batches to concatenate")
    if len(batches) == 1:
        return batches[0]
    cat = lambda parts: torch.cat(list(parts))  # noqa: E731
    label = cat(b.label for b in batches)
    features: Dict[str, Features] = {}
    for shard in batches[0].features:
        parts = [b.features[shard] for b in batches]
        if isinstance(parts[0], SparseFeatures):
            k = max(p.indices.shape[1] for p in parts)
            widen = lambda t: torch.nn.functional.pad(t, (0, k - t.shape[1]))  # noqa: E731
            sf = SparseFeatures(cat(widen(p.indices) for p in parts), cat(widen(p.values) for p in parts),
                                parts[0].dim)
            features[shard] = sf.with_transpose_plan() if all(p.has_plan for p in parts) else sf
        else:
            features[shard] = cat(parts)
    return GameBatch(
        label=label,
        offset=cat(b.offset for b in batches),
        weight=cat(b.weight for b in batches),
        features=features,
        entity_ids={k: cat(b.entity_ids[k] for b in batches) for k in batches[0].entity_ids},
        uid=torch.arange(label.shape[0], dtype=torch.int64, device=label.device),
    )
