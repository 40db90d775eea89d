"""GAME model files (port of photon_tpu/io/model_io.py: the model
directory, its metadata and the feature summary statistics).

The reference layout: ``fixed-effect/<coordinate>/coefficients/part-*.avro``
holding one ``BayesianLinearModelAvro`` record and ``fixed-effect/
<coordinate>/id-info`` naming the feature shard; ``random-effect/
<coordinate>/coefficients/part-*.avro`` holding one record per entity
(``modelId`` = the entity id) and a two-line ``id-info`` (random-effect
type, feature shard); and a JSON ``model-metadata.json``. Coefficients
whose magnitude is not above the sparsity threshold are not written.
Directories written here load in the JAX package and the other way round.
Generation manifests, deltas and gates are not ported yet.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.io.avro import read_avro_records, write_avro_records
from photon_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_SCHEMA, FEATURE_SUMMARIZATION_SCHEMA
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import FixedEffectModel, GameModel, ProjectedRandomEffectModel, RandomEffectModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.types import TaskType

FIXED_DIR = "fixed-effect"
RANDOM_DIR = "random-effect"
METADATA_FILE = "model-metadata.json"
ID_INFO_FILE = "id-info"
COEFF_DIR = "coefficients"

# The reference loader instantiates models by class name, so the records
# carry its fully qualified names (the smoothed hinge has no model class
# there; the logistic classifier stands in, and lossFunction tells them
# apart on reading).
_MODEL_CLASS = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
}
_CLASS_MODEL = {
    "LogisticRegressionModel": TaskType.LOGISTIC_REGRESSION,
    "LinearRegressionModel": TaskType.LINEAR_REGRESSION,
    "PoissonRegressionModel": TaskType.POISSON_REGRESSION,
    "SmoothedHingeLossLinearSVMModel": TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
}
_LOSS_TASK = {loss_for_task(t).name: t for t in TaskType}


def _split_key(key: str) -> Tuple[str, str]:
    if IndexMap.DELIM in key:
        name, term = key.split(IndexMap.DELIM, 1)
        return name, term
    return key, ""


def _coeffs_to_avro(model_id: str, means: np.ndarray, variances: Optional[np.ndarray],
                    index_map: IndexMap, task: TaskType, sparsity_threshold: float,
                    columns: Optional[np.ndarray] = None) -> dict:
    """One BayesianLinearModelAvro record of the coefficients whose
    magnitude is above the threshold. ``columns`` maps positions of
    ``means`` to shard columns (a projected block's col_map); identity when
    None."""
    rows = []
    var_rows = [] if variances is not None else None
    for j in np.flatnonzero(np.abs(means) > sparsity_threshold):
        key = index_map.get_feature_name(int(j if columns is None else columns[j]))
        if key is None:
            continue
        name, term = _split_key(key)
        rows.append({"name": name, "term": term, "value": float(means[j])})
        if var_rows is not None:
            var_rows.append({"name": name, "term": term, "value": float(variances[j])})
    return {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS[task],
        "means": rows,
        "variances": var_rows,
        "lossFunction": loss_for_task(task).name,
    }


def _avro_to_coeffs(rec: dict, index_map: IndexMap, dim: int):
    means = np.zeros(dim, np.float32)
    for ntv in rec["means"]:
        j = index_map.get_index(IndexMap.key(ntv["name"], ntv["term"]))
        if j >= 0:
            means[j] = ntv["value"]
    variances = None
    if rec.get("variances"):
        variances = np.zeros(dim, np.float32)
        for ntv in rec["variances"]:
            j = index_map.get_index(IndexMap.key(ntv["name"], ntv["term"]))
            if j >= 0:
                variances[j] = ntv["value"]
    task = _LOSS_TASK.get(rec.get("lossFunction") or "")
    if task is None:
        task = _CLASS_MODEL.get((rec.get("modelClass") or "").rsplit(".", 1)[-1])
    return means, variances, task


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def save_game_model(
    model: GameModel,
    output_dir: str,
    index_maps: Dict[str, IndexMap],  # feature shard -> IndexMap
    entity_indexes: Optional[Dict[str, EntityIndex]] = None,  # RE type -> EntityIndex
    sparsity_threshold: float = 1e-4,
    extra_metadata: Optional[dict] = None,
) -> None:
    """Write every coordinate of ``model`` under ``output_dir``. A dense
    random effect writes one record per entity; a projected one writes the
    entities that have a block, translating block columns through the
    block's col_map (the (E, d_full) matrix is never built). Entity ids come
    from ``entity_indexes`` (the dense index as a string without one)."""
    entity_indexes = entity_indexes or {}
    os.makedirs(output_dir, exist_ok=True)
    meta: dict = {"coordinates": {}, **(extra_metadata or {})}
    for cid, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            cdir = os.path.join(output_dir, FIXED_DIR, cid, COEFF_DIR)
            os.makedirs(cdir, exist_ok=True)
            with open(os.path.join(output_dir, FIXED_DIR, cid, ID_INFO_FILE), "w") as f:
                f.write(sub.feature_shard + "\n")
            coefs = sub.model.coefficients
            rec = _coeffs_to_avro(cid, _host(coefs.means), _host(coefs.variances),
                                  index_maps[sub.feature_shard], sub.model.task, sparsity_threshold)
            write_avro_records(os.path.join(cdir, "part-00000.avro"), BAYESIAN_LINEAR_MODEL_SCHEMA, [rec])
            meta["coordinates"][cid] = {
                "type": "fixed",
                "featureShard": sub.feature_shard,
                "task": sub.model.task.value,
                "dim": int(coefs.dim),
            }
            continue
        imap = index_maps[sub.feature_shard]
        eidx = entity_indexes.get(sub.re_type)
        name_of = (lambda e: eidx.entity_id(e)) if eidx is not None else str  # noqa: E731
        if isinstance(sub, RandomEffectModel):
            coefs, variances = _host(sub.coefficients), _host(sub.variances)
            records = (_coeffs_to_avro(name_of(e), coefs[e], None if variances is None else variances[e],
                                       imap, sub.task, sparsity_threshold)
                       for e in range(coefs.shape[0]))
            dim, num_entities = int(coefs.shape[1]), int(coefs.shape[0])
        elif isinstance(sub, ProjectedRandomEffectModel):
            block_coefs = [_host(c) for c in sub.block_coefs]
            block_vars = None if sub.block_variances is None else [_host(v) for v in sub.block_variances]
            col_maps = [_host(c) for c in sub.col_maps]
            entity_block, entity_row = _host(sub.entity_block), _host(sub.entity_row)
            records = (_coeffs_to_avro(name_of(e), block_coefs[b][r],
                                       None if block_vars is None else block_vars[b][r],
                                       imap, sub.task, sparsity_threshold, columns=col_maps[b])
                       for e, b, r in zip(range(sub.num_entities), entity_block.tolist(), entity_row.tolist())
                       if b >= 0)  # an entity without a block has no model row
            dim, num_entities = int(sub.d_full), int(sub.num_entities)
        else:
            raise TypeError(f"unknown submodel type {type(sub)}")
        cdir = os.path.join(output_dir, RANDOM_DIR, cid)
        os.makedirs(os.path.join(cdir, COEFF_DIR), exist_ok=True)
        with open(os.path.join(cdir, ID_INFO_FILE), "w") as f:  # two lines: RE type, feature shard
            f.write(sub.re_type + "\n" + sub.feature_shard + "\n")
        write_avro_records(os.path.join(cdir, COEFF_DIR, "part-00000.avro"), BAYESIAN_LINEAR_MODEL_SCHEMA, records)
        meta["coordinates"][cid] = {
            "type": "random",
            "reType": sub.re_type,
            "featureShard": sub.feature_shard,
            "task": sub.task.value,
            "dim": dim,
            "numEntities": num_entities,
        }
    tasks = [c["task"] for c in meta["coordinates"].values()]
    if tasks:
        meta.setdefault("modelType", tasks[0])
    with open(os.path.join(output_dir, METADATA_FILE), "w") as f:
        json.dump(meta, f, indent=2)


def publish_latest_pointer(publish_root: str, generation: str) -> str:
    """Publish ``generation`` as the current model: an fsync'd ``LATEST``
    file written through tmp + rename, so a crash leaves the old pointer or
    the new one, never a torn file. Call it after the model is written."""
    os.makedirs(publish_root, exist_ok=True)
    path = os.path.join(publish_root, "LATEST")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(generation.strip() + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:  # best effort: make the rename itself durable
        dfd = os.open(publish_root, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return path


def _scan_model_dir(model_dir: str, meta: dict) -> Dict[str, dict]:
    """Coordinates of a directory without a metadata table (the reference
    writes none): list fixed-effect/ and random-effect/ and read id-info."""
    task = meta.get("modelType", TaskType.LOGISTIC_REGRESSION.value)
    coords: Dict[str, dict] = {}
    fdir = os.path.join(model_dir, FIXED_DIR)
    if os.path.isdir(fdir):
        for cid in sorted(os.listdir(fdir)):
            with open(os.path.join(fdir, cid, ID_INFO_FILE)) as f:
                (shard,) = f.read().split()
            # No per-coordinate task in the metadata: the records' model
            # class may refine it on loading.
            coords[cid] = {"type": "fixed", "featureShard": shard, "task": task, "task_inferred": True}
    rdir = os.path.join(model_dir, RANDOM_DIR)
    if os.path.isdir(rdir):
        for cid in sorted(os.listdir(rdir)):
            with open(os.path.join(rdir, cid, ID_INFO_FILE)) as f:
                re_type, shard = f.read().split()
            coords[cid] = {"type": "random", "reType": re_type, "featureShard": shard,
                           "task": task, "task_inferred": True}
    return coords


def _coefficient_files(cdir: str) -> list:
    """Coefficient part files of one coordinate: under
    <coordinate>/coefficients/, else directly in <coordinate>/."""
    for d in (os.path.join(cdir, COEFF_DIR), cdir):
        if os.path.isdir(d):
            out = [os.path.join(d, fn) for fn in sorted(os.listdir(d)) if fn.endswith(".avro")]
            if out:
                return out
    return []


# Decoded records per coefficient file, keyed on (mtime_ns, size, inode): a
# published model directory does not change, and a file rewritten in place
# misses the cache. Callers treat the records as read-only.
_COEFF_CACHE_MAX = 512
_coeff_cache: "collections.OrderedDict" = collections.OrderedDict()
_coeff_cache_lock = threading.Lock()


def _coefficient_records(path: str) -> list:
    try:
        st = os.stat(path)
        sig = (st.st_mtime_ns, st.st_size, st.st_ino)
    except OSError:
        return read_avro_records(path)
    with _coeff_cache_lock:
        hit = _coeff_cache.get(path)
        if hit is not None and hit[0] == sig:
            _coeff_cache.move_to_end(path)
            return hit[1]
    recs = read_avro_records(path)
    with _coeff_cache_lock:
        _coeff_cache[path] = (sig, recs)
        _coeff_cache.move_to_end(path)
        while len(_coeff_cache) > _COEFF_CACHE_MAX:
            _coeff_cache.popitem(last=False)
    return recs


def read_model_metadata(model_dir: str) -> dict:
    """Model metadata with a ``coordinates`` table: the JSON written here,
    else a scan of a reference-layout directory."""
    meta: dict = {}
    meta_path = os.path.join(model_dir, METADATA_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if not meta.get("coordinates"):
        meta["coordinates"] = _scan_model_dir(model_dir, meta)
    if not meta["coordinates"]:
        raise FileNotFoundError(
            f"no GAME model at {model_dir!r}: neither a metadata coordinate "
            "table nor fixed-effect/ / random-effect/ directories found"
        )
    return meta


def model_re_types(meta: dict) -> list:
    """Random-effect types named by a metadata coordinate table, in order,
    without repeats (two coordinates may share one entity space)."""
    out = []
    for info in meta.get("coordinates", {}).values():
        if info.get("type") == "random" and info["reType"] not in out:
            out.append(info["reType"])
    return out


def _records(cdir: str) -> list:
    recs = []
    for path in _coefficient_files(cdir):
        recs.extend(_coefficient_records(path))
    return recs


def load_game_model(
    model_dir: str,
    index_maps: Dict[str, IndexMap],
    entity_indexes: Optional[Dict[str, EntityIndex]] = None,
    device="cuda",
) -> GameModel:
    """Read a model directory onto ``device``, written by either package or
    in the reference's layout. A random effect's entity ids are interned
    into ``entity_indexes[reType]`` (a new EntityIndex when absent), so a
    warm start lines up with the run's own interning: entities the run has
    not seen are appended. Each random effect loads as a dense (E, d)
    RandomEffectModel whose ``present_entities`` marks the entities with a
    record in the files, with its variances when the records carry them."""
    entity_indexes = entity_indexes if entity_indexes is not None else {}
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    models: Dict[str, object] = {}
    for cid, info in read_model_metadata(model_dir)["coordinates"].items():
        task = TaskType(info["task"])
        shard = info["featureShard"]
        imap = index_maps[shard]
        dim = info.get("dim", len(imap))
        if info["type"] == "fixed":
            recs = _records(os.path.join(model_dir, FIXED_DIR, cid))
            if len(recs) != 1:  # Spark may write empty extra part files
                raise ValueError(
                    f"fixed-effect coordinate {cid!r}: expected exactly one "
                    f"coefficient record across part files, got {len(recs)}"
                )
            means, variances, rec_task = _avro_to_coeffs(recs[0], imap, dim)
            if info.get("task_inferred") and rec_task is not None:
                task = rec_task  # the model class beats the modelType guess
            models[cid] = FixedEffectModel(
                GeneralizedLinearModel(
                    Coefficients(as_t(means), None if variances is None else as_t(variances)), task),
                shard,
            )
            continue
        cdir = os.path.join(model_dir, RANDOM_DIR, cid)
        with open(os.path.join(cdir, ID_INFO_FILE)) as f:
            re_type = f.read().split()[0]
        eidx = entity_indexes.setdefault(re_type, EntityIndex())
        recs = _records(cdir)
        for rec in recs:  # intern every id first: E covers them all
            eidx.intern(rec["modelId"])
        E = len(eidx)
        coefs = np.zeros((E, dim), np.float32)
        present = np.zeros((E,), bool)
        variances_arr = None
        for rec in recs:
            e = eidx.lookup(rec["modelId"])
            means, variances, rec_task = _avro_to_coeffs(rec, imap, dim)
            if info.get("task_inferred") and rec_task is not None:
                task = rec_task
            coefs[e] = means
            present[e] = True
            if variances is not None:
                if variances_arr is None:
                    variances_arr = np.zeros((E, dim), np.float32)
                variances_arr[e] = variances
        models[cid] = RandomEffectModel(
            as_t(coefs), re_type, shard, task,
            None if variances_arr is None else as_t(variances_arr),
            present_entities=as_t(present),
        )
    return GameModel(models)


def write_basic_statistics(stats, index_map: IndexMap, path: str) -> None:
    """Per-feature summary statistics as FeatureSummarizationResultAvro
    records (reference ModelProcessingUtils.writeBasicStatistics): one
    record per feature with a metric-name → value map."""
    cols = {name: np.asarray(_host(getattr(stats, attr)), np.float64) for name, attr in (
        ("mean", "mean"), ("variance", "variance"), ("min", "min"), ("max", "max"),
        ("normL1", "norm_l1"), ("normL2", "norm_l2"), ("numNonzeros", "num_nonzeros"))}
    records = []
    for j in range(cols["mean"].shape[0]):
        key = index_map.get_feature_name(j)
        if key is None:
            continue
        name, term = _split_key(key)
        records.append({"featureName": name, "featureTerm": term,
                        "metrics": {m: float(v[j]) for m, v in cols.items()}})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_avro_records(path, FEATURE_SUMMARIZATION_SCHEMA, records)
