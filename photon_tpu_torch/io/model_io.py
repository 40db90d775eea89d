"""GAME model files, fixed-effect part (port of photon_tpu/io/model_io.py).

The reference layout: ``fixed-effect/<coordinate>/coefficients/part-*.avro``
holding one ``BayesianLinearModelAvro`` record, ``fixed-effect/<coordinate>
/id-info`` naming the feature shard, and a JSON ``model-metadata.json``.
Coefficients below the sparsity threshold are not written. Directories
written here load in the JAX package and the other way round. Random-effect
coordinates, generation manifests, deltas and gates are not ported yet.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.io.avro import read_avro_records, write_avro_records
from photon_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_SCHEMA
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import FixedEffectModel, GameModel
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
                    index_map: IndexMap, task: TaskType, sparsity_threshold: float) -> dict:
    rows = []
    var_rows = [] if variances is not None else None
    for j in np.flatnonzero(np.abs(means) > sparsity_threshold):
        key = index_map.get_feature_name(int(j))
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


def save_game_model(
    model: GameModel,
    output_dir: str,
    index_maps: Dict[str, IndexMap],  # feature shard -> IndexMap
    sparsity_threshold: float = 1e-4,
    extra_metadata: Optional[dict] = None,
) -> None:
    """Write every fixed-effect coordinate of ``model`` under ``output_dir``."""
    os.makedirs(output_dir, exist_ok=True)
    meta: dict = {"coordinates": {}, **(extra_metadata or {})}
    for cid, sub in model.models.items():
        if not isinstance(sub, FixedEffectModel):
            raise TypeError(f"coordinate {cid!r}: only fixed-effect models are ported, not {type(sub)}")
        cdir = os.path.join(output_dir, FIXED_DIR, cid, COEFF_DIR)
        os.makedirs(cdir, exist_ok=True)
        with open(os.path.join(output_dir, FIXED_DIR, cid, ID_INFO_FILE), "w") as f:
            f.write(sub.feature_shard + "\n")
        coefs = sub.model.coefficients
        rec = _coeffs_to_avro(
            cid,
            coefs.means.detach().cpu().numpy(),
            None if coefs.variances is None else coefs.variances.detach().cpu().numpy(),
            index_maps[sub.feature_shard],
            sub.model.task,
            sparsity_threshold,
        )
        write_avro_records(os.path.join(cdir, "part-00000.avro"), BAYESIAN_LINEAR_MODEL_SCHEMA, [rec])
        meta["coordinates"][cid] = {
            "type": "fixed",
            "featureShard": sub.feature_shard,
            "task": sub.model.task.value,
            "dim": int(coefs.dim),
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


def load_game_model(model_dir: str, index_maps: Dict[str, IndexMap], device="cuda") -> GameModel:
    """Read a model directory's fixed-effect coordinates onto ``device``.
    A random-effect coordinate raises: it is not ported yet."""
    models: Dict[str, FixedEffectModel] = {}
    for cid, info in read_model_metadata(model_dir)["coordinates"].items():
        if info["type"] != "fixed":
            raise NotImplementedError(f"coordinate {cid!r}: random-effect models are not ported yet")
        task = TaskType(info["task"])
        shard = info["featureShard"]
        imap = index_maps[shard]
        recs = []
        for path in _coefficient_files(os.path.join(model_dir, FIXED_DIR, cid)):
            recs.extend(_coefficient_records(path))
        if len(recs) != 1:  # Spark may write empty extra part files
            raise ValueError(
                f"fixed-effect coordinate {cid!r}: expected exactly one "
                f"coefficient record across part files, got {len(recs)}"
            )
        means, variances, rec_task = _avro_to_coeffs(recs[0], imap, info.get("dim", len(imap)))
        if info.get("task_inferred") and rec_task is not None:
            task = rec_task  # the model class beats the modelType guess
        as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        models[cid] = FixedEffectModel(
            GeneralizedLinearModel(
                Coefficients(as_t(means), None if variances is None else as_t(variances)), task),
            shard,
        )
    return GameModel(models)
