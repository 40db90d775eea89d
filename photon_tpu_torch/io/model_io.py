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

The generation half (the reference's rollout files): a generation is a model
directory under a publish root with a ``generation-manifest.json`` (sha256
of every file, parent, holdout metrics, gate verdict); ``LATEST`` names the
current one, ``poisoned-generations.json`` the generations never to load
again; a delta generation holds the changed entities' rows only and names
its base in its metadata. Manifests, checksums and delta chains are the
reference's byte for byte, so either package publishes what the other
serves. The gate counts publications and refusals in the metrics registry
(``model_generations_published_total``, ``model_gate_failures_total``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.io.avro import content_sync, read_avro_records, write_avro_records
from photon_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_SCHEMA, FEATURE_SUMMARIZATION_SCHEMA
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import FixedEffectModel, GameModel, ProjectedRandomEffectModel, RandomEffectModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.obs.metrics import registry
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.types import TaskType

FIXED_DIR = "fixed-effect"
RANDOM_DIR = "random-effect"
METADATA_FILE = "model-metadata.json"
ID_INFO_FILE = "id-info"
COEFF_DIR = "coefficients"
MANIFEST_FILE = "generation-manifest.json"
POISON_FILE = "poisoned-generations.json"

logger = logging.getLogger(__name__)

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


def _write_model_records(path: str, records, stable_bytes: bool = False) -> None:
    """A coefficient file. ``stable_bytes``: its sync marker derives from
    the records instead of being random, so a generation rebuilt from the
    same parent and data has the same bytes and checksums."""
    sync = None
    if stable_bytes:
        records = list(records)
        sync = content_sync(BAYESIAN_LINEAR_MODEL_SCHEMA, records)
    write_avro_records(path, BAYESIAN_LINEAR_MODEL_SCHEMA, records, sync=sync)


def save_game_model(
    model: GameModel,
    output_dir: str,
    index_maps: Dict[str, IndexMap],  # feature shard -> IndexMap
    entity_indexes: Optional[Dict[str, EntityIndex]] = None,  # RE type -> EntityIndex
    sparsity_threshold: float = 1e-4,
    extra_metadata: Optional[dict] = None,
    stable_bytes: bool = False,
) -> None:
    """Write every coordinate of ``model`` under ``output_dir``. A dense
    random effect writes one record per entity; a projected one writes the
    entities that have a block, translating block columns through the
    block's col_map (the (E, d_full) matrix is never built). Entity ids come
    from ``entity_indexes`` (the dense index as a string without one).
    ``stable_bytes``: the same records give the same file bytes (Avro sync
    markers derived from the records, not random)."""
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
            _write_model_records(os.path.join(cdir, "part-00000.avro"), [rec], stable_bytes)
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
        _write_model_records(os.path.join(cdir, COEFF_DIR, "part-00000.avro"), records, stable_bytes)
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


# ---------------------------------------------------------------------------
# Generations: manifests, the validation gate, the poison list, names, locks
# and delta layers (port of the reference's rollout half of
# photon_tpu/io/model_io.py; framework-free but for the delta model's
# tensors). A failing generation stays on disk, never pointed to, with the
# refusal reason in its own manifest.
# ---------------------------------------------------------------------------


def _file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def generation_checksums(model_dir: str) -> Dict[str, str]:
    """relpath → sha256 over every payload file of a generation (the
    manifest itself excluded: it cannot checksum its own content)."""
    out: Dict[str, str] = {}
    for root, _dirs, files in os.walk(model_dir):
        for fn in sorted(files):
            rel = os.path.relpath(os.path.join(root, fn), model_dir)
            if rel == MANIFEST_FILE:
                continue
            out[rel] = _file_sha256(os.path.join(root, fn))
    return out


def _write_json_durable(path: str, obj: dict) -> None:
    """tmp + fsync + rename, the discipline of ``LATEST``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_generation_manifest(model_dir: str, parent: Optional[str] = None,
                              holdout_metrics: Optional[Dict[str, float]] = None,
                              extra: Optional[dict] = None) -> dict:
    """Record a generation's identity (per-file checksums and sizes, parent,
    holdout metrics), after the model is saved and before the gate, which
    verifies it against the files. The fault site
    ``model.corrupt_manifest`` flips one recorded checksum (bit-rot that
    still parses), which the gate must refuse."""
    from photon_tpu_torch.utils import faults

    checksums = generation_checksums(model_dir)
    sizes = {rel: os.path.getsize(os.path.join(model_dir, rel)) for rel in checksums}
    manifest = {
        "generation": os.path.basename(model_dir.rstrip("/")),
        "parent": parent,
        "createdAt": time.time(),
        "holdoutMetrics": dict(holdout_metrics or {}),
        "files": checksums,
        # A delta layer's totalBytes is a small share of its base's.
        "fileBytes": sizes,
        "totalBytes": int(sum(sizes.values())),
        "gate": {"status": "candidate", "reason": None},
        **(extra or {}),
    }
    if faults.injector().fire("model.corrupt_manifest") is not None and manifest["files"]:
        rel = sorted(manifest["files"])[0]
        manifest["files"][rel] = "0" * 64
        logger.warning("fault model.corrupt_manifest: flipped checksum of %r in %s", rel, model_dir)
    _write_json_durable(os.path.join(model_dir, MANIFEST_FILE), manifest)
    return manifest


def load_generation_manifest(model_dir: str) -> Optional[dict]:
    path = os.path.join(model_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def update_generation_manifest(model_dir: str, patch: dict) -> Optional[dict]:
    """Durably merge top-level keys into a generation's manifest (a dict
    value merges into a dict one). The manifest is not in its own
    checksums, so a patch never fails the gate. None without a manifest."""
    manifest = load_generation_manifest(model_dir)
    if manifest is None:
        return None
    for key, val in patch.items():
        if isinstance(val, dict) and isinstance(manifest.get(key), dict):
            manifest[key] = {**manifest[key], **val}
        else:
            manifest[key] = val
    _write_json_durable(os.path.join(model_dir, MANIFEST_FILE), manifest)
    return manifest


def experiment_generations(publish_root: str, experiment_id: Optional[str] = None) -> List[dict]:
    """Every generation manifest under ``publish_root`` with an
    ``experiment`` tag (of ``experiment_id`` when given), sorted by (round,
    generation): the tag plus ``generation``, ``gate`` and ``createdAt``."""
    out: List[dict] = []
    try:
        names = sorted(os.listdir(publish_root))
    except OSError:
        return out
    for name in names:
        model_dir = os.path.join(publish_root, name)
        if not os.path.isdir(model_dir):
            continue
        manifest = load_generation_manifest(model_dir)
        exp = (manifest or {}).get("experiment")
        if not isinstance(exp, dict) or (experiment_id is not None and exp.get("id") != experiment_id):
            continue
        out.append(dict(exp, generation=manifest.get("generation", name), gate=manifest.get("gate"),
                        createdAt=manifest.get("createdAt")))
    out.sort(key=lambda e: (int(e.get("round", 0)), str(e["generation"])))
    return out


def delta_info(model_dir: str) -> Optional[dict]:
    """The ``delta`` block of a generation's metadata ({"base", ...}), or
    None for a full generation."""
    path = os.path.join(model_dir, METADATA_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f).get("delta")
    except (OSError, ValueError):
        return None


def resolve_delta_chain(model_dir: str, publish_root: Optional[str] = None, max_depth: int = 128) -> list:
    """A generation's chain, base first: ``[full_base, delta_1, ...,
    model_dir]`` (``[model_dir]`` for a full one). Bases are siblings under
    ``publish_root`` (default: the generation's parent directory). A missing
    base raises FileNotFoundError, a cycle or an over-deep chain
    ValueError."""
    publish_root = publish_root or os.path.dirname(os.path.abspath(model_dir.rstrip("/")))
    chain: list = []
    seen = set()
    cur = model_dir
    while True:
        name = os.path.basename(cur.rstrip("/"))
        if name in seen:
            raise ValueError(f"delta chain cycle at {name!r}")
        seen.add(name)
        chain.append(cur)
        if len(chain) > max_depth:
            raise ValueError(f"delta chain deeper than {max_depth} from {model_dir!r}")
        info = delta_info(cur)
        if not info:
            chain.reverse()
            return chain
        base = info.get("base")
        if not base:
            raise ValueError(f"delta generation {name!r} names no base")
        cand = base if os.path.isabs(base) else os.path.join(publish_root, base)
        if not os.path.isdir(cand):
            raise FileNotFoundError(f"delta base {base!r} of {name!r} missing under {publish_root!r}")
        cur = cand


def delta_row_ids(model_dir: str) -> Dict[str, set]:
    """Per coordinate, the model ids a delta layer carries (``{"__fixed__"}``
    for a fixed effect); {} for a full generation."""
    if delta_info(model_dir) is None:
        return {}
    out: Dict[str, set] = {}
    for cid, info in read_model_metadata(model_dir)["coordinates"].items():
        if info.get("type") == "fixed":
            out[cid] = {"__fixed__"}  # a layer that retrains the fixed effect commutes with nothing
            continue
        out[cid] = {rec["modelId"] for rec in _records(os.path.join(model_dir, RANDOM_DIR, cid))}
    return out


def layers_commute(dir_a: str, dir_b: str) -> bool:
    """True iff two delta layers touch disjoint entities in every
    coordinate (and neither retrains the fixed effect): row-overwrite
    application is then order-independent."""
    rows_a, rows_b = delta_row_ids(dir_a), delta_row_ids(dir_b)
    return not any(rows_a[cid] & rows_b[cid] for cid in set(rows_a) & set(rows_b))


def _resolved_coordinate_records(model_dir: str, publish_root: Optional[str] = None):
    """A chain resolved into ``(coordinates, {cid: {modelId: record}})``,
    later layers' records replacing earlier ones row by row."""
    coordinates: Dict[str, dict] = {}
    records: Dict[str, dict] = {}
    for layer in resolve_delta_chain(model_dir, publish_root):
        for cid, info in read_model_metadata(layer)["coordinates"].items():
            coordinates.setdefault(cid, dict(info))
            sub = FIXED_DIR if info.get("type") == "fixed" else RANDOM_DIR
            per = records.setdefault(cid, {})
            for rec in _records(os.path.join(layer, sub, cid)):
                per[rec["modelId"]] = rec
    return coordinates, records


def _norms_over_records(recs) -> dict:
    sq, n, finite = 0.0, 0, True
    for rec in recs:
        n += 1
        for ntv in rec.get("means") or ():
            v = float(ntv["value"])
            if not math.isfinite(v):
                finite = False
            else:
                sq += v * v
        for ntv in rec.get("variances") or ():
            if not math.isfinite(float(ntv["value"])):
                finite = False
    return {"l2": math.sqrt(sq), "records": n, "finite": finite}


def coordinate_norms(model_dir: str, resolve_deltas: bool = True) -> Dict[str, dict]:
    """Per coordinate, straight off the Avro part files: the L2 norm of all
    recorded means, the record count and whether every value is finite (the
    gate's coefficient check; a delta generation over its resolved
    chain)."""
    if resolve_deltas and delta_info(model_dir) is not None:
        _coords, records = _resolved_coordinate_records(model_dir)
        return {cid: _norms_over_records(per.values()) for cid, per in records.items()}
    out: Dict[str, dict] = {}
    for cid, info in read_model_metadata(model_dir).get("coordinates", {}).items():
        sub = FIXED_DIR if info.get("type") == "fixed" else RANDOM_DIR
        out[cid] = _norms_over_records(_records(os.path.join(model_dir, sub, cid)))
    return out


@dataclasses.dataclass
class GateResult:
    """The validation gate's verdict on one candidate generation."""

    ok: bool
    reason: Optional[str]
    checks: Dict[str, object] = dataclasses.field(default_factory=dict)


def _metric_regressed(name: str, new: float, old: float, tol: float) -> bool:
    """``new`` worse than ``old`` by more than ``tol`` in the metric's own
    direction; a metric the evaluator grammar does not know is not judged;
    a non-finite new value always regresses."""
    if not (math.isfinite(new) and math.isfinite(old)):
        return not math.isfinite(new)
    try:
        from photon_tpu_torch.evaluation.suite import EvaluatorSpec

        better = EvaluatorSpec.parse(name).better()
    except Exception:  # noqa: BLE001 — unknown metric: no verdict
        return False
    if better(1.0, 0.0):
        return new < old - tol
    return new > old + tol


def verify_generation(model_dir: str, parent_dir: Optional[str] = None, metric_tolerance: float = 0.02,
                      norm_drift_bound: float = 10.0) -> GateResult:
    """The validation gate: (1) every file of the manifest exists and hashes
    to its recorded sha256, and a delta's chain resolves with no poisoned
    base; (2) every coefficient is finite and each coordinate's L2 norm
    within ``norm_drift_bound`` relative drift of the parent's; (3) no
    holdout metric of both manifests is worse than the parent's by more than
    ``metric_tolerance``. Never raises on bad content."""
    checks: Dict[str, object] = {}
    try:
        manifest = load_generation_manifest(model_dir)
    except (OSError, ValueError) as exc:
        return GateResult(False, f"manifest_unreadable: {exc}", checks)
    if manifest is None:
        return GateResult(False, "manifest_missing", checks)
    recorded = manifest.get("files") or {}
    for rel, digest in sorted(recorded.items()):
        path = os.path.join(model_dir, rel)
        if not os.path.exists(path):
            return GateResult(False, f"missing_file: {rel}", checks)
        if _file_sha256(path) != digest:
            return GateResult(False, f"checksum_mismatch: {rel}", checks)
    checks["files_verified"] = len(recorded)
    if delta_info(model_dir) is not None:
        publish_root = os.path.dirname(os.path.abspath(model_dir.rstrip("/")))
        try:
            chain = resolve_delta_chain(model_dir, publish_root)
        except (OSError, ValueError) as exc:
            return GateResult(False, f"delta_chain_unresolvable: {exc}", checks)
        checks["delta_chain"] = [os.path.basename(p.rstrip("/")) for p in chain]
        for layer in chain[:-1]:
            if is_poisoned(publish_root, layer):
                return GateResult(False, f"delta_base_poisoned: {os.path.basename(layer.rstrip('/'))}", checks)
    try:
        norms = coordinate_norms(model_dir)
    except Exception as exc:  # noqa: BLE001 — unreadable coefficients fail the gate
        return GateResult(False, f"coefficients_unreadable: {exc}", checks)
    checks["coordinate_norms"] = {c: round(v["l2"], 6) for c, v in norms.items()}
    for cid, info in norms.items():
        if not info["finite"]:
            return GateResult(False, f"non_finite_coefficients: {cid}", checks)
    parent_manifest = None
    if parent_dir:
        try:
            parent_manifest = load_generation_manifest(parent_dir)
            parent_norms = coordinate_norms(parent_dir)
        except Exception:  # noqa: BLE001 — an unreadable parent cannot bound us
            parent_norms = {}
        for cid, info in norms.items():
            old = parent_norms.get(cid, {}).get("l2")
            if old is None or old <= 1e-9:
                continue
            drift = abs(info["l2"] - old) / old
            if drift > norm_drift_bound:
                return GateResult(False, f"norm_drift: {cid} drifted {drift:.2f}x (bound {norm_drift_bound})",
                                  checks)
    new_metrics = manifest.get("holdoutMetrics") or {}
    old_metrics = (parent_manifest or {}).get("holdoutMetrics") or {}
    compared = {}
    for name, new_v in new_metrics.items():
        old_v = old_metrics.get(name)
        if old_v is None:
            continue
        compared[name] = {"new": new_v, "parent": old_v}
        if _metric_regressed(name, float(new_v), float(old_v), metric_tolerance):
            checks["holdout_compared"] = compared
            return GateResult(False, f"holdout_regression: {name} {new_v:.6g} vs parent {old_v:.6g} "
                                     f"(tolerance {metric_tolerance})", checks)
    checks["holdout_compared"] = compared
    return GateResult(True, None, checks)


def gate_and_publish(publish_root: str, generation: str, metric_tolerance: float = 0.02,
                     norm_drift_bound: float = 10.0) -> GateResult:
    """Gate ``generation`` (a subdirectory of ``publish_root``) against the
    current ``LATEST`` and flip the pointer on a pass only; the verdict goes
    into the generation's own manifest either way."""
    model_dir = os.path.join(publish_root, generation)
    parent_dir = None
    latest = os.path.join(publish_root, "LATEST")
    if os.path.isfile(latest):
        with open(latest) as f:
            name = f.read().strip()
        if name and name != generation:
            cand = name if os.path.isabs(name) else os.path.join(publish_root, name)
            if os.path.isdir(cand):
                parent_dir = cand
    result = verify_generation(model_dir, parent_dir, metric_tolerance=metric_tolerance,
                               norm_drift_bound=norm_drift_bound)
    manifest = load_generation_manifest(model_dir)
    if manifest is not None:
        manifest["gate"] = {"status": "published" if result.ok else "rejected", "reason": result.reason,
                            "checkedAt": time.time()}
        _write_json_durable(os.path.join(model_dir, MANIFEST_FILE), manifest)
    if result.ok:
        publish_latest_pointer(publish_root, generation)
        registry().counter("model_generations_published_total").inc()
        logger.info("generation %s passed the gate; LATEST -> %s", generation, generation)
    else:
        registry().counter("model_gate_failures_total").inc()
        logger.warning("generation %s REFUSED by the validation gate (%s); LATEST unchanged", generation,
                       result.reason)
    return result


def _flock(lockf) -> None:
    try:
        import fcntl

        fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
    except ImportError:  # non-POSIX: best effort, one writer only
        pass


def load_poison_list(publish_root: str) -> Dict[str, str]:
    path = os.path.join(publish_root, POISON_FILE)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            obj = json.load(f)
        return {str(k): str(v) for k, v in obj.items()}
    except (OSError, ValueError):
        return {}


def mark_poisoned(publish_root: str, generation: str, reason: str) -> None:
    """Durably add ``generation`` to the publish root's poison list, the
    read-modify-write under an exclusive flock of a sidecar file (a publish
    root is shared by processes)."""
    generation = os.path.basename(generation.rstrip("/"))
    with open(os.path.join(publish_root, POISON_FILE + ".lock"), "a") as lockf:
        _flock(lockf)
        poisoned = load_poison_list(publish_root)
        poisoned[generation] = reason
        _write_json_durable(os.path.join(publish_root, POISON_FILE), poisoned)
    logger.warning("generation %s marked POISONED: %s", generation, reason)


def is_poisoned(publish_root: str, generation: str) -> bool:
    return os.path.basename(generation.rstrip("/")) in load_poison_list(publish_root)


def next_generation_name(publish_root: str, prefix: str = "gen-") -> str:
    """The first unused ``<prefix><N>`` (N past the largest existing one,
    poisoned ones included)."""
    best = 0
    if os.path.isdir(publish_root):
        for name in os.listdir(publish_root):
            if name.startswith(prefix):
                try:
                    best = max(best, int(name[len(prefix):]))
                except ValueError:
                    continue
    return f"{prefix}{best + 1}"


def allocate_generation(publish_root: str, prefix: str = "gen-") -> str:
    """Claim the next generation name: the scan and the directory's creation
    under an exclusive flock, so two publishers never share a name."""
    os.makedirs(publish_root, exist_ok=True)
    with open(os.path.join(publish_root, ".generation-allocate.lock"), "a") as lockf:
        _flock(lockf)
        name = next_generation_name(publish_root, prefix)
        os.makedirs(os.path.join(publish_root, name))
    return name


@contextlib.contextmanager
def publish_lock(publish_root: str):
    """Exclusive flock over the save → manifest → gate → flip tail of a
    publish, so concurrent publishers rebase onto the true predecessor."""
    os.makedirs(publish_root, exist_ok=True)
    with open(os.path.join(publish_root, ".streaming-publish.lock"), "a") as lockf:
        _flock(lockf)
        yield


def save_delta_model(model: GameModel, changed_entities: Dict[str, np.ndarray], output_dir: str,
                     index_maps: Dict[str, IndexMap], entity_indexes: Dict[str, EntityIndex], base: str,
                     sparsity_threshold: float = 0.0, include_fixed: bool = False,
                     extra_metadata: Optional[dict] = None, stable_bytes: bool = False) -> Dict[str, int]:
    """Write a delta generation: only the rows ``changed_entities`` names
    (``{re_type: bool mask or index array}``), in a full generation's
    layout, with ``{"delta": {"base": <generation>, "changedEntities"}}`` in
    its metadata. The default threshold 0 keeps every nonzero coefficient,
    so resolving the layer equals publishing the whole model. Fixed effects
    only with ``include_fixed``. ``stable_bytes`` as for
    :func:`save_game_model`. Returns the records written a coordinate."""
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.basename(base.rstrip("/"))
    written: Dict[str, int] = {}
    meta: dict = {"coordinates": {}, **(extra_metadata or {})}
    changed_counts: Dict[str, int] = {}
    for cid, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            if not include_fixed:
                continue
            cdir = os.path.join(output_dir, FIXED_DIR, cid, COEFF_DIR)
            os.makedirs(cdir, exist_ok=True)
            with open(os.path.join(output_dir, FIXED_DIR, cid, ID_INFO_FILE), "w") as f:
                f.write(sub.feature_shard + "\n")
            coefs = sub.model.coefficients
            rec = _coeffs_to_avro(cid, _host(coefs.means), _host(coefs.variances), index_maps[sub.feature_shard],
                                  sub.model.task, sparsity_threshold)
            _write_model_records(os.path.join(cdir, "part-00000.avro"), [rec], stable_bytes)
            meta["coordinates"][cid] = {"type": "fixed", "featureShard": sub.feature_shard,
                                        "task": sub.model.task.value, "dim": int(coefs.dim)}
            written[cid] = 1
        elif isinstance(sub, RandomEffectModel):
            mask = changed_entities.get(sub.re_type)
            if mask is None:
                continue
            coefs = _host(sub.coefficients)
            mask = np.asarray(mask)
            idx = np.flatnonzero(mask) if mask.dtype == bool else np.unique(mask.astype(np.int64))
            idx = idx[idx < coefs.shape[0]]
            if idx.size == 0:
                continue
            cdir = os.path.join(output_dir, RANDOM_DIR, cid)
            os.makedirs(os.path.join(cdir, COEFF_DIR), exist_ok=True)
            with open(os.path.join(cdir, ID_INFO_FILE), "w") as f:
                f.write(sub.re_type + "\n" + sub.feature_shard + "\n")
            eidx = entity_indexes.get(sub.re_type)
            variances = _host(sub.variances)
            records = [_coeffs_to_avro(eidx.entity_id(int(e)) if eidx is not None else str(int(e)), coefs[e],
                                       None if variances is None else variances[e], index_maps[sub.feature_shard],
                                       sub.task, sparsity_threshold)
                       for e in idx]
            _write_model_records(os.path.join(cdir, COEFF_DIR, "part-00000.avro"), records, stable_bytes)
            meta["coordinates"][cid] = {"type": "random", "reType": sub.re_type, "featureShard": sub.feature_shard,
                                        "task": sub.task.value, "dim": int(coefs.shape[1]),
                                        "numEntities": int(idx.size)}
            written[cid] = int(idx.size)
            changed_counts[sub.re_type] = changed_counts.get(sub.re_type, 0) + int(idx.size)
        elif isinstance(sub, ProjectedRandomEffectModel):
            raise ValueError(f"coordinate {cid!r}: projected random effects do not support delta layers — "
                             "publish a full generation")
    if not written:
        raise ValueError("delta generation would be empty: no changed entities named and fixed effects excluded")
    tasks = [c["task"] for c in meta["coordinates"].values()]
    if tasks:
        meta.setdefault("modelType", tasks[0])
    meta["delta"] = {"base": base, "changedEntities": changed_counts}
    with open(os.path.join(output_dir, METADATA_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return written


def read_delta_rows(model_dir: str, index_maps: Dict[str, IndexMap], entity_indexes: Dict[str, EntityIndex]) -> dict:
    """One delta layer as the serving store's overlay: ``{"base", "re_rows":
    {cid: (entity_idx int64[m], rows float32[m, d])}, "fixed": {cid: means
    float32[d]}}``. An entity id unknown to ``entity_indexes`` raises
    ValueError (the caller then loads the resolved model whole)."""
    info = delta_info(model_dir)
    if info is None:
        raise ValueError(f"{model_dir!r} is not a delta generation")
    out: dict = {"base": info.get("base"), "re_rows": {}, "fixed": {}}
    for cid, cinfo in read_model_metadata(model_dir)["coordinates"].items():
        imap = index_maps[cinfo["featureShard"]]
        dim = cinfo.get("dim", len(imap))
        if cinfo["type"] == "fixed":
            recs = _records(os.path.join(model_dir, FIXED_DIR, cid))
            if len(recs) != 1:
                raise ValueError(f"delta fixed-effect {cid!r}: expected one record, got {len(recs)}")
            out["fixed"][cid] = _avro_to_coeffs(recs[0], imap, dim)[0]
            continue
        cdir = os.path.join(model_dir, RANDOM_DIR, cid)
        with open(os.path.join(cdir, ID_INFO_FILE)) as f:
            re_type = f.read().split()[0]
        eidx = entity_indexes.get(re_type)
        if eidx is None:
            raise ValueError(f"delta coordinate {cid!r}: no entity index for {re_type!r}")
        idx, rows = [], []
        for rec in _records(cdir):
            e = eidx.lookup(rec["modelId"])
            if e < 0:
                raise ValueError(f"delta coordinate {cid!r}: entity {rec['modelId']!r} unknown to the serving "
                                 "entity index")
            idx.append(e)
            rows.append(_avro_to_coeffs(rec, imap, dim)[0])
        if idx:
            out["re_rows"][cid] = (np.asarray(idx, np.int64), np.stack(rows).astype(np.float32))
    return out


def load_resolved_game_model(model_dir: str, index_maps: Dict[str, IndexMap],
                             entity_indexes: Optional[Dict[str, EntityIndex]] = None, to_device: bool = True,
                             publish_root: Optional[str] = None, device="cuda") -> GameModel:
    """A generation with its delta chain applied: the full base loads on the
    host, each layer's records overwrite their entities' rows (a layer may
    add entities), then the model moves to ``device`` unless ``to_device``
    is False (the serving store's host master: CPU tensors). Equal to
    loading the equivalent whole-model publish."""
    chain = resolve_delta_chain(model_dir, publish_root)
    entity_indexes = entity_indexes if entity_indexes is not None else {}
    model = load_game_model(chain[0], index_maps, entity_indexes, device="cpu")
    for layer in chain[1:]:
        model = _apply_delta_layer(model, layer, index_maps, entity_indexes)
    if not to_device:
        return model
    return GameModel({cid: _submodel_to(sub, device) for cid, sub in model.models.items()})


def _submodel_to(sub, device):
    to = lambda t: None if t is None else t.to(device)  # noqa: E731
    if isinstance(sub, FixedEffectModel):
        c = sub.model.coefficients
        return FixedEffectModel(GeneralizedLinearModel(Coefficients(to(c.means), to(c.variances)), sub.model.task),
                                sub.feature_shard)
    if isinstance(sub, RandomEffectModel):
        return dataclasses.replace(sub, coefficients=to(sub.coefficients), variances=to(sub.variances),
                                   present_entities=to(sub.present_entities))
    return sub


def _apply_delta_layer(model: GameModel, layer_dir: str, index_maps: Dict[str, IndexMap],
                       entity_indexes: Dict[str, EntityIndex]) -> GameModel:
    """Overwrite ``model``'s rows (CPU tensors) with one delta layer's
    records, growing an entity space when the layer adds ids."""
    models = dict(model.models)
    for cid, info in read_model_metadata(layer_dir)["coordinates"].items():
        imap = index_maps[info["featureShard"]]
        dim = info.get("dim", len(imap))
        old = models.get(cid)
        if info["type"] == "fixed":
            recs = _records(os.path.join(layer_dir, FIXED_DIR, cid))
            if len(recs) != 1:
                raise ValueError(f"delta fixed-effect {cid!r}: expected one record, got {len(recs)}")
            if not isinstance(old, FixedEffectModel):
                raise ValueError(f"delta fixed-effect {cid!r} has no fixed base coordinate")
            means, variances, _task = _avro_to_coeffs(recs[0], imap, dim)
            oldv = old.model.coefficients.variances
            models[cid] = FixedEffectModel(
                GeneralizedLinearModel(Coefficients(torch.from_numpy(means), torch.from_numpy(variances)
                                                    if variances is not None else oldv), old.model.task),
                old.feature_shard)
            continue
        cdir = os.path.join(layer_dir, RANDOM_DIR, cid)
        with open(os.path.join(cdir, ID_INFO_FILE)) as f:
            re_type = f.read().split()[0]
        if not isinstance(old, RandomEffectModel):
            raise ValueError(f"delta coordinate {cid!r} has no random-effect base coordinate")
        eidx = entity_indexes.setdefault(re_type, EntityIndex())
        recs = _records(cdir)
        for rec in recs:
            eidx.intern(rec["modelId"])
        E = len(eidx)
        coefs = _host(old.coefficients).copy()
        present = (np.zeros((coefs.shape[0],), bool) if old.present_entities is None
                   else _host(old.present_entities).copy())
        variances_arr = None if old.variances is None else _host(old.variances).copy()
        if E > coefs.shape[0]:  # the layer added entities
            grow = E - coefs.shape[0]
            coefs = np.vstack([coefs, np.zeros((grow, coefs.shape[1]), coefs.dtype)])
            present = np.concatenate([present, np.zeros((grow,), bool)])
            if variances_arr is not None:
                variances_arr = np.vstack([variances_arr, np.zeros((grow, variances_arr.shape[1]),
                                                                   variances_arr.dtype)])
        for rec in recs:
            e = eidx.lookup(rec["modelId"])
            means, variances, _task = _avro_to_coeffs(rec, imap, dim)
            coefs[e] = means
            present[e] = True
            if variances is not None and variances_arr is not None:
                variances_arr[e] = variances
        models[cid] = RandomEffectModel(torch.from_numpy(coefs), re_type, old.feature_shard, old.task,
                                        None if variances_arr is None else torch.from_numpy(variances_arr),
                                        present_entities=torch.from_numpy(present))
    return GameModel(models)


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
