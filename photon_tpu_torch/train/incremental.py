"""Incremental generation updates: re-train only what changed, gate the rest
(port of photon_tpu/train/incremental.py).

An incremental update

1. loads the PARENT generation (whatever ``LATEST`` points to, its delta
   chain resolved) onto the device as the warm start, against the publish
   root's index maps and entity indexes, so slots stay stable across
   generations;
2. trains on the DELTA batch only — the entities present in it are exactly
   the "data changed" set, and the active set gives per-entity convergence
   inside the passes;
3. MERGES on the device: changed entities take their freshly trained rows,
   unchanged entities keep the parent's rows by copy (never by a solve), new
   entities append;
4. records a generation manifest (per-file sha256, parent, holdout metrics)
   and runs the validation gate; only a passing generation moves the
   fsync'd ``LATEST`` pointer that serving watches. The model files' bytes
   depend only on their records, so a generation rebuilt from the same
   parent and data (a restarted updater's) has the same checksums.

An entity quarantined (DIVERGED) in generation g keeps its warm-start row
there; when its data shows up in the g+1 delta it is a changed entity again
and trains from the warm start that survived the manifest round trip.

The merge keeps the trained model's dtype (the reference rounds every row
to float32 here); a float32 run, as the drivers and the card run, gives the
reference's rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.models.game import FixedEffectModel, GameModel, ProjectedRandomEffectModel, RandomEffectModel
from photon_tpu_torch.optim.common import HOST_READS

logger = logging.getLogger(__name__)

# The fits of one process share its solve cache (static buffers and graphs,
# released when a fit returns), so concurrent updates — updater shards run
# as threads — train one at a time; their publish tails still race, under
# the publish root's lock.
_FIT_LOCK = threading.Lock()


def changed_entity_mask(batch, re_type: str, num_entities: int) -> np.ndarray:
    """(E,) bool host mask — entities with at least one row in the delta
    batch. This IS the "data changed" set: the delta reader only carries rows
    whose data moved since the parent generation. One read of the batch's
    entity ids (``HOST_READS``)."""
    mask = np.zeros(int(num_entities), bool)
    (eids,) = HOST_READS.fetch(batch.entity_ids[re_type])
    eids = eids.astype(np.int64)
    valid = (eids >= 0) & (eids < num_entities)
    mask[eids[valid]] = True
    return mask


def _dense_re(model) -> RandomEffectModel:
    if isinstance(model, ProjectedRandomEffectModel):
        return model.to_dense()
    return model


def merge_random_effect(parent: Optional[RandomEffectModel], trained: RandomEffectModel,
                        changed: np.ndarray) -> RandomEffectModel:
    """Row-level merge of one random-effect coordinate, on the trained
    model's device: changed rows from ``trained``, every other row copied
    from ``parent``. Both are sized to the SAME entity space (the parent
    loads against the already-grown entity index, so new entities exist as
    absent rows there)."""
    trained = _dense_re(trained)
    t_coefs = trained.coefficients
    E, d = t_coefs.shape
    changed = np.asarray(changed, bool)
    if changed.shape[0] != E:
        raise ValueError(f"changed mask has {changed.shape[0]} entities, model has {E}")
    dev, dtype = t_coefs.device, t_coefs.dtype
    mask = torch.from_numpy(changed).to(dev)
    if parent is None:
        coefs = torch.where(mask[:, None], t_coefs, torch.zeros((), dtype=dtype, device=dev))
        return RandomEffectModel(coefs, trained.re_type, trained.feature_shard, trained.task, None,
                                 present_entities=mask.clone())
    parent = _dense_re(parent)
    p_coefs = parent.coefficients.to(dev)
    if p_coefs.shape[1] != d:
        raise ValueError(f"parent dim {p_coefs.shape[1]} != trained dim {d} for RE coordinate {trained.re_type!r}")
    p_present = parent.present_entities
    p_present = (torch.ones(p_coefs.shape[0], dtype=torch.bool, device=dev) if p_present is None
                 else p_present.to(dev, torch.bool))
    k = min(E, p_coefs.shape[0])
    coefs = torch.zeros((E, d), dtype=dtype, device=dev)
    present = torch.zeros(E, dtype=torch.bool, device=dev)
    coefs[:k] = p_coefs[:k]  # a copy (exact in the wider dtype)
    present[:k] = p_present[:k]
    coefs = torch.where(mask[:, None], t_coefs, coefs)
    present = present | mask
    variances = None
    if trained.variances is not None and parent.variances is not None:
        variances = torch.zeros((E, d), dtype=trained.variances.dtype, device=dev)
        variances[:k] = parent.variances.to(dev)[:k]
        variances = torch.where(mask[:, None], trained.variances, variances)
    return RandomEffectModel(coefs, trained.re_type, trained.feature_shard, trained.task, variances,
                             present_entities=present)


def merge_models(parent: Optional[GameModel], trained: GameModel, changed_masks: Dict[str, np.ndarray]) -> GameModel:
    """Generation merge: fixed effects take the (warm-started) retrain;
    random effects merge row-wise by ``changed_masks[re_type]``."""
    merged: Dict[str, object] = {}
    for cid, sub in trained.models.items():
        if isinstance(sub, FixedEffectModel):
            merged[cid] = sub
            continue
        p_sub = parent.get(cid) if parent is not None else None
        dense = _dense_re(sub)
        changed = changed_masks.get(dense.re_type)
        if changed is None:
            changed = np.ones((dense.coefficients.shape[0],), bool)
        merged[cid] = merge_random_effect(p_sub, dense, changed)
    return GameModel(merged)


def compute_holdout_metrics(model: GameModel, batch, suite) -> Dict[str, float]:
    """The generation manifest's holdout metrics, scored with the MERGED
    model (what would serve), not the raw retrain.

    Fault site ``model.bad_holdout``: each metric is pushed past any sane
    regression tolerance in its own worse direction, so the gate must
    refuse the generation."""
    from photon_tpu_torch.utils import faults

    metrics = suite.evaluate_model(model, batch)
    rule = faults.injector().fire("model.bad_holdout")
    if rule is not None:
        from photon_tpu_torch.evaluation.suite import EvaluatorSpec

        bad = {}
        for name, v in metrics.items():
            try:
                higher_better = EvaluatorSpec.parse(name).better()(1.0, 0.0)
            except Exception:  # noqa: BLE001 — unknown metric: degrade anyway
                higher_better = True
            bad[name] = v - 0.5 if higher_better else v * 10.0 + 1.0
        logger.warning("fault model.bad_holdout: recorded metrics degraded %s -> %s", metrics, bad)
        metrics = bad
    return metrics


def read_dead_letters(paths: Sequence[str]) -> List[dict]:
    """Parse ingest dead-letter sidecar JSONL files (io/pipeline.py writes one
    record per dropped chunk), recorded in the generation manifest so the
    skipped rows are targeted by the next refresh."""
    out: List[dict] = []
    for path in paths:
        if not path or not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    logger.warning("unparseable dead-letter line in %s", path)
    return out


def _in_dtype(model: GameModel, dtype) -> GameModel:
    """The loaded parent (float32 from its files) in the batch's floating
    dtype, so a float64 update warm-starts in float64 (exact widening)."""
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.models.glm import GeneralizedLinearModel

    def cast(t):
        return t.to(dtype) if t is not None and t.is_floating_point() else t

    out = {}
    for cid, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            c = sub.model.coefficients
            out[cid] = FixedEffectModel(GeneralizedLinearModel(Coefficients(cast(c.means), cast(c.variances)),
                                                               sub.model.task), sub.feature_shard)
        elif isinstance(sub, RandomEffectModel):
            out[cid] = dataclasses.replace(sub, coefficients=cast(sub.coefficients), variances=cast(sub.variances))
        else:
            out[cid] = sub
    return GameModel(out)


@dataclasses.dataclass
class IncrementalResult:
    generation: str
    model_dir: str
    published: bool
    gate_reason: Optional[str]
    holdout_metrics: Dict[str, float]
    changed_entities: Dict[str, int]
    parent: Optional[str]
    is_delta: bool = False


def incremental_update(
    publish_root: str,
    batch,
    index_maps: Dict,
    entity_indexes: Dict,
    task,
    coordinate_configs: Sequence,
    update_sequence: Sequence[str],
    valid_batch=None,
    evaluation_suite=None,
    generation: Optional[str] = None,
    locked_coordinates: Sequence[str] = (),
    num_iterations: int = 1,
    metric_tolerance: float = 0.02,
    norm_drift_bound: float = 10.0,
    sparsity_threshold: float = 0.0,
    re_convergence_tol: float = 1e-4,
    re_device_budget_mb: Optional[float] = None,
    re_spill_dir: Optional[str] = None,
    re_spill_member: Optional[str] = None,
    dead_letters: Optional[List[dict]] = None,
    publish: bool = True,
    emit_delta: bool = False,
    extra_manifest: Optional[dict] = None,
    serialize_publish: bool = False,
    optimization_config=None,
    device="cuda",
) -> IncrementalResult:
    """One incremental generation, end to end: warm-start train on the delta
    ``batch`` → merge over the parent → save → manifest → gate → (maybe)
    publish. ``entity_indexes`` must already hold the delta's interning; the
    parent loads against it onto ``device`` (where ``batch`` lives), so every
    table is sized to the grown entity space.

    ``sparsity_threshold`` defaults to 0 (an exact round trip: the chain
    re-loads its own output as the next warm start).

    ``emit_delta=True`` persists the generation as a per-entity DELTA layer
    over the parent (only changed rows written; the resolved chain equals a
    full publish bit for bit) — the streaming updater's micro-generation. It
    falls back to a full publish without a parent or when no layer can be
    emitted. ``extra_manifest`` adds keys to the manifest (e.g. the stream
    consume cursor).

    ``optimization_config`` (a ``GameOptimizationConfig``) trains at that
    one point instead of the coordinate configs' regularization grid.

    ``serialize_publish=True`` runs the save→manifest→gate tail under the
    publish root's ``publish_lock`` and REBASES onto whatever ``LATEST`` is
    then: when a concurrent publisher (a sibling updater shard) flipped it
    since this cycle resolved its parent, the changed rows are re-merged
    over the live resolved model, so the sibling's rows ride through. The
    changed rows are untouched by the rebase: per-entity solves depend only
    on the entity's own warm start and data, so disjoint publishers
    commute."""
    from photon_tpu_torch.cli.game_serving import resolve_model_dir
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.io.model_io import (allocate_generation, gate_and_publish, load_resolved_game_model,
                                              publish_lock, save_delta_model, save_game_model,
                                              write_generation_manifest)

    device = torch.device(device)
    parent_dir = resolve_model_dir(publish_root)
    has_parent = parent_dir != publish_root and os.path.isdir(parent_dir)
    parent_name = os.path.basename(parent_dir.rstrip("/")) if has_parent else None
    parent = None
    if has_parent:
        # A streaming parent can itself be a delta layer: the warm start is
        # the RESOLVED model, not the layer's few rows.
        parent = _in_dtype(load_resolved_game_model(parent_dir, index_maps, entity_indexes, to_device=True,
                                                    publish_root=publish_root, device=device), batch.label.dtype)

    num_entities = {k: len(v) for k, v in entity_indexes.items()}
    changed_masks = {re_type: changed_entity_mask(batch, re_type, E)
                     for re_type, E in num_entities.items() if re_type in batch.entity_ids}
    changed_counts = {k: int(v.sum()) for k, v in changed_masks.items()}
    logger.info("incremental update: parent=%s changed entities=%s", parent_name, changed_counts)

    estimator = GameEstimator(
        task=task,
        coordinate_configs=list(coordinate_configs),
        num_iterations=num_iterations,
        num_entities=num_entities,
        locked_coordinates=list(locked_coordinates),
        warm_start_model=parent,
        ignore_threshold_for_new_models=parent is not None,
        re_active_set=True,
        re_convergence_tol=re_convergence_tol,
        re_device_budget_mb=re_device_budget_mb,
        re_spill_dir=re_spill_dir,
        re_spill_member=re_spill_member,
    )
    with _FIT_LOCK:
        results = estimator.fit(
            batch,
            validation_batch=valid_batch,
            evaluation_suite=evaluation_suite if valid_batch is not None else None,
            initial_model=parent,
            optimization_configs=[optimization_config] if optimization_config is not None else None,
        )
    best = (estimator.select_best(results, evaluation_suite)
            if evaluation_suite is not None and valid_batch is not None else results[-1])
    merged = merge_models(parent, best.model, changed_masks)

    holdout: Dict[str, float] = {}
    if valid_batch is not None and evaluation_suite is not None:
        holdout = compute_holdout_metrics(merged, valid_batch, evaluation_suite)

    lock = publish_lock(publish_root) if serialize_publish else contextlib.nullcontext()
    with lock:
        publish_parent = parent_name
        if serialize_publish:
            live_dir = resolve_model_dir(publish_root)
            live_ok = live_dir != publish_root and os.path.isdir(live_dir)
            live_name = os.path.basename(live_dir.rstrip("/")) if live_ok else None
            if live_ok and live_name != parent_name:
                # Rebase: a sibling publisher flipped LATEST while this cycle
                # trained; its rows ride through, this cycle's are unchanged.
                live_parent = _in_dtype(load_resolved_game_model(live_dir, index_maps, entity_indexes,
                                                                 to_device=True, publish_root=publish_root,
                                                                 device=device), batch.label.dtype)
                merged = merge_models(live_parent, best.model, changed_masks)
                publish_parent = live_name
        # Allocation is flock-serialized: concurrent updaters never claim the
        # same generation id.
        generation = generation or allocate_generation(publish_root)
        model_dir = os.path.join(publish_root, generation)
        is_delta = False
        if emit_delta and publish_parent is not None:
            # Every random effect needs a mask; a coordinate whose re_type the
            # delta never mentioned changed nowhere and adds no rows.
            save_masks = dict(changed_masks)
            for sub in merged.models.values():
                if isinstance(sub, RandomEffectModel):
                    save_masks.setdefault(sub.re_type, np.zeros((sub.coefficients.shape[0],), bool))
            fe_cids = [cid for cid, sub in merged.models.items() if isinstance(sub, FixedEffectModel)]
            include_fixed = any(c not in locked_coordinates for c in fe_cids)
            try:
                save_delta_model(merged, save_masks, model_dir, index_maps, entity_indexes, base=publish_parent,
                                 sparsity_threshold=sparsity_threshold, include_fixed=include_fixed,
                                 stable_bytes=True)
                is_delta = True
            except ValueError as exc:
                logger.info("delta layer not emittable (%s); publishing full", exc)
        if not is_delta:
            save_game_model(merged, model_dir, index_maps, entity_indexes, sparsity_threshold=sparsity_threshold,
                            stable_bytes=True)
        # The entity indexes grew with the delta's new entities: persist them
        # BEFORE the pointer can move, so a reloading server resolves every
        # slot the new generation references (interning is append-only).
        for shard, imap in index_maps.items():
            imap.save(os.path.join(publish_root, f"index-map-{shard}.json"))
        for re_type, eidx in entity_indexes.items():
            eidx.save(os.path.join(publish_root, f"entity-index-{re_type}.json"))
        extra = {"changedEntities": changed_counts}
        if dead_letters:
            extra["deadLetterChunks"] = dead_letters
        if extra_manifest:
            extra.update(extra_manifest)
        write_generation_manifest(model_dir, parent=publish_parent, holdout_metrics=holdout, extra=extra)
        if publish:
            gate = gate_and_publish(publish_root, generation, metric_tolerance=metric_tolerance,
                                    norm_drift_bound=norm_drift_bound)
            published, reason = gate.ok, gate.reason
        else:
            published, reason = False, "publish_disabled"
    return IncrementalResult(generation=generation, model_dir=model_dir, published=published, gate_reason=reason,
                             holdout_metrics=holdout, changed_entities=changed_counts, parent=publish_parent,
                             is_delta=is_delta)
