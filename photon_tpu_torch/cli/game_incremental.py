"""Incremental GAME retraining driver: one guarded generation per run (port
of photon_tpu/cli/game_incremental.py; data and solves on ``--device``,
cuda unless ``--device cpu`` is given).

Against a *publish root* (the output dir of a previous
``game_training`` run: generations + ``LATEST`` + index-map / entity-index
artifacts), one invocation:

1. reads the DELTA data (rows whose data changed since the parent
   generation; new entities intern into the existing entity index),
2. warm-starts from the ``LATEST`` generation and re-trains only the
   changed entities (active-set machinery; unchanged entities keep the
   parent's coefficients verbatim via a row-level merge),
3. writes the new generation + its manifest (per-file sha256 checksums,
   parent generation id, holdout-metric record),
4. runs the validation gate — checksums, coefficient sanity, holdout
   regression bound vs the parent — and flips the fsync'd ``LATEST``
   pointer ONLY on a pass. A refused generation stays on disk with the
   reason in its manifest; ``game_serving --reload-poll-interval`` never
   sees it.

Usage:

  python -m photon_tpu_torch.cli.game_incremental \\
    --publish-root out/ --input-paths delta/ --validation-paths holdout/ \\
    --coordinate-configurations name=global,feature.shard=globalShard \\
      name=perUser,feature.shard=globalShard,random.effect.type=userId \\
    --update-sequence global,perUser --evaluators AUC
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict

from photon_tpu_torch.cli.common import (
    add_device_arg,
    add_out_of_core_args,
    parse_coordinate_config,
    parse_feature_shard_config,
    parse_input_column_names,
    resolve_device,
    setup_logging,
    task_of,
)
from photon_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("game-incremental")
    p.add_argument("--publish-root", required=True,
                   help="a game_training output dir: generations + LATEST "
                        "pointer + index-map-*.json / entity-index-*.json; "
                        "the new generation is written as a subdir here")
    p.add_argument("--input-paths", nargs="+", required=True,
                   help="delta data — rows whose data changed since the "
                        "parent generation")
    p.add_argument("--validation-paths", nargs="*", default=None,
                   help="holdout data for the gate's regression bound")
    p.add_argument("--feature-shard-configurations", nargs="+",
                   default=["name=global"])
    p.add_argument("--coordinate-configurations", nargs="+", required=True)
    p.add_argument("--update-sequence", required=True,
                   help="comma-separated coordinate ids")
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.name for t in TaskType])
    p.add_argument("--evaluators", nargs="*", default=["AUC"])
    p.add_argument("--input-column-names", default=None)
    p.add_argument("--generation", default=None,
                   help="name for the new generation (default: gen-<N+1>)")
    p.add_argument("--locked-coordinates", default="",
                   help="comma-separated coordinate ids to keep fixed")
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    p.add_argument("--metric-tolerance", type=float, default=0.02,
                   help="gate: max holdout-metric regression vs the parent")
    p.add_argument("--norm-drift-bound", type=float, default=10.0,
                   help="gate: max relative L2 coefficient-norm drift per "
                        "coordinate vs the parent")
    p.add_argument("--re-convergence-tol", type=float, default=1e-4)
    add_out_of_core_args(p)
    p.add_argument("--model-sparsity-threshold", type=float, default=0.0,
                   help="0 keeps all coefficients (exact warm-start round "
                        "trips across the incremental chain)")
    p.add_argument("--dead-letter-in", nargs="*", default=[],
                   help="pipeline dead-letter sidecar JSONL files "
                        "(io/pipeline.py) naming chunks dropped by a "
                        "previous run's skip budget; recorded in the "
                        "generation manifest so the skipped rows are "
                        "targeted by this refresh")
    p.add_argument("--no-publish", action="store_true",
                   help="train + manifest but never touch LATEST (dry run)")
    p.add_argument("--telemetry-out", default=None)
    add_device_arg(p)
    p.add_argument("--verbose", action="store_true")
    return p


def run(args) -> Dict:
    setup_logging(args.verbose)
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.io.data_reader import read_merged
    from photon_tpu_torch.obs import begin_run, finalize_run_report
    from photon_tpu_torch.train.incremental import incremental_update, read_dead_letters

    begin_run()
    device = resolve_device(args.device)
    task = task_of(args)
    shard_configs: Dict = {}
    for spec in args.feature_shard_configurations:
        shard_configs.update(parse_feature_shard_config(spec))
    coord_configs = [
        parse_coordinate_config(s) for s in args.coordinate_configurations
    ]
    update_sequence = [
        s.strip() for s in args.update_sequence.split(",") if s.strip()
    ]
    by_id = {c.coordinate_id: c for c in coord_configs}
    coord_configs = [by_id[cid] for cid in update_sequence]
    entity_id_columns = {
        c.re_type: c.re_type for c in coord_configs if hasattr(c, "re_type")
    }
    column_names = parse_input_column_names(args.input_column_names)

    # Generation-stable artifacts from the publish root: index maps pin the
    # feature space, entity indexes grow append-only as the delta interns
    # new entities — existing slots never move, so the parent model and any
    # running server stay aligned.
    index_maps = {}
    for shard in shard_configs:
        path = os.path.join(args.publish_root, f"index-map-{shard}.json")
        if os.path.exists(path):
            index_maps[shard] = IndexMap.load(path)
    entity_indexes = {}
    for re_type in entity_id_columns:
        path = os.path.join(args.publish_root, f"entity-index-{re_type}.json")
        if os.path.exists(path):
            entity_indexes[re_type] = EntityIndex.load(path)

    batch, index_maps, entity_indexes = read_merged(
        args.input_paths, shard_configs,
        index_maps=index_maps or None,
        entity_id_columns=entity_id_columns,
        entity_indexes=entity_indexes or None,
        intern_new_entities=True,
        column_names=column_names,
        device=device,
    )
    valid_batch = None
    if args.validation_paths:
        valid_batch, _, _ = read_merged(
            args.validation_paths, shard_configs,
            index_maps=index_maps,
            entity_id_columns=entity_id_columns,
            entity_indexes=entity_indexes,
            intern_new_entities=False,
            column_names=column_names,
            device=device,
        )
    suite = None
    if args.evaluators and valid_batch is not None:
        suite = EvaluationSuite(
            [EvaluatorSpec.parse(e) for e in args.evaluators],
            {k: len(v) for k, v in entity_indexes.items()},
        )

    result = incremental_update(
        args.publish_root,
        batch,
        index_maps,
        entity_indexes,
        task,
        coord_configs,
        update_sequence,
        valid_batch=valid_batch,
        evaluation_suite=suite,
        generation=args.generation,
        locked_coordinates=[
            s for s in args.locked_coordinates.split(",") if s
        ],
        num_iterations=args.coordinate_descent_iterations,
        metric_tolerance=args.metric_tolerance,
        norm_drift_bound=args.norm_drift_bound,
        sparsity_threshold=args.model_sparsity_threshold,
        re_convergence_tol=args.re_convergence_tol,
        re_device_budget_mb=args.re_device_budget_mb,
        re_spill_dir=args.re_spill_dir,
        re_spill_member=args.re_spill_member,
        dead_letters=read_dead_letters(args.dead_letter_in),
        publish=not args.no_publish,
        device=device,
    )
    finalize_run_report("game_incremental", path=args.telemetry_out)
    return {
        "generation": result.generation,
        "modelDir": result.model_dir,
        "published": result.published,
        "gateReason": result.gate_reason,
        "parent": result.parent,
        "holdoutMetrics": result.holdout_metrics,
        "changedEntities": result.changed_entities,
    }


def main(argv=None):
    summary = run(build_parser().parse_args(argv))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
