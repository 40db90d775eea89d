"""GAME scoring driver (port of photon_tpu/cli/game_scoring.py, its
whole-file read).

    python -m photon_tpu_torch.cli.game_scoring --input-paths valid/ \\
        --output-dir scores/ --feature-shard-configurations name=globalShard \\
        --model-input-dir out/best --evaluators AUC [--device cpu]

The index maps and entity indexes come from ``--model-artifacts-dir``
(default: the parent of the model directory, where ``game_training``
writes them), the model is loaded onto ``--device`` and the data read with
entities looked up, never interned: an entity the model has not seen gets
id -1 and scores 0 in that coordinate. ``GameTransformer`` scores the rows;
``scores.avro`` holds one ScoringResultAvro record a row, its ``uid`` the
row number, and ``scoring-metrics.json`` the evaluators' values. Prints
``{"numScored": ..., "metrics": ...}``.

The data and the scoring live on ``--device`` (default cuda; without a card
the driver exits non-zero rather than run on the CPU). The streaming
reader's flags and the telemetry flags are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict

from photon_tpu_torch.cli.common import (
    add_active_set_args,
    add_common_args,
    add_device_arg,
    add_out_of_core_args,
    parse_feature_shard_config,
    parse_input_column_names,
    refuse_unported,
    resolve_device,
    resolve_input_paths,
    setup_logging,
)
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.estimators.game_transformer import GameTransformer
from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
from photon_tpu_torch.io.data_reader import read_merged
from photon_tpu_torch.io.model_io import load_game_model, model_re_types, read_model_metadata
from photon_tpu_torch.io.scores import save_scores
from photon_tpu_torch.utils.io_utils import process_output_dir
from photon_tpu_torch.utils.timed import Timed

log = logging.getLogger("photon_tpu_torch.game_scoring")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("game-scoring")
    add_common_args(p)
    p.add_argument("--model-input-dir", required=True)
    p.add_argument("--model-artifacts-dir", default=None,
                   help="dir holding index-map-*.json / entity-index-*.json "
                        "(defaults to the training output dir = parent of model dir)")
    p.add_argument("--evaluators", nargs="*", default=[])
    p.add_argument("--model-id", default="game-model")
    p.add_argument("--stream-ingest-chunk-rows", type=int, default=0, help="not ported yet")
    p.add_argument("--ingest-queue-depth", type=int, default=None, help="not ported yet")
    p.add_argument("--serial-ingest", action="store_true", help="not ported yet")
    p.add_argument("--event-listeners", nargs="*", default=[], help="not ported yet")
    p.add_argument("--event-listener", action="append", default=[], dest="event_listener",
                   help="not ported yet")
    p.add_argument("--telemetry-out", default=None, help="not ported yet")
    add_active_set_args(p)
    add_out_of_core_args(p)
    add_device_arg(p)
    return p


def run(args) -> Dict:
    setup_logging(args.verbose)
    refuse_unported("game_scoring", {
        "--stream-ingest-chunk-rows": args.stream_ingest_chunk_rows > 0,
        "--ingest-queue-depth": args.ingest_queue_depth is not None,
        "--serial-ingest": args.serial_ingest,
        "--event-listeners": bool(args.event_listeners),
        "--event-listener": bool(args.event_listener),
        "--telemetry-out": args.telemetry_out is not None,
    })
    if args.re_active_set:
        log.warning("--re-active-set is a no-op for the scoring driver (nothing is "
                    "trained); it only affects GAME training")
    if args.re_device_budget_mb:
        log.warning("--re-device-budget-mb is a no-op for the scoring driver "
                    "(nothing is trained); it only affects GAME training")
    device = resolve_device(args.device)
    shard_configs: Dict = {}
    for spec in args.feature_shard_configurations:
        shard_configs.update(parse_feature_shard_config(spec))

    artifacts = args.model_artifacts_dir or os.path.dirname(args.model_input_dir.rstrip("/"))
    index_maps = {shard: IndexMap.load(os.path.join(artifacts, f"index-map-{shard}.json"))
                  for shard in shard_configs}
    entity_indexes: Dict[str, EntityIndex] = {}
    re_types = model_re_types(read_model_metadata(args.model_input_dir))
    for re_type in re_types:
        path = os.path.join(artifacts, f"entity-index-{re_type}.json")
        if os.path.exists(path):
            entity_indexes[re_type] = EntityIndex.load(path)
    with Timed("driver/load-model"):
        model = load_game_model(args.model_input_dir, index_maps, entity_indexes, device=device)

    process_output_dir(args.output_dir, args.override_output_dir)
    suite = None
    if args.evaluators:
        suite = EvaluationSuite([EvaluatorSpec.parse(e) for e in args.evaluators],
                                {k: len(v) for k, v in entity_indexes.items()})
    with Timed("driver/read"):
        batch, _, _ = read_merged(
            resolve_input_paths(args), shard_configs, index_maps=index_maps,
            entity_id_columns={rt: rt for rt in re_types}, entity_indexes=entity_indexes,
            intern_new_entities=False, column_names=parse_input_column_names(args.input_column_names),
            device=device,
        )
    with Timed("driver/score"):
        transformer = GameTransformer(model, suite)
        scores = transformer.transform(batch).cpu().numpy()
    metrics = transformer.last_metrics if suite is not None else None

    with Timed("driver/write"):
        save_scores(
            os.path.join(args.output_dir, "scores.avro"), scores, args.model_id,
            uids=[str(int(u)) for u in batch.uid.cpu().numpy()],
            labels=batch.label.cpu().numpy(), weights=batch.weight.cpu().numpy(),
        )
        out = {"numScored": int(scores.shape[0])}
        if metrics is not None:
            out["metrics"] = metrics
            with open(os.path.join(args.output_dir, "scoring-metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2)
    return out


def main(argv=None) -> Dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
