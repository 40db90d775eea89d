"""GAME scoring driver (port of photon_tpu/cli/game_scoring.py).

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

``--stream-ingest-chunk-rows`` scores chunk by chunk through the ingest
pipeline (io/pipeline.py; worker threads and bounded queues of
``--ingest-queue-depth`` chunks, or inline with ``--serial-ingest``): each
chunk is padded to a multiple of the chunk rows, scored and dropped, and
only the O(n) columns (scores, labels, weights, uids, entity ids)
accumulate; the output then carries the pipeline's per-stage statistics
under ``ingestPipeline``. A stream that cannot decode natively exits
non-zero with the reference's advice; it never falls back to a whole-file
read. Events go to the ``--event-listener(s)``.

The data and the scoring live on ``--device`` (default cuda; without a card
the driver exits non-zero rather than run on the CPU). ``--telemetry-out``
writes the run report (spans, metrics, the ingest pipeline's occupancy).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from photon_tpu_torch.cli.common import (
    add_active_set_args,
    add_common_args,
    add_device_arg,
    add_out_of_core_args,
    parse_feature_shard_config,
    parse_input_column_names,
    resolve_device,
    resolve_input_paths,
    setup_logging,
)
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
from photon_tpu_torch.estimators.game_transformer import GameTransformer
from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
from photon_tpu_torch.io.data_reader import read_merged
from photon_tpu_torch.io.model_io import load_game_model, model_re_types, read_model_metadata
from photon_tpu_torch.io.pipeline import DEFAULT_QUEUE_DEPTH, stream_device_batches
from photon_tpu_torch.io.scores import save_scores
from photon_tpu_torch.obs import begin_run, finalize_run_report
from photon_tpu_torch.optim.common import HOST_READS
from photon_tpu_torch.utils.events import EventEmitter, setup_event, training_finish_event
from photon_tpu_torch.utils.io_utils import process_output_dir
from photon_tpu_torch.utils.timed import PipelineStats, Timed

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
    p.add_argument("--stream-ingest-chunk-rows", type=int, default=0,
                   help="score through the chunked streaming pipeline: host memory bounded by a few chunks of "
                        "features (the O(n) columns accumulate); chunks pad to a multiple of this")
    p.add_argument("--ingest-queue-depth", type=int, default=None,
                   help="bound (in chunks) of each inter-stage pipeline queue (default: double buffering)")
    p.add_argument("--serial-ingest", action="store_true",
                   help="run the ingest stages inline on the consumer thread instead of on worker threads")
    p.add_argument("--event-listeners", nargs="*", default=[], help="dotted paths of event listener callables")
    p.add_argument("--event-listener", action="append", default=[], dest="event_listener",
                   help="register one event listener by path ('pkg.module:attr'); repeatable")
    p.add_argument("--telemetry-out", default=None,
                   help="write the unified run report (spans + metrics + ingest-pipeline occupancy) as "
                        "schema-stable JSONL to this path")
    add_active_set_args(p)
    add_out_of_core_args(p)
    add_device_arg(p)
    return p


def run(args) -> Dict:
    setup_logging(args.verbose)
    if args.re_active_set:
        log.warning("--re-active-set is a no-op for the scoring driver (nothing is "
                    "trained); it only affects GAME training")
    if args.re_device_budget_mb:
        log.warning("--re-device-budget-mb is a no-op for the scoring driver "
                    "(nothing is trained); it only affects GAME training")
    device = resolve_device(args.device)
    begin_run()  # fresh spans, metrics and phase records for this run
    emitter = EventEmitter()
    for name in list(args.event_listeners) + list(args.event_listener):
        emitter.register_by_name(name)
    emitter.emit(setup_event(driver="game_scoring", model_input_dir=args.model_input_dir))
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
    read_kwargs = dict(entity_id_columns={rt: rt for rt in re_types}, entity_indexes=entity_indexes,
                       intern_new_entities=False, column_names=parse_input_column_names(args.input_column_names),
                       device=device)
    pipeline_summary = None
    if args.stream_ingest_chunk_rows > 0:
        scores, labels, weights, uids, metrics, pipeline_summary = _score_stream(
            args, model, suite, shard_configs, index_maps, re_types, read_kwargs)
    else:
        with Timed("driver/read"):
            batch, _, _ = read_merged(resolve_input_paths(args), shard_configs, index_maps=index_maps, **read_kwargs)
        with Timed("driver/score"):
            transformer = GameTransformer(model, suite)
            scores = transformer.transform(batch).cpu().numpy()
        metrics = transformer.last_metrics if suite is not None else None
        labels, weights, uids = batch.label.cpu().numpy(), batch.weight.cpu().numpy(), batch.uid.cpu().numpy()

    with Timed("driver/write"):
        save_scores(os.path.join(args.output_dir, "scores.avro"), scores, args.model_id,
                    uids=[str(int(u)) for u in uids], labels=labels, weights=weights)
        out = {"numScored": int(scores.shape[0])}
        if pipeline_summary is not None:
            out["ingestPipeline"] = pipeline_summary
        if metrics is not None:
            out["metrics"] = metrics
            with open(os.path.join(args.output_dir, "scoring-metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2)
    emitter.emit(training_finish_event(num_scored=out["numScored"]))
    finalize_run_report("game_scoring", path=args.telemetry_out, emitter=emitter)
    return out


def _score_stream(args, model, suite, shard_configs, index_maps, re_types, read_kwargs):
    """Score chunk by chunk through ``stream_device_batches``: each chunk is
    padded to a ``--stream-ingest-chunk-rows`` multiple (weight-0 rows), its
    scores and O(n) columns are kept for its valid rows, its features
    dropped. Returns (scores, labels, weights, uids, metrics, the
    pipeline's summary)."""
    chunk_rows = args.stream_ingest_chunk_rows
    transformer = GameTransformer(model, None)
    overlap = not args.serial_ingest
    stats = PipelineStats(overlapped=overlap)
    compute = stats.stage("compute")
    names = ["scores", "label", "weight", "uid"] + [f"ids:{rt}" for rt in re_types]
    acc: Dict[str, list] = {k: [] for k in names}
    gen = stream_device_batches(resolve_input_paths(args), shard_configs, index_maps, chunk_rows=chunk_rows,
                                pad_rows_to=chunk_rows, depth=args.ingest_queue_depth or DEFAULT_QUEUE_DEPTH,
                                overlap=overlap, telemetry_label="scoring-ingest", stats=stats, **read_kwargs)
    with Timed("driver/read-and-score"):
        while True:
            # Only the stream can be "unavailable": scoring errors surface
            # as themselves.
            try:
                chunk = next(gen)
            except StopIteration:
                break
            except (RuntimeError, ValueError) as exc:
                raise SystemExit(f"streaming ingest unavailable: {exc}; drop --stream-ingest-chunk-rows to use "
                                 "the slurping reader") from exc
            n, b = chunk.n, chunk.batch
            t0 = time.perf_counter()
            s = transformer.transform(b)
            host = HOST_READS.fetch(s[:n], b.label[:n], b.weight[:n], b.uid[:n],
                                    *[b.entity_ids[rt][:n] for rt in re_types])  # waits for the card
            compute.add_busy(time.perf_counter() - t0)
            for k, h in zip(names, host):
                acc[k].append(h)
    if not acc["scores"]:
        raise SystemExit("streaming ingest read zero data blocks")
    cols = {k: np.concatenate(v) for k, v in acc.items()}
    metrics = None
    if suite is not None:
        dev = read_kwargs["device"]
        eval_batch = GameBatch(label=torch.as_tensor(cols["label"], device=dev),
                               offset=torch.zeros(len(cols["label"]), dtype=torch.float32, device=dev),
                               weight=torch.as_tensor(cols["weight"], device=dev), features={},
                               entity_ids={rt: torch.as_tensor(cols[f"ids:{rt}"], device=dev) for rt in re_types})
        metrics = suite.evaluate_scores(torch.as_tensor(cols["scores"], device=dev), eval_batch)
    return cols["scores"], cols["label"], cols["weight"], cols["uid"], metrics, stats.summary()


def main(argv=None) -> Dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
