"""GAME training driver (port of photon_tpu/cli/game_training.py).

    python -m photon_tpu_torch.cli.game_training \\
      --input-paths train/ --validation-paths valid/ --output-dir out/ \\
      --feature-shard-configurations name=globalShard \\
      --coordinate-configurations \\
        name=global,feature.shard=globalShard,optimizer=LBFGS,reg.weights=0.1|1|10 \\
        name=perUser,feature.shard=globalShard,random.effect.type=userId,reg.weights=1 \\
      --update-sequence global,perUser --evaluators AUC [--device cpu]

The reference's steps, in its order: the output directory; the index maps
of ``--feature-index-dir``; read the training data (a random effect's id
column is its type); validate; read the validation data, looking entities
up without interning new ones; feature statistics, normalization and
``--summarization-output-dir``; the fixed effects' boxes of
``--coordinate-constraints``; the warm-start model, loaded after both
reads so that its entities extend the run's entity indexes; the
evaluation suite; ``GameEstimator.fit`` over the cross product of the
regularization weights; hyperparameter tuning (``--hyper-parameter-tuning
RANDOM|BAYESIAN``: a Sobol or Gaussian-process search over the log10
regularization weights, seeded with the explicit grid as prior
observations, ``--hyper-parameter-batch-size`` candidates a round as the
batched lanes of estimators/batched_tuning.py where the setup allows,
``hyperparameter-observations.json``); selection by ``--output-mode``
(EXPLICIT: the grid's models, TUNED: the tuned ones, else both); ``best/``
(and ``models/{configs,tuned_configs}-<i>/`` under ALL), the index maps and
entity indexes, then ``LATEST``; and ``training-summary.json``.

``--stream-ingest-chunk-rows`` (with ``--feature-index-dir``: a stream
cannot be distinct-scanned first) reads the training and validation data
through the ingest pipeline (io/pipeline.py), the chunks concatenated on
the device; a stream that cannot decode natively exits non-zero and never
falls back to a whole-file read. With ``--checkpoint-dir`` every
configuration's coordinate descent checkpoints under ``cfg_<i>/`` at pass
boundaries and resumes from there (``--resume`` insists that state exists
and keeps the output directory); a SIGTERM/SIGINT stops at the next pass
boundary with a final checkpoint and exit code 128 + signum. Events go to
the ``--event-listener(s)``. ``--re-device-budget-mb`` trains the random
effects out of core (algorithm/re_store.py): a host master, memory-mapped
under ``--re-spill-dir`` (``host-<k>/`` with ``--re-spill-member``), and a
budgeted working set on the card.

The data and the solves live on ``--device`` (default cuda; without a card
the driver exits non-zero rather than run on the CPU). ``--telemetry-out``
writes the run report, also of an interrupted run; ``--otlp-endpoint``
exports the CD pass spans and the metrics registry to a collector.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import Dict

import numpy as np
import torch

from photon_tpu_torch.cli.common import (
    GracefulShutdown,
    add_active_set_args,
    add_common_args,
    add_device_arg,
    add_out_of_core_args,
    add_validation_arg,
    close_otlp,
    handle_termination,
    install_otlp,
    parse_coordinate_config,
    parse_feature_shard_config,
    parse_input_column_names,
    resolve_device,
    resolve_input_paths,
    setup_logging,
    task_of,
)
from photon_tpu_torch.data.constraints import constraint_bound_vectors
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.data.normalization import build_normalization_context
from photon_tpu_torch.data.stats import compute_feature_stats
from photon_tpu_torch.data.validators import DataValidationType, validate_game_batch
from photon_tpu_torch.estimators.config import FixedEffectCoordinateConfig
from photon_tpu_torch.estimators.evaluation_function import GameEstimatorEvaluationFunction
from photon_tpu_torch.estimators.game_estimator import GameEstimator
from photon_tpu_torch.evaluation.metrics_map import sanitize_for_json
from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
from photon_tpu_torch.hyperparameter.serialization import observations_to_json
from photon_tpu_torch.hyperparameter.tuner import TunerName, TuningMode, get_tuner
from photon_tpu_torch.io.data_reader import concat_game_batches, read_merged
from photon_tpu_torch.io.pipeline import stream_device_batches
from photon_tpu_torch.io.model_io import (
    load_game_model,
    publish_latest_pointer,
    save_game_model,
    write_basic_statistics,
)
from photon_tpu_torch.types import NormalizationType
from photon_tpu_torch.utils import resources
from photon_tpu_torch.utils.checkpoint import latest_step
from photon_tpu_torch.obs import begin_run, finalize_run_report
from photon_tpu_torch.utils.events import EventEmitter, setup_event, training_finish_event, training_start_event
from photon_tpu_torch.utils.io_utils import process_output_dir
from photon_tpu_torch.utils.timed import Timed

logger = logging.getLogger("photon_tpu_torch.driver")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("game-training")
    add_common_args(p)
    add_validation_arg(p)
    add_active_set_args(p)
    add_out_of_core_args(p)
    p.add_argument("--validation-paths", nargs="*", default=None)
    p.add_argument("--coordinate-configurations", nargs="+", required=True)
    p.add_argument("--update-sequence", required=True, help="comma-separated coordinate ids")
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    p.add_argument("--evaluators", nargs="*", default=["AUC"])
    p.add_argument("--normalization", default="NONE", choices=[t.name for t in NormalizationType])
    p.add_argument("--model-input-dir", default=None, help="warm-start model dir")
    p.add_argument("--locked-coordinates", default="",
                   help="comma-separated coordinate ids to keep fixed (partial retrain)")
    p.add_argument("--coordinate-constraints", default=None,
                   help='JSON object: fixed-effect coordinate id → constraint array, e.g. '
                        '\'{"global": [{"name": "f1", "term": "", "lowerBound": 0}]}\'')
    p.add_argument("--output-mode", default="BEST", choices=["BEST", "ALL", "NONE", "EXPLICIT", "TUNED"],
                   help="reference ModelOutputMode: BEST = best model overall, ALL = every trained "
                        "model, EXPLICIT = best of the explicit λ grid, TUNED = best hyperparameter-tuned "
                        "model, NONE = no model output")
    p.add_argument("--hyper-parameter-tuning", default="NONE", choices=["NONE", "RANDOM", "BAYESIAN"],
                   help="tune regularization hyperparameters after the explicit grid (RANDOM = Sobol search, "
                        "BAYESIAN = GP + expected improvement)")
    p.add_argument("--hyper-parameter-tuning-iter", type=int, default=10)
    p.add_argument("--hyper-parameter-batch-size", type=int, default=1,
                   help="candidates evaluated together per tuning round (>1 trains them as lanes of one "
                        "program where the setup allows it)")
    p.add_argument("--hyper-parameter-tuner", default="ATLAS", choices=["DUMMY", "ATLAS"],
                   help="tuner implementation (reference HyperparameterTunerFactory)")
    p.add_argument("--variance-computation", nargs="?", const="SIMPLE", default="NONE",
                   choices=["NONE", "SIMPLE", "FULL"],
                   help="coefficient variances: SIMPLE = inverse diagonal Hessian, FULL = diagonal of "
                        "the Cholesky-inverted Hessian; bare flag = SIMPLE")
    p.add_argument("--model-sparsity-threshold", type=float, default=1e-4,
                   help="coefficients whose magnitude is not above it are not written")
    p.add_argument("--ignore-threshold-for-new-models", action="store_true",
                   help="during warm start, entities without an existing model bypass the "
                        "random-effect active-data lower bound (requires --model-input-dir)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="coordinate-descent checkpoint directory (one cfg_<i>/ per configuration); a run resumes "
                        "from it automatically when state exists")
    p.add_argument("--checkpoint-every", type=int, default=1, help="checkpoint every N coordinate-descent passes")
    p.add_argument("--checkpoint-keep-last", type=int, default=None,
                   help="keep only the newest K step files per configuration; default: all, or "
                        "PHOTON_TPU_CHECKPOINT_KEEP_LAST")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from --checkpoint-dir: requires checkpoint state and keeps "
                        "the existing --output-dir")
    p.add_argument("--event-listeners", nargs="*", default=[], help="dotted paths of event listener callables")
    p.add_argument("--event-listener", action="append", default=[], dest="event_listener",
                   help="register one event listener by path ('pkg.module:attr'); repeatable")
    p.add_argument("--telemetry-out", default=None,
                   help="write the unified run report (spans + metrics + coordinate-descent diagnostics) as "
                        "schema-stable JSONL to this path")
    p.add_argument("--otlp-endpoint", default=None,
                   help="base URL of an OTLP/HTTP collector accepting JSON; CD pass spans and the metrics "
                        "registry export there (bounded queue, drop-and-count on outage: export never blocks "
                        "training)")
    p.add_argument("--otlp-metrics-interval", type=float, default=15.0,
                   help="seconds between registry-snapshot exports (0 = spans only)")
    p.add_argument("--summarization-output-dir", default=None,
                   help="write per-feature summary statistics as FeatureSummarizationResultAvro, "
                        "one file per shard")
    p.add_argument("--feature-index-dir", default=None,
                   help="directory of index-map-<shard>.json files written by the feature-indexing "
                        "driver; skips the distinct scan")
    p.add_argument("--stream-ingest-chunk-rows", type=int, default=0,
                   help="read training/validation data through the chunked streaming pipeline (host memory "
                        "bounded by a few chunks; chunks concatenate on the device); needs --feature-index-dir")
    add_device_arg(p)
    return p


def _constrained(coord_configs, cmap: Dict, index_maps, batch, intercept_indices) -> list:
    """The coordinate configurations with each constrained fixed effect's
    box: its constraint array resolved against its shard's index map."""
    unknown = set(cmap) - {c.coordinate_id for c in coord_configs}
    if unknown:
        raise ValueError(f"constraints for unknown coordinates: {sorted(unknown)}")
    out = []
    for c in coord_configs:
        entries = cmap.get(c.coordinate_id)
        if entries is not None:
            if not isinstance(c, FixedEffectCoordinateConfig):
                raise ValueError(f"coordinate constraints apply to fixed-effect coordinates only; "
                                 f"'{c.coordinate_id}' is a random-effect coordinate")
            bounds = constraint_bound_vectors(json.dumps(entries), index_maps[c.feature_shard],
                                              batch.features[c.feature_shard].shape[1],
                                              intercept_indices.get(c.feature_shard))
            if bounds is not None:
                c = dataclasses.replace(c, box=tuple(
                    torch.as_tensor(b, dtype=batch.label.dtype, device=batch.label.device) for b in bounds))
        out.append(c)
    return out


def run(args) -> Dict:
    setup_logging(args.verbose)
    begin_run()  # fresh spans, metrics and phase records for this run
    otlp = install_otlp(args, "photon-tpu-training")
    device = resolve_device(args.device)
    # Host RSS watchdog: inert without a detectable limit; at hard pressure
    # the pass boundary fails cleanly instead of meeting the OOM-killer.
    resources.start_watchdog()
    task = task_of(args)
    emitter = EventEmitter()
    for name in list(args.event_listeners) + list(args.event_listener):
        emitter.register_by_name(name)
    emitter.emit(setup_event(driver="game_training", task=args.task, update_sequence=args.update_sequence))

    shard_configs: Dict = {}
    for spec in args.feature_shard_configurations:
        shard_configs.update(parse_feature_shard_config(spec))
    coord_configs = [parse_coordinate_config(s) for s in args.coordinate_configurations]
    update_sequence = [s.strip() for s in args.update_sequence.split(",") if s.strip()]
    by_id = {c.coordinate_id: c for c in coord_configs}
    coord_configs = [by_id[cid] for cid in update_sequence]  # order = sequence
    entity_id_columns = {c.re_type: c.re_type for c in coord_configs if hasattr(c, "re_type")}
    column_names = parse_input_column_names(args.input_column_names)
    if args.resume:
        # Checkpoint state must exist (a mistyped dir must not silently
        # start over), and the interrupted run's output dir is kept.
        if not args.checkpoint_dir:
            raise SystemExit("--resume requires --checkpoint-dir")
        # Each configuration checkpoints under cfg_<i>/; state in any of
        # them (or in the dir itself) counts.
        ckpt = args.checkpoint_dir
        cfg_dirs = [ckpt] + sorted(os.path.join(ckpt, d) for d in (os.listdir(ckpt) if os.path.isdir(ckpt) else [])
                                   if d.startswith("cfg_"))
        if all(latest_step(d) is None for d in cfg_dirs if os.path.isdir(d)):
            raise SystemExit(f"--resume: no checkpoint state under {ckpt}")
        os.makedirs(args.output_dir, exist_ok=True)
    else:
        process_output_dir(args.output_dir, args.override_output_dir)

    preloaded_maps = None
    if args.feature_index_dir:
        preloaded_maps = {}
        for shard in shard_configs:
            path = os.path.join(args.feature_index_dir, f"index-map-{shard}.json")
            try:
                preloaded_maps[shard] = IndexMap.load(path)
            except OSError as exc:
                raise SystemExit(
                    f"--feature-index-dir: cannot read {path} ({exc}); expected index-map-<shard>.json "
                    f"files as written by the feature-indexing driver, one per configured feature shard "
                    f"({sorted(shard_configs)})"
                ) from exc

    chunk_rows = args.stream_ingest_chunk_rows
    if chunk_rows > 0 and preloaded_maps is None:
        raise SystemExit("--stream-ingest-chunk-rows requires --feature-index-dir (run the feature-indexing "
                         "driver first)")

    def read(paths, index_maps, entity_indexes, intern_new):
        if chunk_rows > 0:
            # The ingest pipeline: decode → assemble → h2d on worker threads
            # with bounded queues; the unpadded chunks concatenate on the
            # device (the threads are joined before the fit captures).
            eidx = entity_indexes if entity_indexes is not None else {}
            try:
                chunks = list(stream_device_batches(
                    paths, shard_configs, index_maps, entity_id_columns=entity_id_columns, entity_indexes=eidx,
                    intern_new_entities=intern_new, chunk_rows=chunk_rows, column_names=column_names,
                    telemetry_label="game-train-ingest", device=device))
            except (RuntimeError, ValueError) as exc:
                # A stream never falls back to a whole-file read.
                raise SystemExit(f"streaming ingest unavailable for {paths}: {exc}; drop "
                                 "--stream-ingest-chunk-rows to use the row-codec fallback reader") from exc
            if not chunks:
                raise SystemExit(f"streaming ingest read zero data blocks from {paths}")
            return concat_game_batches([c.batch for c in chunks]), index_maps, eidx
        return read_merged(paths, shard_configs, index_maps=index_maps, entity_id_columns=entity_id_columns,
                           entity_indexes=entity_indexes, intern_new_entities=intern_new,
                           column_names=column_names, device=device)

    with Timed("driver/read-train"):
        batch, index_maps, entity_indexes = read(resolve_input_paths(args), preloaded_maps, None, True)
    validation_mode = DataValidationType[args.data_validation]
    validate_game_batch(batch, task, validation_mode)
    valid_batch = None
    if args.validation_paths:
        with Timed("driver/read-validation"):
            valid_batch, _, _ = read(args.validation_paths, index_maps, entity_indexes, False)
        validate_game_batch(valid_batch, task, validation_mode)

    intercept_indices = {
        shard: index_maps[shard].get_index(IndexMap.INTERCEPT)
        for shard in shard_configs
        if index_maps[shard].get_index(IndexMap.INTERCEPT) >= 0
    }
    normalization = {}
    norm_type = NormalizationType[args.normalization]
    if norm_type != NormalizationType.NONE or args.summarization_output_dir:
        for shard in shard_configs:
            stats = compute_feature_stats(batch.labeled_batch(shard), intercept_indices.get(shard))
            if norm_type != NormalizationType.NONE:
                normalization[shard] = build_normalization_context(
                    norm_type, stats.mean, stats.std, stats.abs_max, intercept_indices.get(shard))
            if args.summarization_output_dir:
                write_basic_statistics(stats, index_maps[shard],
                                       os.path.join(args.summarization_output_dir, shard, "part-00000.avro"))

    if args.coordinate_constraints:
        coord_configs = _constrained(coord_configs, json.loads(args.coordinate_constraints), index_maps,
                                     batch, intercept_indices)

    warm = None
    if args.model_input_dir:
        warm = load_game_model(args.model_input_dir, index_maps, entity_indexes, device=device)

    num_entities = {k: len(v) for k, v in entity_indexes.items()}
    suite = EvaluationSuite([EvaluatorSpec.parse(e) for e in args.evaluators],
                            num_entities) if args.evaluators else None

    estimator = GameEstimator(
        task=task,
        coordinate_configs=coord_configs,
        num_iterations=args.coordinate_descent_iterations,
        intercept_indices=intercept_indices,
        normalization=normalization,
        num_entities=num_entities,
        locked_coordinates=[s for s in args.locked_coordinates.split(",") if s],
        variance_computation=args.variance_computation,
        ignore_threshold_for_new_models=args.ignore_threshold_for_new_models,
        warm_start_model=warm,
        re_active_set=args.re_active_set,
        re_convergence_tol=args.re_convergence_tol,
        re_device_budget_mb=args.re_device_budget_mb,
        re_spill_dir=args.re_spill_dir,
        re_spill_member=args.re_spill_member,
    )
    emitter.emit(training_start_event(task=task.value, coordinates=list(update_sequence)))
    try:
        with handle_termination():
            results = estimator.fit(batch, validation_batch=valid_batch,
                                    evaluation_suite=suite if valid_batch is not None else None,
                                    initial_model=warm, checkpoint_dir=args.checkpoint_dir,
                                    checkpoint_every=args.checkpoint_every,
                                    checkpoint_keep_last=args.checkpoint_keep_last, emitter=emitter)
    except GracefulShutdown as exc:
        # The coordinate descent wrote a final pass-boundary checkpoint; the
        # interrupted run still reports.
        finalize_run_report("game_training", path=args.telemetry_out, emitter=emitter)
        close_otlp(otlp)
        raise SystemExit(128 + exc.signum) from exc

    tuned_results = []
    if args.hyper_parameter_tuning != "NONE":
        tuned_results = _run_hyperparameter_tuning(args, estimator, results, batch, valid_batch, suite)

    def select(candidates):
        if not candidates:
            return None
        if suite is not None and valid_batch is not None:
            return estimator.select_best(candidates, suite)
        return candidates[-1]

    if args.output_mode == "EXPLICIT":
        best = select(results)
    elif args.output_mode == "TUNED":
        best = select(tuned_results)
        if best is None:
            raise ValueError("--output-mode TUNED requires --hyper-parameter-tuning with at least one successful "
                             "tuning iteration")
    else:
        best = select(results + tuned_results)
    summary = {"configs": [], "tuned_configs": [], "best": None}
    for key, pool in (("configs", results), ("tuned_configs", tuned_results)):
        for i, r in enumerate(pool):
            summary[key].append({"config": r.config.describe(), "metrics": r.metrics})
            if args.output_mode == "ALL":
                save_game_model(r.model, os.path.join(args.output_dir, "models", f"{key}-{i}"), index_maps,
                                entity_indexes, sparsity_threshold=args.model_sparsity_threshold)
    if args.output_mode != "NONE":
        save_game_model(best.model, os.path.join(args.output_dir, "best"), index_maps, entity_indexes,
                        sparsity_threshold=args.model_sparsity_threshold,
                        extra_metadata={"config": best.config.describe()})
        for shard, imap in index_maps.items():
            imap.save(os.path.join(args.output_dir, f"index-map-{shard}.json"))
        for re_type, eidx in entity_indexes.items():
            eidx.save(os.path.join(args.output_dir, f"entity-index-{re_type}.json"))
        # Everything is on disk: only now flip LATEST, so a reader that
        # follows it never finds a half-written model.
        publish_latest_pointer(args.output_dir, "best")
    summary["best"] = {"config": best.config.describe(), "metrics": best.metrics}
    with open(os.path.join(args.output_dir, "training-summary.json"), "w") as f:
        json.dump(sanitize_for_json(summary), f, indent=2)
    emitter.emit(training_finish_event(best=None if best is None else best.config.describe()))
    finalize_run_report("game_training", path=args.telemetry_out, emitter=emitter, trackers=[
        {"label": f"{key}[{i}]", "tracker": r.tracker, "wall_times": r.wall_times}
        for key, pool in (("config", results), ("tuned", tuned_results)) for i, r in enumerate(pool)])
    close_otlp(otlp)
    return summary


def _run_hyperparameter_tuning(args, estimator, results, batch, valid_batch, suite) -> list:
    """Bayesian or random search over the regularization hyperparameters,
    seeded with the explicit grid as prior observations; the observations go
    to ``hyperparameter-observations.json``. Returns the tuned fits."""
    if valid_batch is None or suite is None:
        raise ValueError("--hyper-parameter-tuning requires --validation-paths and --evaluators (the tuner "
                         "optimizes the primary validation metric)")
    fn = GameEstimatorEvaluationFunction(estimator, results[0].config, batch, valid_batch, suite,
                                         suite.primary.better()(1.0, 0.0))
    if fn.dim == 0:
        logger.warning("hyperparameter tuning requested but no coordinate is regularized in the base "
                       "configuration; skipping")
        return []
    tuner = get_tuner(TunerName[args.hyper_parameter_tuner])
    with Timed(f"driver/hyperparameter-tuning[{args.hyper_parameter_tuning}]"):
        best_x, _best_v, observations = tuner.search(
            args.hyper_parameter_tuning_iter, fn.dim, TuningMode[args.hyper_parameter_tuning], fn,
            search_range=fn.search_range, prior_observations=fn.convert_observations(results),
            batch_size=args.hyper_parameter_batch_size)
    if best_x is not None and not fn.results:
        # The batched lanes evaluate metrics without keeping models: one
        # sequential fit of the winner gives TUNED a model to save.
        fn(np.asarray(best_x))
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "hyperparameter-observations.json"), "w") as f:
        f.write(observations_to_json(observations, fn.names))
    logger.info("hyperparameter tuning: %d candidates evaluated, observations saved", len(fn.results))
    return fn.results


def main(argv=None) -> Dict:
    summary = run(build_parser().parse_args(argv))
    print(json.dumps(summary["best"]))
    return summary


if __name__ == "__main__":
    main()
