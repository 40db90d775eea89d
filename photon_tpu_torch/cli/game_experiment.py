"""Port of photon_tpu/cli/game_experiment.py (candidates train on ``--device``).

Continuous online experiment driver: GP tuner over live shadow traffic;
cuda unless ``--device cpu`` is given.

    python -m photon_tpu_torch.cli.game_experiment --publish-root out/ ... [--device cuda|cpu]

Runs one experiment (photon_tpu_torch/experiment/) against a publish root
that a ``game_training`` / ``game_incremental`` chain produced:

1. serves the ``LATEST`` generation over HTTP (same front end as
   ``game_serving``) with the feedback spool attached — live traffic plus
   label joins are the experiment's measurement substrate;
2. each GP round proposes ``--candidates-per-round`` regularization
   points, trains each as a warm-started candidate generation on the
   delta data (``--input-paths``) in ONE spawned trainer process kept for
   the run (a fit never allocates in the serving process), and loads them
   ALL as concurrent shadow lanes;
3. observations come from the online quality plane (per-candidate
   streaming AUC / loss over joined labels); candidates that burn against
   the primary are poisoned, the final winner promotes through the
   generation-manifest gate.

Crash-resume: re-running with the same ``--experiment-id`` and
``--seed`` re-proposes every round deterministically and skips whatever
the generation manifests already record — completed candidates are never
re-trained. ``--train-only`` does the training half in this process with
no serving engine at all (the state-rebuild path a supervisor uses after a
crash).

Usage:

  python -m photon_tpu_torch.cli.game_experiment \\
    --publish-root out/ --input-paths delta/ --validation-paths holdout/ \\
    --coordinate-configurations name=global,feature.shard=globalShard \\
      name=perUser,feature.shard=globalShard,random.effect.type=userId \\
    --update-sequence global,perUser --evaluators AUC \\
    --experiment-id exp1 --rounds 3 --candidates-per-round 4 \\
    --feedback-spool /tmp/spool --port 8088

The last line of standard output is the run's summary: the manager's,
plus ``timing`` (each round's walls, the candidates' train walls and, on
the card, the device bytes after the round's losers were dropped) and, in
the online mode, ``engine`` (its primary and resident versions and
``retraces_since_warmup`` at the end of the run).
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import signal
import threading
from typing import Dict

from photon_tpu_torch.cli.common import (
    add_device_arg,
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
    p = argparse.ArgumentParser("game-experiment")
    p.add_argument("--publish-root", required=True,
                   help="a game_training output dir: generations + LATEST "
                        "pointer + index/entity artifacts; candidate "
                        "generations are written as subdirs here")
    p.add_argument("--input-paths", nargs="+", required=True,
                   help="delta data each candidate trains on (warm-started "
                        "from LATEST)")
    p.add_argument("--validation-paths", nargs="*", default=None,
                   help="holdout data for the winner's gate metrics")
    p.add_argument("--feature-shard-configurations", nargs="+",
                   default=["name=global"])
    p.add_argument("--coordinate-configurations", nargs="+", required=True)
    p.add_argument("--update-sequence", required=True,
                   help="comma-separated coordinate ids")
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.name for t in TaskType])
    p.add_argument("--evaluators", nargs="*", default=["AUC"])
    p.add_argument("--input-column-names", default=None)
    p.add_argument("--locked-coordinates", default="")
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    # -- experiment plane ---------------------------------------------------
    p.add_argument("--experiment-id", required=True,
                   help="stable id; resuming with the same id + seed "
                        "skips already-recorded candidates")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--candidates-per-round", type=int, default=4)
    p.add_argument("--seed", type=int, default=7,
                   help="GP/Sobol seed — resume REQUIRES the original seed "
                        "(proposals must replay identically)")
    p.add_argument("--objective", default="loss", choices=["loss", "auc"],
                   help="online observation the GP minimizes: windowed "
                        "mean loss, or 1 - windowed AUC")
    p.add_argument("--shadow-fraction", type=float, default=0.5,
                   help="per-candidate fraction of primary traffic "
                        "mirrored for divergence accounting")
    p.add_argument("--min-events", type=int, default=None,
                   help="labeled events per candidate before its quality "
                        "reading counts (default: quality plane's bar)")
    p.add_argument("--observe-timeout", type=float, default=120.0)
    p.add_argument("--observe-poll", type=float, default=0.25)
    p.add_argument("--auc-drop-bound", type=float, default=None,
                   help="quality-burn poison bar (default: the quality "
                        "plane's auc_drop_bound)")
    p.add_argument("--loss-burn-ratio", type=float, default=0.5)
    p.add_argument("--burn-checks", type=int, default=2)
    p.add_argument("--no-promote", action="store_true",
                   help="never gate/promote the winner (measure only)")
    p.add_argument("--train-only", action="store_true",
                   help="train missing candidates for rounds whose "
                        "observations are already durable; no engine, no "
                        "serving — the crash-resume worker mode")
    p.add_argument("--metric-tolerance", type=float, default=0.02)
    p.add_argument("--norm-drift-bound", type=float, default=10.0)
    # -- embedded serving (online mode) -------------------------------------
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8088)
    p.add_argument("--max-batch-size", type=int, default=64)
    p.add_argument("--max-delay-ms", type=float, default=2.0)
    p.add_argument("--hot-bytes-mb", type=float, default=64.0)
    p.add_argument("--max-model-versions", type=int, default=0,
                   help="resident-generation cap; 0 = candidates-per-round "
                        "+ 3 (primary, rollback parent, slack)")
    p.add_argument("--shadow-quality-fraction", type=float, default=1.0,
                   help="fraction of joined labels re-scored on each "
                        "candidate's quality lane")
    p.add_argument("--feedback-spool", default=None,
                   help="spool dir for the label join (REQUIRED unless "
                        "--train-only: observations come from it)")
    p.add_argument("--feedback-sample-fraction", type=float, default=1.0)
    p.add_argument("--feedback-segment-records", type=int, default=512)
    p.add_argument("--feedback-segment-age", type=float, default=5.0)
    p.add_argument("--feedback-join-ttl", type=float, default=600.0)
    p.add_argument("--telemetry-out", default=None)
    add_device_arg(p)
    p.add_argument("--verbose", action="store_true")
    return p


def _coordinates(args):
    """The coordinate configs in update-sequence order, and the sequence."""
    coord_configs = [parse_coordinate_config(s) for s in args.coordinate_configurations]
    update_sequence = [s.strip() for s in args.update_sequence.split(",") if s.strip()]
    by_id = {c.coordinate_id: c for c in coord_configs}
    return [by_id[cid] for cid in update_sequence], update_sequence


def _read_data(args, device):
    """Delta + holdout batches on ``device`` against the publish root's
    pinned feature space (same artifact discipline as game_incremental:
    index maps pin slots, entity indexes grow append-only), read through
    the columnar decoder."""
    from photon_tpu_torch.data.index_map import EntityIndex, IndexMap
    from photon_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorSpec
    from photon_tpu_torch.io.data_reader import read_merged

    shard_configs: Dict = {}
    for spec in args.feature_shard_configurations:
        shard_configs.update(parse_feature_shard_config(spec))
    coord_configs, update_sequence = _coordinates(args)
    entity_id_columns = {c.re_type: c.re_type for c in coord_configs if hasattr(c, "re_type")}
    column_names = parse_input_column_names(args.input_column_names)

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
    return (batch, valid_batch, suite, index_maps, entity_indexes,
            coord_configs, update_sequence)


def build_trainer(args):
    """The in-process candidate trainer: the delta (and holdout) read onto
    ``--device``. The spawned trainer process of an online run calls this
    too, so the serving process never holds the delta."""
    from photon_tpu_torch.experiment import IncrementalCandidateTrainer

    setup_logging(args.verbose)
    device = resolve_device(args.device)
    (batch, valid_batch, suite, index_maps, entity_indexes,
     coord_configs, update_sequence) = _read_data(args, device)
    return IncrementalCandidateTrainer(
        args.publish_root, batch, index_maps, entity_indexes,
        task_of(args), coord_configs, update_sequence,
        valid_batch=valid_batch, evaluation_suite=suite,
        num_iterations=args.coordinate_descent_iterations,
        locked_coordinates=[s for s in args.locked_coordinates.split(",") if s],
        device=device,
    )


def _build_manager(args, trainer, engine=None):
    from photon_tpu_torch.estimators.config import GameOptimizationConfig, RegularizationConfig
    from photon_tpu_torch.experiment import ExperimentConfig, ExperimentManager, ExperimentSpace

    coord_configs, _ = _coordinates(args)
    # Coordinates with a positive configured weight become tunable slots
    # (ExperimentSpace's rule); a 0-weight coordinate stays untuned.
    base = GameOptimizationConfig({
        c.coordinate_id: RegularizationConfig(weight=max(c.reg_weights), alpha=c.reg_alpha)
        for c in coord_configs
    })
    cfg = ExperimentConfig(
        experiment_id=args.experiment_id,
        publish_root=args.publish_root,
        rounds=args.rounds,
        candidates_per_round=args.candidates_per_round,
        seed=args.seed,
        shadow_fraction=args.shadow_fraction,
        min_events=args.min_events,
        observe_timeout_s=args.observe_timeout,
        observe_poll_s=args.observe_poll,
        objective=args.objective,
        auc_drop_bound=args.auc_drop_bound,
        loss_burn_ratio=args.loss_burn_ratio,
        burn_checks=args.burn_checks,
        promote_winner=not args.no_promote,
        metric_tolerance=args.metric_tolerance,
        norm_drift_bound=args.norm_drift_bound,
    )
    return ExperimentManager(cfg, ExperimentSpace(base), trainer, engine=engine)


def _with_timing(manager) -> dict:
    summary = manager.summary()
    summary["timing"] = {"rounds": manager.round_log}
    return summary


def run(args) -> dict:
    setup_logging(args.verbose)
    from photon_tpu_torch.obs import begin_run, finalize_run_report

    begin_run()
    device = resolve_device(args.device)
    if args.train_only:
        manager = _build_manager(args, build_trainer(args))
        manager.run(train_only=True)
        finalize_run_report("game_experiment", path=args.telemetry_out)
        return _with_timing(manager)

    if not args.feedback_spool:
        raise SystemExit(
            "--feedback-spool is required for online experiments: the "
            "label join is where observations come from (use --train-only "
            "for the engine-less resume mode)"
        )

    from photon_tpu_torch.cli.game_serving import make_handler, resolve_model_dir
    from photon_tpu_torch.experiment import SpawnedCandidateTrainer
    from photon_tpu_torch.serve import ServeConfig, load_engine
    from photon_tpu_torch.serve.frontend import ServingHTTPServer
    from photon_tpu_torch.stream.spool import FeedbackSpool, SpoolConfig

    model_dir = resolve_model_dir(args.publish_root)
    if model_dir == args.publish_root:
        raise SystemExit(
            f"no LATEST generation under {args.publish_root!r}: the "
            "experiment warm-starts candidates from a published parent"
        )
    # The trainer process reads the delta while this one loads and warms
    # the engine.
    trainer = SpawnedCandidateTrainer(args.publish_root, functools.partial(build_trainer, args))
    trainer.start()
    engine = server = None
    handlers = {}
    try:
        max_versions = args.max_model_versions or (args.candidates_per_round + 3)
        config = ServeConfig(
            max_batch_size=args.max_batch_size,
            max_delay_ms=args.max_delay_ms,
            hot_bytes=int(args.hot_bytes_mb * (1 << 20)),
            max_versions=max_versions,
            shadow_fraction=args.shadow_fraction,
            shadow_quality_fraction=args.shadow_quality_fraction,
            device=str(device),
        )
        engine = load_engine(model_dir, artifacts_dir=args.publish_root, config=config)
        spool = FeedbackSpool(args.feedback_spool, SpoolConfig(
            segment_max_records=args.feedback_segment_records,
            segment_max_age_s=args.feedback_segment_age,
            sample_fraction=args.feedback_sample_fraction,
            join_ttl_s=args.feedback_join_ttl,
        ))
        spool.start_auto_flush()
        engine.attach_feedback(spool)

        server = ServingHTTPServer((args.host, args.port), make_handler(engine))
        server_thread = threading.Thread(
            target=server.serve_forever, kwargs=dict(poll_interval=0.2),
            name="experiment-frontend", daemon=True,
        )
        server_thread.start()
        stop = threading.Event()

        def _shutdown(signum, frame):
            stop.set()

        if threading.current_thread() is threading.main_thread():
            handlers = {sig: signal.signal(sig, _shutdown) for sig in (signal.SIGTERM, signal.SIGINT)}
        print(json.dumps({
            "experiment": args.experiment_id,
            "serving": True,
            "host": server.server_address[0],
            "port": server.server_address[1],
            "modelVersion": engine.model_version,
        }), flush=True)
        manager = _build_manager(args, trainer, engine=engine)
        manager.run()
        summary = _with_timing(manager)
        summary["engine"] = {"primary": engine.model_version, "versions": engine.versions,
                             "retracesSinceWarmup": engine.retraces_since_warmup}
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if engine is not None:
            engine.close(drain=True)
        trainer.close()
        for sig, previous in handlers.items():
            signal.signal(sig, previous)
        finalize_run_report("game_experiment", path=args.telemetry_out)
    return summary


def main(argv=None):
    summary = run(build_parser().parse_args(argv))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
