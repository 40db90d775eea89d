"""Legacy single-GLM training driver (port of photon_tpu/cli/train_glm.py).

    python -m photon_tpu_torch.cli.train_glm --training-data <path> \\
        --output-dir <dir> [--format libsvm] [--validation-data <path>] \\
        [--regularization-weights 10,1,0.1] [--optimizer TRON] [--device cpu]

The reference's INIT → PREPROCESSED → TRAINED → VALIDATED stages: read Avro
(a file of more than 4096 features as padded-sparse features) or LIBSVM,
restricted to ``--selected-features-file`` where given, validate, summarize
(``--summarization-output-dir``) and normalize where asked, bound the
coefficients (``--coefficient-box`` or ``--constraint-string``), run the λ
sweep strongest first with a warm start (``train_lambda_sweep``), compute
the variances, score the validation set with the task's MetricsMap, pick
the best λ, and write the text models, the Avro ``best/`` model,
``LATEST`` and ``training-summary.json`` in the reference's layouts.

``--stream-ingest-chunk-rows`` reads Avro through the ingest pipeline
(io/pipeline.py): one decode pass, teed into a ``ChunkReplayCache`` of
``--replay-cache-mb`` (the overflow spills to disk), distinct-scans the
features; a replay then assembles the chunks and copies them to the device,
where they concatenate. With ``--checkpoint-dir`` each finished λ is a
durable step (its results and the warm start), a killed sweep resumes at
the next λ (``--resume`` insists that state exists), and a SIGTERM/SIGINT
stops the sweep at the next λ boundary with exit code 128 + signum. Events
go to the ``--event-listener(s)``.

The data and the solves live on ``--device`` (default cuda; without a card
the driver exits non-zero rather than run on the CPU). ``--telemetry-out``
writes the run report (spans, metrics, one tracker row per λ solve); the
random-effect flags warn that they are no-ops, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.algorithm.solve_cache import SolveCache, default_cache
from photon_tpu_torch.cli.common import (
    GracefulShutdown,
    add_active_set_args,
    add_device_arg,
    add_out_of_core_args,
    add_validation_arg,
    handle_termination,
    resolve_device,
    setup_logging,
    shutdown_requested,
    task_of,
)
from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.constraints import constraint_bound_vectors
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.data.normalization import NormalizationContext, build_normalization_context
from photon_tpu_torch.data.stats import compute_feature_stats
from photon_tpu_torch.data.validators import DataValidationType, validate_labeled_batch
from photon_tpu_torch.evaluation.metrics_map import metrics_map, sanitize_for_json, selection_metric
from photon_tpu_torch.io.avro import AvroReader
from photon_tpu_torch.io.data_reader import FeatureShardConfig, read_merged
from photon_tpu_torch.io.libsvm import read_libsvm
from photon_tpu_torch.io.model_io import publish_latest_pointer, save_game_model, write_basic_statistics
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import FixedEffectModel, GameModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.obs import begin_run, finalize_run_report, registry, span
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.ops.variance import coefficient_variances, normalize_variance_type
from photon_tpu_torch.optim.common import HOST_READS, OptimizeResult
from photon_tpu_torch.optim.factory import OptimizerSpec, make_optimizer
from photon_tpu_torch.types import NormalizationType, OptimizerType, TaskType, VarianceComputationType
from photon_tpu_torch.utils import resources
from photon_tpu_torch.utils.checkpoint import LegacyCheckpointError, latest_step, load_checkpoint, save_checkpoint
from photon_tpu_torch.utils.events import (
    EventEmitter,
    optimization_log_event,
    setup_event,
    training_finish_event,
    training_start_event,
)

log = logging.getLogger("photon_tpu_torch.train_glm")

_REPLAY_CACHE_MB = 1024


class DriverStage(enum.Enum):
    """Reference DriverStage.scala:20-55 state machine."""

    INIT = 0
    PREPROCESSED = 1
    TRAINED = 2
    VALIDATED = 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train-glm")
    p.add_argument("--training-data", required=True,
                   help="Avro path/dir/glob, or LIBSVM text file with --format libsvm")
    p.add_argument("--validation-data", default=None)
    p.add_argument("--format", default="avro", choices=["avro", "libsvm"])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", default="LOGISTIC_REGRESSION", choices=[t.name for t in TaskType])
    p.add_argument("--optimizer", default="LBFGS", choices=[o.name for o in OptimizerType])
    p.add_argument("--regularization-weights", default="0.1,1,10,100")
    p.add_argument("--regularization-type", default=None, choices=["NONE", "L1", "L2", "ELASTIC_NET"],
                   help="NONE ignores the weights, L1/L2 force the elastic-net "
                        "alpha to 1/0, ELASTIC_NET uses --elastic-net-alpha")
    p.add_argument("--elastic-net-alpha", type=float, default=0.0)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--tolerance", type=float, default=None)
    p.add_argument("--optimization-state-tracker", action=argparse.BooleanOptionalAction, default=True,
                   help="per-iteration (loss, |grad|) tracker histories")
    p.add_argument("--validate-per-iteration", action="store_true",
                   help="the validation MetricsMap at every iteration count "
                        "(replays each solve at increasing max-iter: expensive)")
    p.add_argument("--feature-dimension", type=int, default=None,
                   help="feature-space dimension of libsvm input (inferred when omitted)")
    p.add_argument("--normalization", default="NONE", choices=[t.name for t in NormalizationType])
    p.add_argument("--intercept", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--coefficient-box", default=None,
                   help="lower,upper box constraint applied to all coefficients")
    p.add_argument("--selected-features-file", default=None,
                   help="Avro file of FeatureNameTermAvro records: train on these features only (avro format)")
    p.add_argument("--constraint-string", default=None,
                   help='JSON array of {"name", "term", "lowerBound", "upperBound"} per-feature bounds '
                        "(exclusive with --coefficient-box)")
    p.add_argument("--compute-variance", nargs="?", const="SIMPLE", default="NONE",
                   choices=["NONE", "SIMPLE", "FULL"],
                   help="coefficient variances (bare flag = SIMPLE diag-inverse; "
                        "FULL = Cholesky inverse diagonal)")
    p.add_argument("--event-listeners", nargs="*", default=[], help="dotted paths of event listener callables")
    p.add_argument("--event-listener", action="append", default=[], dest="event_listener",
                   help="register one event listener by path ('pkg.module:attr'); repeatable")
    p.add_argument("--telemetry-out", default=None,
                   help="write the unified run report (spans + metrics + per-lambda solver diagnostics) as "
                        "schema-stable JSONL to this path")
    p.add_argument("--summarization-output-dir", default=None,
                   help="write per-feature summary statistics of the training data as "
                        "FeatureSummarizationResultAvro (part-00000.avro)")
    p.add_argument("--stream-ingest-chunk-rows", type=int, default=0,
                   help="avro format: stream the data in chunks of this many rows (one decode pass teed into a "
                        "replay cache while the features are distinct-scanned, then a replay through the "
                        "assemble and host-to-device pipeline stages, concatenated on the device)")
    p.add_argument("--replay-cache-mb", type=int, default=_REPLAY_CACHE_MB,
                   help="host byte budget (MiB) of the decoded-chunk replay cache; the overflow spills to disk")
    add_validation_arg(p)
    add_active_set_args(p)
    add_out_of_core_args(p)
    p.add_argument("--checkpoint-dir", default=None,
                   help="λ-sweep checkpoint directory: one durable step per finished λ; a killed run resumes at "
                        "the next λ (automatically when state exists)")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted λ sweep from --checkpoint-dir (requires checkpoint state)")
    p.add_argument("--checkpoint-keep-last", type=int, default=None,
                   help="keep only the newest K λ-step files (a resumed sweep replays pruned λs); default: all, "
                        "or PHOTON_TPU_CHECKPOINT_KEEP_LAST")
    add_device_arg(p)
    p.add_argument("--verbose", action="store_true")
    return p


def _selected_features_index_map(args) -> Optional[IndexMap]:
    """The index map of ``--selected-features-file`` (an Avro file of
    FeatureNameTermAvro records): features outside it are dropped at
    ingest, as the reader drops features absent from a given map."""
    if not args.selected_features_file:
        return None
    if args.format == "libsvm":
        raise ValueError("--selected-features-file applies to the avro format (features are name/term keyed)")
    with AvroReader(args.selected_features_file) as r:
        keys = {IndexMap.key(rec["name"], rec.get("term") or "") for rec in r}
    if not keys:
        raise ValueError(f"no features in {args.selected_features_file}")
    return IndexMap.build(sorted(keys), add_intercept=args.intercept)


def _stream_load_avro(args, path: str, device, index_map: Optional[IndexMap], ingest: Optional[Dict] = None):
    """Streaming multi-pass Avro load: the first pass decodes container
    blocks into ColumnarRows chunks, teed into a ``ChunkReplayCache``, and
    distinct-scans the feature keys (skipped when ``index_map`` is given);
    the second replays the decoded chunks (from memory, then from the
    spool) through the assemble and h2d stages and concatenates them on
    ``device``. Decode is paid once, and host RAM never holds the assembled
    data. The cache's counts land in ``ingest`` when given."""
    from photon_tpu_torch.io.columnar import stream_avro_columnar
    from photon_tpu_torch.io.data_reader import _expand_paths
    from photon_tpu_torch.io.pipeline import (
        ChunkReplayCache,
        assemble_host_batches,
        columnar_nbytes,
        device_chunks_from,
        materialize_game_batch,
    )

    chunk_rows = args.stream_ingest_chunk_rows
    paths = _expand_paths([path])
    cache = ChunkReplayCache(lambda: stream_avro_columnar(paths, chunk_rows),
                             byte_budget=args.replay_cache_mb << 20, nbytes=columnar_nbytes)
    t0 = time.perf_counter()
    imap = index_map
    if imap is None:
        seen: Dict[str, None] = {}
        for cols in cache:
            bag = cols.bags.get("features")
            if bag is not None and bag.key_ids.size:
                for i in np.unique(bag.key_ids):
                    seen.setdefault(cols.intern[i], None)
        imap = IndexMap.build(seen, add_intercept=args.intercept)
    cfg = {"features": FeatureShardConfig(feature_bags=["features"], has_intercept=args.intercept)}
    try:
        batch = materialize_game_batch(device_chunks_from(
            lambda: assemble_host_batches(iter(cache), cfg, {"features": imap}, device=device),
            telemetry_label="train-ingest", device=device))
    finally:
        stats = dict(decode_passes=cache.source_passes, replay_passes=cache.replay_passes, spilled=cache.spilled,
                     cached_bytes=cache.cached_bytes, spilled_bytes=cache.spilled_bytes)
        cache.close()  # the batch is materialized (or failed): delete any spool now
    stats.update(rows=batch.n, wall_s=time.perf_counter() - t0)
    log.info("streaming ingest: decode passes=%d replay passes=%d cache=%s", stats["decode_passes"],
             stats["replay_passes"], "spilled" if stats["spilled"] else f"{stats['cached_bytes'] >> 20} MiB held")
    if ingest is not None:
        ingest.update(stats)
    return batch.labeled_batch("features"), imap


def load_data(args, path: Optional[str], device, index_map: Optional[IndexMap] = None,
              ingest: Optional[Dict] = None):
    """(LabeledBatch on ``device``, IndexMap) of a LIBSVM or Avro file; the
    LIBSVM path appends the ones column of the intercept, as the reference
    does. (None, index_map) when ``path`` is None. Avro streams with
    ``--stream-ingest-chunk-rows``, its counts in ``ingest``."""
    if path is None:
        return None, index_map
    if args.format == "libsvm":
        X, y = read_libsvm(path, dim=args.feature_dimension)
        if args.intercept:
            X = np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], axis=1)
        imap = index_map or IndexMap.build(
            [str(j + 1) for j in range(X.shape[1] - (1 if args.intercept else 0))],
            add_intercept=args.intercept,
        )
        return LabeledBatch.from_numpy(y, X, device=device), imap
    if args.stream_ingest_chunk_rows > 0:
        return _stream_load_avro(args, path, device, index_map, ingest)
    cfg = {"features": FeatureShardConfig(feature_bags=["features"], has_intercept=args.intercept)}
    batch, imaps, _ = read_merged(
        [path], cfg, index_maps=None if index_map is None else {"features": index_map}, device=device,
    )
    return batch.labeled_batch("features"), imaps["features"]


@dataclasses.dataclass
class LambdaResult:
    """One λ of the sweep: the solve, the model-space coefficients, the
    variances, and what the solve cost."""

    lam: float
    objective: GLMObjective
    spec: OptimizerSpec
    w0: torch.Tensor  # the warm start the solve began from
    result: OptimizeResult
    w_model: torch.Tensor
    variances: Optional[torch.Tensor]
    wall_s: float
    host_syncs: int
    # What the solve added to the shared solve cache's counts
    # (SolveCacheStats.counts: builds, i.e. captures on the card, hits,
    # graph replays, bytes copied into the entry's buffers).
    cache: Dict[str, int]


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def lambda_objective(train: LabeledBatch, lam: float, task: TaskType, elastic_net_alpha: float = 0.0,
                     intercept_index: Optional[int] = None,
                     normalization: Optional[NormalizationContext] = None) -> GLMObjective:
    """The objective of one λ of the sweep."""
    # A routing choice, not a feature: on the card the fused kernels (K1 for
    # value and gradient, K2 for TRON's products) are how the port computes
    # these, under the reference's own routing rule (``_can_fuse``: dense X,
    # d <= 4096, no shifts) and within the kernels' pinned parity with the
    # plain path (1e-5 relative). The reference driver leaves use_pallas off.
    return GLMObjective(loss=loss_for_task(task), l2_weight=(1.0 - elastic_net_alpha) * lam,
                        l1_weight=elastic_net_alpha * lam, intercept_index=intercept_index,
                        normalization=normalization, use_fused=train.features.is_cuda)


def train_lambda_sweep(
    train: LabeledBatch,
    weights: Sequence[float],
    task: TaskType,
    spec: OptimizerSpec,
    elastic_net_alpha: float = 0.0,
    intercept_index: Optional[int] = None,
    normalization: Optional[NormalizationContext] = None,
    variance: VarianceComputationType = VarianceComputationType.NONE,
    solve_cache: Optional[SolveCache] = None,
    w_start: Optional[torch.Tensor] = None,
    after_lambda: Optional[Callable[[LambdaResult], None]] = None,
) -> List[LambdaResult]:
    """Solve for every λ in ``weights``, in the order given (the driver
    passes them strongest first), each from the previous solution (the
    first from ``w_start``, else zero), and compute the variances at each
    optimum. The variances are taken in the transformed space and not
    rescaled by factors², as the reference driver does. ``after_lambda`` is
    called with each λ's result as it finishes. The solves dispatch through
    ``solve_cache``; without one, through the shared cache, released when
    the sweep returns."""
    w = (torch.zeros(train.features.shape[1], dtype=train.label.dtype, device=train.label.device)
         if w_start is None else w_start)
    out: List[LambdaResult] = []
    cache = solve_cache if solve_cache is not None else default_cache()
    try:
        for lam in weights:
            objective = lambda_objective(train, lam, task, elastic_net_alpha, intercept_index, normalization)
            _sync(w)
            reads0, t0 = HOST_READS.count, time.perf_counter()
            # λ solves route through the solve cache, as in the reference:
            # one entry per λ; every route's program is captured once on the
            # card and reads λ (its L2 and L1 parts) as an input.
            counts0 = cache.stats.counts()
            solve = cache.fe_solver(objective, spec)
            with span(f"glm/lambda{lam:g}"):
                with span("solve"):
                    result = solve(w, train)
            _sync(result.w)
            wall = time.perf_counter() - t0
            host_syncs = HOST_READS.count - reads0
            counted = cache.stats.since(counts0)
            w0, w = w, result.w  # warm start toward weaker regularization
            w_model = w if normalization is None else normalization.transformed_to_model_space(w)
            out.append(LambdaResult(lam, objective, spec, w0, result, w_model,
                                    coefficient_variances(objective, w, train, variance), wall, host_syncs,
                                    counted))
            if after_lambda is not None:
                after_lambda(out[-1])
    finally:
        if solve_cache is None:
            cache.release()
    return out


def _write_text_model(path: str, task: TaskType, r: LambdaResult, loss: float, imap: IndexMap) -> None:
    with open(path, "w") as f:
        f.write(f"# task={task.value} lambda={r.lam:g} loss={loss:.6e}\n")
        wv = r.w_model.detach().cpu().numpy()
        for j in np.flatnonzero(np.abs(wv) > 0):
            key = imap.get_feature_name(int(j)) or str(j)
            f.write(f"{key}\t{wv[j]:.8g}\n")


def _restore_sweep(args, ckpt_tag: str, device) -> tuple:
    """(finished λ records, warm start) of the sweep checkpoint under
    ``--checkpoint-dir``, or ([], None) when there is none to resume."""
    if args.resume and latest_step(args.checkpoint_dir) is None:
        raise ValueError(f"--resume: no checkpoint state under {args.checkpoint_dir}")
    try:
        state, _step = load_checkpoint(args.checkpoint_dir, device=device)
    except FileNotFoundError:
        return [], None
    except LegacyCheckpointError as exc:
        log.warning("ignoring legacy checkpoint under %s: %s", args.checkpoint_dir, exc)
        return [], None
    if state.get("tag") != ckpt_tag:
        log.warning("checkpoint under %s is for a different λ-sweep configuration; starting fresh",
                    args.checkpoint_dir)
        return [], None
    log.info("resuming λ sweep from checkpoint: %d λ(s) done", len(state["lambdas"]))
    registry().counter("glm_sweep_resumes_total").inc()
    return state["lambdas"], state["w"]


def run(args) -> Dict:
    setup_logging(args.verbose)
    begin_run()  # fresh spans, metrics and phase records for this run
    device = resolve_device(args.device)
    # Host RSS watchdog: inert without a detectable limit; at hard pressure
    # the λ boundary fails cleanly instead of meeting the OOM-killer.
    resources.start_watchdog()
    emitter = EventEmitter()
    for name in list(args.event_listeners) + list(args.event_listener):
        emitter.register_by_name(name)
    emitter.emit(setup_event(driver="train_glm", task=args.task, optimizer=args.optimizer))
    if args.re_active_set:
        log.warning("--re-active-set is a no-op for the single-GLM driver (no "
                    "random-effect coordinates); it only affects GAME training")
    if args.re_device_budget_mb:
        log.warning("--re-device-budget-mb is a no-op for the single-GLM driver "
                    "(no random-effect coordinates); it only affects GAME training")
    task = task_of(args)
    stage = DriverStage.INIT
    if args.validate_per_iteration and args.validation_data is None:
        raise ValueError("--validate-per-iteration requires --validation-data")

    ingest: Dict = {}
    train, imap = load_data(args, args.training_data, device, _selected_features_index_map(args), ingest)
    valid, _ = load_data(args, args.validation_data, device, imap)
    mode = DataValidationType[args.data_validation]
    validate_labeled_batch(train, task, mode)
    if valid is not None:
        validate_labeled_batch(valid, task, mode)
    icpt = imap.get_index(IndexMap.INTERCEPT) if args.intercept else None
    if icpt is not None and icpt < 0:
        icpt = None

    norm = None
    norm_type = NormalizationType[args.normalization]
    if norm_type != NormalizationType.NONE or args.summarization_output_dir:
        stats = compute_feature_stats(train, icpt)
        if norm_type != NormalizationType.NONE:
            norm = build_normalization_context(norm_type, stats.mean, stats.std, stats.abs_max, icpt)
        if args.summarization_output_dir:
            write_basic_statistics(stats, imap, os.path.join(args.summarization_output_dir, "part-00000.avro"))
    stage = DriverStage.PREPROCESSED

    box = None
    d = train.features.shape[1]
    if args.coefficient_box:
        lo, hi = (float(x) for x in args.coefficient_box.split(","))
        box = tuple(torch.full((d,), v, dtype=train.label.dtype, device=device) for v in (lo, hi))
    if args.constraint_string:
        if box is not None:
            raise ValueError("--constraint-string and --coefficient-box are exclusive")
        bounds = constraint_bound_vectors(args.constraint_string, imap, d, icpt)
        if bounds is not None:
            box = tuple(torch.as_tensor(b, dtype=train.label.dtype, device=device) for b in bounds)

    # REGULARIZATION_TYPE_OPTION: NONE ignores the weights, L1/L2 pin the
    # elastic-net mix, ELASTIC_NET takes the alpha as given.
    if args.regularization_type == "NONE":
        args.regularization_weights = "0"
    elif args.regularization_type == "L1":
        args.elastic_net_alpha = 1.0
    elif args.regularization_type == "L2":
        args.elastic_net_alpha = 0.0
    weights = sorted((float(x) for x in args.regularization_weights.split(",")), reverse=True)

    spec = OptimizerSpec(OptimizerType[args.optimizer], args.max_iterations, args.tolerance,
                         box=box, track_history=args.optimization_state_tracker)
    emitter.emit(training_start_event(task=task.value, weights=weights))

    # λ-sweep checkpoint: one step per finished λ. The tag pins the sweep's
    # configuration, so a resumed run solves the same problem.
    ckpt_dir = args.checkpoint_dir
    ckpt_tag = "|".join([args.task, args.optimizer, f"{args.elastic_net_alpha:g}",
                         ",".join(f"{lam:g}" for lam in weights)])
    if ckpt_dir and args.validate_per_iteration:
        raise ValueError("--checkpoint-dir is incompatible with --validate-per-iteration (the per-iteration "
                         "replay needs each solve's warm start)")
    if args.resume and not ckpt_dir:
        raise ValueError("--resume requires --checkpoint-dir")
    done, w_start = _restore_sweep(args, ckpt_tag, device) if ckpt_dir else ([], None)
    sweep = [LambdaResult(r["lam"], lambda_objective(train, r["lam"], task, args.elastic_net_alpha, icpt, norm),
                          spec, None, r["result"], r["w_model"], r["variances"], r["wall_s"], r["host_syncs"],
                          r["cache"]) for r in done]
    save_walls: List[float] = []

    def after_lambda(r: LambdaResult) -> None:
        sweep.append(r)
        emitter.emit(optimization_log_event(reg_weight=r.lam, loss=float(r.result.value),
                                            iterations=int(r.result.iterations),
                                            convergence=r.result.convergence_reason.value))
        if ckpt_dir:
            t0 = time.perf_counter()
            try:
                save_checkpoint(ckpt_dir, dict(
                    tag=ckpt_tag, w=r.result.w,
                    lambdas=[dict(lam=x.lam, result=x.result, w_model=x.w_model, variances=x.variances,
                                  wall_s=x.wall_s, host_syncs=x.host_syncs, cache=x.cache) for x in sweep]),
                    len(sweep) - 1, keep_last=args.checkpoint_keep_last)
            except OSError as exc:
                # The writer already pruned and retried: a disk that stays
                # full costs resumability, not the sweep.
                if not resources.is_enospc(exc):
                    raise
                registry().counter("checkpoint_write_failures_total").inc()
                log.warning("λ-sweep checkpoint at λ=%g failed even after pruning (disk full under %s); "
                            "continuing WITHOUT a checkpoint for this λ: %s", r.lam, ckpt_dir, exc)
            save_walls.append(time.perf_counter() - t0)
        signum = shutdown_requested()
        if signum is not None:
            log.warning("λ sweep stopping after λ=%g on signal %d", r.lam, signum)
            finalize_run_report("train_glm", path=args.telemetry_out, emitter=emitter)
            raise GracefulShutdown(signum)
        # The finished λs are durable: failing here on hard host memory
        # pressure is clean and resumable.
        resources.check_memory(f"train_glm λ={r.lam:g}")

    remaining = weights[len(sweep):]
    if remaining:
        train_lambda_sweep(train, remaining, task, spec, args.elastic_net_alpha, icpt, norm,
                           normalize_variance_type(args.compute_variance), w_start=w_start,
                           after_lambda=after_lambda)
    models: List[Dict] = []
    for r in sweep:
        models.append({"lambda": r.lam, "loss": float(r.result.value),
                       "iterations": int(r.result.iterations),
                       "reason": r.result.convergence_reason.value})
        log.info("λ=%g: %s after %d iterations, objective %.6e", r.lam, models[-1]["reason"],
                 models[-1]["iterations"], models[-1]["loss"])
    stage = DriverStage.TRAINED

    # Every λ gets the task's full MetricsMap; the best is picked by the
    # task's selection metric (the last, weakest λ without validation data).
    best_idx = len(sweep) - 1
    if valid is not None:
        sel_name, larger_better = selection_metric(task)
        best_val = None
        for i, (m, r) in enumerate(zip(models, sweep)):
            mmap = metrics_map(task, valid.margins(r.w_model), valid.label, coefficients=r.w_model)
            m["validation"] = mmap
            log.info("Model with lambda = %g:", r.lam)
            if args.validate_per_iteration:
                # The solve replayed from the same warm start with max_iter=j
                # gives the coefficients after j iterations.
                per_iter = []
                for j in range(1, m["iterations"] + 1):
                    res_j = make_optimizer(r.objective, dataclasses.replace(r.spec, max_iter=j))(r.w0, train)
                    w_j = res_j.w if norm is None else norm.transformed_to_model_space(res_j.w)
                    mm_j = metrics_map(task, valid.margins(w_j), valid.label, coefficients=w_j)
                    per_iter.append(mm_j)
                    for name in sorted(mm_j):
                        log.info("Iteration: [%6d] Metric: [%s] value: %s", j, name, mm_j[name])
                m["per_iteration_validation"] = per_iter
            for name in sorted(mmap):
                log.info("Metric: [%s] value: %s", name, mmap[name])
            v = mmap[sel_name]
            if best_val is None or (v > best_val if larger_better else v < best_val):
                best_val, best_idx = v, i
        log.info("Regularization weight of the best model is: %g", sweep[best_idx].lam)
        stage = DriverStage.VALIDATED

    os.makedirs(args.output_dir, exist_ok=True)
    for m, r in zip(models, sweep):
        _write_text_model(os.path.join(args.output_dir, f"model-lambda-{r.lam:g}.txt"), task, r, m["loss"], imap)
    best = sweep[best_idx]
    game = GameModel({"global": FixedEffectModel(
        GeneralizedLinearModel(Coefficients(best.w_model, best.variances), task), "features")})
    save_game_model(game, os.path.join(args.output_dir, "best"), {"features": imap})
    publish_latest_pointer(args.output_dir, "best")
    summary = {"best_lambda": best.lam, "models": models, "stage": stage.name}
    # Port additions: the streamed read's replay-cache counts and the
    # checkpoint save walls.
    if ingest:
        summary["ingest"] = ingest
    if ckpt_dir:
        summary["checkpoint"] = {"resumed_lambdas": len(done), "save_wall_s": save_walls}
    with open(os.path.join(args.output_dir, "training-summary.json"), "w") as f:
        json.dump(sanitize_for_json(summary), f, indent=2)
    emitter.emit(training_finish_event(best_lambda=best.lam))
    # One tracker row per λ solve: the sweep is this driver's coordinate
    # sequence.
    finalize_run_report("train_glm", path=args.telemetry_out, emitter=emitter,
                        trackers=[{"label": "glm", "tracker": {"global": [r.result for r in sweep]},
                                   "wall_times": {"global": [r.wall_s for r in sweep]}}])
    return summary


def main(argv=None) -> Dict:
    try:
        with handle_termination():
            summary = run(build_parser().parse_args(argv))
    except GracefulShutdown as exc:
        # The finished λs are durable in --checkpoint-dir; 128 + signum is
        # the conventional signal exit.
        raise SystemExit(128 + exc.signum) from exc
    print(json.dumps({"best_lambda": summary["best_lambda"]}))
    return summary


if __name__ == "__main__":
    main()
