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

The data and the solves live on ``--device`` (default cuda; without a card
the driver exits non-zero rather than run on the CPU). Flags whose
machinery is not ported exit non-zero with "not ported yet"; the
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
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.algorithm.solve_cache import SolveCache, default_cache
from photon_tpu_torch.cli.common import (
    add_active_set_args,
    add_device_arg,
    add_out_of_core_args,
    add_validation_arg,
    refuse_unported,
    resolve_device,
    setup_logging,
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
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.ops.variance import coefficient_variances, normalize_variance_type
from photon_tpu_torch.optim.common import HOST_READS, OptimizeResult
from photon_tpu_torch.optim.factory import OptimizerSpec, make_optimizer
from photon_tpu_torch.types import NormalizationType, OptimizerType, TaskType, VarianceComputationType
from photon_tpu_torch.utils.timed import Timed

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
    p.add_argument("--event-listeners", nargs="*", default=[], help="not ported yet")
    p.add_argument("--event-listener", action="append", default=[], dest="event_listener",
                   help="not ported yet")
    p.add_argument("--telemetry-out", default=None, help="not ported yet")
    p.add_argument("--summarization-output-dir", default=None,
                   help="write per-feature summary statistics of the training data as "
                        "FeatureSummarizationResultAvro (part-00000.avro)")
    p.add_argument("--stream-ingest-chunk-rows", type=int, default=0, help="not ported yet")
    p.add_argument("--replay-cache-mb", type=int, default=_REPLAY_CACHE_MB,
                   help="streaming ingest only (not ported yet)")
    add_validation_arg(p)
    add_active_set_args(p)
    add_out_of_core_args(p)
    p.add_argument("--checkpoint-dir", default=None, help="not ported yet")
    p.add_argument("--resume", action="store_true", help="not ported yet")
    p.add_argument("--checkpoint-keep-last", type=int, default=None, help="not ported yet")
    add_device_arg(p)
    p.add_argument("--verbose", action="store_true")
    return p


def _refuse_unported(args) -> None:
    """Exit non-zero on a flag whose machinery the port does not have."""
    refuse_unported("train_glm", {
        "--stream-ingest-chunk-rows": args.stream_ingest_chunk_rows > 0,
        "--replay-cache-mb": args.replay_cache_mb != _REPLAY_CACHE_MB,
        "--checkpoint-dir": args.checkpoint_dir is not None,
        "--resume": args.resume,
        "--checkpoint-keep-last": args.checkpoint_keep_last is not None,
        "--telemetry-out": args.telemetry_out is not None,
        "--event-listeners": bool(args.event_listeners),
        "--event-listener": bool(args.event_listener),
    })


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


def load_data(args, path: Optional[str], device, index_map: Optional[IndexMap] = None):
    """(LabeledBatch on ``device``, IndexMap) of a LIBSVM or Avro file; the
    LIBSVM path appends the ones column of the intercept, as the reference
    does. (None, index_map) when ``path`` is None."""
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
) -> List[LambdaResult]:
    """Solve for every λ in ``weights``, in the order given (the driver
    passes them strongest first), each from the previous solution, and
    compute the variances at each optimum. The variances are taken in the
    transformed space and not rescaled by factors², as the reference driver
    does. The solves dispatch through ``solve_cache``; without one, through
    the shared cache, released when the sweep returns."""
    loss = loss_for_task(task)
    # A routing choice, not a feature: on the card the fused kernels (K1 for
    # value and gradient, K2 for TRON's products) are how the port computes
    # these, under the reference's own routing rule (``_can_fuse``: dense X,
    # d <= 4096, no shifts) and within the kernels' pinned parity with the
    # plain path (1e-5 relative). The reference driver leaves use_pallas off.
    use_fused = train.features.is_cuda
    w = torch.zeros(train.features.shape[1], dtype=train.label.dtype, device=train.label.device)
    out: List[LambdaResult] = []
    cache = solve_cache if solve_cache is not None else default_cache()
    try:
        for lam in weights:
            objective = GLMObjective(
                loss=loss,
                l2_weight=(1.0 - elastic_net_alpha) * lam,
                l1_weight=elastic_net_alpha * lam,
                intercept_index=intercept_index,
                normalization=normalization,
                use_fused=use_fused,
            )
            _sync(w)
            reads0, t0 = HOST_READS.count, time.perf_counter()
            # λ solves route through the solve cache, as in the reference:
            # one entry per λ; every route's program is captured once on the
            # card and reads λ (its L2 and L1 parts) as an input.
            counts0 = cache.stats.counts()
            result = cache.fe_solver(objective, spec)(w, train)
            _sync(result.w)
            wall = time.perf_counter() - t0
            host_syncs = HOST_READS.count - reads0
            counted = cache.stats.since(counts0)
            w0, w = w, result.w  # warm start toward weaker regularization
            w_model = w if normalization is None else normalization.transformed_to_model_space(w)
            out.append(LambdaResult(lam, objective, spec, w0, result, w_model,
                                    coefficient_variances(objective, w, train, variance), wall, host_syncs,
                                    counted))
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


def run(args) -> Dict:
    setup_logging(args.verbose)
    _refuse_unported(args)
    device = resolve_device(args.device)
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

    with Timed("driver/read-train"):
        train, imap = load_data(args, args.training_data, device, _selected_features_index_map(args))
    with Timed("driver/read-validation"):
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
    sweep = train_lambda_sweep(train, weights, task, spec, args.elastic_net_alpha, icpt, norm,
                               normalize_variance_type(args.compute_variance))
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
    with open(os.path.join(args.output_dir, "training-summary.json"), "w") as f:
        json.dump(sanitize_for_json(summary), f, indent=2)
    return summary


def main(argv=None) -> Dict:
    summary = run(build_parser().parse_args(argv))
    print(json.dumps({"best_lambda": summary["best_lambda"]}))
    return summary


if __name__ == "__main__":
    main()
