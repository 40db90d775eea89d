"""Shared CLI plumbing (port of photon_tpu/cli/common.py): logging, the
compound-argument grammars of the reference's scopt layer
(``name=global,feature.shard=shardA,optimizer=LBFGS,reg.weights=0.1|1|10``:
comma-separated key=value lists, multi-values joined by ``|``), the task,
device and input flags and the shared argument groups."""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional

import torch

from photon_tpu_torch.estimators.config import FixedEffectCoordinateConfig, RandomEffectCoordinateConfig
from photon_tpu_torch.io.data_reader import FeatureShardConfig, InputColumnsNames
from photon_tpu_torch.types import OptimizerType, TaskType
from photon_tpu_torch.utils.io_utils import date_range_from_specs, resolve_range_paths


def setup_logging(verbose: bool = False) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


# Re-exported for drivers (the implementation lives in utils so algorithm
# code can poll shutdown_requested without importing the CLI layer).
from photon_tpu_torch.utils.shutdown import (  # noqa: E402,F401
    GracefulShutdown,
    handle_termination,
    shutdown_requested,
)


def parse_kv(spec: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad key=value element {part!r} in {spec!r}")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def parse_feature_shard_config(spec: str) -> Dict[str, FeatureShardConfig]:
    """``name=shardA,feature.bags=features|songFeatures,intercept=true``"""
    kv = parse_kv(spec)
    name = kv.pop("name")
    bags = kv.pop("feature.bags", "features").split("|")
    intercept = kv.pop("intercept", "true").lower() != "false"
    if kv:
        raise ValueError(f"unknown feature-shard keys: {sorted(kv)}")
    return {name: FeatureShardConfig(feature_bags=bags, has_intercept=intercept)}


def parse_coordinate_config(spec: str):
    """The reference's coordinate grammar:
    ``name=global,feature.shard=shardA,optimizer=LBFGS,reg.weights=0.1|1|10``
    with ``max.iter=``, ``tol=``, ``reg.alpha=`` (elastic net) and, for a
    fixed effect, ``down.sampling.rate=``; a random effect adds
    ``random.effect.type=`` and optionally ``active.data.upper.bound=``,
    ``active.data.lower.bound=``, ``features.to.samples.ratio=``,
    ``active.set=`` and ``convergence.tol=``."""
    kv = parse_kv(spec)
    name = kv.pop("name")
    shard = kv.pop("feature.shard")
    optimizer = OptimizerType[kv.pop("optimizer", "LBFGS").upper()]
    reg_weights = [float(x) for x in kv.pop("reg.weights", "0").split("|")]
    reg_alpha = float(kv.pop("reg.alpha", "0"))
    max_iter = int(kv.pop("max.iter")) if "max.iter" in kv else None
    tol = float(kv.pop("tol")) if "tol" in kv else None
    re_type = kv.pop("random.effect.type", None)
    if re_type is None:
        rate = float(kv.pop("down.sampling.rate")) if "down.sampling.rate" in kv else None
        if kv:
            raise ValueError(f"unknown coordinate keys: {sorted(kv)}")
        return FixedEffectCoordinateConfig(
            coordinate_id=name, feature_shard=shard, optimizer=optimizer, max_iter=max_iter, tol=tol,
            reg_weights=reg_weights, reg_alpha=reg_alpha, down_sampling_rate=rate,
        )
    ub = int(kv.pop("active.data.upper.bound")) if "active.data.upper.bound" in kv else None
    lb = int(kv.pop("active.data.lower.bound")) if "active.data.lower.bound" in kv else None
    ratio = float(kv.pop("features.to.samples.ratio")) if "features.to.samples.ratio" in kv else None
    active_set = kv.pop("active.set", "false").strip().lower() in ("1", "true", "yes")
    conv_tol = float(kv.pop("convergence.tol")) if "convergence.tol" in kv else None
    if kv:
        raise ValueError(f"unknown coordinate keys: {sorted(kv)}")
    return RandomEffectCoordinateConfig(
        coordinate_id=name, re_type=re_type, feature_shard=shard, optimizer=optimizer, max_iter=max_iter,
        tol=tol, reg_weights=reg_weights, reg_alpha=reg_alpha, active_upper_bound=ub, active_lower_bound=lb,
        features_to_samples_ratio=ratio, active_set=active_set, convergence_tol=conv_tol,
    )


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input-paths", nargs="+", required=True,
                   help="Avro files/dirs/globs of training data")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-shard-configurations", nargs="+", default=["name=global"],
                   help="name=<shard>,feature.bags=a|b,intercept=true")
    p.add_argument("--task", default="LOGISTIC_REGRESSION", choices=[t.name for t in TaskType])
    p.add_argument("--input-data-date-range", default=None,
                   help="yyyyMMdd-yyyyMMdd over daily-format input dirs (reference inputDataDateRange)")
    p.add_argument("--input-data-days-range", default=None,
                   help="start-end days ago (reference inputDataDaysRange)")
    p.add_argument("--override-output-dir", action="store_true")
    p.add_argument("--input-column-names", default=None,
                   help="remap reserved columns (reference InputColumnsNames), e.g. "
                        "response=the_label,weight=w,offset=off,uid=id,metadata=meta")
    p.add_argument("--verbose", action="store_true")


def parse_input_column_names(spec: Optional[str]) -> Optional[InputColumnsNames]:
    """'response=the_label,weight=w' → InputColumnsNames (None passthrough)."""
    if not spec:
        return None
    allowed = {"response", "offset", "weight", "uid", "metadata"}
    kwargs = {}
    for part in spec.split(","):
        key, _, value = part.partition("=")
        key = key.strip()
        if key not in allowed or not value:
            raise ValueError(f"bad --input-column-names entry {part!r}; keys: {sorted(allowed)}")
        kwargs[key] = value.strip()
    return InputColumnsNames(**kwargs)


def resolve_input_paths(args) -> list:
    """--input-paths expanded through a date or days range, if one is given."""
    date_range = date_range_from_specs(getattr(args, "input_data_date_range", None),
                                       getattr(args, "input_data_days_range", None))
    return resolve_range_paths(args.input_paths, date_range)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the data and the solves live (default cuda; "
                        "cpu runs every kernel's plain PyTorch version)")


def resolve_device(name: str) -> torch.device:
    """The requested device. A CUDA request without a card exits non-zero:
    the driver never carries on silently on the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device(name)


def install_otlp(args, service_name: str):
    """``--otlp-endpoint`` (and ``--otlp-metrics-interval``): install the
    exporter, after ``begin_run`` (the tracer's sinks survive its reset).
    The exporter, or None without an endpoint."""
    from photon_tpu_torch.obs.export import maybe_install_exporter

    return maybe_install_exporter(args.otlp_endpoint, service_name,
                                  metrics_interval_s=float(args.otlp_metrics_interval or 0.0))


def close_otlp(exporter) -> None:
    """At a driver's exit: export the registry once more and flush,
    best-effort, then uninstall the exporter."""
    if exporter is None:
        return
    from photon_tpu_torch.obs.export import uninstall_exporter

    try:
        exporter.export_metrics()
        exporter.flush(timeout_s=3.0)
    except Exception:  # noqa: BLE001 — the exit export is best-effort
        logging.getLogger("photon_tpu_torch").exception("final OTLP export failed")
    uninstall_exporter()


def refuse_unported(driver: str, unported: Dict[str, bool]) -> None:
    """Exit non-zero naming every given flag whose machinery is not ported."""
    named = [flag for flag, given in unported.items() if given]
    if named:
        raise SystemExit(f"{driver}: {', '.join(named)}: not ported yet")


def add_active_set_args(p: argparse.ArgumentParser) -> None:
    """Convergence-gated active-set flags. Only GAME training acts on them
    (random-effect coordinates); the other drivers warn that they are no-ops."""
    p.add_argument("--re-active-set", action="store_true",
                   help="GAME training only: re-solve only the random-effect "
                        "entities whose coefficients still move")
    p.add_argument("--re-convergence-tol", type=float, default=1e-4,
                   help="relative coefficient-delta threshold of the active set")


def add_out_of_core_args(p: argparse.ArgumentParser) -> None:
    """Out-of-core random-effect residency flags shared by all drivers.

    Only GAME training acts on them (random-effect coordinates); the scoring
    and fixed-effect-only drivers accept them and warn that they are no-ops
    there.
    """
    p.add_argument("--re-device-budget-mb", type=float, default=None,
                   help="device byte budget for random-effect block data + coefficients; when set, blocks live in a "
                        "host master (optionally memory-mapped, see --re-spill-dir) and only a budgeted working set "
                        "is device-resident — trains models bigger than device memory at bit-exact parity")
    p.add_argument("--re-spill-dir", default=None,
                   help="directory for the host master's memory-mapped .npy spill (default: host RAM); only "
                        "meaningful with --re-device-budget-mb")
    p.add_argument("--re-spill-member", default=None,
                   help="ring-member tag for the host-owned spill layout: spill files land under "
                        "<re-spill-dir>/host-<k>/ so a fleet rebalance is a file move, not a row re-stream (see "
                        "re_store.rebalance_spill_layout); only meaningful with --re-spill-dir")


def add_validation_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=["VALIDATE_FULL", "VALIDATE_SAMPLE", "VALIDATE_DISABLED"],
                   help="row-level sanity checks (reference DataValidators)")


def task_of(args) -> TaskType:
    return TaskType[args.task]
