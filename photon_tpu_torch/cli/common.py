"""Shared CLI plumbing (port of the parts of photon_tpu/cli/common.py the
legacy GLM driver uses): logging, the task flag, the device flag and the
shared argument groups."""

from __future__ import annotations

import argparse
import logging

import torch

from photon_tpu_torch.types import TaskType


def setup_logging(verbose: bool = False) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


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


def add_active_set_args(p: argparse.ArgumentParser) -> None:
    """Convergence-gated active-set flags. Only GAME training acts on them
    (random-effect coordinates); the GLM driver warns that they are no-ops."""
    p.add_argument("--re-active-set", action="store_true",
                   help="GAME training only: re-solve only the random-effect "
                        "entities whose coefficients still move")
    p.add_argument("--re-convergence-tol", type=float, default=1e-4,
                   help="relative coefficient-delta threshold of the active set")


def add_out_of_core_args(p: argparse.ArgumentParser) -> None:
    """Out-of-core random-effect residency flags. Only GAME training acts on
    them; the GLM driver warns that they are no-ops."""
    p.add_argument("--re-device-budget-mb", type=float, default=None,
                   help="GAME training only: device byte budget for random-effect blocks")
    p.add_argument("--re-spill-dir", default=None,
                   help="GAME training only: memory-mapped spill directory")
    p.add_argument("--re-spill-member", default=None,
                   help="GAME training only: ring-member tag of the spill layout")


def add_validation_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=["VALIDATE_FULL", "VALIDATE_SAMPLE", "VALIDATE_DISABLED"],
                   help="row-level sanity checks (reference DataValidators)")


def task_of(args) -> TaskType:
    return TaskType[args.task]
