"""Optimizer factory: configuration → solver closure over a GLMObjective
(port of photon_tpu/optim/factory.py).

The reference's routing: OWL-QN whenever the objective has an L1 weight
(intercept unpenalized), TRON with the linearized Hessian-vector product,
L-BFGS-B (which needs a box), margin-space L-BFGS for a smooth unboxed
LabeledBatch, and black-box L-BFGS otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import OptimizeResult, OptimizerConfig
from photon_tpu_torch.optim.lbfgs import minimize_lbfgs, minimize_lbfgsb
from photon_tpu_torch.optim.margin_lbfgs import minimize_lbfgs_margin
from photon_tpu_torch.optim.owlqn import minimize_owlqn
from photon_tpu_torch.optim.tron import TRON_DEFAULT_CONFIG, minimize_tron
from photon_tpu_torch.types import OptimizerType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """User-facing optimizer configuration (reference
    CoordinateOptimizationConfiguration optimizer fields)."""

    optimizer: OptimizerType = OptimizerType.LBFGS
    max_iter: Optional[int] = None
    tol: Optional[float] = None
    memory: int = 10
    max_cg_iter: int = 20
    box: Optional[Tuple[Tensor, Tensor]] = None
    track_history: bool = True

    def config(self) -> OptimizerConfig:
        base = TRON_DEFAULT_CONFIG if self.optimizer == OptimizerType.TRON else OptimizerConfig()
        return OptimizerConfig(
            max_iter=self.max_iter if self.max_iter is not None else base.max_iter,
            tol=self.tol if self.tol is not None else base.tol,
            memory=self.memory,
            track_history=self.track_history,
        )


def make_optimizer(
    objective: GLMObjective, spec: OptimizerSpec
) -> Callable[[Tensor, LabeledBatch], OptimizeResult]:
    """solve(w0, batch) -> OptimizeResult for the given objective."""
    config = spec.config()

    def solve(w0: Tensor, batch: LabeledBatch) -> OptimizeResult:
        vg = lambda w: objective.value_and_grad(w, batch)  # noqa: E731
        # An L1 term always routes to OWL-QN; a smooth objective never does
        # (orthant projection would still pin sign-crossing coordinates).
        if objective.l1_weight > 0.0:
            l1_mask = None
            if objective.intercept_index is not None:
                l1_mask = torch.ones_like(w0)
                l1_mask[objective.intercept_index] = 0.0
            return minimize_owlqn(vg, w0, objective.l1_weight, config, l1_mask)
        if spec.optimizer == OptimizerType.TRON:
            return minimize_tron(
                vg, None, w0, config, spec.max_cg_iter, spec.box,
                hvp_factory=lambda w: objective.linearized_hvp(w, batch),
            )
        if spec.optimizer == OptimizerType.LBFGSB:
            if spec.box is None:
                raise ValueError("LBFGSB requires a box")
            return minimize_lbfgsb(vg, w0, spec.box[0], spec.box[1], config)
        # Smooth unconstrained GLM over a LabeledBatch: two X passes per
        # iteration instead of 2·(1 + line-search trials).
        if spec.box is None and isinstance(batch, LabeledBatch):
            return minimize_lbfgs_margin(objective, batch, w0, config)
        return minimize_lbfgs(vg, w0, config, spec.box)

    return solve
