"""Optimizer factory: configuration → solver closure over a GLMObjective
(port of photon_tpu/optim/factory.py).

The reference's routing: OWL-QN whenever the objective has an L1 weight
(intercept unpenalized), TRON with the linearized Hessian-vector product,
L-BFGS-B (which needs a box), margin-space L-BFGS for a smooth unboxed
LabeledBatch (dense or sparse features), and gradient-form L-BFGS otherwise.
``fe_program`` builds the route's device program (optim/program.py) over the
objective's GLM terms; ``make_optimizer`` runs it eagerly and the solve
cache captures it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import OptimizeResult, OptimizerConfig
from photon_tpu_torch.optim.lbfgs import LBFGS
from photon_tpu_torch.optim.margin_lbfgs import MarginLBFGS
from photon_tpu_torch.optim.owlqn import OWLQN
from photon_tpu_torch.optim.program import EAGER_CHUNK, Program, run_chunked
from photon_tpu_torch.optim.tron import TRON, TRON_DEFAULT_CONFIG
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


def l1_mask(objective: GLMObjective, w0: Tensor) -> Optional[Tensor]:
    """OWL-QN's mask: 0 at the intercept (unpenalized), else None (all 1)."""
    if objective.intercept_index is None:
        return None
    mask = torch.ones(w0.shape[-1], dtype=w0.dtype, device=w0.device)
    mask[objective.intercept_index] = 0.0
    return mask


def fe_program(objective: GLMObjective, spec: OptimizerSpec, w0: Tensor, batch: LabeledBatch,
               config: Optional[OptimizerConfig] = None) -> Program:
    """The program of the reference's route for ``objective`` on ``batch``
    from ``w0``; it reads the batch's tensors and ``w0`` in place."""
    config = spec.config() if config is None else config
    if objective.l1_weight == 0.0 and spec.box is None and spec.optimizer not in (
            OptimizerType.TRON, OptimizerType.LBFGSB):
        # Smooth unconstrained GLM over a LabeledBatch: two X passes per
        # iteration instead of 2·(1 + line-search trials).
        return MarginLBFGS.of_batch(objective, batch, w0, config)
    oracle = objective.oracle(batch, w0.dtype)
    # An L1 term always routes to OWL-QN; a smooth objective never does
    # (orthant projection would still pin sign-crossing coordinates).
    if objective.l1_weight > 0.0:
        return OWLQN(oracle, w0, objective.l1_weight, config, l1_mask(objective, w0))
    if spec.optimizer == OptimizerType.TRON:
        return TRON(oracle, w0, config, spec.max_cg_iter, spec.box)
    if spec.box is None:
        raise ValueError("LBFGSB requires a box")
    return LBFGS(oracle, w0, config, spec.box)


def make_optimizer(
    objective: GLMObjective, spec: OptimizerSpec
) -> Callable[[Tensor, LabeledBatch], OptimizeResult]:
    """solve(w0, batch) -> OptimizeResult for the given objective: the
    route's program, run eagerly."""

    def solve(w0: Tensor, batch: LabeledBatch) -> OptimizeResult:
        prog = fe_program(objective, spec, w0, batch)
        run_chunked(prog, EAGER_CHUNK)
        return prog.result()

    return solve
