"""Shared optimizer plumbing (port of photon_tpu/optim/common.py).

The reference runs each solver as one ``lax.while_loop`` on the device. The
port runs Python loops, so every loop condition is a device-to-host read.
``HOST_READS`` counts them, so a caller can report the syncs per step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor

REASON_NOT_CONVERGED = 0
REASON_MAX_ITERATIONS = 1
REASON_FUNCTION_VALUES_CONVERGED = 2
REASON_GRADIENT_CONVERGED = 3
REASON_OBJECTIVE_NOT_IMPROVING = 4
# A non-finite iterate: the solve kept the last finite point.
REASON_DIVERGED = 5

_REASONS = {
    REASON_NOT_CONVERGED: ConvergenceReason.NOT_CONVERGED,
    REASON_MAX_ITERATIONS: ConvergenceReason.MAX_ITERATIONS,
    REASON_FUNCTION_VALUES_CONVERGED: ConvergenceReason.FUNCTION_VALUES_CONVERGED,
    REASON_GRADIENT_CONVERGED: ConvergenceReason.GRADIENT_CONVERGED,
    REASON_OBJECTIVE_NOT_IMPROVING: ConvergenceReason.OBJECTIVE_NOT_IMPROVING,
    REASON_DIVERGED: ConvergenceReason.DIVERGED,
}


class HostReads:
    """Counter of device-to-host reads made by the solvers' loops."""

    def __init__(self) -> None:
        self.count = 0

    def read(self, *tensors: Tensor) -> np.ndarray:
        """One transfer of the given scalars (stacked) to the host, as numpy
        scalars of their dtype."""
        self.count += 1
        return torch.stack([t.reshape(()) for t in tensors]).cpu().numpy()


HOST_READS = HostReads()


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Solver configuration. Defaults mirror the reference: L-BFGS
    maxIter=100, m=10, tol=1e-7."""

    max_iter: int = 100
    tol: float = 1e-7
    memory: int = 10
    max_line_search_evals: int = 20
    track_history: bool = True

    @property
    def history_len(self) -> int:
        return self.max_iter + 1 if self.track_history else 1


@dataclasses.dataclass(frozen=True)
class OptimizeResult:
    """Solution and tracker. ``evals`` counts work in ``eval_unit``:
    "objective_evals" (2 X passes each) or "x_passes". Batched solvers
    (optim/newton.py) give every field a leading entity axis."""

    w: Tensor
    value: Tensor
    grad_norm: Tensor
    iterations: Tensor
    reason_code: Tensor
    loss_history: Tensor
    grad_norm_history: Tensor
    evals: Tensor
    eval_unit: str = "objective_evals"

    @property
    def x_passes(self) -> Tensor:
        """``evals`` in feature-matrix passes (the reference's work unit)."""
        return self.evals * (2 if self.eval_unit == "objective_evals" else 1)

    @property
    def convergence_reason(self) -> ConvergenceReason:
        return _REASONS[int(self.reason_code)]

    def summary(self) -> str:
        """Per-iteration table of a single solve (reads the history back)."""
        n = int(self.iterations)
        if self.loss_history.shape[0] < n + 1:
            return (f"iterations={n} value={float(self.value):.6e} |grad|={float(self.grad_norm):.6e} "
                    f"reason: {self.convergence_reason.value} (history not tracked)")
        lines = ["iter    loss           |grad|"]
        for i in range(n + 1):
            lines.append(f"{i:4d}    {float(self.loss_history[i]):.6e}   "
                         f"{float(self.grad_norm_history[i]):.6e}")
        lines.append(f"reason: {self.convergence_reason.value}")
        return "\n".join(lines)


def check_convergence(value, prev_value, grad_norm, init_grad_norm, tol: float,
                      iteration, max_iter: int) -> Tensor:
    """Reason code (elementwise): gradient converged relative to the initial
    gradient norm, relative function improvement within tol, max
    iterations."""
    rel_impr = torch.abs(value - prev_value) / torch.clamp(torch.abs(prev_value), min=1e-12)
    code = torch.where(
        grad_norm <= tol * torch.clamp(init_grad_norm, min=1e-12),
        REASON_GRADIENT_CONVERGED,
        torch.where(
            rel_impr <= tol,
            REASON_FUNCTION_VALUES_CONVERGED,
            torch.where(torch.as_tensor(iteration >= max_iter, device=value.device),
                        REASON_MAX_ITERATIONS, REASON_NOT_CONVERGED),
        ),
    )
    return code.to(torch.int32)


def project_to_box(w: Tensor, box: Optional[Tuple[Tensor, Tensor]]) -> Tensor:
    """Clip coefficients into a (lower, upper) box; None is no box."""
    return w if box is None else torch.clamp(w, box[0], box[1])


def finish_result(w, f, grad_norm, it, reason, loss_hist, gnorm_hist, final_loss, final_gnorm,
                  evals, eval_unit="objective_evals") -> OptimizeResult:
    """OptimizeResult with the histories padded past the last iteration by
    the final values and NOT_CONVERGED turned into MAX_ITERATIONS."""
    idx = np.arange(loss_hist.shape[0])
    loss_hist = np.where(idx <= it, loss_hist, final_loss)
    gnorm_hist = np.where(idx <= it, gnorm_hist, final_gnorm)
    if reason == REASON_NOT_CONVERGED:
        reason = REASON_MAX_ITERATIONS
    dtype, device = w.dtype, w.device
    as_t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return OptimizeResult(
        w=w, value=f, grad_norm=grad_norm, iterations=as_t(it, torch.int32),
        reason_code=as_t(reason, torch.int32), loss_history=as_t(loss_hist),
        grad_norm_history=as_t(gnorm_hist), evals=as_t(evals, torch.int32), eval_unit=eval_unit,
    )
