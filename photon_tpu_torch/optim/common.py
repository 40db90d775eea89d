"""Shared optimizer plumbing (port of photon_tpu/optim/common.py).

The reference runs each solver as one ``lax.while_loop`` on the device. The
port's margin L-BFGS and Newton run as device-side state machines
(optim/program.py) whose loop test is read back once per chunk of
iterations; the other solvers keep host loops with a read per loop test.
``HOST_READS`` counts every device-to-host read of the solvers and of the
GAME coordinates, so a caller can report the syncs per step. Histories are
device tensors written by index, read only by whoever reports them.
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

    def fetch(self, *tensors: Tensor) -> list:
        """One transfer of tensors of any shapes and dtypes to the host (one
        synchronization), as numpy arrays of their own shapes and dtypes."""
        self.count += 1
        host = [t.detach().to("cpu", non_blocking=True) for t in tensors]
        if any(t.is_cuda for t in tensors):
            torch.cuda.synchronize()
        return [h.numpy().copy() if t.device.type == "cpu" else h.numpy() for t, h in zip(tensors, host)]


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
        """Per-iteration table of a single solve (one read of the result)."""
        it, value, gnorm, reason, losses, gnorms = HOST_READS.fetch(
            self.iterations, self.value, self.grad_norm, self.reason_code, self.loss_history,
            self.grad_norm_history)
        n, why = int(it), _REASONS[int(reason)].value
        if losses.shape[0] < n + 1:
            return (f"iterations={n} value={float(value):.6e} |grad|={float(gnorm):.6e} "
                    f"reason: {why} (history not tracked)")
        lines = ["iter    loss           |grad|"]
        for i in range(n + 1):
            lines.append(f"{i:4d}    {float(losses[i]):.6e}   {float(gnorms[i]):.6e}")
        lines.append(f"reason: {why}")
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


def new_history(config: OptimizerConfig, value: Tensor) -> Tensor:
    """A (history_len,) device history filled with ``value`` (the reference's
    ``jnp.full``); slot min(it, len - 1) holds iteration it's value."""
    return value.reshape(1).repeat(config.history_len)


def record(hist: Tensor, it, value: Tensor) -> Tensor:
    """``hist`` with slot min(it, len - 1) set to ``value``; ``it`` may be a
    host int or a device int (then no host read)."""
    slot = torch.clamp(torch.as_tensor(it, device=hist.device).reshape(1).long(), max=hist.shape[0] - 1)
    return hist.index_copy(0, slot, value.reshape(1).to(hist.dtype))


def finish_result(w, f, grad_norm, it, reason, loss_hist, gnorm_hist, evals,
                  eval_unit="objective_evals") -> OptimizeResult:
    """OptimizeResult with the histories padded past the last iteration by
    the final values and NOT_CONVERGED turned into MAX_ITERATIONS. Every
    argument may be a device tensor or a host number; nothing is read back."""
    dtype, device = w.dtype, w.device
    as_t = lambda a, dt: torch.as_tensor(a, device=device).to(dt)  # noqa: E731
    it, reason = as_t(it, torch.int32), as_t(reason, torch.int32)
    f, grad_norm = as_t(f, dtype), as_t(grad_norm, dtype)
    idx = torch.arange(loss_hist.shape[0], device=device)
    reason = torch.where(reason == REASON_NOT_CONVERGED, REASON_MAX_ITERATIONS, reason).to(torch.int32)
    return OptimizeResult(
        w=w, value=f, grad_norm=grad_norm, iterations=it, reason_code=reason,
        loss_history=torch.where(idx <= it, loss_hist, f), grad_norm_history=torch.where(idx <= it, gnorm_hist, grad_norm),
        evals=as_t(evals, torch.int32), eval_unit=eval_unit,
    )
