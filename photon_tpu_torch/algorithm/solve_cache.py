"""The block and fixed-effect solves of the GAME coordinates (port of the
solves in photon_tpu/algorithm/solve_cache.py), without the cache.

The reference keeps one jitted executable per static configuration; PyTorch
runs eagerly, so here ``block_solver`` and ``fe_solver`` return plain
functions. What they add to the solvers is kept: the divergence quarantine
(an entity, or the fixed effect, whose solve ends non-finite keeps its warm
start and is flagged DIVERGED) and, for the active-set gate, the per-entity
``active`` and ``quarantined`` masks computed beside the solve.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from photon_tpu_torch.optim.common import REASON_DIVERGED

Tensor = torch.Tensor


def block_solver(objective, spec, config, convergence_tol: Optional[float] = None,
                 re_kernel: str = "torch") -> Callable:
    """``solve(block, offsets, w0, feature_mask=None)`` → (w, iterations,
    reasons, X passes), plus (active, quarantined) with ``convergence_tol``: an entity
    stays active while its coefficients moved by more than tol relative to
    max(1, ‖w0‖); padding rows are never active. ``re_kernel`` is resolved
    (ops.fused_newton.resolve_re_kernel)."""
    from photon_tpu_torch.algorithm.random_effect import _solve_block

    tol = None if convergence_tol is None else float(convergence_tol)

    def solve(block, offsets: Tensor, w0: Tensor, feature_mask: Optional[Tensor] = None):
        w, iterations, reasons, passes = _solve_block(block, offsets, w0, objective, spec, config,
                                                      feature_mask, re_kernel=re_kernel)
        row_finite = torch.isfinite(w).all(dim=-1)
        w = torch.where(row_finite[:, None], w, w0)
        reasons = torch.where(row_finite, reasons, REASON_DIVERGED)
        if tol is None:
            return w, iterations, reasons, passes
        delta = torch.linalg.norm((w - w0).float(), dim=-1)
        ref = torch.clamp(torch.linalg.norm(w0.float(), dim=-1), min=1.0)
        valid = block.entity_idx >= 0
        active = (delta > tol * ref) & valid
        quarantined = (reasons == REASON_DIVERGED) & valid
        return w, iterations, reasons, passes, active, quarantined

    return solve


def fe_solver(objective, spec) -> Callable:
    """``solve(w0, labeled_batch)`` → OptimizeResult; a non-finite final
    point falls back to w0 with reason DIVERGED."""
    from photon_tpu_torch.optim.factory import make_optimizer

    run = make_optimizer(objective, spec)

    def solve(w0: Tensor, lb):
        res = run(w0, lb)
        ok = torch.isfinite(res.w).all()
        return dataclasses.replace(
            res, w=torch.where(ok, res.w, w0),
            reason_code=torch.where(ok, res.reason_code, REASON_DIVERGED).to(torch.int32),
        )

    return solve
