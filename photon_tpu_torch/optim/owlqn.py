"""OWL-QN: orthant-wise limited-memory quasi-Newton for L1 and elastic net
(port of photon_tpu/optim/owlqn.py).

Minimizes f(w) + λ‖mask∘w‖₁ (Andrew & Gao 2007): the pseudo-gradient picks
the orthant of steepest descent, the L-BFGS direction from the smooth
curvature history is sign-aligned with it, and a backtracking Armijo search
on the regularized objective clips every trial to the orthant of the search
point, which is what makes coefficients exactly zero. The reference runs
both loops as ``lax.while_loop``s; here they are host loops, one device read
per backtracking trial and one per iteration.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.optim.common import (
    HOST_READS,
    OptimizeResult,
    OptimizerConfig,
    REASON_NOT_CONVERGED,
    check_convergence,
    finish_result,
)
from photon_tpu_torch.optim.lbfgs import CurvatureHistory

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]


def _pseudo_gradient(w: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """Steepest-descent subgradient of f + λ‖·‖₁ (λ per coordinate)."""
    right, left = g + l1, g - l1
    pg_zero = torch.where(left > 0, left, torch.where(right < 0, right, torch.zeros_like(g)))
    return torch.where(w > 0, g + l1, torch.where(w < 0, g - l1, pg_zero))


def _orthant_project(w: Tensor, xi: Tensor) -> Tensor:
    """Clip w to the orthant xi (zero where the signs disagree)."""
    return torch.where(w * xi > 0, w, torch.zeros_like(w))


def minimize_owlqn(
    value_and_grad: ValueAndGrad,
    w0: Tensor,
    l1_weight: float,
    config: OptimizerConfig = OptimizerConfig(),
    l1_mask: Optional[Tensor] = None,
) -> OptimizeResult:
    """``value_and_grad`` is the smooth part only (loss + L2 for elastic
    net); ``l1_mask`` holds 0 where a coefficient (the intercept) is not
    penalized. ``result.value`` is the regularized objective."""
    m, max_iter, tol = config.memory, config.max_iter, config.tol
    d, dtype, device = w0.shape[0], w0.dtype, w0.device
    l1 = torch.full((d,), l1_weight, dtype=dtype, device=device)
    if l1_mask is not None:
        l1 = l1 * l1_mask

    def full_value(w: Tensor):
        f, g = value_and_grad(w)
        return f + torch.sum(l1 * torch.abs(w)), g

    w = w0
    F, g = full_value(w)
    pg0_norm = torch.linalg.norm(_pseudo_gradient(w, g, l1))
    F_host, pg0n_host = HOST_READS.read(F, pg0_norm)
    hist_len = config.history_len
    loss_hist = np.full(hist_len, F_host)
    gnorm_hist = np.full(hist_len, pg0n_host)
    hist = CurvatureHistory(m, d, dtype, device)
    it, reason, evals = 0, REASON_NOT_CONVERGED, 1

    while reason == REASON_NOT_CONVERGED and it < max_iter:
        pg = _pseudo_gradient(w, g, l1)
        p = hist.direction(pg)
        # Sign alignment: zero the components that disagree with −pg.
        p = torch.where(p * -pg > 0, p, torch.zeros_like(p))
        p = torch.where(torch.dot(p, pg) >= 0, -pg, p)
        # Orthant: sign(w), or sign(−pg) where w == 0.
        xi = torch.where(w != 0, torch.sign(w), torch.sign(-pg))
        dirderiv = torch.dot(pg, p)
        one = torch.ones((), dtype=dtype, device=device)
        alpha = one / torch.clamp(torch.linalg.norm(p), min=1e-12) if hist.num_stored == 0 else one

        # Backtracking Armijo on the regularized objective, orthant-projected.
        bt_evals = 0
        while True:
            w_new = _orthant_project(w + alpha * p, xi)
            F_new, g_new = full_value(w_new)
            bt_evals += 1
            armijo = F_new <= F + 1e-4 * alpha * dirderiv
            (armijo_host,) = HOST_READS.read(armijo.to(dtype))
            if armijo_host or bt_evals >= config.max_line_search_evals:
                break
            alpha = alpha * 0.5

        s, y = w_new - w, g_new - g  # curvature from the SMOOTH gradient
        sy = torch.dot(s, y)
        it += 1
        pgn = torch.linalg.norm(_pseudo_gradient(w_new, g_new, l1))
        reason_t = check_convergence(F_new, F, pgn, pg0_norm, tol, it, max_iter)
        sy_host, F_host, pgn_host, reason_host = HOST_READS.read(sy, F_new, pgn, reason_t.to(dtype))
        reason = int(reason_host)
        if sy_host > 1e-12:
            hist.push(s, y, sy)
        w, F, g = w_new, F_new, g_new
        evals += bt_evals
        loss_hist[min(it, hist_len - 1)] = F_host
        gnorm_hist[min(it, hist_len - 1)] = pgn_host

    final_pgn = torch.linalg.norm(_pseudo_gradient(w, g, l1))
    (final_pgn_host,) = HOST_READS.read(final_pgn)
    return finish_result(w, F, final_pgn, it, reason, loss_hist, gnorm_hist, F_host,
                         final_pgn_host, evals)
