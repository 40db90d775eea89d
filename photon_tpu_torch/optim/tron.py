"""TRON: trust-region Newton with truncated conjugate gradient (port of
photon_tpu/optim/tron.py::minimize_tron).

The same outer trust-region loop, radius update and Steihaug CG. The
reference runs both loops as ``lax.while_loop``s; here they are host loops,
one device read per CG step and one per outer iteration. A coefficient
``box`` is applied by projection to the start and to every trial point. With
``hvp_factory=objective.linearized_hvp`` the Hessian state is built once
per outer iteration and each CG product is one fused pass
(csrc/fused_hvp.cu) when the objective fuses.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.optim.common import (
    HOST_READS,
    OptimizeResult,
    OptimizerConfig,
    REASON_MAX_ITERATIONS,
    REASON_NOT_CONVERGED,
    check_convergence,
    finish_result,
    project_to_box,
)

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]

ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA3 = 0.25, 4.0

TRON_DEFAULT_CONFIG = OptimizerConfig(max_iter=15, tol=1e-5)


def _truncated_cg(hvp: Callable[[Tensor], Tensor], g: Tensor, delta: Tensor,
                  max_cg_iter: int, cg_tol: float):
    """min_s g·s + ½ sᵀHs s.t. ‖s‖ ≤ delta (Steihaug). Returns (s, whether
    the boundary was hit, iterations = H·v products)."""
    s = torch.zeros_like(g)
    r = -g
    p = r
    it, done = 0, False
    r_norm = float(HOST_READS.read(torch.linalg.norm(r))[0])
    while not done and it < max_cg_iter and r_norm > cg_tol:
        Hp = hvp(p)
        pHp = torch.dot(p, Hp)
        rr = torch.dot(r, r)
        alpha = torch.where(pHp > 0, rr / torch.clamp(pHp, min=1e-30), float("inf"))
        s_next = s + alpha * p
        ss, sp, pp = torch.dot(s, s), torch.dot(s, p), torch.dot(p, p)
        disc = torch.sqrt(torch.clamp(sp * sp + pp * (delta * delta - ss), min=0.0))
        tau = (disc - sp) / torch.clamp(pp, min=1e-30)
        outside = (torch.linalg.norm(s_next) >= delta) | (pHp <= 0)
        s = torch.where(outside, s + tau * p, s_next)
        r_new = torch.where(outside, r, r - alpha * Hp)
        beta = torch.dot(r_new, r_new) / torch.clamp(rr, min=1e-30)
        p = r_new + beta * p
        r = r_new
        it += 1
        out_host, r_norm = HOST_READS.read(outside.to(r.dtype), torch.linalg.norm(r))
        done = bool(out_host)
    return s, done, it


def minimize_tron(
    value_and_grad: ValueAndGrad,
    hvp: Optional[Callable[[Tensor, Tensor], Tensor]],
    w0: Tensor,
    config: OptimizerConfig = TRON_DEFAULT_CONFIG,
    max_cg_iter: int = 20,
    box: Optional[Tuple[Tensor, Tensor]] = None,
    hvp_factory: Optional[Callable[[Tensor], Callable[[Tensor], Tensor]]] = None,
) -> OptimizeResult:
    """Trust-region Newton minimization. ``hvp_factory`` (w → (v → H(w)·v))
    is preferred over ``hvp``: it is built once per outer iteration.
    ``box`` (lower, upper) bounds the coefficients by projection."""
    if hvp_factory is None:
        if hvp is None:
            raise ValueError("minimize_tron needs hvp or hvp_factory")
        hvp_factory = lambda w: (lambda v: hvp(w, v))  # noqa: E731
    max_iter, tol = config.max_iter, config.tol
    dtype = w0.dtype

    w = project_to_box(w0, box)
    f, g = value_and_grad(w)
    g0_norm = torch.linalg.norm(g)
    delta = g0_norm
    f_host, gn_host = HOST_READS.read(f, g0_norm)
    hist_len = config.history_len
    loss_hist = np.full(hist_len, f_host)
    gnorm_hist = np.full(hist_len, gn_host)
    it, reason, evals = 0, REASON_NOT_CONVERGED, 1

    while reason == REASON_NOT_CONVERGED and it < max_iter:
        cg_tol = 0.1 * gn_host
        hv = hvp_factory(w)
        s, _hit, cg_iters = _truncated_cg(hv, g, delta, max_cg_iter, cg_tol)

        w_trial = project_to_box(w + s, box)
        s_eff = w_trial - w
        f_trial, g_trial = value_and_grad(w_trial)

        Hs = hv(s_eff)
        pred = -(torch.dot(g, s_eff) + 0.5 * torch.dot(s_eff, Hs))
        actual = f - f_trial
        rho = actual / torch.clamp(pred, min=1e-30)
        snorm = torch.linalg.norm(s_eff)
        accept = (rho > ETA0) & (pred > 0)
        delta = torch.where(
            rho < ETA1,
            torch.clamp(SIGMA1 * torch.minimum(snorm, delta), min=1e-12),
            torch.where(rho < ETA2, delta,
                        torch.minimum(torch.maximum(SIGMA3 * snorm, delta), SIGMA3 * delta)),
        )
        w = torch.where(accept, w_trial, w)
        f_prev = f
        f = torch.where(accept, f_trial, f)
        g = torch.where(accept, g_trial, g)

        it += 1
        gn = torch.linalg.norm(g)
        reason_t = torch.where(
            accept,
            check_convergence(f, f_prev, gn, g0_norm, tol, it, max_iter),
            torch.where(delta <= 1e-10, REASON_MAX_ITERATIONS, REASON_NOT_CONVERGED),
        )
        f_host, gn_host, reason_host = HOST_READS.read(f, gn, reason_t.to(dtype))
        reason = int(reason_host)
        evals += 2 + cg_iters
        loss_hist[min(it, hist_len - 1)] = f_host
        gnorm_hist[min(it, hist_len - 1)] = gn_host

    return finish_result(w, f, torch.linalg.norm(g), it, reason, loss_hist, gnorm_hist, f_host, gn_host, evals)
