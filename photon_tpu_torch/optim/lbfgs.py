"""L-BFGS and box-constrained L-BFGS (port of photon_tpu/optim/lbfgs.py).

The same two-loop recursion, strong-Wolfe line search, curvature test,
divergence rollback and tracker as the reference. The reference runs the
solve as one ``lax.while_loop``; here it is a host loop with one device read
per line-search trial and one per iteration (``HOST_READS``). Every trial is
one ``value_and_grad``, so with a fused objective each is one K1 launch.

Box constraints use projected line search: trial points are clipped to the
box before evaluation, and coordinates on a bound whose gradient pushes
outward are frozen for the direction.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.optim.common import (
    HOST_READS,
    OptimizeResult,
    OptimizerConfig,
    REASON_DIVERGED,
    REASON_NOT_CONVERGED,
    check_convergence,
    finish_result,
    project_to_box,
)
from photon_tpu_torch.optim.linesearch import strong_wolfe

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]
Box = Optional[Tuple[Tensor, Tensor]]


def two_loop_direction(grad: Tensor, s_hist: Tensor, y_hist: Tensor, rho_hist: Tensor,
                       num_stored: int, head: int) -> Tensor:
    """Search direction −H·grad from a circular (m, d) history; ``head`` is
    the slot of the most recent pair and ``num_stored`` the filled count
    (both host ints, so unfilled slots are simply skipped)."""
    m = s_hist.shape[0]
    q = grad
    alphas = [None] * m
    for i in range(num_stored):
        slot = (head - i) % m
        alphas[slot] = rho_hist[slot] * torch.dot(s_hist[slot], q)
        q = q - alphas[slot] * y_hist[slot]

    # Initial Hessian scaling gamma = s·y / y·y from the most recent pair.
    recent = head % m
    sy = torch.dot(s_hist[recent], y_hist[recent])
    yy = torch.dot(y_hist[recent], y_hist[recent])
    if num_stored > 0:
        gamma = torch.where(yy > 0, sy / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
    else:
        gamma = torch.ones_like(yy)
    r = gamma * q

    for i in range(num_stored):
        slot = (head - (num_stored - 1 - i)) % m
        beta = rho_hist[slot] * torch.dot(y_hist[slot], r)
        r = r + (alphas[slot] - beta) * s_hist[slot]
    return -r


class CurvatureHistory:
    """The circular (s, y, ρ) history of an L-BFGS solve."""

    def __init__(self, m: int, d: int, dtype, device):
        self.m = m
        self.s = torch.zeros((m, d), dtype=dtype, device=device)
        self.y = torch.zeros((m, d), dtype=dtype, device=device)
        self.rho = torch.zeros((m,), dtype=dtype, device=device)
        self.num_stored, self.head = 0, 0

    def direction(self, g: Tensor) -> Tensor:
        return two_loop_direction(g, self.s, self.y, self.rho, self.num_stored, self.head)

    def push(self, s: Tensor, y: Tensor, sy: Tensor) -> None:
        """Store a pair (the caller has checked s·y > 1e-12 on the host)."""
        slot = (self.head + 1) % self.m
        self.s[slot] = s
        self.y[slot] = y
        self.rho[slot] = 1.0 / torch.clamp(sy, min=1e-30)
        self.head = slot
        self.num_stored = min(self.num_stored + 1, self.m)


def minimize_lbfgs(
    value_and_grad: ValueAndGrad,
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    box: Box = None,
) -> OptimizeResult:
    """Minimize a smooth function with L-BFGS, optionally inside a box
    (lower, upper). ``result.evals`` counts objective evaluations."""
    m, max_iter, tol = config.memory, config.max_iter, config.tol
    d, dtype, device = w0.shape[0], w0.dtype, w0.device

    def proj(w: Tensor) -> Tensor:
        return project_to_box(w, box)

    def opt_gnorm(w: Tensor, g: Tensor) -> Tensor:
        # Plain gradient norm, or the projected-gradient norm ‖w − proj(w − g)‖
        # under a box (0 at a KKT point).
        return torch.linalg.norm(g) if box is None else torch.linalg.norm(w - proj(w - g))

    w = proj(w0)
    f, g = value_and_grad(w)
    g0_norm = opt_gnorm(w, g)
    f_host, g0n_host = HOST_READS.read(f, g0_norm)
    hist_len = config.history_len
    loss_hist = np.full(hist_len, f_host)
    gnorm_hist = np.full(hist_len, g0n_host)
    hist = CurvatureHistory(m, d, dtype, device)
    it, reason, evals = 0, REASON_NOT_CONVERGED, 1

    while reason == REASON_NOT_CONVERGED and it < max_iter:
        if box is None:
            g_dir = g
        else:
            # Gradient-projection active set: freeze coordinates sitting on a
            # bound with the gradient pushing outward.
            eps = 1e-9
            active = ((w <= box[0] + eps) & (g > 0)) | ((w >= box[1] - eps) & (g < 0))
            g_dir = torch.where(active, 0.0, g)
        p = hist.direction(g_dir)
        if box is not None:
            p = torch.where(active, 0.0, p)
        dg0 = torch.dot(p, g)
        # Fall back to (projected) steepest descent on a non-descent direction.
        bad_dir = dg0 >= 0
        p = torch.where(bad_dir, -g_dir, p)
        dg0 = torch.where(bad_dir, -torch.dot(g_dir, g_dir), dg0)

        def ls_fg(a, w=w, p=p):
            a = float(a)
            if box is None:
                ft, gt = value_and_grad(w + a * p)
                return ft, torch.dot(gt, p)
            wt = proj(w + a * p)
            ft, gt = value_and_grad(wt)
            # Derivative along the projected path.
            return ft, torch.dot(gt, (wt - w) / max(a, 1e-30))

        dg0_host, gn_host = HOST_READS.read(dg0, torch.linalg.norm(g))
        dt = dg0_host.dtype.type
        init_alpha = dt(min(1.0, 1.0 / max(gn_host, 1e-12))) if hist.num_stored == 0 else dt(1.0)
        ls = strong_wolfe(ls_fg, f_host, dg0_host, init_alpha, max_evals=config.max_line_search_evals)

        w_new = proj(w + float(ls.alpha) * p)
        f_new, g_new = value_and_grad(w_new)
        # Divergence rollback: a non-finite trial state never replaces the
        # last finite iterate, and no curvature pair is stored from it.
        finite = torch.isfinite(f_new) & torch.isfinite(w_new).all() & torch.isfinite(g_new).all()
        w_new = torch.where(finite, w_new, w)
        f_new = torch.where(finite, f_new, f)
        g_new = torch.where(finite, g_new, g)

        s, y = w_new - w, g_new - g
        sy = torch.dot(s, y)
        it += 1
        gn = opt_gnorm(w_new, g_new)
        reason_t = check_convergence(f_new, f, gn, g0_norm, tol, it, max_iter)
        reason_t = torch.where(finite, reason_t, REASON_DIVERGED)
        sy_host, f_host, gn_host, reason_host = HOST_READS.read(sy, f_new, gn, reason_t.to(dtype))
        reason = int(reason_host)
        if sy_host > 1e-12:
            hist.push(s, y, sy)
        w, f, g = w_new, f_new, g_new
        evals += ls.evals + 1
        loss_hist[min(it, hist_len - 1)] = f_host
        gnorm_hist[min(it, hist_len - 1)] = gn_host

    final_gnorm = opt_gnorm(w, g)
    (final_gn_host,) = HOST_READS.read(final_gnorm)
    return finish_result(w, f, final_gnorm, it, reason, loss_hist, gnorm_hist, f_host,
                         final_gn_host, evals)


def minimize_lbfgsb(
    value_and_grad: ValueAndGrad,
    w0: Tensor,
    lower: Tensor,
    upper: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
) -> OptimizeResult:
    """Box-constrained L-BFGS: projected-line-search L-BFGS, as the
    reference implements it (not the full Byrd subspace algorithm)."""
    return minimize_lbfgs(value_and_grad, w0, config, box=(lower, upper))
