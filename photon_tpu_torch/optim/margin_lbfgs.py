"""Margin-space L-BFGS (port of
photon_tpu/optim/margin_lbfgs.py::minimize_lbfgs_margin).

A GLM's margins are affine along a direction p: z(w + αp) = z + α·u with
u = X·p, so a whole strong-Wolfe line search costs one X pass and every
trial is O(n) work on (z, u). One iteration is two X passes: u = X·p and the
gradient at the accepted point. With the fused kernel the gradient pass
also returns fresh margins (csrc/fused_value_grad.cu), so the carried
margins never drift, which is what makes a bf16 X safe.
``sweep_l2_lbfgs_margin`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_tpu_torch.data.batch import LabeledBatch, matvec_rounded, rmatvec
from photon_tpu_torch.ops.fused_glm import fused_value_grad
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import (
    HOST_READS,
    OptimizeResult,
    OptimizerConfig,
    REASON_NOT_CONVERGED,
    check_convergence,
    finish_result,
)
from photon_tpu_torch.optim.lbfgs import CurvatureHistory
from photon_tpu_torch.optim.linesearch import strong_wolfe

Tensor = torch.Tensor


def minimize_lbfgs_margin(
    objective: GLMObjective,
    batch: LabeledBatch,
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
) -> OptimizeResult:
    """L-BFGS over a smooth GLMObjective at two X passes per iteration.
    ``result.evals`` counts X passes; O(n) line-search trials are not
    counted."""
    if objective.l1_weight > 0.0:
        raise ValueError("margin L-BFGS is for smooth objectives; use OWL-QN for L1")

    loss = objective.loss
    l2 = objective.l2_weight
    has_l2 = l2 != 0.0
    norm = objective.normalization
    factors = None if norm is None or norm.is_identity else norm.factors
    shifts = None if norm is None or norm.is_identity else norm.shifts
    label, weight, offset, feats = batch.label, batch.weight, batch.offset, batch.features
    use_fused = objective._can_fuse(batch)
    dtype, device = w0.dtype, w0.device

    def direction_margins(p: Tensor) -> Tensor:
        """u = d(margins)/dα along p (normalization folded)."""
        ep = p if factors is None else p * factors
        u = matvec_rounded(feats, ep)
        if shifts is not None:
            u = u - torch.dot(shifts, ep)
        return u

    def l2_mask(w: Tensor) -> Tensor:
        return objective._l2_mask(w)

    def l2_value(w: Tensor) -> Tensor:
        if not has_l2:
            return torch.zeros((), dtype=dtype, device=device)
        wm = l2_mask(w)
        return 0.5 * l2 * torch.dot(wm, wm)

    def data_value(z: Tensor) -> Tensor:
        return torch.sum(weight * loss.value(z, label))

    def fused_value_grad_margins(w: Tensor):
        """One X pass: value, gradient and fresh margins at w."""
        ew = w if factors is None else w * factors
        val, g, z = fused_value_grad(loss, ew, feats, label, offset, weight, return_margins=True)
        if factors is not None:
            g = g * factors
        if has_l2:
            g = g + l2 * l2_mask(w)
        return val + l2_value(w), g, z

    def grad_from_margins(z: Tensor, w: Tensor) -> Tensor:
        dz = weight * loss.dz(z, label)
        g = rmatvec(feats, dz)
        if shifts is not None:
            g = g - torch.sum(dz) * shifts
        if factors is not None:
            g = g * factors
        if has_l2:
            g = g + l2 * l2_mask(w)
        return g

    m, max_iter, tol = config.memory, config.max_iter, config.tol
    d = w0.shape[0]

    if use_fused:
        f, g, z = fused_value_grad_margins(w0)
        evals = 1
    else:
        z = objective.margins(w0, batch)
        f = data_value(z) + l2_value(w0)
        g = grad_from_margins(z, w0)
        evals = 2
    w = w0
    g0_norm = torch.linalg.norm(g)
    f_host, g0n_host = HOST_READS.read(f, g0_norm)

    hist_len = config.history_len
    loss_hist = np.full(hist_len, f_host)
    gnorm_hist = np.full(hist_len, g0n_host)
    hist = CurvatureHistory(m, d, dtype, device)
    it, reason = 0, REASON_NOT_CONVERGED

    while reason == REASON_NOT_CONVERGED and it < max_iter:
        p = hist.direction(g)
        dg0 = torch.dot(p, g)
        bad_dir = dg0 >= 0
        p = torch.where(bad_dir, -g, p)
        dg0 = torch.where(bad_dir, -torch.dot(g, g), dg0)

        u = direction_margins(p)  # the one X pass of this line search
        if has_l2:
            wm, pm = l2_mask(w), l2_mask(p)
            l2_a, l2_b = l2 * torch.dot(wm, pm), l2 * torch.dot(pm, pm)
        else:
            l2_a = l2_b = torch.zeros((), dtype=dtype, device=device)
        f_l2 = l2_value(w)

        def ls_fg(a, z=z, u=u, f_l2=f_l2, l2_a=l2_a, l2_b=l2_b):
            a = float(a)
            za = z + a * u
            dza = weight * loss.dz(za, label)
            val = data_value(za) + f_l2 + a * l2_a + 0.5 * a * a * l2_b
            deriv = torch.dot(u, dza) + l2_a + a * l2_b
            return val, deriv

        dg0_host, gnorm_host = HOST_READS.read(dg0, torch.linalg.norm(g))
        dt = dg0_host.dtype.type
        init_alpha = dt(min(1.0, 1.0 / max(gnorm_host, 1e-12))) if hist.num_stored == 0 else dt(1.0)
        ls = strong_wolfe(ls_fg, f_host, dg0_host, init_alpha,
                          max_evals=config.max_line_search_evals)

        alpha = float(ls.alpha)
        w_new = w + alpha * p
        if use_fused:
            # Second X pass: value, gradient and exact fresh margins.
            f_new, g_new, z_new = fused_value_grad_margins(w_new)
        else:
            z_new = z + alpha * u
            f_new = data_value(z_new) + l2_value(w_new)
            g_new = grad_from_margins(z_new, w_new)
        f_new = f_new.to(dtype)
        g_new = g_new.to(dtype)

        s = w_new - w
        y = g_new - g
        sy = torch.dot(s, y)
        it += 1
        gn = torch.linalg.norm(g_new)
        reason_t = check_convergence(f_new, f, gn, g0_norm, tol, it, max_iter)
        sy_host, f_host, gn_host, reason_host = HOST_READS.read(sy, f_new, gn, reason_t.to(dtype))
        reason = int(reason_host)
        if sy_host > 1e-12:
            hist.push(s, y, sy)

        w, z, f, g = w_new, z_new, f_new, g_new
        evals += 2
        loss_hist[min(it, hist_len - 1)] = f_host
        gnorm_hist[min(it, hist_len - 1)] = gn_host

    return finish_result(w, f, torch.linalg.norm(g), it, reason, loss_hist, gnorm_hist, f_host,
                         gn_host if it > 0 else g0n_host, evals, eval_unit="x_passes")
