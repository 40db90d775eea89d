"""L-BFGS and box-constrained L-BFGS (port of photon_tpu/optim/lbfgs.py).

The same two-loop recursion, strong-Wolfe line search, curvature test,
divergence rollback and tracker as the reference. The reference runs the
solve as one ``lax.while_loop``; ``minimize_lbfgs`` is a host loop with one
device read per line-search trial and one per iteration (``HOST_READS``),
its state (history ring, tracker) on the device. Every trial is one
``value_and_grad``, so with a fused objective each is one K1 launch.
``two_loop_direction`` and ``CurvatureHistory`` serve every L-BFGS of the
port, batched (optim/batched.py) and captured (optim/margin_lbfgs.py) too.

Box constraints use projected line search: trial points are clipped to the
box before evaluation, and coordinates on a bound whose gradient pushes
outward are frozen for the direction.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from photon_tpu_torch.optim.common import (
    HOST_READS,
    OptimizeResult,
    OptimizerConfig,
    REASON_DIVERGED,
    REASON_NOT_CONVERGED,
    check_convergence,
    finish_result,
    new_history,
    project_to_box,
    record,
)
from photon_tpu_torch.optim.linesearch import strong_wolfe

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]
Box = Optional[Tuple[Tensor, Tensor]]


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _at(H: Tensor, slot: Tensor) -> Tensor:
    """Slot ``slot`` (...) of a history H (..., m[, d])."""
    if H.dim() == slot.dim() + 1:
        return torch.take_along_dim(H, slot[..., None], dim=-1)[..., 0]
    return torch.take_along_dim(H, slot[..., None, None], dim=-2)[..., 0, :]


def two_loop_direction(grad: Tensor, s_hist: Tensor, y_hist: Tensor, rho_hist: Tensor,
                       num_stored, head) -> Tensor:
    """Search direction −H·grad from circular histories: grad (..., d),
    s_hist/y_hist (..., m, d), rho_hist (..., m); ``head`` (...) is the slot
    of the most recent pair and ``num_stored`` (...) the filled count, host
    or device ints. As in the reference, every one of the m slots is
    visited and the unfilled ones are masked, so nothing is read back."""
    m = s_hist.shape[-2]
    device = grad.device
    lead = grad.shape[:-1]
    head = torch.as_tensor(head, device=device).long().expand(lead)
    num_stored = torch.as_tensor(num_stored, device=device).long().expand(lead)
    q = grad
    alphas = torch.zeros_like(rho_hist)
    for i in range(m):
        slot = (head - i) % m
        alpha = torch.where(i < num_stored, _at(rho_hist, slot) * _dot(_at(s_hist, slot), q), 0.0)
        q = q - alpha[..., None] * _at(y_hist, slot)
        alphas = alphas.scatter(-1, slot[..., None], alpha[..., None])
    # Initial Hessian scaling gamma = s·y / y·y from the most recent pair.
    recent = head % m
    sy = _dot(_at(s_hist, recent), _at(y_hist, recent))
    yy = _dot(_at(y_hist, recent), _at(y_hist, recent))
    gamma = torch.where((num_stored > 0) & (yy > 0), sy / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
    r = gamma[..., None] * q
    for i in range(m):
        slot = (head - (num_stored - 1 - i)) % m
        beta = _at(rho_hist, slot) * _dot(_at(y_hist, slot), r)
        r = r + torch.where(i < num_stored, _at(alphas, slot) - beta, 0.0)[..., None] * _at(s_hist, slot)
    return -r


class CurvatureHistory:
    """The circular (s, y, ρ) history of an L-BFGS solve, one per lane of
    ``lanes`` (() for a single solve, (E,) for an entity block), kept as the
    reference keeps it: a masked ring whose head and fill count are device
    ints, updated in place (so a captured step can hold it)."""

    def __init__(self, m: int, d: int, dtype, device, lanes: tuple = ()):
        self.m = m
        self.s = torch.zeros((*lanes, m, d), dtype=dtype, device=device)
        self.y = torch.zeros((*lanes, m, d), dtype=dtype, device=device)
        self.rho = torch.zeros((*lanes, m), dtype=dtype, device=device)
        self.num_stored = torch.zeros(lanes, dtype=torch.long, device=device)
        self.head = torch.zeros(lanes, dtype=torch.long, device=device)

    def reset(self) -> None:
        for t in (self.s, self.y, self.rho, self.num_stored, self.head):
            t.zero_()

    def direction(self, g: Tensor) -> Tensor:
        return two_loop_direction(g, self.s, self.y, self.rho, self.num_stored, self.head)

    def push(self, s: Tensor, y: Tensor, sy: Tensor, lanes=True) -> None:
        """Store the pair of every lane in ``lanes`` whose s·y > 1e-12."""
        store = (sy > 1e-12) & torch.as_tensor(lanes, device=sy.device)
        slot = (self.head + 1) % self.m
        at = (torch.arange(self.m, device=sy.device) == slot[..., None]) & store[..., None]
        self.s.copy_(torch.where(at[..., None], s[..., None, :], self.s))
        self.y.copy_(torch.where(at[..., None], y[..., None, :], self.y))
        self.rho.copy_(torch.where(at, (1.0 / torch.clamp(sy, min=1e-30))[..., None], self.rho))
        self.head.copy_(torch.where(store, slot, self.head))
        self.num_stored.copy_(torch.where(store, torch.clamp(self.num_stored + 1, max=self.m), self.num_stored))


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
    loss_hist, gnorm_hist = new_history(config, f), new_history(config, g0_norm)
    hist = CurvatureHistory(m, d, dtype, device)
    it, reason, evals = 0, REASON_NOT_CONVERGED, torch.ones((), dtype=torch.int32, device=device)

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
            if box is None:
                ft, gt = value_and_grad(w + a * p)
                return ft, torch.dot(gt, p)
            wt = proj(w + a * p)
            ft, gt = value_and_grad(wt)
            # Derivative along the projected path.
            return ft, torch.dot(gt, (wt - w) / torch.clamp(a, min=1e-30))

        init_alpha = torch.where(hist.num_stored == 0,
                                 torch.clamp(1.0 / torch.clamp(torch.linalg.norm(g), min=1e-12), max=1.0),
                                 1.0).to(dtype)
        ls = strong_wolfe(ls_fg, f, dg0, init_alpha, max_evals=config.max_line_search_evals)

        w_new = proj(w + ls.alpha * p)
        f_new, g_new = value_and_grad(w_new)
        # Divergence rollback: a non-finite trial state never replaces the
        # last finite iterate, and no curvature pair is stored from it.
        finite = torch.isfinite(f_new) & torch.isfinite(w_new).all() & torch.isfinite(g_new).all()
        w_new = torch.where(finite, w_new, w)
        f_new = torch.where(finite, f_new, f)
        g_new = torch.where(finite, g_new, g)

        s, y = w_new - w, g_new - g
        hist.push(s, y, torch.dot(s, y))
        it += 1
        gn = opt_gnorm(w_new, g_new)
        reason_t = check_convergence(f_new, f, gn, g0_norm, tol, it, max_iter)
        reason_t = torch.where(finite, reason_t, REASON_DIVERGED)
        reason = int(HOST_READS.read(reason_t)[0])
        w, f, g = w_new, f_new, g_new
        evals = evals + ls.evals + 1
        loss_hist, gnorm_hist = record(loss_hist, it, f), record(gnorm_hist, it, gn)

    return finish_result(w, f, opt_gnorm(w, g), it, reason, loss_hist, gnorm_hist, evals)


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
