"""Entity-batched L-BFGS for the random-effect solves (the reference vmaps
photon_tpu/optim/margin_lbfgs.py::minimize_lbfgs_margin and
photon_tpu/optim/lbfgs.py::minimize_lbfgs over the entities of a block,
photon_tpu/algorithm/random_effect.py::_solve_block).

vmap of a ``lax.while_loop`` runs the body for every lane while any lane's
condition holds and keeps each finished lane frozen. Here every piece of
state carries the leading entity axis E and an ``active`` mask does the
freezing, for the outer L-BFGS loop and for the strong-Wolfe line search
inside it, so every lane follows its own unbatched trajectory: the same
iterates, iteration count and reason. Each loop step reads one flag back to
the host (``HOST_READS``), however many entities the block holds. The
line-search arithmetic is optim/linesearch.py's and the history ring
optim/lbfgs.py's, with a lane axis.

``BlockGLM`` is the GLM objective of every entity of a block at once:
X (E, n, d), label/weight/offset (E, n), coefficients (E, d).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_tpu_torch.ops.losses import PointwiseLoss
from photon_tpu_torch.optim.common import (
    HOST_READS,
    OptimizeResult,
    OptimizerConfig,
    REASON_DIVERGED,
    REASON_MAX_ITERATIONS,
    REASON_NOT_CONVERGED,
    check_convergence,
)
from photon_tpu_torch.optim.lbfgs import CurvatureHistory
from photon_tpu_torch.optim.linesearch import strong_wolfe

Tensor = torch.Tensor
BatchedValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def bmv(X: Tensor, w: Tensor) -> Tensor:
    """(E, n, d) · (E, d) → (E, n)."""
    return torch.bmm(X, w[:, :, None])[:, :, 0]


@dataclasses.dataclass(frozen=True)
class BlockGLM:
    """Σ_i weight·loss(margin, label) + ½λ‖w‖² (intercept unpenalized) for
    every entity of a block, with the normalization fold: margins are
    X·(f∘w) − s·(f∘w) + offset."""

    loss: PointwiseLoss
    X: Tensor
    label: Tensor
    weight: Tensor
    offset: Tensor
    l2: float = 0.0
    intercept_index: Optional[int] = None
    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None

    def l2_mask(self, w: Tensor) -> Tensor:
        if self.intercept_index is None:
            return w
        w = w.clone()
        w[..., self.intercept_index] = 0.0
        return w

    def l2_value(self, w: Tensor) -> Tensor:
        if self.l2 == 0.0:
            return torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device)
        wm = self.l2_mask(w)
        return 0.5 * self.l2 * _dot(wm, wm)

    def forward(self, v: Tensor) -> Tensor:
        """The change of the margins along v: (E, d) → (E, n)."""
        ev = v if self.factors is None else v * self.factors
        u = bmv(self.X, ev)
        return u if self.shifts is None else u - (ev @ self.shifts)[:, None]

    def transpose(self, r: Tensor) -> Tensor:
        """The transpose of ``forward``: (E, n) → (E, d)."""
        g = torch.einsum("bnd,bn->bd", self.X, r)
        if self.shifts is not None:
            g = g - torch.sum(r, dim=-1, keepdim=True) * self.shifts
        return g if self.factors is None else g * self.factors

    def data_value(self, z: Tensor) -> Tensor:
        return torch.sum(self.weight * self.loss.value(z, self.label), dim=-1)

    def grad_from_margins(self, z: Tensor, w: Tensor) -> Tensor:
        g = self.transpose(self.weight * self.loss.dz(z, self.label))
        return g + self.l2 * self.l2_mask(w) if self.l2 != 0.0 else g

    def value_and_grad(self, w: Tensor) -> Tuple[Tensor, Tensor]:
        z = self.forward(w) + self.offset
        return self.data_value(z) + self.l2_value(w), self.grad_from_margins(z, w)


def _init_alpha(g: Tensor, hist: CurvatureHistory) -> Tensor:
    gn = torch.linalg.norm(g, dim=-1)
    first = torch.clamp(1.0 / torch.clamp(gn, min=1e-12), max=1.0)
    return torch.where(hist.num_stored == 0, first, torch.ones_like(gn))


def _descent(g: Tensor, p: Tensor) -> Tuple[Tensor, Tensor]:
    """(p, p·g), falling back to steepest descent on a non-descent lane."""
    dg0 = _dot(p, g)
    bad = dg0 >= 0
    return torch.where(bad[:, None], -g, p), torch.where(bad, -_dot(g, g), dg0)


def _result(w, f, g, it, reason, evals, eval_unit) -> OptimizeResult:
    reason = torch.where(reason == REASON_NOT_CONVERGED, REASON_MAX_ITERATIONS, reason)
    gn = torch.linalg.norm(g, dim=-1)
    return OptimizeResult(
        w=w, value=f, grad_norm=gn, iterations=it.to(torch.int32), reason_code=reason.to(torch.int32),
        loss_history=f[:, None], grad_norm_history=gn[:, None], evals=evals.to(torch.int32),
        eval_unit=eval_unit,
    )


def minimize_lbfgs_margin(problem: BlockGLM, w0: Tensor,
                          config: OptimizerConfig = OptimizerConfig()) -> OptimizeResult:
    """Margin-space L-BFGS on every entity of a block: the line search runs
    on the margins z + α·u with u = X·p, so an iteration is two X passes
    (u, and the gradient at the accepted point). ``evals`` counts X passes
    per lane. Histories are not tracked (the random-effect solves keep
    aggregate counts only)."""
    P = problem
    E, d = w0.shape
    m, max_iter, tol = config.memory, config.max_iter, config.tol
    w = w0
    z = P.forward(w0) + P.offset
    f = P.data_value(z) + P.l2_value(w0)
    g = P.grad_from_margins(z, w0)
    g0_norm = torch.linalg.norm(g, dim=-1)
    it = torch.zeros(E, dtype=torch.long, device=w0.device)
    reason = torch.full((E,), REASON_NOT_CONVERGED, dtype=torch.int32, device=w0.device)
    evals = torch.full((E,), 2, dtype=torch.long, device=w0.device)
    hist = CurvatureHistory(m, d, w0.dtype, w0.device, lanes=(E,))

    while True:
        lanes = (reason == REASON_NOT_CONVERGED) & (it < max_iter)
        if not bool(HOST_READS.read(lanes.any())[0]):
            break
        p, dg0 = _descent(g, hist.direction(g))
        u = P.forward(p)
        if P.l2 != 0.0:
            wm, pm = P.l2_mask(w), P.l2_mask(p)
            l2_a, l2_b = P.l2 * _dot(wm, pm), P.l2 * _dot(pm, pm)
        else:
            l2_a = l2_b = torch.zeros_like(f)
        f_l2 = P.l2_value(w)

        def ls_fg(a, z=z, u=u, f_l2=f_l2, l2_a=l2_a, l2_b=l2_b):
            za = z + a[:, None] * u
            dza = P.weight * P.loss.dz(za, P.label)
            return (P.data_value(za) + f_l2 + a * l2_a + 0.5 * a * a * l2_b,
                    _dot(u, dza) + l2_a + a * l2_b)

        ls = strong_wolfe(ls_fg, f, dg0, _init_alpha(g, hist), lanes,
                          max_evals=config.max_line_search_evals)
        w_new = w + ls.alpha[:, None] * p
        z_new = z + ls.alpha[:, None] * u
        f_new = P.data_value(z_new) + P.l2_value(w_new)
        g_new = P.grad_from_margins(z_new, w_new)

        s, y = w_new - w, g_new - g
        hist.push(s, y, _dot(s, y), lanes)
        it_new = it + 1
        r_new = check_convergence(f_new, f, torch.linalg.norm(g_new, dim=-1), g0_norm, tol, it_new,
                                  max_iter)
        l2d = lanes[:, None]
        w, z, g = torch.where(l2d, w_new, w), torch.where(l2d, z_new, z), torch.where(l2d, g_new, g)
        f = torch.where(lanes, f_new, f)
        reason = torch.where(lanes, r_new, reason)
        evals = torch.where(lanes, evals + 2, evals)
        it = torch.where(lanes, it_new, it)
    return _result(w, f, g, it, reason, evals, "x_passes")


def minimize_lbfgs(value_and_grad: BatchedValueAndGrad, w0: Tensor,
                   config: OptimizerConfig = OptimizerConfig()) -> OptimizeResult:
    """Gradient-form L-BFGS on every entity of a block: every line-search
    trial is a value and gradient. A lane whose new point, value or gradient
    is not finite keeps its last finite iterate and stops with DIVERGED.
    ``evals`` counts objective evaluations per lane."""
    E, d = w0.shape
    m, max_iter, tol = config.memory, config.max_iter, config.tol
    w = w0
    f, g = value_and_grad(w0)
    g0_norm = torch.linalg.norm(g, dim=-1)
    it = torch.zeros(E, dtype=torch.long, device=w0.device)
    reason = torch.full((E,), REASON_NOT_CONVERGED, dtype=torch.int32, device=w0.device)
    evals = torch.ones(E, dtype=torch.long, device=w0.device)
    hist = CurvatureHistory(m, d, w0.dtype, w0.device, lanes=(E,))

    while True:
        lanes = (reason == REASON_NOT_CONVERGED) & (it < max_iter)
        if not bool(HOST_READS.read(lanes.any())[0]):
            break
        p, dg0 = _descent(g, hist.direction(g))

        def ls_fg(a, w=w, p=p):
            ft, gt = value_and_grad(w + a[:, None] * p)
            return ft, _dot(gt, p)

        ls = strong_wolfe(ls_fg, f, dg0, _init_alpha(g, hist), lanes,
                          max_evals=config.max_line_search_evals)
        w_new = w + ls.alpha[:, None] * p
        f_new, g_new = value_and_grad(w_new)
        finite = torch.isfinite(f_new) & torch.isfinite(w_new).all(-1) & torch.isfinite(g_new).all(-1)
        w_new = torch.where(finite[:, None], w_new, w)
        f_new = torch.where(finite, f_new, f)
        g_new = torch.where(finite[:, None], g_new, g)

        s, y = w_new - w, g_new - g
        hist.push(s, y, _dot(s, y), lanes)
        it_new = it + 1
        r_new = check_convergence(f_new, f, torch.linalg.norm(g_new, dim=-1), g0_norm, tol, it_new,
                                  max_iter)
        r_new = torch.where(finite, r_new, REASON_DIVERGED)
        l2d = lanes[:, None]
        w, g = torch.where(l2d, w_new, w), torch.where(l2d, g_new, g)
        f = torch.where(lanes, f_new, f)
        reason = torch.where(lanes, r_new, reason).to(torch.int32)
        evals = torch.where(lanes, evals + ls.evals + 1, evals)
        it = torch.where(lanes, it_new, it)
    return _result(w, f, g, it, reason, evals, "objective_evals")
