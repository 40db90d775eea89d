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
the host (``HOST_READS``), however many entities the block holds.

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

Tensor = torch.Tensor
BatchedValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]

_BRACKET, _ZOOM, _DONE = 0, 1, 2


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


def two_loop_direction(g: Tensor, S: Tensor, Y: Tensor, rho: Tensor, num_stored: Tensor,
                       head: Tensor) -> Tensor:
    """−H·g per lane from circular (E, m, d) histories; ``head`` (E,) is the
    slot of each lane's newest pair, ``num_stored`` (E,) its filled count."""
    E, m, _ = S.shape
    lanes = torch.arange(E, device=g.device)
    q = g
    alphas = torch.zeros((E, m), dtype=g.dtype, device=g.device)
    for i in range(m):
        slot = (head - i) % m
        alpha = torch.where(i < num_stored, rho[lanes, slot] * _dot(S[lanes, slot], q), 0.0)
        q = q - alpha[:, None] * Y[lanes, slot]
        alphas[lanes, slot] = alpha
    recent = head % m
    sy = _dot(S[lanes, recent], Y[lanes, recent])
    yy = _dot(Y[lanes, recent], Y[lanes, recent])
    gamma = torch.where((num_stored > 0) & (yy > 0), sy / torch.clamp(yy, min=1e-30),
                        torch.ones_like(yy))
    r = gamma[:, None] * q
    for i in range(m):
        slot = (head - (num_stored - 1 - i)) % m
        beta = rho[lanes, slot] * _dot(Y[lanes, slot], r)
        upd = (alphas[lanes, slot] - beta)[:, None] * S[lanes, slot]
        r = r + (i < num_stored).to(r.dtype)[:, None] * upd
    return -r


def _interp(a_lo, f_lo, g_lo, a_hi, f_hi):
    """Safeguarded quadratic interpolation for the zoom trial point."""
    d = a_hi - a_lo
    denom = f_hi - f_lo - g_lo * d
    a_q = a_lo - 0.5 * g_lo * d * d / torch.where(torch.abs(denom) > 1e-20, denom, 1.0)
    lo, hi = torch.minimum(a_lo, a_hi), torch.maximum(a_lo, a_hi)
    margin = 0.1 * (hi - lo)
    bad = torch.isnan(a_q) | (torch.abs(denom) <= 1e-20) | (a_q < lo + margin) | (a_q > hi - margin)
    return torch.where(bad, 0.5 * (a_lo + a_hi), a_q)


@dataclasses.dataclass(frozen=True)
class LineSearchResult:
    alpha: Tensor
    value: Tensor
    deriv: Tensor
    evals: Tensor
    success: Tensor


def strong_wolfe(fg: Callable[[Tensor], Tuple[Tensor, Tensor]], f0: Tensor, dg0: Tensor,
                 init_alpha: Tensor, lanes: Tensor, c1: float = 1e-4, c2: float = 0.9,
                 max_evals: int = 20, max_alpha: float = 1e10) -> LineSearchResult:
    """The reference's bracket/zoom strong-Wolfe search (Nocedal & Wright
    alg. 3.5/3.6) on every lane in ``lanes`` (E,) bool at once.
    ``fg(alpha (E,))`` returns (f, directional derivative), each (E,)."""
    zero = torch.zeros_like(f0)
    phase = torch.where(lanes, _BRACKET, _DONE)
    a_prev, f_prev, g_prev = zero, f0, dg0
    a_lo, f_lo, g_lo = zero, f0, dg0
    a_hi, f_hi = zero, f0
    a_cur = init_alpha
    evals = torch.zeros_like(phase)
    a_best, f_best, g_best = zero, f0, dg0
    success = torch.zeros_like(lanes)

    while True:
        run = (phase != _DONE) & (evals < max_evals)
        if not bool(HOST_READS.read(run.any())[0]):
            break
        f, g = fg(a_cur)
        evals_n = evals + 1
        ok = f <= f0 + c1 * a_cur * dg0
        curv = torch.abs(g) <= -c2 * dg0
        better = ok & (f < f_best)
        b_a = torch.where(better, a_cur, a_best)
        b_f = torch.where(better, f, f_best)
        b_g = torch.where(better, g, g_best)

        # Bracket phase: zoom(lo=prev, hi=cur) on a failure, zoom(lo=cur,
        # hi=prev) on a rise, else double the step.
        fail_b = (~ok) | ((evals_n > 1) & (f >= f_prev))
        wolfe_b = ok & curv
        zoom_b = fail_b | (ok & (g >= 0))
        lo_b = [torch.where(fail_b, x, y) for x, y in ((a_prev, a_cur), (f_prev, f), (g_prev, g))]
        hi_b = [torch.where(fail_b, x, y) for x, y in ((a_cur, a_prev), (f, f_prev))]
        phase_b = torch.where(wolfe_b, _DONE, torch.where(zoom_b, _ZOOM, _BRACKET))
        trial_b = torch.where(zoom_b, _interp(*lo_b, *hi_b), torch.clamp(2.0 * a_cur, max=max_alpha))

        # Zoom phase: hi ← cur on a failure, else lo ← cur (and hi ← old lo
        # when the slope says the minimum is on the other side).
        fail_z = (~ok) | (f >= f_lo)
        wolfe_z = (~fail_z) & curv
        flip = (~fail_z) & (g * (a_hi - a_lo) >= 0)
        hi_z = [torch.where(fail_z, c, torch.where(flip, lo, hi)) for c, lo, hi in ((a_cur, a_lo, a_hi),
                                                                                     (f, f_lo, f_hi))]
        lo_z = [torch.where(fail_z, x, y) for x, y in ((a_lo, a_cur), (f_lo, f), (g_lo, g))]
        dead = torch.abs(hi_z[0] - lo_z[0]) <= 1e-12 * torch.clamp(hi_z[0], min=1.0)
        phase_z = torch.where(wolfe_z | dead, _DONE, _ZOOM)
        trial_z = _interp(*lo_z, *hi_z)

        br = phase == _BRACKET
        sel = lambda x, y: torch.where(br, x, y)  # noqa: E731
        wolfe = sel(wolfe_b, wolfe_z)
        new = dict(
            phase=sel(phase_b, phase_z),
            a_prev=a_cur, f_prev=f, g_prev=g,
            a_lo=sel(lo_b[0], lo_z[0]), f_lo=sel(lo_b[1], lo_z[1]), g_lo=sel(lo_b[2], lo_z[2]),
            a_hi=sel(hi_b[0], hi_z[0]), f_hi=sel(hi_b[1], hi_z[1]),
            a_cur=sel(trial_b, trial_z).to(a_cur.dtype), evals=evals_n,
            a_best=torch.where(wolfe, a_cur, b_a), f_best=torch.where(wolfe, f, b_f),
            g_best=torch.where(wolfe, g, b_g), success=success | wolfe,
        )
        keep = lambda name, old: torch.where(run, new[name], old)  # noqa: E731
        phase, evals, success = keep("phase", phase), keep("evals", evals), keep("success", success)
        a_prev, f_prev, g_prev = keep("a_prev", a_prev), keep("f_prev", f_prev), keep("g_prev", g_prev)
        a_lo, f_lo, g_lo = keep("a_lo", a_lo), keep("f_lo", f_lo), keep("g_lo", g_lo)
        a_hi, f_hi, a_cur = keep("a_hi", a_hi), keep("f_hi", f_hi), keep("a_cur", a_cur)
        a_best, f_best, g_best = keep("a_best", a_best), keep("f_best", f_best), keep("g_best", g_best)

    # Best Wolfe point, else the best sufficient-decrease point, else lo.
    take = success | (f_best < f0)
    return LineSearchResult(
        alpha=torch.where(take, a_best, a_lo), value=torch.where(take, f_best, f_lo),
        deriv=torch.where(take, g_best, g_lo), evals=evals, success=success,
    )


class _History:
    """Per-lane circular (s, y, ρ) history."""

    def __init__(self, E: int, m: int, d: int, dtype, device):
        self.m = m
        self.S = torch.zeros((E, m, d), dtype=dtype, device=device)
        self.Y = torch.zeros((E, m, d), dtype=dtype, device=device)
        self.rho = torch.zeros((E, m), dtype=dtype, device=device)
        self.num_stored = torch.zeros(E, dtype=torch.long, device=device)
        self.head = torch.zeros(E, dtype=torch.long, device=device)

    def direction(self, g: Tensor) -> Tensor:
        return two_loop_direction(g, self.S, self.Y, self.rho, self.num_stored, self.head)

    def push(self, s: Tensor, y: Tensor, sy: Tensor, lanes: Tensor) -> None:
        """Store the pair of every lane in ``lanes`` with s·y > 1e-12."""
        store = lanes & (sy > 1e-12)
        idx = torch.arange(s.shape[0], device=s.device)
        slot = (self.head + 1) % self.m
        self.S[idx, slot] = torch.where(store[:, None], s, self.S[idx, slot])
        self.Y[idx, slot] = torch.where(store[:, None], y, self.Y[idx, slot])
        self.rho[idx, slot] = torch.where(store, 1.0 / torch.clamp(sy, min=1e-30), self.rho[idx, slot])
        self.head = torch.where(store, slot, self.head)
        self.num_stored = torch.where(store, torch.clamp(self.num_stored + 1, max=self.m),
                                      self.num_stored)


def _init_alpha(g: Tensor, hist: _History) -> Tensor:
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
    hist = _History(E, m, d, w0.dtype, w0.device)

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
    hist = _History(E, m, d, w0.dtype, w0.device)

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
