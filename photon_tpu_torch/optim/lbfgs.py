"""L-BFGS and box-constrained L-BFGS (port of photon_tpu/optim/lbfgs.py).

The same two-loop recursion, strong-Wolfe line search, curvature test,
divergence rollback and tracker as the reference. The reference runs the
solve as one ``lax.while_loop`` (vmapped over the entities of a block for
the gradient-form route of random_effect.py::_solve_block); here ``LBFGS``
is a device state machine (optim/program.py) with a lane axis, one
value-and-gradient pass a step: a step starts an iteration where no search
is in flight (the direction and the search's state), then evaluates the
lane's point, which is the search's next trial while the search runs and
the accepted point once it is done (the reference's evaluation after the
search), and ends the iteration there. A lane whose new point, value or
gradient is not finite keeps its last finite iterate and stops with
DIVERGED. With a fused objective every evaluation is one K1 launch.
``two_loop_direction`` and ``CurvatureHistory`` serve every quasi-Newton
program of the port (optim/margin_lbfgs.py, optim/owlqn.py too).

Box constraints use projected line search: trial points are clipped to the
box before evaluation, and coordinates on a bound whose gradient pushes
outward are frozen for the direction; the convergence test reads the
projected-gradient norm ‖w − proj(w − g)‖.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from photon_tpu_torch.optim.common import (
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
from photon_tpu_torch.optim.linesearch import wolfe_alpha, wolfe_result, wolfe_running, wolfe_start, wolfe_update
from photon_tpu_torch.optim.problem import LOCAL_SPACE, CallableOracle, dot
from photon_tpu_torch.optim.program import EAGER_CHUNK, Commit, Program, lanewise, run_chunked

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]
Box = Optional[Tuple[Tensor, Tensor]]


def _at(H: Tensor, slot: Tensor) -> Tensor:
    """Slot ``slot`` (...) of a history H (..., m[, d])."""
    if H.dim() == slot.dim() + 1:
        return torch.take_along_dim(H, slot[..., None], dim=-1)[..., 0]
    return torch.take_along_dim(H, slot[..., None, None], dim=-2)[..., 0, :]


def two_loop_direction(grad: Tensor, s_hist: Tensor, y_hist: Tensor, rho_hist: Tensor,
                       num_stored, head, dot=dot) -> Tensor:
    """Search direction −H·grad from circular histories: grad (..., d),
    s_hist/y_hist (..., m, d), rho_hist (..., m); ``head`` (...) is the slot
    of the most recent pair and ``num_stored`` (...) the filled count, host
    or device ints. As in the reference, every one of the m slots is
    visited and the unfilled ones are masked, so nothing is read back.
    ``dot``: the space's dot product (a feature-sharded space reduces it)."""
    m = s_hist.shape[-2]
    device = grad.device
    lead = grad.shape[:-1]
    head = torch.as_tensor(head, device=device).long().expand(lead)
    num_stored = torch.as_tensor(num_stored, device=device).long().expand(lead)
    q = grad
    alphas = torch.zeros_like(rho_hist)
    for i in range(m):
        slot = (head - i) % m
        alpha = torch.where(i < num_stored, _at(rho_hist, slot) * dot(_at(s_hist, slot), q), 0.0)
        q = q - alpha[..., None] * _at(y_hist, slot)
        alphas = alphas.scatter(-1, slot[..., None], alpha[..., None])
    # Initial Hessian scaling gamma = s·y / y·y from the most recent pair.
    recent = head % m
    sy = dot(_at(s_hist, recent), _at(y_hist, recent))
    yy = dot(_at(y_hist, recent), _at(y_hist, recent))
    gamma = torch.where((num_stored > 0) & (yy > 0), sy / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
    r = gamma[..., None] * q
    for i in range(m):
        slot = (head - (num_stored - 1 - i)) % m
        beta = _at(rho_hist, slot) * dot(_at(y_hist, slot), r)
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

    def direction(self, g: Tensor, dot=dot) -> Tensor:
        return two_loop_direction(g, self.s, self.y, self.rho, self.num_stored, self.head, dot)

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



_START, _SEARCH, _FINAL = 0, 1, 2


class LBFGS(Program):
    """Gradient-form L-BFGS over an oracle (optim/problem.py) from ``w0``
    (lanes, d), optionally inside ``box`` (lower, upper). ``evals`` counts
    objective evaluations per lane. ``space``: the dots and norms of w's
    space (optim/problem.py::LocalSpace; a feature-sharded solve reduces
    them over the mesh)."""

    step_passes = 1

    def __init__(self, oracle, w0: Tensor, config: OptimizerConfig = OptimizerConfig(), box: Box = None,
                 space=LOCAL_SPACE):
        self.oracle, self.w0, self.config, self.box, self.space = oracle, w0, config, box, space
        self.l2 = oracle.l2
        lanes, d, dtype, device = tuple(w0.shape[:-1]), w0.shape[-1], w0.dtype, w0.device
        # An iteration is its search's trials and the evaluation of its point.
        self.max_steps = config.max_iter * (config.max_line_search_evals + 1)
        self.hist = CurvatureHistory(config.memory, d, dtype, device, lanes)
        lane = lambda v, dt=dtype: torch.full(lanes, v, dtype=dt, device=device)  # noqa: E731
        self.true = lane(True, torch.bool)
        self.one = torch.ones((), dtype=torch.int32, device=device)
        f0 = lane(0.0)
        self.s = dict(
            w=torch.zeros_like(w0), f=lane(0.0), g=torch.zeros_like(w0), g0_norm=lane(0.0),
            it=lane(0, torch.int32), reason=lane(0, torch.int32), evals=lane(1, torch.int32),
            loss_hist=new_history(config, lane(0.0)), gnorm_hist=new_history(config, lane(0.0)),
            # the iteration in flight: its phase, direction, slope and search
            phase=lane(_START, torch.int32), p=torch.zeros_like(w0), dg0=lane(0.0),
            ls=wolfe_start(f0, f0, f0, self.true))

    def _proj(self, w: Tensor) -> Tensor:
        return project_to_box(w, self.box)

    def _gnorm(self, w: Tensor, g: Tensor) -> Tensor:
        """The gradient norm, or the projected-gradient norm under a box."""
        return self.space.norm(g if self.box is None else w - self._proj(w - g))

    def _lanes(self) -> Tensor:
        S = self.s
        return (S["reason"] == REASON_NOT_CONVERGED) & (S["it"] < self.config.max_iter)

    def running(self) -> Tensor:
        return self._lanes().any()

    def init(self) -> None:
        S, cfg = self.s, self.config
        w = self._proj(self.w0)
        f, g = self.oracle.value_grad(w, self.one)
        g0_norm = self._gnorm(w, g)
        for k, v in dict(w=w, f=f, g=g, g0_norm=g0_norm, loss_hist=new_history(cfg, f),
                         gnorm_hist=new_history(cfg, g0_norm)).items():
            S[k].copy_(v)
        S["it"].zero_()
        S["reason"].fill_(REASON_NOT_CONVERGED)
        S["evals"].fill_(1)
        S["phase"].fill_(_START)
        self.hist.reset()

    def step(self) -> None:
        S, cfg, box, dot = self.s, self.config, self.box, self.space.dot
        run = self._lanes()
        w, f, g = S["w"], S["f"], S["g"]

        # --- start: the direction and the search's state ---
        if box is None:
            g_dir = g
        else:
            eps = 1e-9
            frozen = ((w <= box[0] + eps) & (g > 0)) | ((w >= box[1] - eps) & (g < 0))
            g_dir = torch.where(frozen, 0.0, g)
        p = self.hist.direction(g_dir, dot)
        if box is not None:
            p = torch.where(frozen, 0.0, p)
        dg0 = dot(p, g)
        bad = dg0 >= 0  # not a descent direction: (projected) steepest descent
        p = torch.where(lanewise(bad, p), -g_dir, p)
        dg0 = torch.where(bad, -dot(g_dir, g_dir), dg0)
        first = torch.clamp(1.0 / torch.clamp(self.space.norm(g), min=1e-12), max=1.0)
        init_alpha = torch.where(self.hist.num_stored == 0, first, torch.ones_like(first)).to(w.dtype)
        Commit(run & (S["phase"] == _START)).update(S, dict(
            p=p, dg0=dg0, ls=wolfe_start(f, dg0, init_alpha, self.true),
            phase=torch.full_like(S["phase"], _SEARCH)))

        # --- the step's one evaluation: the next trial, or the accepted point ---
        phase, p, dg0, ls = S["phase"], S["p"], S["dg0"], S["ls"]
        searching = phase == _SEARCH
        a = wolfe_alpha(ls)
        found = wolfe_result(ls, f)
        x = self._proj(w + lanewise(torch.where(searching, a, found.alpha), p) * p)
        f_x, g_x = self.oracle.value_grad(x, run.any().to(torch.int32))

        # --- the search: one trial ---
        if box is None:
            deriv = dot(g_x, p)
        else:  # along the projected path
            deriv = dot(g_x, (x - w) / lanewise(torch.clamp(a, min=1e-30), x))
        ls_new = wolfe_update(ls, f_x, deriv, f, dg0)
        ends = run & (phase == _FINAL)
        Commit(run & searching).update(S, dict(
            ls=ls_new, phase=torch.where(wolfe_running(ls_new, cfg.max_line_search_evals), _SEARCH,
                                         _FINAL).to(torch.int32)))

        # --- the end of the iteration at the accepted point ---
        finite = torch.isfinite(f_x) & self.space.all_finite(x) & self.space.all_finite(g_x)
        keep = lambda new, old: torch.where(lanewise(finite, old), new, old)  # noqa: E731
        w_new, f_new, g_new = keep(x, w), keep(f_x, f), keep(g_x, g)
        s, y = w_new - w, g_new - g
        self.hist.push(s, y, dot(s, y), ends)
        it = S["it"] + 1
        gn = self._gnorm(w_new, g_new)
        reason = torch.where(finite, check_convergence(f_new, f, gn, S["g0_norm"], cfg.tol, it, cfg.max_iter),
                             REASON_DIVERGED).to(torch.int32)
        Commit(ends).update(S, dict(
            w=w_new, f=f_new, g=g_new, it=it, reason=reason, evals=S["evals"] + found.evals + 1,
            loss_hist=record(S["loss_hist"], it, f_new), gnorm_hist=record(S["gnorm_hist"], it, gn),
            phase=torch.full_like(S["phase"], _START)))

    def finish(self) -> None:
        S = self.s
        self.out = finish_result(S["w"], S["f"], self._gnorm(S["w"], S["g"]), S["it"], S["reason"],
                                 S["loss_hist"], S["gnorm_hist"], S["evals"])

    def result(self) -> OptimizeResult:
        return self.out


def minimize_lbfgs(
    value_and_grad: ValueAndGrad,
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    box: Box = None,
    space=LOCAL_SPACE,
) -> OptimizeResult:
    """Minimize a smooth function with L-BFGS, optionally inside a box
    (lower, upper). ``result.evals`` counts objective evaluations. Runs the
    program eagerly, EAGER_CHUNK steps between host reads. ``space``: w's
    (a feature-sharded solve's reduces over the mesh,
    parallel/feature_sharded.py)."""
    prog = LBFGS(CallableOracle(value_and_grad), w0, config, box, space)
    run_chunked(prog, EAGER_CHUNK)
    return prog.result()


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
