"""OWL-QN: orthant-wise limited-memory quasi-Newton for L1 and elastic net
(port of photon_tpu/optim/owlqn.py).

Minimizes f(w) + λ‖mask∘w‖₁ (Andrew & Gao 2007): the pseudo-gradient picks
the orthant of steepest descent, the L-BFGS direction from the smooth
curvature history is sign-aligned with it, and a backtracking Armijo search
on the regularized objective clips every trial to the orthant of the search
point, which is what makes coefficients exactly zero. The reference runs the
iterations and the backtracking as nested ``lax.while_loop``s (vmapped over
the entities of a block); here they are one device state machine
(optim/program.py) with a lane axis, one backtracking trial (one
value-and-gradient pass) a step: a step starts an iteration where no search
is in flight, runs the trial, and ends the iteration where the trial passed
or the budget is spent. λ is a device scalar (``l1``) the steps read, so
one captured program serves every weight of a sweep.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from photon_tpu_torch.optim.common import (
    OptimizeResult,
    OptimizerConfig,
    REASON_NOT_CONVERGED,
    check_convergence,
    finish_result,
    new_history,
    record,
)
from photon_tpu_torch.optim.lbfgs import CurvatureHistory
from photon_tpu_torch.optim.problem import CallableOracle, dot
from photon_tpu_torch.optim.program import EAGER_CHUNK, Commit, Program, lanewise, run_chunked

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


class OWLQN(Program):
    """OWL-QN over an oracle of the smooth part (loss + L2) from ``w0``
    (lanes, d). ``l1_mask`` (d,) or (lanes, d) holds 0 where a coefficient
    (the intercept) is not penalized. ``result().value`` is the regularized
    objective, ``grad_norm`` the pseudo-gradient's norm."""

    step_passes = 1

    def __init__(self, oracle, w0: Tensor, l1_weight: float, config: OptimizerConfig = OptimizerConfig(),
                 l1_mask: Optional[Tensor] = None):
        self.oracle, self.w0, self.config = oracle, w0, config
        self.l2 = oracle.l2
        lanes, d, dtype, device = tuple(w0.shape[:-1]), w0.shape[-1], w0.dtype, w0.device
        self.l1 = torch.full((), l1_weight, dtype=dtype, device=device)
        self.l1_mask = torch.ones(d, dtype=dtype, device=device) if l1_mask is None else l1_mask.to(dtype)
        self.max_steps = config.max_iter * config.max_line_search_evals
        self.hist = CurvatureHistory(config.memory, d, dtype, device, lanes)
        lane = lambda v, dt=dtype: torch.full(lanes, v, dtype=dt, device=device)  # noqa: E731
        self.one = torch.ones((), dtype=torch.int32, device=device)
        self.s = dict(
            w=torch.zeros_like(w0), F=lane(0.0), g=torch.zeros_like(w0), pg0_norm=lane(0.0),
            it=lane(0, torch.int32), reason=lane(0, torch.int32), evals=lane(1, torch.int32),
            loss_hist=new_history(config, lane(0.0)), gnorm_hist=new_history(config, lane(0.0)),
            # the search in flight: its direction, orthant, slope, step and trials
            searching=lane(False, torch.bool), p=torch.zeros_like(w0), xi=torch.zeros_like(w0),
            dirderiv=lane(0.0), alpha=lane(0.0), bt=lane(0, torch.int32))

    def _l1(self) -> Tensor:
        return self.l1 * self.l1_mask

    def _value(self, w: Tensor, enable: Tensor):
        """(regularized value, smooth gradient) at w."""
        f, g = self.oracle.value_grad(w, enable)
        return f + torch.sum(self._l1() * torch.abs(w), dim=-1), g

    def _lanes(self) -> Tensor:
        S = self.s
        return (S["reason"] == REASON_NOT_CONVERGED) & (S["it"] < self.config.max_iter)

    def running(self) -> Tensor:
        return self._lanes().any()

    def init(self) -> None:
        S, cfg = self.s, self.config
        w0 = self.w0
        F, g = self._value(w0, self.one)
        pg0_norm = torch.linalg.norm(_pseudo_gradient(w0, g, self._l1()), dim=-1)
        for k, v in dict(w=w0, F=F, g=g, pg0_norm=pg0_norm, loss_hist=new_history(cfg, F),
                         gnorm_hist=new_history(cfg, pg0_norm)).items():
            S[k].copy_(v)
        S["it"].zero_()
        S["reason"].fill_(REASON_NOT_CONVERGED)
        S["evals"].fill_(1)
        S["searching"].zero_()
        self.hist.reset()

    def step(self) -> None:
        S, cfg = self.s, self.config
        run = self._lanes()
        l1 = self._l1()
        w, F, g = S["w"], S["F"], S["g"]

        # --- start: direction, orthant and first step where no search runs ---
        pg = _pseudo_gradient(w, g, l1)
        p = self.hist.direction(pg)
        p = torch.where(p * -pg > 0, p, torch.zeros_like(p))  # sign alignment with −pg
        p = torch.where(lanewise(dot(p, pg) >= 0, p), -pg, p)
        alpha0 = torch.where(self.hist.num_stored == 0,
                             1.0 / torch.clamp(torch.linalg.norm(p, dim=-1), min=1e-12), 1.0).to(w.dtype)
        Commit(run & ~S["searching"]).update(S, dict(
            p=p, xi=torch.where(w != 0, torch.sign(w), torch.sign(-pg)), dirderiv=dot(pg, p), alpha=alpha0,
            bt=torch.zeros_like(S["bt"]), searching=torch.ones_like(S["searching"])))

        # --- one backtracking trial: Armijo on the regularized objective ---
        alpha = S["alpha"]
        w_t = _orthant_project(w + lanewise(alpha, w) * S["p"], S["xi"])
        F_t, g_t = self._value(w_t, run.any().to(torch.int32))
        bt = S["bt"] + 1
        end = (F_t <= F + 1e-4 * alpha * S["dirderiv"]) | (bt >= cfg.max_line_search_evals)
        Commit(run & ~end).update(S, dict(alpha=alpha * 0.5, bt=bt))

        # --- end of the iteration: curvature from the SMOOTH gradient ---
        done = run & end
        s, y = w_t - w, g_t - g
        self.hist.push(s, y, dot(s, y), done)
        it = S["it"] + 1
        pgn = torch.linalg.norm(_pseudo_gradient(w_t, g_t, l1), dim=-1)
        Commit(done).update(S, dict(
            w=w_t, F=F_t, g=g_t, it=it, reason=check_convergence(F_t, F, pgn, S["pg0_norm"], cfg.tol, it, cfg.max_iter),
            evals=S["evals"] + bt, loss_hist=record(S["loss_hist"], it, F_t),
            gnorm_hist=record(S["gnorm_hist"], it, pgn), searching=torch.zeros_like(S["searching"])))

    def finish(self) -> None:
        S = self.s
        pgn = torch.linalg.norm(_pseudo_gradient(S["w"], S["g"], self._l1()), dim=-1)
        self.out = finish_result(S["w"], S["F"], pgn, S["it"], S["reason"], S["loss_hist"], S["gnorm_hist"],
                                 S["evals"])

    def result(self) -> OptimizeResult:
        return self.out


def minimize_owlqn(
    value_and_grad: ValueAndGrad,
    w0: Tensor,
    l1_weight: float,
    config: OptimizerConfig = OptimizerConfig(),
    l1_mask: Optional[Tensor] = None,
) -> OptimizeResult:
    """``value_and_grad`` is the smooth part only (loss + L2 for elastic
    net); ``l1_mask`` holds 0 where a coefficient (the intercept) is not
    penalized. ``result.value`` is the regularized objective. Runs the
    program eagerly, EAGER_CHUNK steps between host reads."""
    prog = OWLQN(CallableOracle(value_and_grad), w0, l1_weight, config, l1_mask)
    run_chunked(prog, EAGER_CHUNK)
    return prog.result()
