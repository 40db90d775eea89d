"""TRON: trust-region Newton with truncated conjugate gradient (port of
photon_tpu/optim/tron.py::minimize_tron).

The same outer trust-region loop, textbook radius update, Steihaug CG,
``box`` projection and work count (``evals += 2 + cg_iters``). The
reference runs the outer loop and the CG as nested ``lax.while_loop``s
(vmapped over the entities of a block); here both are phases of one device
state machine (optim/program.py), held per lane, and every step is exactly
one X pass of one shape: a forward pass u = X·q, a pointwise map, a
transpose pass. Only q and the map depend on the lane's phase:
  CG       q = p,         t = d2 ∘ u                       (H·p)
  TRIAL    q = w + s,     t = weight·loss′(u + offset)     (f, ∇f at the trial)
  RHO      q = s_eff,     t = d2 ∘ u                       (H·s for ρ)
so no X pass runs masked while the lane is live (optim/problem.py; on the
fixed effect the trial is K1 and the products K2, each with its launch
flag). The Hessian state at w, d2 = weight·loss″(margins), is held in the
state and taken from the trial's margins when the step is accepted, so it
costs no pass of its own. An outer iteration is cg_iters + 2 steps.

``minimize_tron`` runs the program eagerly over a black-box objective;
factory.make_optimizer and the solve cache run it over a GLM.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from photon_tpu_torch.optim.common import (
    OptimizeResult,
    OptimizerConfig,
    REASON_MAX_ITERATIONS,
    REASON_NOT_CONVERGED,
    check_convergence,
    finish_result,
    new_history,
    project_to_box,
    record,
)
from photon_tpu_torch.optim.problem import CallableOracle, dot
from photon_tpu_torch.optim.program import EAGER_CHUNK, Commit, Program, lanewise, run_chunked

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]

ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA3 = 0.25, 4.0

TRON_DEFAULT_CONFIG = OptimizerConfig(max_iter=15, tol=1e-5)

_CG, _TRIAL, _RHO = 0, 1, 2


class TRON(Program):
    """TRON over an oracle (optim/problem.py) from ``w0`` (lanes, d), one X
    pass a step. ``box`` (lower, upper) bounds the coefficients by
    projection of the start and of every trial point."""

    step_passes = 1

    def __init__(self, oracle, w0: Tensor, config: OptimizerConfig = TRON_DEFAULT_CONFIG, max_cg_iter: int = 20,
                 box: Optional[Tuple[Tensor, Tensor]] = None):
        self.oracle, self.w0, self.config, self.max_cg, self.box = oracle, w0, config, max_cg_iter, box
        self.l2 = oracle.l2
        self.max_steps = config.max_iter * (max_cg_iter + 2)
        lanes, dtype, device = tuple(w0.shape[:-1]), w0.dtype, w0.device
        lane = lambda v, dt=dtype: torch.full(lanes, v, dtype=dt, device=device)  # noqa: E731
        self.true = lane(True, torch.bool)
        self.s = dict(
            w=torch.zeros_like(w0), f=lane(0.0), g=torch.zeros_like(w0), curv=oracle.new_curvature(w0),
            delta=lane(0.0), g0_norm=lane(0.0), it=lane(0, torch.int32), reason=lane(0, torch.int32),
            evals=lane(1, torch.int32), loss_hist=new_history(config, lane(0.0)),
            gnorm_hist=new_history(config, lane(0.0)), phase=lane(_CG, torch.int32),
            # the CG of the outer iteration in flight
            cg_s=torch.zeros_like(w0), cg_r=torch.zeros_like(w0), cg_p=torch.zeros_like(w0),
            cg_it=lane(0, torch.int32), cg_tol=lane(0.0),
            # the trial point's value, gradient and curvature, between TRIAL and RHO
            f_t=lane(0.0), g_t=torch.zeros_like(w0), curv_t=oracle.new_curvature(w0))

    def _lanes(self) -> Tensor:
        S = self.s
        return (S["reason"] == REASON_NOT_CONVERGED) & (S["it"] < self.config.max_iter)

    def running(self) -> Tensor:
        return self._lanes().any()

    def _begin_cg(self, lanes: Tensor) -> None:
        """Start the CG of an outer iteration at the lanes' current gradient:
        s = 0, r = p = −g; a lane whose CG would not run goes to its trial."""
        S = self.s
        g = S["g"]
        gn = torch.linalg.norm(g, dim=-1)
        cg_tol = 0.1 * gn
        runs = (gn > cg_tol) & (self.max_cg > 0)
        Commit(lanes).update(S, dict(cg_s=torch.zeros_like(g), cg_r=-g, cg_p=-g, cg_it=torch.zeros_like(S["cg_it"]),
                                     cg_tol=cg_tol, phase=torch.where(runs, _CG, _TRIAL).to(torch.int32)))

    def init(self) -> None:
        S, cfg = self.s, self.config
        w = project_to_box(self.w0, self.box)
        f, g, curv = self.oracle.tron_pass(w, self.true, S["curv"])
        g0_norm = torch.linalg.norm(g, dim=-1)
        for k, v in dict(w=w, f=f, g=g, curv=curv, delta=g0_norm, g0_norm=g0_norm,
                         loss_hist=new_history(cfg, f), gnorm_hist=new_history(cfg, g0_norm)).items():
            S[k].copy_(v)
        S["it"].zero_()
        S["reason"].fill_(REASON_NOT_CONVERGED)
        S["evals"].fill_(1)
        self._begin_cg(self.true)

    def step(self) -> None:
        S, cfg = self.s, self.config
        run = self._lanes()
        phase = S["phase"]
        cg, trial, rho_lanes = run & (phase == _CG), run & (phase == _TRIAL), run & (phase == _RHO)
        w, f, g, delta = S["w"], S["f"], S["g"], S["delta"]
        w_trial = project_to_box(w + S["cg_s"], self.box)
        s_eff = w_trial - w
        q = torch.where(lanewise(phase == _CG, w), S["cg_p"], torch.where(lanewise(phase == _TRIAL, w), w_trial, s_eff))
        f_q, out, curv_q = self.oracle.tron_pass(q, phase == _TRIAL, S["curv"], enable=run.any().to(torch.int32))

        # --- CG: one Steihaug step with Hp = out ---
        s, r, p = S["cg_s"], S["cg_r"], S["cg_p"]
        pHp, rr = dot(p, out), dot(r, r)
        alpha = torch.where(pHp > 0, rr / torch.clamp(pHp, min=1e-30), float("inf"))
        s_next = s + lanewise(alpha, s) * p
        ss, sp, pp = dot(s, s), dot(s, p), dot(p, p)
        disc = torch.sqrt(torch.clamp(sp * sp + pp * (delta * delta - ss), min=0.0))
        tau = (disc - sp) / torch.clamp(pp, min=1e-30)
        outside = (torch.linalg.norm(s_next, dim=-1) >= delta) | (pHp <= 0)
        s_new = torch.where(lanewise(outside, s), s + lanewise(tau, s) * p, s_next)
        r_new = torch.where(lanewise(outside, r), r, r - lanewise(alpha, r) * out)
        beta = dot(r_new, r_new) / torch.clamp(rr, min=1e-30)
        cg_it = S["cg_it"] + 1
        more = ~outside & (cg_it < self.max_cg) & (torch.linalg.norm(r_new, dim=-1) > S["cg_tol"])
        Commit(cg).update(S, dict(cg_s=s_new, cg_r=r_new, cg_p=r_new + lanewise(beta, p) * p, cg_it=cg_it,
                                  phase=torch.where(more, _CG, _TRIAL).to(torch.int32)))

        # --- TRIAL: keep the trial point's value, gradient and curvature ---
        Commit(trial).update(S, dict(f_t=f_q, g_t=out, curv_t=curv_q,
                                     phase=torch.full_like(phase, _RHO)))

        # --- RHO: H·s_eff = out; accept or reject, update the radius ---
        f_t = S["f_t"]
        pred = -(dot(g, s_eff) + 0.5 * dot(s_eff, out))
        rho = (f - f_t) / torch.clamp(pred, min=1e-30)
        snorm = torch.linalg.norm(s_eff, dim=-1)
        accept = (rho > ETA0) & (pred > 0)
        delta_new = torch.where(
            rho < ETA1,
            torch.clamp(SIGMA1 * torch.minimum(snorm, delta), min=1e-12),
            torch.where(rho < ETA2, delta, torch.minimum(torch.maximum(SIGMA3 * snorm, delta), SIGMA3 * delta)),
        )
        keep = lambda new, old: torch.where(lanewise(accept, old), new, old)  # noqa: E731
        f_new, g_new = keep(f_t, f), keep(S["g_t"], g)
        it = S["it"] + 1
        gn = torch.linalg.norm(g_new, dim=-1)
        reason = torch.where(
            accept,
            check_convergence(f_new, f, gn, S["g0_norm"], cfg.tol, it, cfg.max_iter),
            torch.where(delta_new <= 1e-10, REASON_MAX_ITERATIONS, REASON_NOT_CONVERGED),
        ).to(torch.int32)
        Commit(rho_lanes).update(S, dict(
            w=keep(w_trial, w), f=f_new, g=g_new, curv=keep(S["curv_t"], S["curv"]), delta=delta_new, it=it,
            reason=reason, evals=S["evals"] + 2 + S["cg_it"], loss_hist=record(S["loss_hist"], it, f_new),
            gnorm_hist=record(S["gnorm_hist"], it, gn)))
        self._begin_cg(rho_lanes)

    def finish(self) -> None:
        S = self.s
        self.out = finish_result(S["w"], S["f"], torch.linalg.norm(S["g"], dim=-1), S["it"], S["reason"],
                                 S["loss_hist"], S["gnorm_hist"], S["evals"])

    def result(self) -> OptimizeResult:
        return self.out


def minimize_tron(
    value_and_grad: ValueAndGrad,
    hvp: Optional[Callable[[Tensor, Tensor], Tensor]],
    w0: Tensor,
    config: OptimizerConfig = TRON_DEFAULT_CONFIG,
    max_cg_iter: int = 20,
    box: Optional[Tuple[Tensor, Tensor]] = None,
    hvp_factory: Optional[Callable[[Tensor], Callable[[Tensor], Tensor]]] = None,
) -> OptimizeResult:
    """Trust-region Newton minimization of a black-box objective, eagerly.
    ``hvp_factory`` (w → (v → H(w)·v)) is preferred over ``hvp``. ``box``
    (lower, upper) bounds the coefficients by projection. A step calls
    ``value_and_grad`` or the product, as its phase needs, and a product is
    built once for each point H is taken at (problem.CallableOracle); a GLM
    runs as a program over its oracle (factory.make_optimizer)."""
    if hvp_factory is None:
        if hvp is None:
            raise ValueError("minimize_tron needs hvp or hvp_factory")
        hvp_factory = lambda w: (lambda v: hvp(w, v))  # noqa: E731
    prog = TRON(CallableOracle(value_and_grad, hvp_factory), w0, config, max_cg_iter, box)
    run_chunked(prog, EAGER_CHUNK)
    return prog.result()
