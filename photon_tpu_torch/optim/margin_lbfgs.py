"""Margin-space L-BFGS (port of
photon_tpu/optim/margin_lbfgs.py::minimize_lbfgs_margin).

A GLM's margins are affine along a direction p: z(w + αp) = z + α·u with
u = X·p, so a whole strong-Wolfe line search costs one X pass and every
trial is O(n) work on (z, u). One iteration is two X passes: u = X·p and the
gradient at the accepted point. With the fused kernel the gradient pass
also returns fresh margins (csrc/fused_value_grad.cu), so the carried
margins never drift, which is what makes a bf16 X safe; without it (an
entity block, shifts) the margins are carried as z + α·u, as in the
reference.

The reference's ``lax.while_loop`` body (vmapped over the entities of a
block for the random-effect fallbacks of random_effect.py::_solve_block)
runs as ``MarginLBFGS.step``s of the device state machine of
optim/program.py, with a lane axis and no host read: a step starts an
iteration (the direction and u = X·p) where no line search is in flight,
runs TRIALS_PER_STEP strong-Wolfe trials, and finishes the iteration (the
gradient pass, the masked history push, the convergence test) where the
search is done, so an iteration whose search needs more trials spans steps.
A part that does not apply runs and keeps nothing. The solve cache
(algorithm/solve_cache.py) captures K steps as one CUDA graph;
``minimize_lbfgs_margin`` runs the same steps eagerly, K between reads of
the loop flag. The L2 weight is a device scalar (``l2``) the steps read, so
one captured solve serves every weight (the solve cache fills it per
solve). On a rows-sharded batch the trials' sums over rows reduce over
the mesh with the terms' other sums (GLMTerms.value_slope, one all-reduce a
trial). ``sweep_l2_lbfgs_margin`` solves one batch against k L2 weights as
k lanes of one program over the shared X, one weight a lane.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.ops.objective import GLMObjective
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
from photon_tpu_torch.optim.linesearch import wolfe_alpha, wolfe_result, wolfe_running, wolfe_start, wolfe_update
from photon_tpu_torch.optim.problem import GLMTerms, L2Term, dot
from photon_tpu_torch.optim.program import EAGER_CHUNK, Commit, Program, lanewise, run_chunked

Tensor = torch.Tensor

# Line-search trials a step runs; a longer search goes on in the next step.
TRIALS_PER_STEP = 4


class MarginLBFGS(Program):
    """Margin-space L-BFGS over GLM data terms (optim/problem.py: a
    fixed-effect batch, or an entity block with one lane an entity) plus
    ½·l2·‖c∘w‖² (c zero at ``intercept_index``; ``l2_weight`` a float, or a
    tensor of one weight a lane over a shared batch), as a device state
    machine. The terms' tensors and ``w0`` are read by ``init`` and
    ``step``; the state is owned."""

    eval_unit = "x_passes"

    def __init__(self, terms: GLMTerms, l2_weight, intercept_index: Optional[int], w0: Tensor,
                 config: OptimizerConfig = OptimizerConfig()):
        self.terms, self.w0, self.config = terms, w0, config
        # An iteration takes at most this many steps (its search's trials).
        self.max_steps = config.max_iter * -(-config.max_line_search_evals // TRIALS_PER_STEP)
        self.init_passes = 1 if terms.fused else 2
        lanes, d, dtype, device = tuple(w0.shape[:-1]), w0.shape[-1], w0.dtype, w0.device
        self.dtype = dtype
        self.reg = L2Term(l2_weight, intercept_index, d, dtype, device)
        self.l2 = self.reg.l2
        self.hist = CurvatureHistory(config.memory, d, dtype, device, lanes)
        lane = lambda v, dt=dtype: torch.full(lanes, v, dtype=dt, device=device)  # noqa: E731
        z = torch.zeros(lanes + tuple(terms.label.shape[-1:]), dtype=terms.curvature_dtype(dtype), device=device)
        self.true = lane(True, torch.bool)
        f0 = lane(0.0)
        self.s = dict(
            w=torch.zeros_like(w0), z=z, f=lane(0.0), g=torch.zeros_like(w0), g0_norm=lane(0.0),
            it=lane(0, torch.int32), reason=lane(0, torch.int32), evals=lane(0, torch.int32),
            loss_hist=new_history(config, lane(0.0)), gnorm_hist=new_history(config, lane(0.0)),
            # The search in flight: its direction, u = X·p, the L2 terms along
            # it, and its state (none in flight: done).
            p=torch.zeros_like(w0), u=torch.zeros_like(z), dg0=lane(0.0), f_l2=lane(0.0), l2_a=lane(0.0),
            l2_b=lane(0.0), ls=wolfe_start(f0, f0, f0, ~self.true))

    @staticmethod
    def of_batch(objective: GLMObjective, batch: LabeledBatch, w0: Tensor,
                 config: OptimizerConfig = OptimizerConfig()) -> "MarginLBFGS":
        """The fixed effect's program over ``objective`` on ``batch``."""
        if objective.l1_weight > 0.0:
            raise ValueError("margin L-BFGS is for smooth objectives; use OWL-QN for L1")
        return MarginLBFGS(GLMTerms.of_batch(objective, batch), objective.l2_weight, objective.intercept_index,
                           w0, config)

    # --- the objective along the margins ---

    def _point(self, w: Tensor, z_carried: Optional[Tensor]):
        """(value, gradient, margins) at w: fused, one pass that also returns
        fresh margins; else from the carried margins (one transpose pass,
        or two passes from nothing when ``z_carried`` is None)."""
        T = self.terms
        if T.fused:
            val, g, z = T.value_grad(w, margins=True)
        else:
            z = T.forward(w) + T.offset if z_carried is None else z_carried
            val, g = T.point(z)
            val, g = val.to(self.dtype), g.to(self.dtype)
        if self.reg.on:
            g = g + self.reg.grad(w)
        return val + self.reg.value(w), g, z

    # --- the state machine ---

    def init(self) -> None:
        S, cfg = self.s, self.config
        self.terms.refresh()
        w0 = self.w0
        f, g, z = self._point(w0, None)
        g0_norm = torch.linalg.norm(g, dim=-1)
        for k, v in dict(w=w0, z=z, f=f, g=g, g0_norm=g0_norm, loss_hist=new_history(cfg, f),
                         gnorm_hist=new_history(cfg, g0_norm)).items():
            S[k].copy_(v)
        S["it"].zero_()
        S["reason"].fill_(REASON_NOT_CONVERGED)
        S["evals"].fill_(self.init_passes)
        self.hist.reset()
        S["ls"].copy_(wolfe_start(S["f"], S["f"], S["f"], ~self.true))

    def _lanes(self) -> Tensor:
        S = self.s
        return (S["reason"] == REASON_NOT_CONVERGED) & (S["it"] < self.config.max_iter)

    def running(self) -> Tensor:
        return self._lanes().any()

    def step(self) -> None:
        """Start an iteration where no search is in flight, run up to
        TRIALS_PER_STEP trials of the search, and finish the iteration where
        the search is done; each part kept only where it applies."""
        S, cfg, T = self.s, self.config, self.terms
        l2, max_evals = self.l2, cfg.max_line_search_evals
        run = self._lanes()
        w, z, f, g, ls = S["w"], S["z"], S["f"], S["g"], S["ls"]

        # --- start: direction, u = X·p (the one X pass of the search) ---
        p = self.hist.direction(g)
        dg0 = dot(p, g)
        bad_dir = dg0 >= 0
        p = torch.where(lanewise(bad_dir, p), -g, p)
        dg0 = torch.where(bad_dir, -dot(g, g), dg0)
        if self.reg.on:
            wc, pc = w * self.reg.cols, p * self.reg.cols
            l2_a, l2_b = l2 * dot(wc, pc), l2 * dot(pc, pc)
        else:
            l2_a = l2_b = torch.zeros_like(f)
        first = torch.clamp(1.0 / torch.clamp(torch.linalg.norm(g, dim=-1), min=1e-12), max=1.0)
        init_alpha = torch.where(self.hist.num_stored == 0, first, torch.ones_like(first))
        Commit(run & ~wolfe_running(ls, max_evals)).update(S, dict(
            p=p, u=T.forward(p, rounded=True), dg0=dg0, f_l2=self.reg.value(w), l2_a=l2_a, l2_b=l2_b,
            ls=wolfe_start(f, dg0, init_alpha.to(self.dtype), self.true)))

        # --- trials on the margins: O(n) each ---
        p, u, dg0, f_l2, l2_a, l2_b = (S[k] for k in ("p", "u", "dg0", "f_l2", "l2_a", "l2_b"))
        for _ in range(TRIALS_PER_STEP):
            t = Commit(run & wolfe_running(ls, max_evals))
            a = wolfe_alpha(ls)
            za = z + lanewise(a, z) * u
            val, slope = T.value_slope(za, u)
            val = val + f_l2 + a * l2_a + 0.5 * a * a * l2_b
            deriv = slope + l2_a + a * l2_b
            t.set(ls, wolfe_update(ls, val, deriv, f, dg0))

        # --- finish: the second X pass, the history, the convergence test ---
        done = run & ~wolfe_running(ls, max_evals)
        found = wolfe_result(ls, f)
        w_new = w + lanewise(found.alpha, w) * p
        f_new, g_new, z_new = self._point(w_new, None if T.fused else z + lanewise(found.alpha, z) * u)
        f_new, g_new = f_new.to(self.dtype), g_new.to(self.dtype)

        s, y = w_new - w, g_new - g
        it = S["it"] + 1
        gn = torch.linalg.norm(g_new, dim=-1)
        reason = check_convergence(f_new, f, gn, S["g0_norm"], cfg.tol, it, cfg.max_iter)
        loss_hist, gnorm_hist = record(S["loss_hist"], it, f_new), record(S["gnorm_hist"], it, gn)
        self.hist.push(s, y, dot(s, y), done)
        Commit(done).update(S, dict(w=w_new, z=z_new, f=f_new, g=g_new, it=it, reason=reason, evals=S["evals"] + 2,
                                    loss_hist=loss_hist, gnorm_hist=gnorm_hist))

    def finish(self) -> None:
        S = self.s
        self.out = finish_result(S["w"], S["f"], torch.linalg.norm(S["g"], dim=-1), S["it"], S["reason"],
                                 S["loss_hist"], S["gnorm_hist"], S["evals"], eval_unit="x_passes")

    def result(self) -> OptimizeResult:
        return self.out


def minimize_lbfgs_margin(
    objective: GLMObjective,
    batch: LabeledBatch,
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
) -> OptimizeResult:
    """L-BFGS over a smooth GLMObjective at two X passes per iteration.
    ``result.evals`` counts X passes; O(n) line-search trials are not
    counted. Runs eagerly, EAGER_CHUNK steps between host reads."""
    prog = MarginLBFGS.of_batch(objective, batch, w0, config)
    run_chunked(prog, EAGER_CHUNK)
    return prog.result()


def sweep_l2_lbfgs_margin(
    objective: GLMObjective,
    batch: LabeledBatch,
    w0s: Tensor,
    l2_weights: Union[Sequence[float], Tensor],
    config: OptimizerConfig = OptimizerConfig(),
) -> OptimizeResult:
    """One batch against k L2 weights: ``w0s`` (k, d) starts, one lane a
    weight, every field of the result with a leading (k,) axis. Each lane is
    ``minimize_lbfgs_margin`` at its weight (the reference's vmap over
    ``l2_override``); the lanes' direction passes are one X·P product over
    the shared X. The fused kernel is off, as in the reference. Runs
    eagerly, EAGER_CHUNK steps between host reads."""
    if objective.l1_weight > 0.0:
        raise ValueError("margin L-BFGS is for smooth objectives; use OWL-QN for L1")
    terms = GLMTerms.of_batch(dataclasses.replace(objective, use_fused=False), batch)
    l2 = torch.as_tensor(l2_weights, dtype=w0s.dtype, device=w0s.device)
    prog = MarginLBFGS(terms, l2, objective.intercept_index, w0s, config)
    run_chunked(prog, EAGER_CHUNK)
    return prog.result()
