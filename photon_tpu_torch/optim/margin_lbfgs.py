"""Margin-space L-BFGS (port of
photon_tpu/optim/margin_lbfgs.py::minimize_lbfgs_margin).

A GLM's margins are affine along a direction p: z(w + αp) = z + α·u with
u = X·p, so a whole strong-Wolfe line search costs one X pass and every
trial is O(n) work on (z, u). One iteration is two X passes: u = X·p and the
gradient at the accepted point. With the fused kernel the gradient pass
also returns fresh margins (csrc/fused_value_grad.cu), so the carried
margins never drift, which is what makes a bf16 X safe.

The reference's ``lax.while_loop`` body runs as ``MarginLBFGS.step``s of
the device state machine of optim/program.py, with no host read: a step
starts an iteration (the direction and u = X·p) when no line search is in
flight, runs TRIALS_PER_STEP strong-Wolfe trials, and finishes the
iteration (the gradient pass, the masked history push, the convergence
test) when the search is done, so an iteration whose search needs more
trials spans steps. A part that does not apply runs and keeps nothing. The
solve cache (algorithm/solve_cache.py) captures K steps as one CUDA graph;
``minimize_lbfgs_margin`` runs the same steps eagerly, K between reads of
the loop flag. The L2 weight is a device scalar (``l2``) the steps read, so
one captured solve serves every weight (the solve cache fills it per
solve). ``sweep_l2_lbfgs_margin`` is not ported yet.
"""

from __future__ import annotations

import torch

from photon_tpu_torch.data.batch import LabeledBatch, matvec_rounded, rmatvec
from photon_tpu_torch.ops.fused_glm import fused_value_grad
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import (
    OptimizeResult,
    OptimizerConfig,
    REASON_NOT_CONVERGED,
    check_convergence,
    finish_result,
    record,
)
from photon_tpu_torch.optim.lbfgs import CurvatureHistory
from photon_tpu_torch.optim.linesearch import wolfe_alpha, wolfe_result, wolfe_running, wolfe_start, wolfe_update
from photon_tpu_torch.optim.program import Commit, Program, run_chunked

Tensor = torch.Tensor

# Steps between reads of the loop flag when run eagerly.
EAGER_CHUNK = 4
# Line-search trials a step runs; a longer search goes on in the next step.
TRIALS_PER_STEP = 4


class MarginLBFGS(Program):
    """Margin-space L-BFGS over a smooth GLMObjective as a device state
    machine. ``batch``, ``w0`` and ``l2`` (the objective's L2 weight, a
    device scalar) are read by ``init`` and ``step``; the state is owned."""

    def __init__(self, objective: GLMObjective, batch: LabeledBatch, w0: Tensor,
                 config: OptimizerConfig = OptimizerConfig()):
        if objective.l1_weight > 0.0:
            raise ValueError("margin L-BFGS is for smooth objectives; use OWL-QN for L1")
        self.objective, self.batch, self.w0, self.config = objective, batch, w0, config
        # An iteration takes at most this many steps (its search's trials).
        self.max_steps = config.max_iter * -(-config.max_line_search_evals // TRIALS_PER_STEP)
        norm = objective.normalization
        self.factors = None if norm is None or norm.is_identity else norm.factors
        self.shifts = None if norm is None or norm.is_identity else norm.shifts
        self.use_fused = objective._can_fuse(batch)
        self.init_passes = 1 if self.use_fused else 2
        self.dtype, self.device = w0.dtype, w0.device
        self.has_l2 = objective.l2_weight != 0.0
        self.l2 = torch.full((), objective.l2_weight, dtype=w0.dtype, device=w0.device)
        self.hist = CurvatureHistory(config.memory, w0.shape[0], w0.dtype, w0.device)
        self.s = {}

    # --- the objective along the margins ---

    def _l2_value(self, w: Tensor) -> Tensor:
        if not self.has_l2:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        wm = self.objective._l2_mask(w)
        return 0.5 * self.l2 * torch.dot(wm, wm)

    def _data_value(self, z: Tensor) -> Tensor:
        b = self.batch
        return torch.sum(b.weight * self.objective.loss.value(z, b.label))

    def _direction_margins(self, p: Tensor) -> Tensor:
        """u = d(margins)/dα along p (normalization folded)."""
        ep = p if self.factors is None else p * self.factors
        u = matvec_rounded(self.batch.features, ep)
        if self.shifts is not None:
            u = u - torch.dot(self.shifts, ep)
        return u

    def _fused(self, w: Tensor):
        """One X pass: value, gradient and fresh margins at w."""
        b, obj = self.batch, self.objective
        ew = w if self.factors is None else w * self.factors
        val, g, z = fused_value_grad(obj.loss, ew, b.features, b.label, b.offset, b.weight, return_margins=True)
        if self.factors is not None:
            g = g * self.factors
        if self.has_l2:
            g = g + self.l2 * obj._l2_mask(w)
        return val + self._l2_value(w), g, z

    def _grad_from_margins(self, z: Tensor, w: Tensor) -> Tensor:
        b, obj = self.batch, self.objective
        dz = b.weight * obj.loss.dz(z, b.label)
        g = rmatvec(b.features, dz)
        if self.shifts is not None:
            g = g - torch.sum(dz) * self.shifts
        if self.factors is not None:
            g = g * self.factors
        if self.has_l2:
            g = g + self.l2 * obj._l2_mask(w)
        return g

    def _put(self, name: str, value: Tensor, dtype=None) -> None:
        """Write state ``name`` in place (allocated on the first solve)."""
        value = value if dtype is None else value.to(dtype)
        if name in self.s:
            self.s[name].copy_(value)
        else:
            self.s[name] = value.clone()

    # --- the state machine ---

    def init(self) -> None:
        w0 = self.w0
        if self.use_fused:
            f, g, z = self._fused(w0)
            evals = 1
        else:
            z = self.objective.margins(w0, self.batch)
            f = self._data_value(z) + self._l2_value(w0)
            g = self._grad_from_margins(z, w0)
            evals = 2
        g0_norm = torch.linalg.norm(g)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        self._put("w", w0)
        self._put("z", z)
        self._put("f", f)
        self._put("g", g, self.dtype)
        self._put("g0_norm", g0_norm)
        self._put("it", torch.zeros((), dtype=torch.int32, device=self.device))
        self._put("reason", torch.full((), REASON_NOT_CONVERGED, dtype=torch.int32, device=self.device))
        self._put("evals", torch.full((), evals, dtype=torch.int32, device=self.device))
        self._put("loss_hist", f.reshape(1).repeat(self.config.history_len))
        self._put("gnorm_hist", g0_norm.reshape(1).repeat(self.config.history_len))
        self.hist.reset()
        # The search in flight: its direction, u = X·p, the L2 terms along it,
        # and its state (none in flight: done).
        self._put("p", torch.zeros_like(w0))
        self._put("u", torch.zeros_like(z))
        for name in ("dg0", "f_l2", "l2_a", "l2_b"):
            self._put(name, zero)
        f0 = self.s["f"]
        self._put("ls", wolfe_start(f0, f0, f0, torch.zeros((), dtype=torch.bool, device=self.device)))

    def running(self) -> Tensor:
        return (self.s["reason"] == REASON_NOT_CONVERGED) & (self.s["it"] < self.config.max_iter)

    def step(self) -> None:
        """Start an iteration if no search is in flight, run up to
        TRIALS_PER_STEP trials of the search, and finish the iteration if
        the search is done; each part kept only where it applies."""
        S, obj, cfg = self.s, self.objective, self.config
        l2, max_evals = self.l2, cfg.max_line_search_evals
        run = self.running()
        w, z, f, g, ls = S["w"], S["z"], S["f"], S["g"], S["ls"]

        # --- start: direction, u = X·p (the one X pass of the search) ---
        p = self.hist.direction(g)
        dg0 = torch.dot(p, g)
        bad_dir = dg0 >= 0
        p = torch.where(bad_dir, -g, p)
        dg0 = torch.where(bad_dir, -torch.dot(g, g), dg0)
        if self.has_l2:
            wm, pm = obj._l2_mask(w), obj._l2_mask(p)
            l2_a, l2_b = l2 * torch.dot(wm, pm), l2 * torch.dot(pm, pm)
        else:
            l2_a = l2_b = torch.zeros((), dtype=self.dtype, device=self.device)
        init_alpha = torch.where(self.hist.num_stored == 0,
                                 torch.clamp(1.0 / torch.clamp(torch.linalg.norm(g), min=1e-12), max=1.0), 1.0)
        Commit(run & ~wolfe_running(ls, max_evals)).update(S, dict(
            p=p, u=self._direction_margins(p), dg0=dg0, f_l2=self._l2_value(w), l2_a=l2_a, l2_b=l2_b,
            ls=wolfe_start(f, dg0, init_alpha.to(self.dtype), run)))

        # --- trials on the margins: O(n) each ---
        p, u, dg0, f_l2, l2_a, l2_b = (S[k] for k in ("p", "u", "dg0", "f_l2", "l2_a", "l2_b"))
        b = self.batch
        for _ in range(TRIALS_PER_STEP):
            t = Commit(run & wolfe_running(ls, max_evals))
            a = wolfe_alpha(ls)
            za = z + a * u
            dza = b.weight * obj.loss.dz(za, b.label)
            val = self._data_value(za) + f_l2 + a * l2_a + 0.5 * a * a * l2_b
            deriv = torch.dot(u, dza) + l2_a + a * l2_b
            t.set(ls, wolfe_update(ls, val, deriv, f, dg0))

        # --- finish: the second X pass, the history, the convergence test ---
        done = run & ~wolfe_running(ls, max_evals)
        alpha = wolfe_result(ls, f).alpha
        w_new = w + alpha * p
        if self.use_fused:
            # Second X pass: value, gradient and exact fresh margins.
            f_new, g_new, z_new = self._fused(w_new)
        else:
            z_new = z + alpha * u
            f_new = self._data_value(z_new) + self._l2_value(w_new)
            g_new = self._grad_from_margins(z_new, w_new)
        f_new, g_new = f_new.to(self.dtype), g_new.to(self.dtype)

        s, y = w_new - w, g_new - g
        it = S["it"] + 1
        gn = torch.linalg.norm(g_new)
        reason = check_convergence(f_new, f, gn, S["g0_norm"], cfg.tol, it, cfg.max_iter)
        loss_hist, gnorm_hist = record(S["loss_hist"], it, f_new), record(S["gnorm_hist"], it, gn)
        self.hist.push(s, y, torch.dot(s, y), done)
        Commit(done).update(S, dict(w=w_new, z=z_new, f=f_new, g=g_new, it=it, reason=reason, evals=S["evals"] + 2,
                                    loss_hist=loss_hist, gnorm_hist=gnorm_hist))

    def finish(self) -> None:
        S = self.s
        self.out = finish_result(S["w"], S["f"], torch.linalg.norm(S["g"]), S["it"], S["reason"], S["loss_hist"],
                                 S["gnorm_hist"], S["evals"], eval_unit="x_passes")

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
    prog = MarginLBFGS(objective, batch, w0, config)
    run_chunked(prog, EAGER_CHUNK)
    return prog.result()
