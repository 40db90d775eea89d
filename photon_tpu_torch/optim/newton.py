"""Damped (Levenberg) Newton for small-dimension GLMs, batched over the
entities of a block (port of photon_tpu/optim/newton.py::minimize_newton).

The reference writes the solve for one entity and vmaps it; vmap of a
``lax.while_loop`` runs the body for every lane while any lane's condition
holds and keeps each finished lane frozen. Here the state carries the
leading entity axis E and an ``active`` mask does the freezing, so every
lane follows exactly its unbatched trajectory. The loop ends when no lane
is active (one host read per chunk of iterations, optim/program.py) or at
``max_iter``. The L2 weight is a device scalar (``l2``) the steps read, so
one captured solve serves every weight.

Candidate lanes (``l2_lanes``): q candidates of a tuning round share the
block, each with its own L2 weight and offsets, as a (q, E) lane grid over
the one X (the reference vmaps the block solve over candidates). The
margins of all q lanes are one product with X; the Newton systems are q
launches of K3 over the one slab (or q einsums on the plain path), so X is
never copied q times.

Each iteration is two X passes: the Newton system (H, g) from the carried
margins — through the fused kernel (ops/fused_newton.py) when ``kernel`` is
"cuda" or "cuda_bf16x" — and the trial margins, after which step-halving
trials are O(n) on the margins. A failed Cholesky sets the lane's step to
NaN, which lands in the reject branch as in the reference. Each lane
records its value and gradient norm a step into histories of
``config.history_len`` slots, as the reference's loop does.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.ops.fused_newton import newton_system
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import (
    OptimizeResult,
    OptimizerConfig,
    REASON_DIVERGED,
    REASON_MAX_ITERATIONS,
    REASON_NOT_CONVERGED,
    check_convergence,
    record,
)
from photon_tpu_torch.optim.problem import L2Term
from photon_tpu_torch.optim.program import EAGER_CHUNK, Commit, Program, run_chunked

Tensor = torch.Tensor

_MU_INIT = 0.0  # pure Newton first; L2'd GLM Hessians are PD
_MU_BOOST = 10.0
_MU_SHRINK = 0.25
_MU_MIN_ON_REJECT = 1e-4
_TRIAL_STEPS = (1.0, 0.5, 0.25, 0.125, 1 / 16, 1 / 32, 1 / 64)


def _bmv(X: Tensor, w: Tensor) -> Tensor:
    """(E, n, d) · (E, d) → (E, n); with candidate lanes (E, n, d) · (q, E, d)
    → (q, E, n), one product over the shared X."""
    if w.dim() == 3:
        return torch.bmm(X, w.permute(1, 2, 0)).permute(2, 0, 1)
    return torch.bmm(X, w[:, :, None])[:, :, 0]


@contextlib.contextmanager
def _cusolver(device: torch.device) -> Iterator[None]:
    """Pin the batched Cholesky to cuSOLVER on the card: it runs inside a
    captured graph (MAGMA's batched path may synchronize), and the eager and
    captured solves then do the same arithmetic."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _check(objective: GLMObjective, kernel: str) -> None:
    if objective.l1_weight > 0.0:
        raise ValueError("Newton solves smooth objectives; use OWL-QN for L1")
    if kernel not in ("torch", "cuda", "cuda_bf16x"):
        raise ValueError(
            f"minimize_newton kernel must be 'torch', 'cuda' or 'cuda_bf16x' (got {kernel!r}; "
            "resolve 'auto' via ops.fused_newton.resolve_re_kernel first)"
        )
    norm = objective.normalization
    if norm is not None and not norm.is_identity and norm.shifts is not None:
        raise ValueError("minimize_newton supports scale normalization only")


class Newton(Program):
    """Batched Levenberg-damped Newton as a device state machine. ``batch``
    (label/offset/weight (E, n), features (E, n, d)) and ``w0`` (E, d) are
    read by ``init``; every constant is built here, outside any capture.
    With ``l2_lanes`` (q, E), the objective's L2 weight is one a lane of a
    (q, E) grid over the shared block: ``w0`` (q, E, d) and the batch's
    offset (q, E, n)."""

    eval_unit = "x_passes"

    def __init__(self, objective: GLMObjective, batch: LabeledBatch, w0: Tensor,
                 config: OptimizerConfig = OptimizerConfig(), kernel: str = "torch",
                 l2_lanes: Optional[Tensor] = None):
        if isinstance(batch.features, SparseFeatures):
            raise ValueError("minimize_newton requires dense features")
        _check(objective, kernel)
        self.objective, self.batch, self.w0, self.config, self.kernel = objective, batch, w0, config, kernel
        self.max_steps = config.max_iter
        norm = objective.normalization
        self.factors = norm.factors if norm is not None and norm.factors is not None else None
        d = batch.features.shape[-1]
        lanes = tuple(w0.shape[:-1])
        self.candidates = len(lanes) == 2
        dtype, device = w0.dtype, w0.device
        self.dtype, self.device = dtype, device
        self.reg = L2Term(objective.l2_weight if l2_lanes is None else l2_lanes, objective.intercept_index, d, dtype,
                          device)
        self.l2 = self.reg.l2
        self.init_passes = 1 if self.factors is None else 2
        self.ts = torch.tensor(_TRIAL_STEPS, dtype=dtype, device=device)
        z = torch.zeros(lanes + tuple(batch.label.shape[-1:]), dtype=torch.promote_types(batch.features.dtype, dtype),
                        device=device)
        lane = lambda v, dt=dtype: torch.full(lanes, v, dtype=dt, device=device)  # noqa: E731
        hist = lambda: torch.zeros(lanes + (config.history_len,), dtype=dtype, device=device)  # noqa: E731
        self.slots = torch.arange(config.history_len, device=device)
        self.s = dict(w=torch.zeros_like(w0), z=z, f=lane(0.0), mu=lane(_MU_INIT), gnorm=lane(float("inf")),
                      g0_norm=lane(0.0), it=lane(0, torch.int32), reason=lane(REASON_NOT_CONVERGED, torch.int32),
                      evals=lane(1, torch.int32), loss_hist=hist(), gnorm_hist=hist())
        if self.factors is not None:
            self.s["X"] = torch.empty(batch.features.shape, dtype=torch.promote_types(batch.features.dtype,
                                                                                      self.factors.dtype),
                                      device=device)

    def _X(self) -> Tensor:
        """The features with the normalization factors folded in (by ``init``)."""
        return self.batch.features if self.factors is None else self.s["X"]

    def _data_value(self, z: Tensor) -> Tensor:  # (..., n) → (...)
        b = self.batch
        return torch.sum(b.weight * self.objective.loss.value(z, b.label), dim=-1)

    def init(self) -> None:
        S, w0 = self.s, self.w0
        if self.factors is not None:
            torch.mul(self.batch.features, self.factors, out=S["X"])
        z = _bmv(self._X(), w0) + self.batch.offset
        S["w"].copy_(w0)
        S["z"].copy_(z)
        S["f"].copy_(self._data_value(z) + self.reg.value(w0))
        S["loss_hist"].copy_(S["f"][..., None].expand_as(S["loss_hist"]))
        S["gnorm_hist"].fill_(float("inf"))
        S["mu"].fill_(_MU_INIT)
        S["gnorm"].fill_(float("inf"))
        S["g0_norm"].zero_()
        S["it"].zero_()
        S["reason"].fill_(REASON_NOT_CONVERGED)
        S["evals"].fill_(1)

    def _active(self) -> Tensor:
        return (self.s["reason"] == REASON_NOT_CONVERGED) & (self.s["it"] < self.config.max_iter)

    def running(self) -> Tensor:
        return self._active().any()

    def step(self) -> None:
        S, obj, b = self.s, self.objective, self.batch
        loss = obj.loss
        active = self._active()
        c = Commit(active.any())
        w, z, f, mu, it = S["w"], S["z"], S["f"], S["mu"], S["it"]
        X = self._X()
        # --- pass 1: gradient and Hessian from the carried margins ---
        dz = b.weight * loss.dz(z, b.label)
        d2 = b.weight * loss.dzz(z, b.label)
        if self.candidates:
            # q systems over the one slab: a launch (or an einsum) a candidate.
            systems = [self._system(X, d2[i], dz[i]) for i in range(d2.shape[0])]
            H_data, g_data = torch.stack([h for h, _ in systems]), torch.stack([g for _, g in systems])
        else:
            H_data, g_data = self._system(X, d2, dz)
        if self.reg.on:
            g = g_data + self.reg.grad(w)
            H = H_data + torch.diag_embed(self.l2[..., None] * self.reg.cols)
        else:
            g, H = g_data, H_data
        gn_new = torch.linalg.norm(g, dim=-1)
        g0n_new = torch.where(it == 0, gn_new, S["g0_norm"])

        # Levenberg system (H + mu diag(H)) p = -g, diagonal floored so a
        # dead column still becomes PD under damping.
        diag_h = torch.diagonal(H, dim1=-2, dim2=-1)
        floor = 1e-7 * torch.clamp(diag_h.max(dim=-1).values, min=1.0)
        Hd = H + mu[..., None, None] * torch.diag_embed(torch.maximum(diag_h, floor[..., None]))
        with _cusolver(self.device):
            chol, info = torch.linalg.cholesky_ex(Hd)
            p = -torch.cholesky_solve(g[..., None], chol)[..., 0]
        p = torch.where((info != 0)[..., None], torch.full_like(p, float("nan")), p)

        # --- pass 2: trial margins, then backtracking on the margins ---
        ts = self.ts
        w_try = w + p
        z_try = _bmv(X, w_try) + b.offset
        u = z_try - z
        z_trials = z[..., None, :] + ts[:, None] * u[..., None, :]  # (lanes, len(ts), n)
        fs = torch.sum(b.weight[..., None, :] * loss.value(z_trials, b.label[..., None, :]), dim=-1)
        fs = fs + self.reg.value(w[..., None, :] + ts[:, None] * p[..., None, :])
        fs = torch.where(torch.isnan(fs), float("inf"), fs)
        ib = torch.argmin(fs, dim=-1)
        f_best = fs.gather(-1, ib[..., None])[..., 0]
        t_best = ts[ib]
        accept = f_best <= f

        w_new = torch.where(accept[..., None], w + t_best[..., None] * p, w)
        z_new = torch.where(accept[..., None], z + t_best[..., None] * u, z)
        f_new = torch.where(accept, f_best, f)
        mu_new = torch.where(
            accept & (t_best == 1.0),
            mu * _MU_SHRINK,
            torch.where(accept, mu, torch.clamp(mu, min=_MU_MIN_ON_REJECT) * _MU_BOOST),
        )
        it_new = it + 1
        r_new = check_convergence(f_best, f, gn_new, g0n_new, self.config.tol, it_new, self.config.max_iter)
        r_new = torch.where(torch.isfinite(f_new), r_new, REASON_DIVERGED).to(torch.int32)

        # Freeze finished lanes (vmap-of-while_loop semantics).
        a1, a2 = active, active[..., None]
        c.update(S, dict(
            w=torch.where(a2, w_new, w), z=torch.where(a2, z_new, z), f=torch.where(a1, f_new, f),
            mu=torch.where(a1, mu_new, mu), gnorm=torch.where(a1, gn_new, S["gnorm"]),
            g0_norm=torch.where(a1, g0n_new, S["g0_norm"]), reason=torch.where(a1, r_new, S["reason"]),
            evals=torch.where(a1, S["evals"] + 2, S["evals"]), it=torch.where(a1, it_new, it),
            loss_hist=torch.where(a2, record(S["loss_hist"], it_new, f_new), S["loss_hist"]),
            gnorm_hist=torch.where(a2, record(S["gnorm_hist"], it_new, gn_new), S["gnorm_hist"])))

    def _system(self, X: Tensor, d2: Tensor, dz: Tensor):
        """(Xᵀ·diag(d2)·X, Xᵀ·dz) of every entity: K3 or the plain einsums."""
        if self.kernel != "torch":
            X_sys = X.to(torch.bfloat16) if self.kernel == "cuda_bf16x" else X
            H_data, g_data = newton_system(X_sys, d2, dz)
            return H_data.to(self.dtype), g_data.to(self.dtype)
        return torch.einsum("bnd,bn,bne->bde", X, d2, X), torch.einsum("bnd,bn->bd", X, dz)

    def finish(self) -> None:
        """The result; past a lane's last iteration its histories hold its
        final value and |g|, and |g| at the start is entry 0 of the gradient
        history (inf where no iteration ran), as in the reference."""
        S = self.s
        reason = torch.where(S["reason"] == REASON_NOT_CONVERGED, REASON_MAX_ITERATIONS, S["reason"])
        past = self.slots > S["it"][..., None]
        loss_hist = torch.where(past, S["f"][..., None], S["loss_hist"])
        gnorm_hist = torch.where(past, S["gnorm"][..., None], S["gnorm_hist"])
        start = torch.where(S["it"] > 0, S["g0_norm"], S["gnorm"])
        gnorm_hist = torch.where(self.slots == 0, start[..., None], gnorm_hist)
        self.out = OptimizeResult(
            w=S["w"], value=S["f"], grad_norm=S["gnorm"], iterations=S["it"], reason_code=reason.to(torch.int32),
            loss_history=loss_hist, grad_norm_history=gnorm_hist, evals=S["evals"], eval_unit="x_passes",
        )

    def result(self) -> OptimizeResult:
        return self.out


def minimize_newton(
    objective: GLMObjective,
    batch: LabeledBatch,
    w0: Tensor,
    config: OptimizerConfig = OptimizerConfig(),
    kernel: str = "torch",
) -> OptimizeResult:
    """Batched Levenberg-damped Newton. ``batch`` holds one entity per
    leading row: label/offset/weight (E, n), features (E, n, d); ``w0`` is
    (E, d). ``kernel`` is a resolved routing value
    (ops.fused_newton.resolve_re_kernel): "torch", "cuda" or "cuda_bf16x".
    Margins always use the f32 slab. ``result.evals`` counts X passes per
    entity. Runs eagerly, EAGER_CHUNK iterations between host reads."""
    prog = Newton(objective, batch, w0, config, kernel)
    run_chunked(prog, EAGER_CHUNK)
    return prog.result()
