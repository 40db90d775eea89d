"""Damped (Levenberg) Newton for small-dimension GLMs, batched over the
entities of a block (port of photon_tpu/optim/newton.py::minimize_newton).

The reference writes the solve for one entity and vmaps it; vmap of a
``lax.while_loop`` runs the body for every lane while any lane's condition
holds and keeps each finished lane frozen. Here the state carries the
leading entity axis E and an ``active`` mask does the freezing, so every
lane follows exactly its unbatched trajectory. The loop ends when no lane
is active (one host read per iteration) or at ``max_iter``.

Each iteration is two X passes: the Newton system (H, g) from the carried
margins — through the fused kernel (ops/fused_newton.py) when ``kernel`` is
"cuda" or "cuda_bf16x" — and the trial margins, after which step-halving
trials are O(n) on the margins. A failed Cholesky sets the lane's step to
NaN, which lands in the reject branch as in the reference.
"""

from __future__ import annotations

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.ops.fused_newton import newton_system
from photon_tpu_torch.ops.objective import GLMObjective
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

_MU_INIT = 0.0  # pure Newton first; L2'd GLM Hessians are PD
_MU_BOOST = 10.0
_MU_SHRINK = 0.25
_MU_MIN_ON_REJECT = 1e-4
_TRIAL_STEPS = (1.0, 0.5, 0.25, 0.125, 1 / 16, 1 / 32, 1 / 64)


def _bmv(X: Tensor, w: Tensor) -> Tensor:
    """(E, n, d) · (E, d) → (E, n)."""
    return torch.bmm(X, w[:, :, None])[:, :, 0]


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
    entity."""
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

    loss = objective.loss
    l2 = objective.l2_weight
    has_l2 = l2 != 0.0
    label, weight, offset = batch.label, batch.weight, batch.offset
    X = batch.features
    if norm is not None and norm.factors is not None:
        X = X * norm.factors
    E, _, d = X.shape
    dtype, device = w0.dtype, w0.device
    m_iter, tol = config.max_iter, config.tol
    ii = objective.intercept_index

    use_fused = kernel != "torch"
    X_sys = X.to(torch.bfloat16) if kernel == "cuda_bf16x" else X

    def l2_mask(w: Tensor) -> Tensor:
        if ii is None:
            return w
        w = w.clone()
        w[..., ii] = 0.0
        return w

    def l2_value(w: Tensor) -> Tensor:  # (..., d) → (...)
        if not has_l2:
            return torch.zeros(w.shape[:-1], dtype=dtype, device=device)
        wm = l2_mask(w)
        return 0.5 * l2 * torch.sum(wm * wm, dim=-1)

    def data_value(z: Tensor) -> Tensor:  # (..., n) → (...)
        return torch.sum(weight * loss.value(z, label), dim=-1)

    lam_diag = torch.zeros(d, dtype=dtype, device=device)
    if has_l2:
        lam_diag = torch.full((d,), l2, dtype=dtype, device=device)
        if ii is not None:
            lam_diag[ii] = 0.0
    lam_H = torch.diag(lam_diag)

    w = w0
    z = _bmv(X, w0) + offset
    f = data_value(z) + l2_value(w0)
    mu = torch.full((E,), _MU_INIT, dtype=dtype, device=device)
    gnorm = torch.full((E,), float("inf"), dtype=dtype, device=device)
    g0_norm = torch.zeros(E, dtype=dtype, device=device)
    it = torch.zeros(E, dtype=torch.int32, device=device)
    reason = torch.full((E,), REASON_NOT_CONVERGED, dtype=torch.int32, device=device)
    evals = torch.ones(E, dtype=torch.int32, device=device)
    ts = torch.tensor(_TRIAL_STEPS, dtype=dtype, device=device)

    for _ in range(m_iter):
        active = (reason == REASON_NOT_CONVERGED) & (it < m_iter)
        if not bool(HOST_READS.read(active.any())[0]):
            break
        # --- pass 1: gradient and Hessian from the carried margins ---
        dz = weight * loss.dz(z, label)
        d2 = weight * loss.dzz(z, label)
        if use_fused:
            H_data, g_data = newton_system(X_sys, d2, dz)
            H_data, g_data = H_data.to(dtype), g_data.to(dtype)
        else:
            g_data = torch.einsum("bnd,bn->bd", X, dz)
            H_data = torch.einsum("bnd,bn,bne->bde", X, d2, X)
        g = g_data + (l2 * l2_mask(w) if has_l2 else 0.0)
        H = H_data + lam_H
        gn_new = torch.linalg.norm(g, dim=-1)
        g0n_new = torch.where(it == 0, gn_new, g0_norm)

        # Levenberg system (H + mu diag(H)) p = -g, diagonal floored so a
        # dead column still becomes PD under damping.
        diag_h = torch.diagonal(H, dim1=-2, dim2=-1)
        floor = 1e-7 * torch.clamp(diag_h.max(dim=-1).values, min=1.0)
        Hd = H + mu[:, None, None] * torch.diag_embed(torch.maximum(diag_h, floor[:, None]))
        chol, info = torch.linalg.cholesky_ex(Hd)
        p = -torch.cholesky_solve(g[:, :, None], chol)[:, :, 0]
        p = torch.where((info != 0)[:, None], torch.full_like(p, float("nan")), p)

        # --- pass 2: trial margins, then backtracking on the margins ---
        w_try = w + p
        z_try = _bmv(X, w_try) + offset
        u = z_try - z
        z_trials = z[:, None, :] + ts[None, :, None] * u[:, None, :]  # (E, len(ts), n)
        fs = torch.sum(weight[:, None, :] * loss.value(z_trials, label[:, None, :]), dim=-1)
        fs = fs + l2_value(w[:, None, :] + ts[None, :, None] * p[:, None, :])
        fs = torch.where(torch.isnan(fs), float("inf"), fs)
        ib = torch.argmin(fs, dim=-1)
        f_best = fs.gather(1, ib[:, None])[:, 0]
        t_best = ts[ib]
        accept = f_best <= f

        w_new = torch.where(accept[:, None], w + t_best[:, None] * p, w)
        z_new = torch.where(accept[:, None], z + t_best[:, None] * u, z)
        f_new = torch.where(accept, f_best, f)
        mu_new = torch.where(
            accept & (t_best == 1.0),
            mu * _MU_SHRINK,
            torch.where(accept, mu, torch.clamp(mu, min=_MU_MIN_ON_REJECT) * _MU_BOOST),
        )
        it_new = it + 1
        r_new = check_convergence(f_best, f, gn_new, g0n_new, tol, it_new, m_iter)
        r_new = torch.where(torch.isfinite(f_new), r_new, REASON_DIVERGED).to(torch.int32)

        # Freeze finished lanes (vmap-of-while_loop semantics).
        a1, a2 = active, active[:, None]
        w = torch.where(a2, w_new, w)
        z = torch.where(a2, z_new, z)
        f = torch.where(a1, f_new, f)
        mu = torch.where(a1, mu_new, mu)
        gnorm = torch.where(a1, gn_new, gnorm)
        g0_norm = torch.where(a1, g0n_new, g0_norm)
        reason = torch.where(a1, r_new, reason)
        evals = torch.where(a1, evals + 2, evals)
        it = torch.where(a1, it_new, it)

    reason = torch.where(reason == REASON_NOT_CONVERGED, REASON_MAX_ITERATIONS, reason)
    return OptimizeResult(
        w=w, value=f, grad_norm=gnorm, iterations=it, reason_code=reason.to(torch.int32),
        loss_history=f[:, None], grad_norm_history=gnorm[:, None], evals=evals,
        eval_unit="x_passes",
    )
