"""L-BFGS two-loop recursion (port of
photon_tpu/optim/lbfgs.py::two_loop_direction). ``minimize_lbfgs`` and
``minimize_lbfgsb`` are not ported yet.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def two_loop_direction(grad: Tensor, s_hist: Tensor, y_hist: Tensor, rho_hist: Tensor,
                       num_stored: int, head: int) -> Tensor:
    """Search direction −H·grad from a circular (m, d) history; ``head`` is
    the slot of the most recent pair and ``num_stored`` the filled count
    (both host ints, so unfilled slots are simply skipped)."""
    m = s_hist.shape[0]
    q = grad
    alphas = [None] * m
    for i in range(num_stored):
        slot = (head - i) % m
        alphas[slot] = rho_hist[slot] * torch.dot(s_hist[slot], q)
        q = q - alphas[slot] * y_hist[slot]

    # Initial Hessian scaling gamma = s·y / y·y from the most recent pair.
    recent = head % m
    sy = torch.dot(s_hist[recent], y_hist[recent])
    yy = torch.dot(y_hist[recent], y_hist[recent])
    if num_stored > 0:
        gamma = torch.where(yy > 0, sy / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
    else:
        gamma = torch.ones_like(yy)
    r = gamma * q

    for i in range(num_stored):
        slot = (head - (num_stored - 1 - i)) % m
        beta = rho_hist[slot] * torch.dot(y_hist[slot], r)
        r = r + (alphas[slot] - beta) * s_hist[slot]
    return -r
