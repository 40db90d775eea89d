"""Strong-Wolfe line search (port of photon_tpu/optim/linesearch.py).

The same bracket/zoom state machine with safeguarded quadratic
interpolation (Nocedal & Wright alg. 3.5/3.6). The reference runs it as a
``lax.while_loop``; here it is a host loop over numpy scalars of the
objective's dtype, with one device read per evaluation (the value and the
directional derivative together).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from photon_tpu_torch.optim.common import HOST_READS

_BRACKET, _ZOOM, _DONE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class LineSearchResult:
    alpha: np.floating
    value: np.floating
    deriv: np.floating
    evals: int
    success: bool


def _interp(a_lo, f_lo, g_lo, a_hi, f_hi):
    """Safeguarded quadratic interpolation for the zoom trial point."""
    d = a_hi - a_lo
    denom = f_hi - f_lo - g_lo * d
    a_q = a_lo - 0.5 * g_lo * d * d / (denom if abs(denom) > 1e-20 else 1.0)
    lo, hi = min(a_lo, a_hi), max(a_lo, a_hi)
    margin = 0.1 * (hi - lo)
    bad = np.isnan(a_q) or abs(denom) <= 1e-20 or a_q < lo + margin or a_q > hi - margin
    return 0.5 * (a_lo + a_hi) if bad else a_q


def strong_wolfe(
    fg: Callable[[np.floating], Tuple[torch.Tensor, torch.Tensor]],
    f0: np.floating,
    dg0: np.floating,
    init_alpha: np.floating,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_evals: int = 20,
    max_alpha: float = 1e10,
) -> LineSearchResult:
    """Find alpha with f(a) <= f0 + c1 a dg0 and |f'(a)| <= c2 |dg0|.

    ``fg(alpha)`` returns device scalars (f(x + alpha p), p·∇f(x + alpha p));
    ``f0``, ``dg0`` and ``init_alpha`` are numpy scalars of the working
    dtype (dg0 < 0). On budget exhaustion returns the best
    sufficient-decrease point seen, else the zoom's lo end.
    """
    dt = np.asarray(f0).dtype.type
    zero = dt(0)
    with np.errstate(all="ignore"):
        phase = _BRACKET
        a_prev, f_prev, g_prev = zero, f0, dg0
        a_lo, f_lo, g_lo = zero, f0, dg0
        a_hi, f_hi = zero, f0
        a_cur = dt(init_alpha)
        evals = 0
        a_best, f_best, g_best = zero, f0, dg0
        success = False

        while phase != _DONE and evals < max_evals:
            f, g = HOST_READS.read(*fg(a_cur))
            evals += 1
            ok = f <= f0 + c1 * a_cur * dg0
            if ok and f < f_best:
                a_best, f_best, g_best = a_cur, f, g
            curv = abs(g) <= -c2 * dg0
            if phase == _BRACKET:
                fail = (not ok) or (evals > 1 and f >= f_prev)
                wolfe = ok and curv
                rising = ok and g >= 0
                if fail:
                    lo, hi = (a_prev, f_prev, g_prev), (a_cur, f)
                else:
                    lo, hi = (a_cur, f, g), (a_prev, f_prev)
                to_zoom = fail or rising
                phase = _DONE if wolfe else (_ZOOM if to_zoom else _BRACKET)
                trial = _interp(*lo, *hi) if to_zoom else dt(min(2.0 * a_cur, max_alpha))
                (a_lo, f_lo, g_lo), (a_hi, f_hi) = lo, hi
            else:
                fail = (not ok) or f >= f_lo
                wolfe = (not fail) and curv
                flip = (not fail) and g * (a_hi - a_lo) >= 0
                if fail:
                    a_hi, f_hi = a_cur, f
                else:
                    if flip:
                        a_hi, f_hi = a_lo, f_lo
                    a_lo, f_lo, g_lo = a_cur, f, g
                dead = abs(a_hi - a_lo) <= 1e-12 * max(1.0, a_hi)
                phase = _DONE if (wolfe or dead) else _ZOOM
                trial = _interp(a_lo, f_lo, g_lo, a_hi, f_hi)
            if wolfe:
                a_best, f_best, g_best = a_cur, f, g
                success = True
            a_prev, f_prev, g_prev = a_cur, f, g
            a_cur = dt(trial)

        if success or f_best < f0:
            return LineSearchResult(a_best, f_best, g_best, evals, success)
        return LineSearchResult(a_lo, f_lo, g_lo, evals, success)
