"""Strong-Wolfe line search (port of photon_tpu/optim/linesearch.py).

The same bracket/zoom state machine with safeguarded quadratic
interpolation (Nocedal & Wright alg. 3.5/3.6), written as tensors in the
objective's dtype: ``wolfe_start`` makes the state, ``wolfe_update`` takes
it one trial further. The state is one tensor, (15,) for one search or
(E, 15) for one per lane of an entity block, and every operation works
lane by lane. The L-BFGS state machines (optim/margin_lbfgs.py,
optim/lbfgs.py) run the trials on the device, each kept only while its
search runs.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

_BRACKET, _ZOOM, _DONE = 0, 1, 2
C1, C2, MAX_ALPHA = 1e-4, 0.9, 1e10

# The state of a search is one tensor (..., 15) of the objective's dtype,
# these columns (phase, evals and success as small whole numbers), so that a
# trial reads it through views and writes it back at once.
FIELDS = ("phase", "a_prev", "f_prev", "g_prev", "a_lo", "f_lo", "g_lo", "a_hi", "f_hi", "a_cur", "evals",
          "a_best", "f_best", "g_best", "success")
(_PHASE, _A_PREV, _F_PREV, _G_PREV, _A_LO, _F_LO, _G_LO, _A_HI, _F_HI, _A_CUR, _EVALS, _A_BEST, _F_BEST, _G_BEST,
 _SUCCESS) = range(len(FIELDS))


@dataclasses.dataclass(frozen=True)
class LineSearchResult:
    alpha: Tensor
    value: Tensor
    deriv: Tensor
    evals: Tensor
    success: Tensor


def _interp(lo: Tensor, hi: Tensor) -> Tensor:
    """Safeguarded quadratic interpolation for the zoom trial point, from lo
    (..., 3) = (a, f, f') and hi (..., 2) = (a, f)."""
    a_lo, f_lo, g_lo, a_hi, f_hi = lo[..., 0], lo[..., 1], lo[..., 2], hi[..., 0], hi[..., 1]
    d = a_hi - a_lo
    denom = f_hi - f_lo - g_lo * d
    a_q = a_lo - 0.5 * g_lo * d * d / torch.where(torch.abs(denom) > 1e-20, denom, 1.0)
    lo_a, hi_a = torch.minimum(a_lo, a_hi), torch.maximum(a_lo, a_hi)
    margin = 0.1 * (hi_a - lo_a)
    bad = (torch.isnan(a_q) | (torch.abs(denom) <= 1e-20) | (a_q < lo_a + margin)
           | (a_q > hi_a - margin))
    return torch.where(bad, 0.5 * (a_lo + a_hi), a_q)


def wolfe_start(f0: Tensor, dg0: Tensor, init_alpha: Tensor, lanes: Tensor) -> Tensor:
    """The state of a search from f0 with slope dg0 < 0, first trial
    ``init_alpha``; lanes where ``lanes`` is false start done."""
    zero = torch.zeros_like(f0)
    phase = torch.where(lanes, _BRACKET, _DONE).to(f0.dtype)
    return torch.stack([phase, zero, f0, dg0, zero, f0, dg0, zero, f0, init_alpha.to(f0.dtype), zero, zero, f0, dg0,
                        zero], dim=-1)


def wolfe_running(st: Tensor, max_evals: int) -> Tensor:
    return (st[..., _PHASE] != _DONE) & (st[..., _EVALS] < max_evals)


def wolfe_alpha(st: Tensor) -> Tensor:
    """The step of the next trial."""
    return st[..., _A_CUR]


def wolfe_update(st: Tensor, f: Tensor, g: Tensor, f0: Tensor, dg0: Tensor, c1: float = C1, c2: float = C2,
                 max_alpha: float = MAX_ALPHA) -> Tensor:
    """The state after the trial at a_cur returned value f and directional
    derivative g (whether or not the lane was running: the caller keeps the
    old state where it was not). Both phases' candidates are formed and the
    lane's phase picks one."""
    a_cur = st[..., _A_CUR]
    cur = torch.stack([a_cur, f, g], dim=-1)
    prev, lo_z, hi_z = st[..., _A_PREV:_G_PREV + 1], st[..., _A_LO:_G_LO + 1], st[..., _A_HI:_F_HI + 1]
    ok = f <= f0 + c1 * a_cur * dg0
    curv = torch.abs(g) <= -c2 * dg0
    # Bracket phase: zoom(lo=prev, hi=cur) on a failure, zoom(lo=cur,
    # hi=prev) on a rise, else double the step.
    fail_b = ~ok | ((st[..., _EVALS] > 0) & (f >= st[..., _F_PREV]))
    zoom_b = fail_b | (g >= 0)
    # Zoom phase: hi ← cur on a failure, else lo ← cur (and hi ← old lo when
    # the slope says the minimum is on the other side).
    fail_z = ~ok | (f >= st[..., _F_LO])
    flip = g * (st[..., _A_HI] - st[..., _A_LO]) >= 0
    bracket = st[..., _PHASE] == _BRACKET
    fail = torch.where(bracket, fail_b, fail_z)[..., None]
    lo = torch.where(bracket[..., None], torch.where(fail, prev, cur), torch.where(fail, lo_z, cur))
    hi = torch.where(bracket[..., None], torch.where(fail, cur, prev)[..., :2],
                     torch.where(fail, cur[..., :2], torch.where(flip[..., None], lo_z[..., :2], hi_z)))
    wolfe = ok & curv & ~torch.where(bracket, torch.zeros_like(ok), fail_z)
    dead = torch.abs(hi[..., 0] - lo[..., 0]) <= 1e-12 * torch.clamp(hi[..., 0], min=1.0)
    done = wolfe | (~bracket & dead)
    phase = torch.where(done, _DONE, torch.where(bracket & ~zoom_b, _BRACKET, _ZOOM)).to(f.dtype)
    trial = torch.where(bracket & ~zoom_b, torch.clamp(2.0 * a_cur, max=max_alpha), _interp(lo, hi))
    better = wolfe | (ok & (f < st[..., _F_BEST]))
    best = torch.where(better[..., None], cur, st[..., _A_BEST:_G_BEST + 1])
    return torch.cat([phase[..., None], cur, lo, hi, trial[..., None], st[..., _EVALS:_EVALS + 1] + 1, best,
                      torch.maximum(st[..., _SUCCESS:], wolfe[..., None].to(f.dtype))], dim=-1)


def wolfe_result(st: Tensor, f0: Tensor) -> LineSearchResult:
    """Best Wolfe point, else the best sufficient-decrease point, else the
    zoom's lo end."""
    success = st[..., _SUCCESS] > 0
    take = (success | (st[..., _F_BEST] < f0))[..., None]
    alpha, value, deriv = torch.where(take, st[..., _A_BEST:_G_BEST + 1], st[..., _A_LO:_G_LO + 1]).unbind(-1)
    return LineSearchResult(alpha=alpha, value=value, deriv=deriv, evals=st[..., _EVALS].to(torch.int32),
                            success=success)
