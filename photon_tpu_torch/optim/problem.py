"""The smooth objectives the solver programs minimize (optim/program.py),
with a lane axis: one solve (lanes ()), one per entity of a block (lanes
(E,)), or, for the q candidates of a tuning round over one X, (q,) and
(q, E): the port's counterpart of the reference's closures that
photon_tpu/algorithm/random_effect.py::_solve_block vmaps.

``GLMTerms`` is the data term of a GLM: Σ weight·loss(A·w + offset, label)
over a fixed-effect LabeledBatch (X (n, d), dense or ``SparseFeatures``) or
an entity block (X (E, n, d)), where A·v = X·(f∘v) − s·(f∘v) folds the
normalization (factors f, shifts s). ``GLMOracle`` adds the L2 term, its
weight a device scalar the programs' steps read (so one captured program
serves every weight), and the Pearson feature mask m of a block (the reference's f(w ∘ m), gradient ∘ m and
m ∘ H(m ∘ v)); ``L2Term`` is that L2 term, which the margin L-BFGS and
Newton programs share. ``GLMObjective.oracle`` (ops/objective.py) builds
the oracle of a fixed-effect batch, and the objective's value, gradient
and Hessian products are that oracle's. ``CallableOracle`` wraps a
black-box value-and-gradient (and Hessian-vector product) for the
``minimize_*`` entry points.

An oracle answers each question of a step with one X pass:
  ``value_grad(w)``                  f(w) and ∇f(w);
  ``tron_pass(q, trial, curv)``      lane by lane, where ``trial`` f(q), ∇f(q)
                                     and the curvature state at q, elsewhere
                                     H(curv)·q (TRON's trial point and its CG
                                     and ρ products take turns, one a step).
On a fixed effect that fuses (dense X, no shifts) these are the K1 and K2
kernels (ops/fused_glm.py), each with its launch flag: a disabled launch
returns at once, so a step pays for the one pass it needs. The curvature
state of a GLM is d2 = weight·loss″(margins), from the margins the trial
pass returns (K1's ``return_margins``): no pass of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from photon_tpu_torch.data.batch import LabeledBatch, matvec, matvec_rounded, rmatvec
from photon_tpu_torch.ops.fused_glm import fused_hvp, fused_value_grad
from photon_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Lane-wise dot product over the last axis."""
    return torch.sum(a * b, dim=-1)


class L2Term:
    """½·l2·‖c∘w‖² over the last axis of w: ``l2`` a device scalar the
    programs' steps read (the solve cache fills it per solve, so one captured
    program serves every weight), or one weight a lane (a tensor of the
    lanes' shape: the λ sweep), c zero at the intercept. ``on``: a weight
    the program was built with is not 0 (a zero weight builds no L2 work)."""

    def __init__(self, weight, intercept_index: Optional[int], d: int, dtype, device):
        if isinstance(weight, Tensor):
            self.on = True  # per-lane weights: the reference's traced override
            self.l2 = weight.to(dtype=dtype, device=device).clone()
        else:
            self.on = weight != 0.0
            self.l2 = torch.full((), weight, dtype=dtype, device=device)
        self.cols = torch.ones(d, dtype=dtype, device=device)
        if intercept_index is not None:
            self.cols[intercept_index] = 0.0

    def value(self, w: Tensor) -> Tensor:
        if not self.on:
            return torch.zeros(w.shape[:-1], dtype=self.l2.dtype, device=w.device)
        wc = w * self.cols
        l2 = self.l2
        if l2.dim() and w.dim() - 1 > l2.dim():  # lane weights over points of extra axes (trials)
            l2 = l2.reshape(l2.shape + (1,) * (w.dim() - 1 - l2.dim()))
        return 0.5 * l2 * dot(wc, wc)

    def grad(self, w: Tensor) -> Tensor:
        """The gradient at w, or the Hessian's product with w."""
        return self.l2[..., None] * (w * self.cols)


@dataclasses.dataclass(frozen=True)
class GLMTerms:
    """The data term Σ weight·loss(A·w + offset, label) of one GLM (X 2-D)
    or of every entity of a block (X 3-D). ``fused``: the fixed effect's K1
    and K2 kernels serve the passes. ``col_mask`` (E, d): the columns of X
    are masked (the margin route of a Pearson-capped block); ``X`` is then a
    buffer of the terms' own that ``refresh`` fills from ``source``."""

    loss: PointwiseLoss
    X: Tensor
    label: Tensor
    weight: Tensor
    offset: Tensor
    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    fused: bool = False
    source: Optional[Tensor] = None
    col_mask: Optional[Tensor] = None

    @staticmethod
    def of_batch(objective, batch: LabeledBatch) -> "GLMTerms":
        """The fixed effect's terms (the objective's loss and normalization)."""
        norm = objective.normalization
        folded = norm is not None and not norm.is_identity
        return GLMTerms(objective.loss, batch.features, batch.label, batch.weight, batch.offset,
                        norm.factors if folded else None, norm.shifts if folded else None,
                        objective._can_fuse(batch))

    @staticmethod
    def of_block(objective, block, offsets: Tensor, col_mask: Optional[Tensor] = None) -> "GLMTerms":
        """A block's terms; with ``col_mask`` over X ∘ mask (filled by ``refresh``)."""
        norm = objective.normalization
        folded = norm is not None and not norm.is_identity
        X = block.features if col_mask is None else torch.empty_like(block.features)
        return GLMTerms(objective.loss, X, block.label, block.weight, offsets,
                        norm.factors if folded else None, norm.shifts if folded else None,
                        source=None if col_mask is None else block.features, col_mask=col_mask)

    def refresh(self) -> None:
        """Fill the masked copy of X from the source (a program's ``init``)."""
        if self.col_mask is not None:
            torch.mul(self.source, self.col_mask[:, None, :], out=self.X)

    @property
    def blocked(self) -> bool:
        """X is an entity block (E, n, d)."""
        return isinstance(self.X, Tensor) and self.X.dim() == 3

    def curvature_dtype(self, dtype) -> torch.dtype:
        if self.fused:
            return torch.float32
        return torch.promote_types(torch.promote_types(self.X.dtype, dtype), self.offset.dtype)

    # --- the linear map and its transpose ---

    def forward(self, v: Tensor, rounded: bool = False) -> Tensor:
        """A·v: (lanes, d) → (lanes, n). ``rounded``: a bf16 X takes v rounded
        to bf16 with an f32 product (margin L-BFGS's direction pass)."""
        ev = v if self.factors is None else v * self.factors
        if self.blocked:
            # Candidate lanes (q, E, d) over the shared block: one product.
            u = (torch.bmm(self.X, ev.permute(1, 2, 0)).permute(2, 0, 1) if ev.dim() == 3
                 else torch.bmm(self.X, ev[:, :, None])[:, :, 0])
        else:
            u = matvec_rounded(self.X, ev) if rounded else matvec(self.X, ev)
        return u if self.shifts is None else u - dot(ev, self.shifts)[..., None]

    def transpose(self, r: Tensor) -> Tensor:
        """Aᵀ·r: (lanes, n) → (lanes, d)."""
        if self.blocked:
            g = torch.einsum("bnd,qbn->qbd" if r.dim() == 3 else "bnd,bn->bd", self.X, r)
        else:
            g = rmatvec(self.X, r)
        if self.shifts is not None:
            g = g - torch.sum(r, dim=-1, keepdim=True) * self.shifts
        return g if self.factors is None else g * self.factors

    # --- pointwise terms of the margins z ---

    def data_value(self, z: Tensor) -> Tensor:
        # Summed in f64 and rounded once, so the value does not depend on the
        # CPU's vector width: near the optimum TRON's decrease is an ulp or
        # two of f, and a summation order must not decide its ratio test.
        return torch.sum(self.weight * self.loss.value(z, self.label), dim=-1, dtype=torch.float64).to(z.dtype)

    def dz(self, z: Tensor) -> Tensor:
        return self.weight * self.loss.dz(z, self.label)

    def curvature(self, z: Tensor) -> Tensor:
        """d2 = weight·loss″(z), the Hessian's per-sample multiplier."""
        return self.weight * self.loss.dzz(z, self.label)

    # --- one X pass each ---

    def value_grad(self, w: Tensor, enable: Optional[Tensor] = None, margins: bool = False):
        """(value, gradient, margins or None) at w; the gradient in w's dtype."""
        if self.fused:
            ew = w if self.factors is None else w * self.factors
            out = fused_value_grad(self.loss, ew, self.X, self.label, self.offset, self.weight,
                                   return_margins=margins, enable=enable)
            val, g = out[0], out[1]
            if self.factors is not None:
                g = g * self.factors
            return val.to(w.dtype), g.to(w.dtype), out[2] if margins else None
        z = self.forward(w) + self.offset
        return self.data_value(z).to(w.dtype), self.transpose(self.dz(z)).to(w.dtype), z

    def hvp(self, d2: Tensor, v: Tensor, enable: Optional[Tensor] = None) -> Tensor:
        """Aᵀ·(d2 ∘ A·v)."""
        if self.fused:
            ev = v if self.factors is None else v * self.factors
            out = fused_hvp(ev, self.X, d2, enable=enable)
            return (out if self.factors is None else out * self.factors).to(v.dtype)
        return self.transpose(d2 * self.forward(v)).to(v.dtype)

    def tron_pass(self, q: Tensor, trial: Tensor, d2: Tensor, enable: Optional[Tensor] = None):
        """One X pass at q: (value, gradient, margins) where ``trial`` (one
        bool a lane), Aᵀ·(d2 ∘ A·q) elsewhere (value and margins then
        unused). Fused, K1 runs if the solve's lane is a trial and K2 if it
        is not, each launch with its flag (times ``enable``)."""
        if self.fused:
            on = trial.to(torch.int32)
            off = 1 - on
            if enable is not None:
                on, off = on * enable, off * enable
            val, g, z = self.value_grad(q, on, margins=True)
            hv = self.hvp(d2, q, off)
            return val, torch.where(trial, g, hv), z
        u = self.forward(q)
        z = u + self.offset
        t = torch.where(trial[..., None], self.dz(z), d2 * u)
        return self.data_value(z).to(q.dtype), self.transpose(t).to(q.dtype), z


class GLMOracle:
    """f(w) = data(m∘w) + ½·l2·‖c∘m∘w‖² over ``terms``: ``l2`` a device
    scalar (filled per solve), c zero at the intercept, m the feature mask
    (None: no mask), the gradient and Hessian products masked by m."""

    def __init__(self, terms: GLMTerms, l2_weight: float, intercept_index: Optional[int], dtype,
                 mask: Optional[Tensor] = None):
        self.terms, self.mask, self.dtype = terms, mask, dtype
        self.reg = L2Term(l2_weight, intercept_index, terms.X.shape[-1], dtype, terms.X.device)
        self.l2 = self.reg.l2

    def new_curvature(self, w: Tensor) -> Tensor:
        """A buffer of the curvature state (d2, one value a sample)."""
        return torch.zeros(self.terms.label.shape, dtype=self.terms.curvature_dtype(self.dtype),
                           device=self.terms.X.device)

    def _m(self, v: Tensor) -> Tensor:
        return v if self.mask is None else v * self.mask

    def _l2_value(self, val: Tensor, wm: Tensor) -> Tensor:
        return val + self.reg.value(wm) if self.reg.on else val

    def _l2_grad(self, g: Tensor, wm: Tensor) -> Tensor:
        return g + self.reg.grad(wm) if self.reg.on else g

    def value_grad(self, w: Tensor, enable: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        wm = self._m(w)
        val, g, _ = self.terms.value_grad(wm, enable)
        return self._l2_value(val, wm), self._m(self._l2_grad(g, wm))

    def curvature(self, w: Tensor) -> Tensor:
        """The curvature state at w (one forward pass)."""
        t = self.terms
        return t.curvature(t.forward(self._m(w)) + t.offset)

    def hvp(self, curv: Tensor, v: Tensor) -> Tensor:
        """H·v, H taken where ``curv`` was."""
        vm = self._m(v)
        return self._m(self._l2_grad(self.terms.hvp(curv, vm), vm))

    def tron_pass(self, q: Tensor, trial: Tensor, curv: Tensor, enable: Optional[Tensor] = None):
        """(value, gradient or H·q, curvature at q): see the module docstring."""
        qm = self._m(q)
        val, out, z = self.terms.tron_pass(qm, trial, curv, enable)
        return self._l2_value(val, qm), self._m(self._l2_grad(out, qm)), self.terms.curvature(z)


class CallableOracle:
    """A black-box objective: ``vg(w) -> (f, ∇f)`` and, for TRON,
    ``hvp_factory(w) -> (v -> H(w)·v)``; its curvature state is the point
    H is taken at. It serves eager solves only: a step asks the host which
    of the two its lanes need and calls only that (nothing once every lane
    has ended), and the product is built once a curvature point."""

    l2 = None

    def __init__(self, vg: Callable, hvp_factory: Optional[Callable] = None):
        self.vg, self.hvp_factory = vg, hvp_factory
        self._at: Optional[Tensor] = None
        self._hv: Optional[Callable] = None

    def new_curvature(self, w: Tensor) -> Tensor:
        return torch.zeros_like(w)

    def _product(self, curv: Tensor) -> Callable:
        if self._at is None or not torch.equal(self._at, curv):
            self._at, self._hv = curv.clone(), self.hvp_factory(curv)
        return self._hv

    @staticmethod
    def _ended(enable: Optional[Tensor]) -> bool:
        return enable is not None and not bool(enable)

    def value_grad(self, w: Tensor, enable: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        if self._ended(enable):
            return torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device), torch.zeros_like(w)
        return self.vg(w)

    def tron_pass(self, q: Tensor, trial: Tensor, curv: Tensor, enable: Optional[Tensor] = None):
        if self._ended(enable) or bool(trial.all()):
            f, g = self.value_grad(q, enable)
            return f, g, q
        hv = self._product(curv)(q)
        if not bool(trial.any()):
            return torch.zeros(trial.shape, dtype=q.dtype, device=q.device), hv, q
        f, g = self.vg(q)
        return f, torch.where(trial[..., None], g, hv), q
