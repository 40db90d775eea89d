"""GLM objective: value, gradient and Hessian-vector products (port of
photon_tpu/ops/objective.py::GLMObjective).

The objective is w → Σ_i weight_i · loss(x_i·w + offset_i, y_i) + ½λ‖w‖²
(intercept excluded from L2), a weighted sum, not a mean. The reference
takes the gradient with ``jax.grad``; here it is written out: with the
normalization fold the margin is A·w where A·v = X·(f∘v) − s·(f∘v), so the
gradient is Aᵀ·dz = f∘(Xᵀ·dz − s·Σdz).

With ``use_fused`` (and a batch ``_can_fuse`` accepts) ``value_and_grad``
and ``linearized_hvp`` run the fused kernels of ops/fused_glm.py.
``hessian_diagonal`` and ``hessian_matrix`` (for coefficient variances)
work through row chunks of X, so no temporary of X's full size is held.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import torch

from photon_tpu_torch.data.batch import LabeledBatch, matvec, rmatvec
from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.ops.fused_glm import MAX_FUSED_DIM, fused_hvp, fused_value_grad
from photon_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

# Rows per chunk of the Hessian diagonal and matrix.
_CHUNK_ROWS = 1 << 16


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    loss: PointwiseLoss
    l2_weight: float = 0.0
    l1_weight: float = 0.0
    intercept_index: Optional[int] = None
    normalization: Optional[NormalizationContext] = None
    # Route dense value_and_grad / linearized_hvp through the fused kernels
    # where ``_can_fuse`` allows (the reference's ``use_pallas``).
    use_fused: bool = False

    # ----- margins and their transpose -----

    def _factors(self) -> Optional[Tensor]:
        return None if self.normalization is None else self.normalization.factors

    def _shifts(self) -> Optional[Tensor]:
        return None if self.normalization is None else self.normalization.shifts

    def margins(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        if self.normalization is not None and not self.normalization.is_identity:
            ew, es = self.normalization.effective(w)
            return batch.margins(ew) + es
        return batch.margins(w)

    def _forward(self, v: Tensor, batch: LabeledBatch) -> Tensor:
        """A·v: the (linear) change of the margins along v."""
        f, s = self._factors(), self._shifts()
        ev = v if f is None else v * f
        u = matvec(batch.features, ev)
        return u if s is None else u - torch.dot(s, ev)

    def _transpose(self, r: Tensor, batch: LabeledBatch) -> Tensor:
        """Aᵀ·r."""
        f, s = self._factors(), self._shifts()
        g = rmatvec(batch.features, r)
        if s is not None:
            g = g - torch.sum(r) * s
        return g if f is None else g * f

    # ----- regularization -----

    def _l2_mask(self, w: Tensor) -> Tensor:
        if self.intercept_index is None:
            return w
        m = w.clone()
        m.select(-1, self.intercept_index).zero_()  # a fill: no host scalar copied under capture
        return m

    def l2_term(self, w: Tensor) -> Tensor:
        if self.l2_weight == 0.0:
            return torch.zeros((), dtype=w.dtype, device=w.device)
        wm = self._l2_mask(w)
        return 0.5 * self.l2_weight * torch.dot(wm, wm)

    def l1_term(self, w: Tensor) -> Tensor:
        """Nonsmooth term, for reporting and OWL-QN only."""
        if self.l1_weight == 0.0:
            return torch.zeros((), dtype=w.dtype, device=w.device)
        return self.l1_weight * torch.sum(torch.abs(self._l2_mask(w)))

    def _l2_diag(self, d: int, dtype, device) -> Tensor:
        """λ on the diagonal, 0 at the intercept."""
        lam = torch.full((d,), self.l2_weight, dtype=dtype, device=device)
        if self.intercept_index is not None:
            lam[self.intercept_index] = 0.0
        return lam

    # ----- value / gradient -----

    def value(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        z = self.margins(w, batch)
        return torch.sum(batch.weight * self.loss.value(z, batch.label)) + self.l2_term(w)

    def value_and_grad(self, w: Tensor, batch: LabeledBatch) -> Tuple[Tensor, Tensor]:
        if self._can_fuse(batch):
            return self._fused_value_and_grad(w, batch)
        z = self.margins(w, batch)
        val = torch.sum(batch.weight * self.loss.value(z, batch.label)) + self.l2_term(w)
        g = self._transpose(batch.weight * self.loss.dz(z, batch.label), batch)
        if self.l2_weight != 0.0:
            g = g + self.l2_weight * self._l2_mask(w)
        return val, g.to(w.dtype)

    def _can_fuse(self, batch: LabeledBatch) -> bool:
        """The reference's shape routing: dense features within the kernel's
        width, no shift normalization."""
        if not self.use_fused or batch.features.shape[1] > MAX_FUSED_DIM:
            return False
        return self._shifts() is None

    def _fused_value_and_grad(self, w: Tensor, batch: LabeledBatch) -> Tuple[Tensor, Tensor]:
        f = self._factors()
        ew = w if f is None else w * f
        val, g = fused_value_grad(
            self.loss, ew, batch.features, batch.label, batch.offset, batch.weight
        )
        if f is not None:
            g = g * f
        if self.l2_weight != 0.0:
            val = val + self.l2_term(w)
            g = g + self.l2_weight * self._l2_mask(w)
        return val.to(w.dtype), g.to(w.dtype)

    # ----- Hessian-vector products -----

    def _curvature(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        """d2 = weight·loss''(margins): the Hessian's per-sample multiplier."""
        return batch.weight * self.loss.dzz(self.margins(w, batch), batch.label)

    def _plain_hvp(self, d2: Tensor, batch: LabeledBatch) -> Callable[[Tensor], Tensor]:
        lam = self.l2_weight

        def hv(v: Tensor) -> Tensor:
            out = self._transpose(d2 * self._forward(v, batch), batch)
            if lam != 0.0:
                out = out + lam * self._l2_mask(v)
            return out.to(v.dtype)

        return hv

    def hvp(self, w: Tensor, v: Tensor, batch: LabeledBatch) -> Tensor:
        """H(w)·v without materializing H (the reference's jvp of the
        gradient): one forward and one transpose pass."""
        return self._plain_hvp(self._curvature(w, batch), batch)(v)

    def linearized_hvp(self, w: Tensor, batch: LabeledBatch) -> Callable[[Tensor], Tensor]:
        """Build v → H(w)·v with the w-dependent state (margins, d2) computed
        once; each product is then one fused pass (or a forward and a
        transpose pass)."""
        d2 = self._curvature(w, batch)
        lam = self.l2_weight

        if self._can_fuse(batch):
            f = self._factors()

            def hv_fused(v: Tensor) -> Tensor:
                ev = v if f is None else v * f
                out = fused_hvp(ev, batch.features, d2)
                if f is not None:
                    out = out * f
                if lam != 0.0:
                    out = out + lam * self._l2_mask(v)
                return out.to(v.dtype)

            return hv_fused

        return self._plain_hvp(d2, batch)

    # ----- Hessian diagonal and matrix (coefficient variances) -----

    def _effective_chunks(self, batch: LabeledBatch, d2: Tensor) -> Iterator[Tuple[Tensor, Tensor]]:
        """(rows of the effective features, their d2), chunk by chunk: with
        factors f and shifts s the effective feature is x∘f − s∘f, and the
        intercept column is reset to 1 after shifting."""
        X = batch.features
        dt = torch.promote_types(X.dtype, d2.dtype)
        norm = self.normalization
        f = s = None
        if norm is not None and not norm.is_identity:
            f = norm.factors
            s = None if norm.shifts is None else (norm.shifts if f is None else norm.shifts * f)
        for i in range(0, X.shape[0], _CHUNK_ROWS):
            Xc = X[i:i + _CHUNK_ROWS].to(dt)
            if f is not None:
                Xc = Xc * f[None, :]
            if s is not None:
                Xc = Xc - s[None, :]
                if norm.intercept_index is not None:
                    Xc[:, norm.intercept_index] = 1.0
            yield Xc, d2[i:i + _CHUNK_ROWS].to(dt)

    def hessian_diagonal(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        """diag(H) = Σ_i weight_i · loss''_i · x_ij² (+λ off the intercept),
        normalization folded into the effective features."""
        d2 = self._curvature(w, batch)
        diag = None
        for Xc, dc in self._effective_chunks(batch, d2):
            part = dc @ (Xc * Xc)
            diag = part if diag is None else diag + part
        if self.l2_weight != 0.0:
            diag = diag + self._l2_diag(diag.shape[0], diag.dtype, diag.device)
        return diag

    def hessian_matrix(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        """H = Xᵀ·diag(d2)·X + λ·I (intercept unpenalized), over effective
        features; for variances at the widths they are computed for."""
        d2 = self._curvature(w, batch)
        H = None
        for Xc, dc in self._effective_chunks(batch, d2):
            part = Xc.T @ (dc[:, None] * Xc)
            H = part if H is None else H + part
        if self.l2_weight != 0.0:
            H = H + torch.diag(self._l2_diag(H.shape[0], H.dtype, H.device))
        return H

    # ----- convenience -----

    def full_value(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        """Smooth value + L1 term (the quantity OWL-QN minimizes)."""
        return self.value(w, batch) + self.l1_term(w)

    def with_l2(self, l2_weight: float) -> "GLMObjective":
        return dataclasses.replace(self, l2_weight=l2_weight)

    def with_l1(self, l1_weight: float) -> "GLMObjective":
        return dataclasses.replace(self, l1_weight=l1_weight)
