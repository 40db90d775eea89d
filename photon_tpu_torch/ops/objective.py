"""GLM objective: value, gradient and Hessian-vector products (port of
photon_tpu/ops/objective.py::GLMObjective).

The objective is w → Σ_i weight_i · loss(x_i·w + offset_i, y_i) + ½λ‖w‖²
(intercept excluded from L2), a weighted sum, not a mean. The reference
takes the gradient with ``jax.grad``; here it is written out: with the
normalization fold the margin is A·w where A·v = X·(f∘v) − s·(f∘v), so the
gradient is Aᵀ·dz = f∘(Xᵀ·dz − s·Σdz).

``value_and_grad``, ``hvp`` and ``linearized_hvp`` are the solvers' GLM
oracle over this batch (optim/problem.py::GLMOracle, the one implementation
of a GLM's X passes); with ``use_fused`` (and a batch ``_can_fuse``
accepts) they run the fused kernels of ops/fused_glm.py.
``hessian_diagonal`` and ``hessian_matrix`` (for coefficient variances)
work through row chunks of X, so no temporary of X's full size is held.
Over ``SparseFeatures`` the diagonal scatters values²·d2 over the entries;
the matrix, and the diagonal under shifts, densify, as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import torch

from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.ops.fused_glm import MAX_FUSED_DIM
from photon_tpu_torch.ops.losses import PointwiseLoss
from photon_tpu_torch.optim.problem import GLMOracle, GLMTerms

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

    # ----- margins -----

    def _factors(self) -> Optional[Tensor]:
        return None if self.normalization is None else self.normalization.factors

    def _shifts(self) -> Optional[Tensor]:
        return None if self.normalization is None else self.normalization.shifts

    def margins(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        if self.normalization is not None and not self.normalization.is_identity:
            ew, es = self.normalization.effective(w)
            return batch.margins(ew) + es
        return batch.margins(w)

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

    def oracle(self, batch: LabeledBatch, dtype: torch.dtype) -> GLMOracle:
        """The solvers' oracle of this objective over ``batch`` (its L2
        weight fixed)."""
        return GLMOracle(GLMTerms.of_batch(self, batch), self.l2_weight, self.intercept_index, dtype)

    def value_and_grad(self, w: Tensor, batch: LabeledBatch) -> Tuple[Tensor, Tensor]:
        return self.oracle(batch, w.dtype).value_grad(w)

    def _can_fuse(self, batch: LabeledBatch) -> bool:
        """The reference's shape routing: dense features (never sparse)
        within the kernel's width, no shift normalization."""
        feats = batch.features
        if not self.use_fused or isinstance(feats, SparseFeatures) or feats.shape[1] > MAX_FUSED_DIM:
            return False
        return self._shifts() is None

    # ----- Hessian-vector products -----

    def _curvature(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        """d2 = weight·loss''(margins): the Hessian's per-sample multiplier."""
        return batch.weight * self.loss.dzz(self.margins(w, batch), batch.label)

    def hvp(self, w: Tensor, v: Tensor, batch: LabeledBatch) -> Tensor:
        """H(w)·v without materializing H (the reference's jvp of the
        gradient)."""
        return self.linearized_hvp(w, batch)(v)

    def linearized_hvp(self, w: Tensor, batch: LabeledBatch) -> Callable[[Tensor], Tensor]:
        """Build v → H(w)·v with the w-dependent state (margins, d2) computed
        once; each product is then one fused pass (or a forward and a
        transpose pass)."""
        oracle = self.oracle(batch, w.dtype)
        d2 = oracle.curvature(w)
        return lambda v: oracle.hvp(d2, v)

    # ----- Hessian diagonal and matrix (coefficient variances) -----

    def _effective_chunks(self, batch: LabeledBatch, d2: Tensor) -> Iterator[Tuple[Tensor, Tensor]]:
        """(rows of the effective features, their d2), chunk by chunk: with
        factors f and shifts s the effective feature is x∘f − s∘f, and the
        intercept column is reset to 1 after shifting. Sparse features
        densify here, where the reference's do."""
        X = batch.features
        if isinstance(X, SparseFeatures):
            X = X.to_dense()
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
        feats, norm = batch.features, self.normalization
        if isinstance(feats, SparseFeatures) and (norm is None or norm.shifts is None):
            # Σ_i d2_i · (x_ij f_j)², scattered over the entries (shifts densify).
            # Entry by entry, as the reference: a column repeated in a row
            # adds Σv², where the dense matrix has (Σv)².
            vals = feats.values if norm is None or norm.factors is None else \
                feats.values * norm.factors[feats.indices]
            diag = feats.scatter_columns(vals * vals * d2[:, None])
            if self.l2_weight != 0.0:
                diag = diag + self._l2_diag(diag.shape[0], diag.dtype, diag.device)
            return diag
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
