"""Dense labeled batch (port of photon_tpu/data/batch.py::LabeledBatch).

A struct of tensors: label, features (n, d), offset, weight; padding rows
have weight 0. ``SparseFeatures`` is not ported yet.

Mixed precision follows the reference's JAX promotion: a bfloat16 X times an
f32 vector is computed as f32 X times the f32 vector. ``matvec`` and
``rmatvec`` do that in row chunks, so no full f32 copy of X is ever held.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

# Rows per upcast chunk of a bf16 X (64 MiB of f32 at d = 256).
_CHUNK_ROWS = 1 << 16


def _promoted(X: Tensor, v: Tensor) -> torch.dtype:
    return torch.promote_types(X.dtype, v.dtype)


def matvec(X: Tensor, v: Tensor) -> Tensor:
    """X @ v at the promoted dtype of X and v."""
    dt = _promoted(X, v)
    if X.dtype == dt:
        return X @ v.to(dt)
    v = v.to(dt)
    return torch.cat([X[i:i + _CHUNK_ROWS].to(dt) @ v for i in range(0, X.shape[0], _CHUNK_ROWS)])


def rmatvec(X: Tensor, r: Tensor) -> Tensor:
    """X.T @ r at the promoted dtype of X and r."""
    dt = _promoted(X, r)
    if X.dtype == dt:
        return X.T @ r.to(dt)
    r = r.to(dt)
    out = torch.zeros(X.shape[1], dtype=dt, device=X.device)
    for i in range(0, X.shape[0], _CHUNK_ROWS):
        out += X[i:i + _CHUNK_ROWS].to(dt).T @ r[i:i + _CHUNK_ROWS]
    return out


def matvec_rounded(X: Tensor, v: Tensor) -> Tensor:
    """X @ v with v rounded to X's dtype and an f32 (or wider) result: the
    ``preferred_element_type=f32`` product of the reference's bf16 path
    (photon_tpu/optim/margin_lbfgs.py:97-103). On CUDA one bf16 GEMV with
    f32 output; on the CPU the exact bf16 products, summed in f32."""
    if X.dtype != torch.bfloat16:
        return matvec(X, v)
    vb = v.to(torch.bfloat16)
    if X.is_cuda:
        return torch.mm(X, vb[:, None], out_dtype=torch.float32)[:, 0]
    return matvec(X, vb.float())


@dataclasses.dataclass
class LabeledBatch:
    label: Tensor
    features: Tensor
    offset: Optional[Tensor] = None
    weight: Optional[Tensor] = None

    def __post_init__(self):
        n = self.label.shape[0]
        if self.offset is None:
            self.offset = torch.zeros(n, dtype=self.label.dtype, device=self.label.device)
        if self.weight is None:
            self.weight = torch.ones(n, dtype=self.label.dtype, device=self.label.device)

    @staticmethod
    def from_numpy(
        label: np.ndarray,
        features: np.ndarray,
        offset: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        device="cuda",
        features_dtype: Optional[torch.dtype] = None,
    ) -> "LabeledBatch":
        """Batch on ``device`` from host arrays; ``features_dtype`` (e.g.
        torch.bfloat16) converts X on the device after the copy."""
        as_t = lambda a: None if a is None else torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
        X = as_t(features)
        if features_dtype is not None:
            X = X.to(features_dtype)
        return LabeledBatch(as_t(label), X, as_t(offset), as_t(weight))

    def margins(self, w: Tensor) -> Tensor:
        """x·w + offset for every sample."""
        return matvec(self.features, w) + self.offset

    def with_offset(self, offset: Tensor) -> "LabeledBatch":
        return LabeledBatch(self.label, self.features, offset, self.weight)

    def add_scores_to_offsets(self, scores: Tensor) -> "LabeledBatch":
        return self.with_offset(self.offset + scores)
