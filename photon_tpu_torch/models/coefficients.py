"""Model coefficients (port of photon_tpu/models/coefficients.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.batch import Features, SparseFeatures

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Coefficients:
    means: Tensor
    variances: Optional[Tensor] = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def compute_score(self, features: Features) -> Tensor:
        if isinstance(features, SparseFeatures):
            return features.matvec(self.means)  # a gather and a row sum: per row too
        # A per-row product and sum, not ``features @ means``: a matrix-vector
        # product picks its accumulation order by row count (cuBLAS and CPU
        # BLAS alike), so its scores would depend on the batch size. The
        # per-row reduction does not, which is what lets chunked or
        # micro-batched scoring match the whole-batch scores exactly.
        return torch.sum(features * self.means, dim=-1)
