"""Model coefficients (port of photon_tpu/models/coefficients.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.batch import Features, SparseFeatures

Tensor = torch.Tensor


def row_sum(p: Tensor) -> Tensor:
    """Σ over the last axis in one fixed pairwise order: the width padded
    with zeros to a power of two, then halved by elementwise adds until one
    column is left. No reduction kernel is involved, so a row's sum has the
    same bits whatever the number of rows (a CUDA ``sum(-1)`` picks its
    reduction layout by the row count: at d = 256 a batch of 1-12 rows
    sums in another order than 32768 rows on an H100). The halves are added
    into ``p`` in place (callers pass a temporary), so it takes no memory
    beyond ``p``."""
    width = 1 << max(p.shape[-1] - 1, 0).bit_length()
    if width != p.shape[-1]:
        p = torch.nn.functional.pad(p, (0, width - p.shape[-1]))
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p[..., :half] += p[..., half:]
        p = p[..., :half]
    return p[..., 0].contiguous()  # a copy: the scores do not hold ``p`` alive


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
        # A per-row product and a fixed-order row sum, not ``features @
        # means``: a matrix-vector product (cuBLAS and CPU BLAS alike) and a
        # CUDA ``sum(-1)`` pick their accumulation order by row count, so
        # scores would depend on the batch size. ``row_sum`` does not, which
        # is what lets chunked or micro-batched scoring match the
        # whole-batch scores exactly.
        return row_sum(features * self.means)
