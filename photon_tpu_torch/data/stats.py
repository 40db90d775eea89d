"""Per-feature summary statistics (port of photon_tpu/data/stats.py).

Weighted-presence column reductions over a batch: rows of weight 0
(padding) are excluded from every statistic. The reductions run over row
chunks, so at a large N no temporary of X's full size is held. A sparse
batch gives the statistics of its dense matrix, computed from its entries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures

Tensor = torch.Tensor

# Rows per chunk of the column reductions.
_CHUNK_ROWS = 1 << 16


@dataclasses.dataclass(frozen=True)
class FeatureDataStatistics:
    count: Tensor  # scalar: samples present (unweighted)
    mean: Tensor  # (d,)
    variance: Tensor  # (d,)
    min: Tensor  # (d,)
    max: Tensor  # (d,)
    norm_l1: Tensor  # (d,)
    norm_l2: Tensor  # (d,)
    num_nonzeros: Tensor  # (d,)
    intercept_index: Optional[int] = None

    @property
    def abs_max(self) -> Tensor:
        return torch.maximum(torch.abs(self.min), torch.abs(self.max))

    @property
    def std(self) -> Tensor:
        return torch.sqrt(torch.clamp(self.variance, min=0.0))


def compute_feature_stats(
    batch: LabeledBatch, intercept_index: Optional[int] = None
) -> FeatureDataStatistics:
    """Count, mean, sample variance (n − 1), min, max, L1 and L2 norms and
    nonzero counts of every column, over the rows of positive weight. Two
    passes over row chunks: sums first, then squared deviations from the
    mean. A sparse batch takes them from its entries (``_sparse_stats``)."""
    if isinstance(batch.features, SparseFeatures):
        return _sparse_stats(batch.features, batch.weight, intercept_index)
    X = batch.features
    n_rows, d = X.shape
    dt = torch.promote_types(X.dtype, batch.weight.dtype)
    present = (batch.weight > 0).to(dt)
    n = torch.clamp(torch.sum(present), min=1.0)
    big = torch.finfo(dt).max

    def chunks():
        for i in range(0, n_rows, _CHUNK_ROWS):
            yield X[i:i + _CHUNK_ROWS].to(dt), present[i:i + _CHUNK_ROWS]

    zeros = lambda: torch.zeros(d, dtype=dt, device=X.device)  # noqa: E731
    total, l1, sq = zeros(), zeros(), zeros()
    mn = torch.full((d,), big, dtype=dt, device=X.device)
    mx = torch.full((d,), -big, dtype=dt, device=X.device)
    nnz = torch.zeros(d, dtype=torch.int64, device=X.device)
    for Xc, pc in chunks():
        Xp = Xc * pc[:, None]
        total += torch.sum(Xp, dim=0)
        l1 += torch.sum(torch.abs(Xp), dim=0)
        sq += torch.sum(Xp * Xp, dim=0)
        keep = pc[:, None] > 0
        mn = torch.minimum(mn, torch.amin(torch.where(keep, Xc, big), dim=0))
        mx = torch.maximum(mx, torch.amax(torch.where(keep, Xc, -big), dim=0))
        nnz += torch.sum(Xp != 0, dim=0)
    mean = total / n
    ss = zeros()
    for Xc, pc in chunks():
        ss += torch.sum(pc[:, None] * (Xc - mean[None, :]) ** 2, dim=0)
    var = ss / torch.clamp(n - 1.0, min=1.0)
    return FeatureDataStatistics(
        count=n, mean=mean, variance=var, min=mn, max=mx,
        norm_l1=l1, norm_l2=torch.sqrt(sq), num_nonzeros=nnz.to(torch.int32),
        intercept_index=intercept_index,
    )


def _sparse_stats(feats: SparseFeatures, weight: Tensor, intercept_index: Optional[int]) -> FeatureDataStatistics:
    """The statistics of the dense matrix (duplicate entries of a row summed,
    as ``to_dense`` sums them) from the entries, the implicit zeros counted:
    a column's present rows without an entry add 0 to its sums, (0 − mean)²
    each to its squared deviations, and 0 to its min and max."""
    n_rows, k = feats.values.shape
    d, device = feats.dim, feats.device
    dt = torch.promote_types(feats.values.dtype, weight.dtype)
    rows = torch.arange(n_rows, device=device)[:, None].expand(n_rows, k)
    cells, inverse = torch.unique((rows * d + feats.indices.long()).reshape(-1), return_inverse=True)
    vals = torch.zeros(cells.shape[0], dtype=dt, device=device).index_add_(
        0, inverse, feats.values.reshape(-1).to(dt))
    row, col = cells // d, cells % d
    present = weight > 0
    n_present = torch.sum(present)
    n = torch.clamp(n_present.to(dt), min=1.0)
    p = present[row]
    vp = vals * p.to(dt)
    col_sum = lambda x: torch.zeros(d, dtype=x.dtype, device=device).index_add_(0, col, x)  # noqa: E731
    total, l1, sq = col_sum(vp), col_sum(torch.abs(vp)), col_sum(vp * vp)
    nnz = col_sum((vp != 0).to(torch.int64))
    zeros_in = n_present - col_sum(p.to(torch.int64))  # present rows without an entry
    big = torch.finfo(dt).max
    zero = torch.zeros((), dtype=dt, device=device)
    mn = torch.full((d,), big, dtype=dt, device=device).scatter_reduce(0, col[p], vals[p], "amin")
    mx = torch.full((d,), -big, dtype=dt, device=device).scatter_reduce(0, col[p], vals[p], "amax")
    implicit = zeros_in > 0
    mn, mx = torch.where(implicit, torch.minimum(mn, zero), mn), torch.where(implicit, torch.maximum(mx, zero), mx)
    mean = total / n
    ss = col_sum(p.to(dt) * (vals - mean[col]) ** 2) + zeros_in.to(dt) * mean * mean
    var = ss / torch.clamp(n - 1.0, min=1.0)
    return FeatureDataStatistics(
        count=n, mean=mean, variance=var, min=mn, max=mx,
        norm_l1=l1, norm_l2=torch.sqrt(sq), num_nonzeros=nnz.to(torch.int32),
        intercept_index=intercept_index,
    )
