"""Labeled batch and padded-sparse features (port of
photon_tpu/data/batch.py: ``LabeledBatch``, ``SparseFeatures``).

A LabeledBatch is a struct of tensors: label, features, offset, weight;
padding rows have weight 0. Features are a dense (n, d) tensor or a
``SparseFeatures``: k (index, value) pairs a row, unused slots value 0.

Mixed precision follows the reference's JAX promotion: a bfloat16 X times an
f32 vector is computed as f32 X times the f32 vector. ``matvec`` and
``rmatvec`` do that in row chunks, so no full f32 copy of X is ever held.
Both take a lane axis on the vector (v (lanes, d), r (lanes, n)), as the λ
sweep of optim/margin_lbfgs.py needs.

The sparse products are torch ops, as the reference's are XLA ops outside
any Pallas kernel: the margin is a gather and a row sum; the gradient Xᵀ·r
either a duplicate-index ``index_add_`` (float atomics on the card) or,
with the transpose plan (``with_transpose_plan``), a gather into column
order and ``torch.segment_reduce`` over sorted segments, whose summation
order does not depend on the run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

# Rows per upcast chunk of a bf16 X (64 MiB of f32 at d = 256).
_CHUNK_ROWS = 1 << 16

# The rmatvec lowering a sparse shard gets at ingest where its
# FeatureShardConfig leaves it open (``default_transpose_plan``). CPU: the
# scatter, as the reference measured on the CPU. CUDA: the segment sum, by
# chip_smoke.py phase 10a (config 6, NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md §5): the scatter's float atomics move the solve's path from its
# second iteration, so its objective after 30 iterations spreads by 1-2 %
# run to run, where the segment sum's is bitwise the same, at 1.36× the
# scatter's captured wall (0.2865 against 0.2100 s a solve).
_TRANSPOSE_PLAN_CPU = False
_TRANSPOSE_PLAN_CUDA = True


def default_transpose_plan(device) -> bool:
    """Whether a sparse shard on ``device`` carries the transpose plan."""
    return _TRANSPOSE_PLAN_CUDA if torch.device(device).type == "cuda" else _TRANSPOSE_PLAN_CPU


class SparseFeatures:
    """Row-padded sparse feature matrix: ``indices`` (n, k) int32, ``values``
    (n, k) f32 or bf16, ``dim`` columns; an unused slot has value 0 (its
    index conventionally 0). ``csc_order`` (n·k,) sorts the flat entries by
    column and ``csc_segments`` holds the sorted columns: the transpose plan.
    ``csc_offsets`` (dim + 1,) is derived from the plan here, so that no
    product has to."""

    def __init__(self, indices: Tensor, values: Tensor, dim: int, csc_order: Optional[Tensor] = None,
                 csc_segments: Optional[Tensor] = None):
        self.indices, self.values, self.dim = indices, values, int(dim)
        self.csc_order, self.csc_segments = csc_order, csc_segments
        self.csc_offsets = None
        if csc_segments is not None:
            cols = torch.arange(self.dim + 1, dtype=csc_segments.dtype, device=csc_segments.device)
            self.csc_offsets = torch.searchsorted(csc_segments, cols)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.values.shape[0], self.dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def is_cuda(self) -> bool:
        return self.values.is_cuda

    @property
    def has_plan(self) -> bool:
        return self.csc_order is not None

    def tensors(self) -> Tuple[Tensor, ...]:
        """Every tensor it holds (the plan's when it has one)."""
        plan = (self.csc_order, self.csc_segments, self.csc_offsets) if self.has_plan else ()
        return (self.indices, self.values) + plan

    def matvec(self, w: Tensor) -> Tensor:
        """X·w: (d,) → (n,), or (lanes, d) → (lanes, n), at the promoted dtype."""
        if w.dim() > 1:
            return torch.stack([self.matvec(wl) for wl in w])
        return torch.sum(self.values * w[self.indices], dim=-1)

    def scatter_columns(self, contrib: Tensor) -> Tensor:
        """(d,) column sums of per-entry contributions (n, k): the segment sum
        with the plan, the duplicate-index scatter-add without."""
        if self.has_plan:
            return torch.segment_reduce(contrib.reshape(-1)[self.csc_order], "sum", offsets=self.csc_offsets,
                                        unsafe=True)
        out = torch.zeros(self.dim, dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(0, self.indices.reshape(-1), contrib.reshape(-1))

    def rmatvec(self, r: Tensor) -> Tensor:
        """Xᵀ·r: (n,) → (d,), or (lanes, n) → (lanes, d); a bf16 matrix sums
        at r's (f32) dtype."""
        if r.dim() > 1:
            return torch.stack([self.rmatvec(rl) for rl in r])
        return self.scatter_columns(self.values * r[:, None])

    def with_transpose_plan(self) -> "SparseFeatures":
        """A copy carrying the column-sorted transpose plan: one stable
        argsort of the flat indices where they live, run outside any
        captured region (two int32 arrays of n·k entries)."""
        segments, order = torch.sort(self.indices.reshape(-1), stable=True)
        return SparseFeatures(self.indices, self.values, self.dim, order.to(torch.int32),
                              segments.to(torch.int32))

    def to_dense(self) -> Tensor:
        """(n, dim), duplicate entries of a row summed."""
        n = self.values.shape[0]
        rows = torch.arange(n, device=self.device)[:, None].expand_as(self.indices)
        out = torch.zeros((n, self.dim), dtype=self.values.dtype, device=self.device)
        return out.index_put_((rows, self.indices.long()), self.values, accumulate=True)

    @staticmethod
    def from_rows(rows: Sequence[Tuple[Sequence[int], Sequence[float]]], dim: int, dtype=np.float32,
                  device="cuda") -> "SparseFeatures":
        """From (indices, values) pairs a row, padded to the widest row
        (at least 1); built on the host, placed on ``device`` once."""
        k = max(1, max((len(ix) for ix, _ in rows), default=1))
        indices = np.zeros((len(rows), k), dtype=np.int32)
        values = np.zeros((len(rows), k), dtype=dtype)
        for i, (ix, vs) in enumerate(rows):
            indices[i, :len(ix)] = ix
            values[i, :len(ix)] = vs
        return SparseFeatures(torch.as_tensor(indices, device=device), torch.as_tensor(values, device=device), dim)


Features = Union[Tensor, SparseFeatures]


def _promoted(X: Tensor, v: Tensor) -> torch.dtype:
    return torch.promote_types(X.dtype, v.dtype)


def matvec(X: Features, v: Tensor) -> Tensor:
    """X @ v at the promoted dtype of X and v; v (d,) or (lanes, d)."""
    if isinstance(X, SparseFeatures):
        return X.matvec(v)
    lanes = v.dim() > 1
    V = v.mT if lanes else v
    dt = _promoted(X, V)
    if X.dtype == dt:
        out = X @ V.to(dt)
    else:
        V = V.to(dt)
        out = torch.cat([X[i:i + _CHUNK_ROWS].to(dt) @ V for i in range(0, X.shape[0], _CHUNK_ROWS)])
    return out.mT if lanes else out


def rmatvec(X: Features, r: Tensor) -> Tensor:
    """X.T @ r at the promoted dtype of X and r; r (n,) or (lanes, n)."""
    if isinstance(X, SparseFeatures):
        return X.rmatvec(r)
    lanes = r.dim() > 1
    R = r.mT if lanes else r
    dt = _promoted(X, R)
    if X.dtype == dt:
        out = X.T @ R.to(dt)
    else:
        R = R.to(dt)
        out = torch.zeros((X.shape[1],) + tuple(R.shape[1:]), dtype=dt, device=X.device)
        for i in range(0, X.shape[0], _CHUNK_ROWS):
            out += X[i:i + _CHUNK_ROWS].to(dt).T @ R[i:i + _CHUNK_ROWS]
    return out.mT if lanes else out


def matvec_rounded(X: Features, v: Tensor) -> Tensor:
    """X @ v with v rounded to X's dtype and an f32 (or wider) result: the
    ``preferred_element_type=f32`` product of the reference's bf16 path
    (photon_tpu/optim/margin_lbfgs.py:97-103). On CUDA one bf16 GEMV with
    f32 output; on the CPU the exact bf16 products, summed in f32. A sparse
    X takes v as it is, as the reference's does."""
    if isinstance(X, SparseFeatures) or X.dtype != torch.bfloat16:
        return matvec(X, v)
    vb = v.to(torch.bfloat16)
    if X.is_cuda:
        V = vb.mT if vb.dim() > 1 else vb[:, None]
        out = torch.mm(X, V, out_dtype=torch.float32)
        return out.mT if vb.dim() > 1 else out[:, 0]
    return matvec(X, vb.float())


@dataclasses.dataclass
class LabeledBatch:
    label: Tensor
    features: Features
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
