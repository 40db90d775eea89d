"""Rows-sharded batches over the mesh's data axes (port of
photon_tpu/parallel/distributed.py).

In the reference, placing a batch with a row sharding is the whole
communication backend: XLA turns the objective's sums into cross-device
psums. Here a rank holds only its own rows, and the batch carries its row
layout (``LabeledBatch.rows``, a ``RowShards``); the objective's terms
(optim/problem.py::GLMTerms) compute each shard's partial sums (K1 and K2
on the card) and reduce them with one ``all_reduce`` over the data group.

The rows are cut into a FIXED number of row shards (``ROW_SHARDS``, like
the entity shards of parallel/entity_shard.py) whatever the number of
ranks: shard s is rows [s·m, (s+1)·m) of the batch padded to S·m rows with
weight-0 rows, and belongs to data rank (s·dp)//S. A partial sum is taken
per shard; the reduction adds exact zeros from the ranks that do not own a
shard (an all-reduce of a zero-filled (S, ...) buffer), then sums the S
partials in shard order on every rank. So every world size sums the same
partials in the same order, and a rows-sharded solve is bitwise the same at
1, 2, 4 and 8 ranks, as the entity-sharded random effects are.

``pad_batch`` pads with weight-0 rows (weighted sums make padding exact),
``shard_batch`` returns this rank's padded rows with their layout, and
``replicate`` broadcasts from rank 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.parallel.mesh import Mesh, dp_axes, owned_shards

Tensor = torch.Tensor

ROW_SHARDS = 8


def _pad_rows(a: Tensor, target: int, fill=0) -> Tensor:
    n = a.shape[0]
    if n == target:
        return a
    pad = torch.full((target - n,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


def pad_batch(batch: LabeledBatch, target_n: int) -> LabeledBatch:
    """Pad to ``target_n`` rows with weight-0 padding samples."""
    n = batch.label.shape[0]
    if n == target_n:
        return batch
    assert target_n > n
    return _slice_batch(batch, 0, n, target_n - n, batch.rows)


def _slice_batch(batch: LabeledBatch, lo: int, hi: int, pad: int, rows) -> LabeledBatch:
    """Rows [lo, hi) of ``batch`` followed by ``pad`` weight-0 rows."""
    def cut(a, fill=0):
        part = a[lo:hi]
        return _pad_rows(part, hi - lo + pad, fill) if pad else part

    feats = batch.features
    if isinstance(feats, SparseFeatures):
        feats = SparseFeatures(cut(feats.indices), cut(feats.values), feats.dim)
    else:
        feats = cut(feats)
    return LabeledBatch(label=cut(batch.label), features=feats, offset=cut(batch.offset),
                        weight=cut(batch.weight), rows=rows)


@dataclasses.dataclass(frozen=True)
class RowShards:
    """The row layout of a rows-sharded batch (module docstring): ``n``
    real rows cut into ``n_shards`` shards of ``shard_rows`` rows, of which
    this rank holds ``owned`` (consecutive), reduced over ``mesh``'s data
    axes (no collective when ``mesh`` is None or one rank)."""

    n: int
    n_shards: int
    shard_rows: int
    owned: Tuple[int, ...]
    mesh: Optional[Mesh] = dataclasses.field(default=None, compare=False)

    @property
    def lo(self) -> int:
        """This rank's first row in the padded batch."""
        return self.owned[0] * self.shard_rows if self.owned else 0

    @property
    def local_rows(self) -> int:
        return len(self.owned) * self.shard_rows

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph may hold this layout's collectives: none at
        all, or NCCL's (which capture on the H100 under torch 2.11 and CUDA
        12.8); gloo's cannot be captured."""
        mesh = self.mesh
        return mesh is None or mesh.backend is None or mesh.backend == "nccl"

    def split(self, t: Tensor) -> list:
        """Views of a per-row tensor (rows on the last axis), one a shard."""
        m = self.shard_rows
        return [t[..., i * m:(i + 1) * m] for i in range(len(self.owned))]

    def split_rows(self, t) -> list:
        """Row views of ``t`` (dense (rows, ...) or SparseFeatures), one a shard."""
        m = self.shard_rows
        if isinstance(t, SparseFeatures):
            return [SparseFeatures(t.indices[i * m:(i + 1) * m], t.values[i * m:(i + 1) * m], t.dim)
                    for i in range(len(self.owned))]
        return [t[i * m:(i + 1) * m] for i in range(len(self.owned))]

    def _reduce(self, buf: Tensor) -> Tensor:
        if self.mesh is not None:
            self.mesh.all_reduce(buf, dp_axes(self.mesh))
        return buf

    def sum_parts(self, parts: Sequence[Tensor]) -> Tensor:
        """Σ over all shards of the per-shard partials; ``parts`` are this
        rank's, one an owned shard, all of one shape. One all-reduce."""
        first = parts[0]
        buf = torch.zeros((self.n_shards,) + tuple(first.shape), dtype=first.dtype, device=first.device)
        if self.owned:
            # + 0.0 makes a -0.0 partial +0.0, as the all-reduce's sum with
            # the other ranks' zeros would: a rank's own shards read alike
            # at every world size.
            buf[self.owned[0]:self.owned[-1] + 1] = torch.stack(list(parts)) + 0.0
        return self._reduce(buf).sum(0)

    def gather(self, t: Tensor) -> Tensor:
        """The whole batch's rows of a per-row tensor (the first ``n`` of the
        padded rows), on every rank; exact (an all-reduce of disjoint rows)."""
        total = self.n_shards * self.shard_rows
        buf = torch.zeros((total,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        buf[self.lo:self.lo + self.local_rows] = t + 0
        return self._reduce(buf)[:self.n]


def row_shards(n: int, mesh: Optional[Mesh], n_shards: int = ROW_SHARDS) -> RowShards:
    """The layout of ``n`` rows over ``mesh``'s data axes (module
    docstring); at least one shard a data rank."""
    S = max(int(n_shards), 1 if mesh is None else mesh.size(*dp_axes(mesh)))
    return RowShards(n=n, n_shards=S, shard_rows=max(1, -(-n // S)), owned=tuple(owned_shards(S, mesh)), mesh=mesh)


def shard_batch(batch: LabeledBatch, mesh: Optional[Mesh], n_shards: int = ROW_SHARDS) -> LabeledBatch:
    """This rank's rows of ``batch`` (the whole batch on every rank), padded
    with weight-0 rows to its shards' size, with their layout in ``rows``.
    Rows that need no padding are views of the batch's tensors."""
    n = batch.label.shape[0]
    rows = row_shards(n, mesh, n_shards)
    lo = rows.lo
    hi = min(lo + rows.local_rows, n)
    lo = min(lo, n)
    return _slice_batch(batch, lo, hi, rows.local_rows - (hi - lo), rows)


def local_rows(t: Tensor, rows: RowShards, fill=0) -> Tensor:
    """This rank's rows of a per-row tensor of the whole batch, padded as
    ``shard_batch`` pads them."""
    n = t.shape[0]
    lo, hi = min(rows.lo, n), min(rows.lo + rows.local_rows, n)
    return _pad_rows(t[lo:hi], rows.local_rows, fill)


def replicate(x):
    """Rank 0's value of every tensor of ``x`` (a tensor, or a tuple, list
    or dict of them) on every rank: a broadcast over the job."""
    if isinstance(x, Tensor):
        out = x.clone()
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            dist.broadcast(out, src=0)
        return out
    if isinstance(x, dict):
        return {k: replicate(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(replicate(v) for v in x)
    return x
