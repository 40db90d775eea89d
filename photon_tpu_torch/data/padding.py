"""Shape-bucketed GameBatch padding (port of photon_tpu/data/padding.py).

Rows pad with weight-0 samples and entity id -1 (scored as zero); uid,
label and offset pad with zeros. A sparse shard's padding rows are
zero-valued slots at index 0, and its nnz width k is bucketed to the next
power of two, so a stream of batches meets few widths.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from photon_tpu_torch.data.batch import Features, SparseFeatures
from photon_tpu_torch.data.random_effect import bucket_dim


def bucket_pow2(k: int) -> int:
    """Next power of two ≥ k (k ≥ 0)."""
    return 1 << max(0, (int(k) - 1)).bit_length()


def bucket_grid(max_n: int):
    """Every row-count bucket of batches of 1..max_n rows: the ``bucket_dim``
    grid up to and including ``bucket_dim(max_n)``."""
    grid = []
    n = 1
    top = bucket_dim(int(max_n))
    while True:
        b = bucket_dim(n)
        grid.append(b)
        if b >= top:
            return grid
        n = b + 1


def pad_feature_matrix(v: Features, pad: int) -> Features:
    """Pad one feature matrix by ``pad`` zero rows; a sparse one also to a
    power-of-two nnz width, its transpose plan rebuilt if it had one (the
    pattern changed). ``v`` itself when there is nothing to pad."""
    if isinstance(v, SparseFeatures):
        k = v.indices.shape[1]
        k_pad = bucket_pow2(k)
        if pad == 0 and k_pad == k:
            return v
        out = SparseFeatures(F.pad(v.indices, (0, k_pad - k, 0, pad)), F.pad(v.values, (0, k_pad - k, 0, pad)), v.dim)
        return out.with_transpose_plan() if v.has_plan else out
    return v if pad == 0 else F.pad(v, (0, 0, 0, pad))


def pad_game_batch(b, target_n: int):
    """Pad a GameBatch to ``target_n`` rows; ``b`` itself when no row is
    added."""
    pad = max(int(target_n) - b.n, 0)
    if pad == 0:
        return b
    padv = lambda a, value=0: F.pad(a, (0, pad), value=value)  # noqa: E731
    return dataclasses.replace(
        b,
        label=padv(b.label),
        offset=padv(b.offset),
        weight=padv(b.weight),
        features={k: pad_feature_matrix(v, pad) for k, v in b.features.items()},
        entity_ids={k: padv(v, -1) for k, v in b.entity_ids.items()},
        uid=None if b.uid is None else padv(b.uid),
    )
