"""Shape-bucketed GameBatch padding (port of photon_tpu/data/padding.py).

Rows pad with weight-0 samples and entity id -1 (scored as zero); uid,
label and offset pad with zeros. Sparse shards are not ported yet, so the
nnz-width bucketing has no counterpart here; ``bucket_pow2`` is kept for
it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

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


def pad_feature_matrix(v: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad one dense feature matrix by ``pad`` zero rows (``v`` itself when
    there is nothing to pad)."""
    if not isinstance(v, torch.Tensor):
        raise NotImplementedError("sparse feature shards are not ported yet")
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
