"""Synthetic GLMix data (copy of bench.py::make_data, sized by argument).

Features with an intercept column, entity ids drawn uniformly, labels from a
logistic model of the fixed-effect features. Generated with numpy from
``seed`` and returned as tensors on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch


def make_data(n: int, d_fix: int, d_re: int, num_entities: int, seed: int = 0, device="cuda"):
    """(Xf (n, d_fix), Xr (n, d_re), entity ids (n,) int32, y (n,)), f32."""
    rng = np.random.default_rng(seed)
    Xf = rng.normal(size=(n, d_fix)).astype(np.float32)
    Xf[:, 0] = 1.0
    Xr = rng.normal(size=(n, d_re)).astype(np.float32)
    Xr[:, 0] = 1.0
    users = rng.integers(0, num_entities, size=n).astype(np.int32)
    w_true = (rng.normal(size=d_fix) / np.sqrt(d_fix)).astype(np.float32)
    logits = Xf @ w_true
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (Xf, Xr, users, y))
