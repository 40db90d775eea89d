"""Carry the JAX package's training state into the port.

Every function takes host numpy arrays (``np.asarray`` of the reference's
arrays) and returns the port's tensors on ``device``, so both packages can
start from the same state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.data.random_effect import EntityBlock


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def coefficients(w_fixed: np.ndarray, re_coefs: np.ndarray, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_fixed (d,), re_coefs (E, d_re))."""
    return _t(w_fixed, device), _t(re_coefs, device)


def normalization(factors: Optional[np.ndarray], shifts: Optional[np.ndarray],
                  intercept_index: Optional[int] = None, device="cuda") -> NormalizationContext:
    return NormalizationContext(
        None if factors is None else _t(factors, device),
        None if shifts is None else _t(shifts, device),
        intercept_index,
    )


def entity_block(entity_idx, features, label, weight, sample_index, train_mask,
                 device="cuda") -> EntityBlock:
    """An EntityBlock from the arrays of a reference block."""
    return EntityBlock(*(_t(a, device) for a in (
        entity_idx, features, label, weight, sample_index, train_mask)))
