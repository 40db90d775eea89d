"""Carry the JAX package's training state into the port.

Every function takes host numpy arrays (``np.asarray`` of the reference's
arrays), or a reference object whose arrays it reads that way, and returns
the port's tensors on ``device``, so both packages can start from, or
score, the same state. Nothing of the reference is imported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.data.random_effect import EntityBlock
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    ProjectedRandomEffectModel,
    RandomEffectModel,
)
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.types import TaskType


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


def _opt(a, device):
    return None if a is None else _t(a, device)


def game_model(ref_model, device="cuda") -> GameModel:
    """The port's GameModel holding the coefficients (and variances) of a
    reference GameModel: fixed-effect, dense random-effect and projected
    random-effect submodels."""
    models = {}
    for cid, sub in ref_model.models.items():
        if hasattr(sub, "block_coefs"):
            models[cid] = ProjectedRandomEffectModel(
                block_coefs=[_t(b, device) for b in sub.block_coefs],
                col_maps=[_t(c, device) for c in sub.col_maps],
                inv_maps=[_t(c, device) for c in sub.inv_maps],
                entity_block=_t(sub.entity_block, device), entity_row=_t(sub.entity_row, device),
                d_full=int(sub.d_full), re_type=sub.re_type, feature_shard=sub.feature_shard,
                task=TaskType(sub.task.value),
                block_variances=None if sub.block_variances is None
                else [_t(v, device) for v in sub.block_variances],
            )
        elif hasattr(sub, "re_type"):
            models[cid] = RandomEffectModel(
                _t(sub.coefficients, device), sub.re_type, sub.feature_shard, TaskType(sub.task.value),
                _opt(sub.variances, device), _opt(sub.present_entities, device))
        else:
            glm = sub.model
            models[cid] = FixedEffectModel(
                GeneralizedLinearModel(Coefficients(_t(glm.coefficients.means, device),
                                                    _opt(glm.coefficients.variances, device)),
                                       TaskType(glm.task.value)),
                sub.feature_shard)
    return GameModel(models)
