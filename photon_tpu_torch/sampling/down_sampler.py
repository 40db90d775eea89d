"""Down-sampling for fixed-effect training (port of
photon_tpu/sampling/down_sampler.py).

Sampling is a weight mask: dropped samples get weight 0, kept ones are
reweighted by 1/rate, and shapes never change. The keep mask is the
reference's ``jax.random.uniform(fold_in(PRNGKey(seed), salt), (n,)) < rate``
drawn bit for bit on the host (sampling/threefry.py), then moved to the
batch's device. The reference draws in jax's default float type: float32,
or float64 under x64; the port draws in the batch weight's type, float64
for a float64 batch and float32 otherwise, so each matches the reference
run on the same data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.sampling.threefry import fold_in, prng_key, uniform
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass
class DownSampler:
    """Uniform down-sampling of all samples."""

    rate: float
    seed: int = 0

    def keep_mask(self, n: int, salt: int, dtype=np.float32) -> np.ndarray:
        return uniform(fold_in(prng_key(self.seed), salt), n, dtype) < np.dtype(dtype).type(self.rate)

    def _keep(self, batch: LabeledBatch, salt: int) -> Tensor:
        dtype = np.float64 if batch.weight.dtype == torch.float64 else np.float32
        return torch.as_tensor(self.keep_mask(batch.label.shape[0], salt, dtype), device=batch.label.device)

    def apply(self, batch: LabeledBatch) -> LabeledBatch:
        keep = self._keep(batch, 0)
        new_w = torch.where(keep, batch.weight / self.rate, 0.0)
        return LabeledBatch(batch.label, batch.features, batch.offset, new_w, batch.rows)


@dataclasses.dataclass
class DefaultDownSampler(DownSampler):
    pass


@dataclasses.dataclass
class BinaryClassificationDownSampler(DownSampler):
    """Down-samples only the negative class, reweighting kept negatives by
    1/rate."""

    def apply(self, batch: LabeledBatch) -> LabeledBatch:
        keep = self._keep(batch, 1)
        is_neg = batch.label <= 0
        new_w = torch.where(is_neg, torch.where(keep, batch.weight / self.rate, 0.0), batch.weight)
        return LabeledBatch(batch.label, batch.features, batch.offset, new_w, batch.rows)


def down_sampler_for_task(task: TaskType, rate: float, seed: int = 0) -> DownSampler:
    if task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        return BinaryClassificationDownSampler(rate, seed)
    return DefaultDownSampler(rate, seed)
