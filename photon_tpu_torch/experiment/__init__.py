"""Port of photon_tpu/experiment/__init__.py: the continuous online
experiment plane (see manager.py for the design)."""

from photon_tpu_torch.experiment.manager import (
    Candidate,
    ExperimentConfig,
    ExperimentManager,
    ExperimentSpace,
    IncrementalCandidateTrainer,
    SpawnedCandidateTrainer,
    experiment_summary,
    point_key,
)

__all__ = [
    "Candidate",
    "ExperimentConfig",
    "ExperimentManager",
    "ExperimentSpace",
    "IncrementalCandidateTrainer",
    "SpawnedCandidateTrainer",
    "experiment_summary",
    "point_key",
]
