"""Copy of photon_tpu/hyperparameter/__init__.py (numpy and scipy only)."""

from photon_tpu_torch.hyperparameter.search import (  # noqa: F401
    GaussianProcessSearch,
    RandomSearch,
)
from photon_tpu_torch.hyperparameter.kernels import RBF, Matern52  # noqa: F401
from photon_tpu_torch.hyperparameter.gp import GaussianProcessEstimator, GaussianProcessModel  # noqa: F401
from photon_tpu_torch.hyperparameter.criteria import confidence_bound, expected_improvement  # noqa: F401
from photon_tpu_torch.hyperparameter.tuner import HyperparameterTuner, get_tuner  # noqa: F401
