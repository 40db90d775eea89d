"""Copy of photon_tpu/hyperparameter/kernels.py (numpy and scipy only).

Stationary GP covariance kernels.

Parity target: reference kernels (photon-lib hyperparameter/estimators/
kernels/StationaryKernel.scala, RBF.scala, Matern52.scala:44-80) —
amplitude/noise/lengthscale-parameterized stationary kernels with
automatic-relevance-determination lengthscales.

Host-side numpy in float64: the GP fits are tiny (tens of observations) and
driver-side, exactly as in the reference; the expensive part of tuning — the
candidate model trainings — runs on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StationaryKernel:
    amplitude: float = 1.0
    noise: float = 1e-4
    lengthscale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(1)
    )  # scalar or per-dim (ARD)

    def _scaled_sqdist(self, X1: np.ndarray, X2: np.ndarray) -> np.ndarray:
        ls = np.broadcast_to(np.asarray(self.lengthscale, float), (X1.shape[1],))
        A = X1 / ls
        B = X2 / ls
        d2 = (
            np.sum(A * A, axis=1)[:, None]
            + np.sum(B * B, axis=1)[None, :]
            - 2.0 * A @ B.T
        )
        return np.maximum(d2, 0.0)

    def with_params(self, amplitude: float, noise: float, lengthscale: np.ndarray):
        return dataclasses.replace(
            self, amplitude=amplitude, noise=noise, lengthscale=lengthscale
        )

    def __call__(self, X1: np.ndarray, X2: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def kernel_matrix(self, X: np.ndarray) -> np.ndarray:
        """K(X, X) + noise·I."""
        return self(X, X) + self.noise * np.eye(X.shape[0])


@dataclasses.dataclass
class RBF(StationaryKernel):
    """Squared-exponential kernel (reference RBF.scala)."""

    def __call__(self, X1, X2):
        return self.amplitude * np.exp(-0.5 * self._scaled_sqdist(X1, X2))


@dataclasses.dataclass
class Matern52(StationaryKernel):
    """Matérn 5/2 kernel (reference Matern52.scala:44-80)."""

    def __call__(self, X1, X2):
        d = np.sqrt(self._scaled_sqdist(X1, X2))
        s5d = np.sqrt(5.0) * d
        return self.amplitude * (1.0 + s5d + 5.0 / 3.0 * d * d) * np.exp(-s5d)
