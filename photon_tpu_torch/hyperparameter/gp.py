"""Copy of photon_tpu/hyperparameter/gp.py (numpy and scipy only).

Gaussian-process regression for Bayesian hyperparameter search.

Parity targets: reference ``GaussianProcessModel.predict`` via Cholesky
(photon-lib hyperparameter/estimators/GaussianProcessModel.scala:34-120),
``GaussianProcessEstimator.fit`` with slice-sampled kernel hyperparameters
(estimators/GaussianProcessEstimator.scala:36-142) and ``SliceSampler``
(estimators/SliceSampler.scala:52-210), and the Cholesky helpers the
reference keeps in util/Linalg.scala:33-100.

Predictions are averaged over an ensemble of kernel-hyperparameter samples
drawn by slice sampling from the GP marginal likelihood — the same
integrated-acquisition scheme the reference implements.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.linalg

from photon_tpu_torch.hyperparameter.kernels import Matern52, StationaryKernel


def cholesky_solve(L: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve A x = b given lower Cholesky L of A (Linalg.choleskySolve role)."""
    return scipy.linalg.cho_solve((L, True), b)


def log_marginal_likelihood(kernel: StationaryKernel, X: np.ndarray, y: np.ndarray) -> float:
    n = X.shape[0]
    K = kernel.kernel_matrix(X) + 1e-10 * np.eye(n)
    try:
        L = np.linalg.cholesky(K)
    except np.linalg.LinAlgError:
        return -np.inf
    alpha = cholesky_solve(L, y)
    return float(
        -0.5 * y @ alpha - np.sum(np.log(np.diag(L))) - 0.5 * n * np.log(2 * np.pi)
    )


class SliceSampler:
    """Univariate stepping-out slice sampler over each coordinate in turn
    (reference SliceSampler.scala:52-210)."""

    def __init__(self, log_density: Callable[[np.ndarray], float], step: float = 1.0,
                 max_steps: int = 16, rng: Optional[np.random.Generator] = None):
        self.log_density = log_density
        self.step = step
        self.max_steps = max_steps
        self.rng = rng or np.random.default_rng(0)

    def sample_coordinate(self, x: np.ndarray, dim: int) -> np.ndarray:
        f0 = self.log_density(x)
        if not np.isfinite(f0):
            return x
        log_y = f0 + np.log(self.rng.uniform(1e-12, 1.0))
        # Step out
        u = self.rng.uniform()
        lo = x[dim] - self.step * u
        hi = lo + self.step
        steps = 0

        def density_at(v):
            xx = x.copy()
            xx[dim] = v
            return self.log_density(xx)

        while density_at(lo) > log_y and steps < self.max_steps:
            lo -= self.step
            steps += 1
        steps = 0
        while density_at(hi) > log_y and steps < self.max_steps:
            hi += self.step
            steps += 1
        # Shrink
        for _ in range(64):
            v = self.rng.uniform(lo, hi)
            if density_at(v) > log_y:
                out = x.copy()
                out[dim] = v
                return out
            if v < x[dim]:
                lo = v
            else:
                hi = v
        return x

    def sample(self, x: np.ndarray) -> np.ndarray:
        for d in range(x.shape[0]):
            x = self.sample_coordinate(x, d)
        return x


@dataclasses.dataclass
class GaussianProcessModel:
    """Posterior predictive over an ensemble of fitted kernels."""

    X: np.ndarray  # (n, d) observed points
    kernels: List[StationaryKernel]
    Ls: List[np.ndarray]  # per-kernel Cholesky of K
    alphas: List[np.ndarray]  # per-kernel K⁻¹ y

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) at query points, averaged over the kernel ensemble
        (GaussianProcessModel.scala:34-120)."""
        mus, vars_ = [], []
        for kernel, L, alpha in zip(self.kernels, self.Ls, self.alphas):
            Ks = kernel(self.X, Xs)  # (n, m)
            mu = Ks.T @ alpha
            v = scipy.linalg.solve_triangular(L, Ks, lower=True)
            var = np.maximum(
                kernel.amplitude + kernel.noise - np.sum(v * v, axis=0), 1e-12
            )
            mus.append(mu)
            vars_.append(var)
        mus = np.stack(mus)
        vars_ = np.stack(vars_)
        # Moment-matched mixture: E[y], Var[y] over ensemble members.
        mean = mus.mean(axis=0)
        var = vars_.mean(axis=0) + (mus**2).mean(axis=0) - mean**2
        return mean, np.sqrt(np.maximum(var, 1e-12))


class GaussianProcessEstimator:
    """Fit a GP with slice-sampled kernel hyperparameters
    (GaussianProcessEstimator.scala:36-142).

    Hyperparameters (log amplitude, log noise, log lengthscale) are sampled
    from the marginal likelihood; ``num_samples`` posterior kernels form the
    predictive ensemble.
    """

    def __init__(
        self,
        kernel_factory: Callable[..., StationaryKernel] = Matern52,
        num_samples: int = 3,
        burn_in: int = 5,
        seed: int = 0,
        normalize_y: bool = True,
    ):
        self.kernel_factory = kernel_factory
        self.num_samples = num_samples
        self.burn_in = burn_in
        self.seed = seed
        self.normalize_y = normalize_y

    def fit(self, X: np.ndarray, y: np.ndarray) -> GaussianProcessModel:
        X = np.asarray(X, float)
        y = np.asarray(y, float).ravel()
        y_mean, y_std = 0.0, 1.0
        if self.normalize_y and y.size > 1:
            y_mean = float(np.mean(y))
            y_std = float(np.std(y)) or 1.0
        yn = (y - y_mean) / y_std

        d = X.shape[1]

        def kernel_from_theta(theta: np.ndarray) -> StationaryKernel:
            return self.kernel_factory(
                amplitude=float(np.exp(theta[0])),
                noise=float(np.exp(theta[1])),
                lengthscale=np.exp(theta[2 : 2 + d]),
            )

        def log_density(theta: np.ndarray) -> float:
            # Weak log-normal priors keep the sampler in sane regions.
            prior = -0.5 * np.sum((theta / 3.0) ** 2)
            return log_marginal_likelihood(kernel_from_theta(theta), X, yn) + prior

        theta = np.zeros(2 + d)
        theta[1] = np.log(1e-3)
        sampler = SliceSampler(log_density, rng=np.random.default_rng(self.seed))
        for _ in range(self.burn_in):
            theta = sampler.sample(theta)

        kernels, Ls, alphas = [], [], []
        for _ in range(self.num_samples):
            theta = sampler.sample(theta)
            kern = kernel_from_theta(theta)
            K = kern.kernel_matrix(X) + 1e-10 * np.eye(X.shape[0])
            try:
                L = np.linalg.cholesky(K)
            except np.linalg.LinAlgError:
                continue
            kernels.append(kern)
            Ls.append(L)
            alphas.append(cholesky_solve(L, yn))
        if not kernels:  # degenerate fallback: default kernel
            kern = self.kernel_factory()
            K = kern.kernel_matrix(X) + 1e-6 * np.eye(X.shape[0])
            L = np.linalg.cholesky(K)
            kernels, Ls, alphas = [kern], [L], [cholesky_solve(L, yn)]

        model = GaussianProcessModel(X, kernels, Ls, alphas)
        model._y_mean, model._y_std = y_mean, y_std  # type: ignore[attr-defined]
        # Wrap predict to undo normalization.
        raw_predict = model.predict

        def predict(Xs):
            mu, sd = raw_predict(np.asarray(Xs, float))
            return mu * y_std + y_mean, sd * y_std

        model.predict = predict  # type: ignore[method-assign]
        return model
