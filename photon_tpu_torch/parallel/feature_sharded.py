"""Feature-sharded fixed-effect training (port of
photon_tpu/parallel/feature_sharded.py): the coefficient vector of a
sparse fixed effect too wide for one device, sharded over the mesh's
``feature`` axis.

Each rank along ``feature`` owns a contiguous range [lo, lo + d/F) of the
(padded) dimension and holds only that range of w; its rows are those of
its data rank (``place_feature_sharded``), with GLOBAL feature indices. A
rank resolves the entries that fall in its range (mask and local gather);
the partial margins are summed over the feature group (an (n_local,)
all-reduce instead of a gather of w), the gradient is scattered into the
local range and summed over the data group only, and the L2 term is summed
over the feature group. The solvers (L-BFGS and TRON, optim/) run on the
local range with a coefficient space whose dots and norms are reduced over
the feature group (``FeatureSpace``), so every rank of a feature line takes
the same steps. Sparse, so no kernel runs, as in the reference.

Scale normalization folds in (a local gather, like the values); shifts
would densify sparse rows and are refused, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures, default_transpose_plan
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import OptimizeResult, OptimizerConfig
from photon_tpu_torch.optim.lbfgs import minimize_lbfgs
from photon_tpu_torch.optim.problem import CallableOracle, dot
from photon_tpu_torch.optim.program import EAGER_CHUNK, run_chunked
from photon_tpu_torch.optim.tron import TRON
from photon_tpu_torch.parallel.distributed import shard_batch
from photon_tpu_torch.parallel.mesh import FEATURE_AXIS, Mesh, dp_axes

Tensor = torch.Tensor


def padded_dim(dim: int, n_feature_shards: int) -> int:
    """The dimension padded so that every feature shard is equal-sized.
    Padded coefficients start at 0 and get zero data and L2 gradient, so
    they stay exactly 0 through any quasi-Newton run."""
    f = n_feature_shards
    return int(np.ceil(dim / f) * f)


def _check_objective(objective: GLMObjective) -> None:
    norm = objective.normalization
    if norm is not None and norm.shifts is not None:
        raise ValueError(
            "feature-sharded training supports scale normalization only: shift normalization densifies sparse rows "
            "(the limitation the reference documents in HessianMatrixAggregator.scala:27-28); standardize to "
            "scale-only or use the replicated path")


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least float32; float64 kept (the float64 parity runs)."""
    return dtype if dtype == torch.float64 else torch.float32


class _Layout:
    """One rank's view of the feature axis: its range and the reductions."""

    def __init__(self, objective: GLMObjective, mesh: Mesh, dim: int):
        _check_objective(objective)
        n_feat = mesh.shape[FEATURE_AXIS]
        if dim % n_feat:
            raise ValueError(f"dim {dim} not divisible by the feature axis {n_feat}")
        self.mesh, self.shard = mesh, dim // n_feat
        self.lo = mesh.coords[FEATURE_AXIS] * self.shard
        self.loss, self.l2 = objective.loss, objective.l2_weight
        self.intercept = objective.intercept_index
        norm = objective.normalization
        self.factors = None if norm is None or norm.factors is None else norm.factors
        self._window = None  # (the batch's features, their window)

    def window(self, feats: SparseFeatures):
        """(local index, validity, values with the factors folded, the local
        columns) of the entries in this rank's range: the one place of the
        window math, computed once a batch. The local columns carry the
        transpose plan where the device's sparse products take it (the card:
        a deterministic segment sum, not float atomics)."""
        if self._window is not None and self._window[0] is feats:
            return self._window[1]
        local_idx = feats.indices.long() - self.lo
        valid = (local_idx >= 0) & (local_idx < self.shard)
        local_idx = torch.clamp(local_idx, 0, self.shard - 1)
        vals = feats.values
        if self.factors is not None:
            f_loc = self.factors[self.lo:self.lo + self.shard].to(vals.device)
            vals = vals * torch.where(valid, f_loc[local_idx], 0.0)
        cols = SparseFeatures(local_idx.to(torch.int32), vals, self.shard)
        if default_transpose_plan(vals.device):
            cols = cols.with_transpose_plan()
        self._window = (feats, (local_idx, valid, vals, cols))
        return self._window[1]

    def margins_partial(self, v_loc: Tensor, win) -> Tensor:
        """Σ over this rank's entries of each row's x·v (unreduced)."""
        local_idx, valid, vals, _cols = win
        acc = _acc_dtype(v_loc.dtype)
        gathered = torch.where(valid, v_loc[local_idx], 0.0)
        return torch.sum((vals * gathered).to(acc), dim=-1)

    def scatter(self, win, r: Tensor) -> Tensor:
        """Σ_i r_i·x_i over this rank's rows, into its range (unreduced)."""
        _local_idx, valid, vals, cols = win
        return cols.scatter_columns(torch.where(valid, vals * r[:, None], 0.0).to(r.dtype))

    def l2_masked(self, x_loc: Tensor) -> Tensor:
        """x_loc with the (global) intercept zeroed."""
        xm = x_loc.to(_acc_dtype(x_loc.dtype))
        if self.intercept is not None and self.lo <= self.intercept < self.lo + self.shard:
            xm = xm.clone()
            xm[self.intercept - self.lo] = 0.0
        return xm

    def feature_sum(self, t: Tensor) -> Tensor:
        return self.mesh.all_reduce(t, (FEATURE_AXIS,))

    def data_sum(self, t: Tensor) -> Tensor:
        return self.mesh.all_reduce(t, dp_axes(self.mesh))


class FeatureSpace:
    """The coefficient space of a feature-sharded solve: dots, norms and
    finiteness tests over a rank's range, reduced over the feature group
    (optim/problem.py::LocalSpace is the whole-vector one)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _sum(self, t: Tensor) -> Tensor:
        return self.mesh.all_reduce(t.contiguous(), (FEATURE_AXIS,))

    def dot(self, a: Tensor, b: Tensor) -> Tensor:
        return self._sum(dot(a, b))

    def norm(self, a: Tensor) -> Tensor:
        return torch.sqrt(self._sum(dot(a, a)))

    def all_finite(self, a: Tensor) -> Tensor:
        return self._sum((~torch.isfinite(a)).sum(-1)) == 0


class _ShardedOracle(CallableOracle):
    """CallableOracle whose decision to rebuild the Hessian product (its
    point moved) is taken by the whole feature line, so that every rank
    makes the same collectives."""

    def __init__(self, vg, hvp_factory, mesh: Mesh):
        super().__init__(vg, hvp_factory)
        self.mesh = mesh

    def _product(self, curv: Tensor):
        moved = torch.ones((), dtype=torch.int32, device=curv.device)
        if self._at is not None and torch.equal(self._at, curv):
            moved.zero_()
        if int(self.mesh.all_reduce(moved, self.mesh.axis_names)) or self._hv is None:
            self._at, self._hv = curv.clone(), self.hvp_factory(curv)
        return self._hv


def sparse_value_and_grad_feature_sharded(objective: GLMObjective, mesh: Mesh, dim: int):
    """``(w_loc, batch) -> (value, grad_loc)`` for a sparse LabeledBatch of
    this rank's rows (global feature indices) with w sharded over the
    feature axis. ``dim`` is the PADDED dimension (a multiple of the
    feature-axis size)."""
    L = _Layout(objective, mesh, dim)

    def value_and_grad(w_loc: Tensor, batch: LabeledBatch) -> Tuple[Tensor, Tensor]:
        feats = batch.features
        assert isinstance(feats, SparseFeatures)
        win = L.window(feats)
        acc = _acc_dtype(w_loc.dtype)
        z = L.feature_sum(L.margins_partial(w_loc, win)) + batch.offset
        lv = L.loss.value(z, batch.label)
        dz = batch.weight * L.loss.dz(z, batch.label)
        loss_local = torch.sum(batch.weight * lv).to(acc)
        grad_loc = L.scatter(win, dz.to(acc))
        # The data term and gradient over the data group in one reduction.
        packed = L.data_sum(torch.cat([loss_local[None], grad_loc]))
        loss, grad_loc = packed[0], packed[1:]
        if L.l2 != 0.0:
            wm = L.l2_masked(w_loc)
            grad_loc = grad_loc + L.l2 * wm
            value = loss + L.feature_sum(0.5 * L.l2 * torch.sum(wm * wm))
        else:
            value = loss
        return value.to(w_loc.dtype), grad_loc.to(w_loc.dtype)

    return value_and_grad


def sparse_linearized_hvp_feature_sharded(objective: GLMObjective, mesh: Mesh, dim: int):
    """``make_hvp(w_loc, batch) -> (v_loc -> H(w)·v)``: the curvature
    d2 = weight·loss″(z) once an outer iterate (one margins pass, summed
    over the feature group), then each product a forward pass (summed over
    the feature group) and a scatter (summed over the data group)."""
    L = _Layout(objective, mesh, dim)

    def make_hvp(w_loc: Tensor, batch: LabeledBatch):
        feats = batch.features
        assert isinstance(feats, SparseFeatures)
        win = L.window(feats)
        z = L.feature_sum(L.margins_partial(w_loc, win)) + batch.offset
        d2 = batch.weight * L.loss.dzz(z, batch.label)

        def hv(v_loc: Tensor) -> Tensor:
            u = L.feature_sum(L.margins_partial(v_loc, win))
            out = L.data_sum(L.scatter(win, (d2 * u).to(_acc_dtype(v_loc.dtype))))
            if L.l2 != 0.0:
                out = out + L.l2 * L.l2_masked(v_loc)
            return out.to(v_loc.dtype)

        return hv

    return make_hvp


def place_feature_sharded(mesh: Mesh, w: Tensor, batch: LabeledBatch) -> Tuple[Tensor, LabeledBatch]:
    """This rank's range of ``w`` (the whole vector on every rank) and its
    data rank's rows of the sparse ``batch`` (padded with weight-0 rows)."""
    assert isinstance(batch.features, SparseFeatures)
    shard = w.shape[0] // mesh.shape[FEATURE_AXIS]
    lo = mesh.coords[FEATURE_AXIS] * shard
    local = shard_batch(batch, mesh, n_shards=mesh.size(*dp_axes(mesh)))
    return w[lo:lo + shard].clone(), LabeledBatch(local.label, local.features, local.offset, local.weight)


def train_fixed_effect_feature_sharded(mesh: Mesh, objective: GLMObjective, config: OptimizerConfig, dim: int,
                                       box: Optional[Tuple[Tensor, Tensor]] = None, solver: str = "lbfgs",
                                       max_cg_iter: int = 20):
    """``fit(w0_loc, batch) -> OptimizeResult`` of a sparse fixed effect
    with w feature-sharded (``result.w`` is this rank's range): L-BFGS, or
    TRON on the sharded Hessian products. ``dim`` must be padded
    (``padded_dim``); ``box`` is this rank's range of the bounds. Runs
    eagerly (its reductions are in every step)."""
    if solver not in ("lbfgs", "tron"):
        raise ValueError(f"unknown feature-sharded solver {solver!r}")
    vg = sparse_value_and_grad_feature_sharded(objective, mesh, dim)
    make_hvp = sparse_linearized_hvp_feature_sharded(objective, mesh, dim) if solver == "tron" else None
    space = FeatureSpace(mesh)

    def fit(w0: Tensor, batch: LabeledBatch) -> OptimizeResult:
        if solver == "tron":
            prog = TRON(_ShardedOracle(lambda w: vg(w, batch), lambda w: make_hvp(w, batch), mesh), w0, config,
                        max_cg_iter, box, space)
            run_chunked(prog, EAGER_CHUNK)
            return prog.result()
        return minimize_lbfgs(lambda w: vg(w, batch), w0, config, box=box, space=space)

    return fit
