"""The rank programs of the multi-rank CPU tests (tests/test_torch_entity_sharded.py,
tests/test_torch_multidevice.py).

``photon_tpu_torch.utils.virtual_devices.run_ranks`` runs one of these
functions in each of n spawned processes joined by a gloo group; ``spawn``
imports this module in every child, so it imports torch, numpy and the port
only (never jax or photon_tpu, which the tests' own process holds). Each
program runs every case of its test module at one world size and returns
host arrays, so that each world size spawns once per module.
"""

from __future__ import annotations

import numpy as np
import torch

E, D_RE = 96, 4


def make_workload(seed=7):
    """The reference's entity-sharded workload (tests/test_entity_sharded.py):
    ragged per-entity row counts."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(3, 24, size=E)
    eids = np.repeat(np.arange(E, dtype=np.int32), counts)
    n = eids.size
    Xr = rng.normal(size=(n, D_RE)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    offsets = (0.25 * np.sin(np.arange(n, dtype=np.float32))).astype(np.float32)
    return eids, Xr, y, w, offsets


def fused_workload(seed=3):
    """The reference's fused entity-sharded step fixture (E = 64, 8 rows an
    entity, d_fe = 8, d_re = 4)."""
    rng = np.random.default_rng(seed)
    E_f, d_re, d_fe, rows_per = 64, 4, 8, 8
    n = E_f * rows_per
    eids = np.repeat(np.arange(E_f, dtype=np.int32), rows_per)[rng.permutation(n)]
    Xf = rng.normal(size=(n, d_fe)).astype(np.float32)
    Xr = rng.normal(size=(n, d_re)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    return E_f, eids, Xf, Xr, y, w


def tiny_glmix(n, d_fix, d_re, E_, seed=0):
    """__graft_entry__.py::_make_tiny_glmix."""
    rng = np.random.default_rng(seed)
    Xf = rng.normal(size=(n, d_fix)).astype(np.float32)
    Xf[:, 0] = 1.0
    Xr = rng.normal(size=(n, d_re)).astype(np.float32)
    Xr[:, 0] = 1.0
    users = (np.arange(n) % E_).astype(np.int32)
    logits = Xf @ rng.normal(size=d_fix).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return Xf, Xr, users, y


# GLMix fixture of the sharded-step cases: the dryrun's shapes at 8 devices.
GLMIX_N, GLMIX_D_FIX, GLMIX_D_RE, GLMIX_E = 128, 16, 4, 32


def sparse_problem(n=64, d=30, k=6, seed=0, binary=True):
    """tests/test_feature_sharded.py::_sparse_problem."""
    rng = np.random.default_rng(seed)
    indices = np.zeros((n, k), np.int32)
    values = np.zeros((n, k), np.float32)
    for i in range(n):
        nnz = rng.integers(2, k + 1)
        ix = rng.choice(d, size=nnz, replace=False)
        indices[i, :nnz] = np.sort(ix)
        values[i, :nnz] = rng.normal(size=nnz)
    X = np.zeros((n, d), np.float32)
    for i in range(n):
        mask = values[i] != 0
        X[i, indices[i, mask]] += values[i, mask]
    w_true = rng.normal(size=d).astype(np.float32) / np.sqrt(d)
    logits = X @ w_true
    if binary:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    else:
        y = rng.poisson(np.exp(np.clip(logits, None, 3))).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    offset = rng.normal(size=n).astype(np.float32) * 0.1
    return indices, values, X, y, weight, offset


def multislice_sparse(n=64, d=32, k=5):
    """tests/test_multislice.py::test_feature_sharded_on_multislice_mesh's data."""
    rng = np.random.default_rng(0)
    indices = rng.integers(0, d, size=(n, k)).astype(np.int32)
    values = rng.normal(size=(n, k)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    Xd = np.zeros((n, d), np.float32)
    for i in range(n):
        for j in range(k):
            Xd[i, indices[i, j]] += values[i, j]
    return indices, values, y, Xd


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)


# ---------------------------------------------------------------------------
# Entity-sharded random effects (tests/test_torch_entity_sharded.py)
# ---------------------------------------------------------------------------


def _run_sharded(mesh, device, dtype, passes=3, cache=None, spill_dir=None, **kw):
    from photon_tpu_torch.algorithm.sharded_random_effect import ShardedRandomEffectCoordinate
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.types import OptimizerType, TaskType

    eids, Xr, y, w, offsets = make_workload()
    Xr, y, w, offsets = (a.astype(dtype) for a in (Xr, y, w, offsets))
    n = eids.size
    batch = GameBatch(label=_t(y, dtype, device), offset=torch.zeros(n, dtype=_t(y, dtype, device).dtype,
                                                                     device=device),
                      weight=_t(w, dtype, device), features={"re": _t(Xr, dtype, device)},
                      entity_ids={"userId": _t(eids, np.int32, device)})
    cfg = RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=3, shape_bucketing=True,
                                 subspace_projection=False)
    cache = cache if cache is not None else SolveCache()
    coord = ShardedRandomEffectCoordinate.build(
        coordinate_id="per_user", entity_ids=eids, features=Xr, label=y, weight=w, num_entities=E, config=cfg,
        task=TaskType.LOGISTIC_REGRESSION, objective=GLMObjective(loss=LogisticLoss, l2_weight=0.5),
        optimizer_spec=OptimizerSpec(optimizer=OptimizerType.NEWTON, max_iter=3, tol=1e-9), mesh=mesh,
        device=device, solve_cache=cache, device_spill_dir=spill_dir, **kw)
    model, marks, iters = None, [], []
    off = _t(offsets, dtype, device)
    for it in range(passes):
        coord.begin_cd_pass(it)
        m = cache.trace_mark()
        model, stats = coord.train(batch, off, model)
        marks.append(cache.traces_since(m))
        iters.append(stats.iterations[stats.valid].numpy())
    return coord, model.coefficients.numpy(), marks, iters


def _fused_step(mesh, device, dtype, steps=2):
    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.common import OptimizerConfig
    from photon_tpu_torch.parallel.entity_shard import build_shard_plan
    from photon_tpu_torch.parallel.train_step import game_entity_sharded_train_step, stack_shard_blocks

    S = 8
    E_f, eids, Xf, Xr, y, w = fused_workload()
    Xf, Xr, y, w = (a.astype(dtype) for a in (Xf, Xr, y, w))
    n = eids.size
    plan = build_shard_plan(E_f, n_shards=S, seed=0)
    cfg = RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=1, shape_bucketing=True,
                                 subspace_projection=False)
    blocks = [build_random_effect_dataset(se, Xr, y, w, int(plan.counts[s]), cfg, device="cpu").blocks[0]
              for s, se in enumerate(plan.shard_sample_entities(eids))]
    stacked = stack_shard_blocks(blocks)
    E_s = stacked.entity_idx.shape[1]
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0)
    step, place = game_entity_sharded_train_step(mesh, obj, obj, OptimizerConfig(max_iter=6, tol=1e-8),
                                                 OptimizerConfig(max_iter=3, tol=1e-9))
    fe = LabeledBatch(torch.from_numpy(y), torch.from_numpy(Xf), torch.zeros(n, dtype=torch.from_numpy(y).dtype),
                      torch.from_numpy(w))
    args = place(np.zeros(Xf.shape[1], dtype), np.zeros((S, E_s, Xr.shape[1]), dtype), fe, stacked, Xr,
                 plan.shard_of[eids].astype(np.int32), plan.local_of[eids].astype(np.int32))
    wf, rc = args[0], args[1]
    for _ in range(steps):
        wf, rc, scores, fe_evals, visits = step(wf, rc, *args[2:])
    return dict(w=wf.numpy(), rc=rc.numpy(), scores=args[2].rows.gather(scores).numpy(), visits=int(visits),
                fe_evals=int(fe_evals))


def estimator_fit(mesh, device, dtype=np.float64):
    """``GameEstimator.fit`` of a fixed effect and a per-user effect (the
    GLMix fixture, 2 passes, active set), over ``mesh`` (None: unsharded):
    the fixed-effect and per-user coefficients."""
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    Xf, Xr, users, y = tiny_glmix(4 * GLMIX_N, GLMIX_D_FIX, GLMIX_D_RE, GLMIX_E, seed=2)
    n = users.size
    batch = GameBatch(label=_t(y, dtype, device), offset=_t(np.zeros(n), dtype, device),
                      weight=_t(np.ones(n), dtype, device),
                      features={"global": _t(Xf, dtype, device), "user": _t(Xr, dtype, device)},
                      entity_ids={"userId": _t(users, np.int32, device)})
    cfgs = [config.FixedEffectCoordinateConfig("global", "global"),
            config.RandomEffectCoordinateConfig("per_user", "userId", "user")]
    reg = config.GameOptimizationConfig({c.coordinate_id: config.RegularizationConfig(1.0, 0.0) for c in cfgs})
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, cfgs, num_iterations=2,
                        intercept_indices={"global": 0, "user": 0}, num_entities={"userId": GLMIX_E},
                        re_active_set=True, solve_cache=SolveCache(), mesh=mesh)
    (res,) = est.fit(batch, optimization_configs=[reg])
    return dict(fe=res.model.get("global").model.coefficients.means.cpu().numpy(),
                re=res.model.get("per_user").coefficients.cpu().numpy())


def entity_sharded_program(rank, world, device, spill_root):
    """Every case of tests/test_torch_entity_sharded.py at this world size."""
    import os

    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=device)
    out = {}
    for name, dtype, kw in (("plain", np.float64, {}), ("plain_f32", np.float32, {}),
                            ("gated", np.float64, dict(active_set=True, convergence_tol=1e-7)),
                            ("ooc", np.float64, dict(device_budget_bytes=1)),
                            ("spill", np.float32, dict(device_budget_bytes=1,
                                                       spill_dir=os.path.join(spill_root, f"world{world}")))):
        coord, coefs, marks, iters = _run_sharded(mesh, device, dtype, **kw)
        out[name] = dict(coefs=coefs, marks=marks, iters=iters)
        if name == "plain":
            out["busy"] = coord.device_busy_seconds()
            out["owned"] = sorted(coord.shards)
            out["shard_devices"] = sorted({str(b.features.device) for c in coord.shards.values()
                                           for b in c.dataset.blocks})
            out["samples"] = int(sum(coord.last_shard_samples.values()))
        if name in ("ooc", "spill"):
            out[name]["residency"] = [None if st is None else dict(evictions=st["evictions"],
                                                                   peak_bytes=st["peak_bytes"])
                                      for st in coord.residency_stats()]
    # A second coordinate over the same geometry in a warm cache builds nothing.
    cache = SolveCache()
    _run_sharded(mesh, device, np.float64, cache=cache)
    out["warm_marks"] = _run_sharded(mesh, device, np.float64, cache=cache)[2]
    out["fused"] = _fused_step(mesh, device, np.float64)
    out["fused_again"] = _fused_step(mesh, device, np.float64)
    out["estimator"] = estimator_fit(mesh, device)
    return out


# ---------------------------------------------------------------------------
# Sharded fixed effects (tests/test_torch_multidevice.py)
# ---------------------------------------------------------------------------


def glmix_sparse_rows(Xf):
    """Xf as padded-sparse rows (indices, values): every other column of a
    row, so that the sparse fixed effect differs from the dense one."""
    n, d = Xf.shape
    cols = np.arange(0, d, 2)
    return np.broadcast_to(cols, (n, cols.size)).astype(np.int32).copy(), Xf[:, cols].copy()


def _glmix_inputs(dtype, sparse=False):
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset

    Xf, Xr, users, y = tiny_glmix(GLMIX_N, GLMIX_D_FIX, GLMIX_D_RE, GLMIX_E)
    Xf, Xr, y = (a.astype(dtype) for a in (Xf, Xr, y))
    (block,) = build_random_effect_dataset(users, Xr, y, np.ones(GLMIX_N, dtype), GLMIX_E,
                                           RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=1),
                                           device="cpu").blocks
    X = torch.from_numpy(Xf)
    if sparse:
        idx, vals = glmix_sparse_rows(Xf)
        X = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(vals), GLMIX_D_FIX)
    return LabeledBatch(torch.from_numpy(y), X), block, Xr, users


def _glmix_run(mesh, dtype, cfg, steps=1, re_solver="newton", sparse=False):
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.parallel.train_step import glmix_sharded_train_step

    fe, block, Xr, users = _glmix_inputs(dtype, sparse)
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    step, place = glmix_sharded_train_step(mesh, obj, obj, cfg, cfg, re_solver=re_solver, solve_cache=SolveCache())
    args = place(np.zeros(GLMIX_D_FIX, dtype), np.zeros((GLMIX_E, GLMIX_D_RE), dtype), fe, block, Xr, users)
    w, c = args[0], args[1]
    for _ in range(steps):
        w, c, scores, fe_evals, visits = step(w, c, *args[2:])
    return dict(w=w.numpy(), c=c.numpy(), scores=args[2].rows.gather(scores).numpy(), fe_evals=int(fe_evals),
                visits=int(visits))


def _tron_rows(mesh, dtype):
    """A fixed-effect TRON solve on a rows-sharded batch (K2's route)."""
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.parallel.distributed import shard_batch
    from photon_tpu_torch.types import OptimizerType

    Xf, _Xr, _u, y = tiny_glmix(GLMIX_N, GLMIX_D_FIX, GLMIX_D_RE, GLMIX_E, seed=5)
    rng = np.random.default_rng(5)
    off = (0.1 * rng.normal(size=GLMIX_N)).astype(dtype)
    wt = rng.uniform(0.5, 1.5, size=GLMIX_N).astype(dtype)
    lb = shard_batch(LabeledBatch(_t(y, dtype, "cpu"), _t(Xf, dtype, "cpu"), _t(off, dtype, "cpu"),
                                  _t(wt, dtype, "cpu")), mesh)
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    spec = OptimizerSpec(OptimizerType.TRON, max_iter=15, tol=1e-9, track_history=False)
    res = SolveCache().fe_solver(obj, spec)(torch.zeros(GLMIX_D_FIX, dtype=lb.label.dtype), lb)
    return dict(w=res.w.numpy(), iterations=int(res.iterations), reason=int(res.reason_code),
                value=float(res.value))


def _feature_cases(mesh, world):
    """tests/test_feature_sharded.py's cases on this rank; the results are
    gathered over the feature axis to the whole vector."""
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
    from photon_tpu_torch.data.normalization import NormalizationContext
    from photon_tpu_torch.ops.losses import LogisticLoss, PoissonLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.common import OptimizerConfig
    from photon_tpu_torch.parallel.feature_sharded import (
        padded_dim, place_feature_sharded, sparse_linearized_hvp_feature_sharded,
        sparse_value_and_grad_feature_sharded, train_fixed_effect_feature_sharded)
    from photon_tpu_torch.parallel.mesh import FEATURE_AXIS

    F = mesh.shape[FEATURE_AXIS]
    whole = lambda t: torch.cat(mesh.all_gather(t.contiguous(), FEATURE_AXIS)).numpy()  # noqa: E731
    f64 = torch.float64

    def batch_of(indices, values, y, offset, weight, dim_p):
        return LabeledBatch(_t(y, np.float64, "cpu"), SparseFeatures(torch.from_numpy(indices),
                                                                     _t(values, np.float64, "cpu"), dim_p),
                            _t(offset, np.float64, "cpu"), _t(weight, np.float64, "cpu"))

    out = {}
    # value and gradient, with and without the scale normalization
    idx, vals, X, y, wt, off = sparse_problem(n=64, d=30)
    dim_p = padded_dim(30, F)
    w = np.zeros(dim_p)
    w[:30] = np.linspace(-0.5, 0.5, 30)
    obj = GLMObjective(loss=LogisticLoss, l2_weight=0.7, intercept_index=3)
    w_loc, b = place_feature_sharded(mesh, torch.from_numpy(w), batch_of(idx, vals, y, off, wt, dim_p))
    val, g = sparse_value_and_grad_feature_sharded(obj, mesh, dim_p)(w_loc, b)
    out["vg"] = (float(val), whole(g))

    idx, vals, X, y, wt, off = sparse_problem(n=32, d=14, seed=3)
    dim_p = padded_dim(14, F)
    factors = np.ones(dim_p)
    factors[:14] = np.linspace(0.5, 2.0, 14)
    obj = GLMObjective(loss=LogisticLoss, l2_weight=0.1,
                       normalization=NormalizationContext(factors=torch.from_numpy(factors)))
    w_loc, b = place_feature_sharded(mesh, torch.linspace(-0.3, 0.3, dim_p, dtype=f64),
                                     batch_of(idx, vals, y, off, wt, dim_p))
    val, g = sparse_value_and_grad_feature_sharded(obj, mesh, dim_p)(w_loc, b)
    out["vg_scaled"] = (float(val), whole(g))

    for name, loss, binary in (("train_logistic", LogisticLoss, True), ("train_poisson", PoissonLoss, False)):
        idx, vals, X, y, wt, off = sparse_problem(n=64, d=30, seed=7, binary=binary)
        dim_p = padded_dim(30, F)
        obj = GLMObjective(loss=loss, l2_weight=1.0, intercept_index=0)
        cfg = OptimizerConfig(max_iter=50, tol=1e-8, track_history=False)
        w0, b = place_feature_sharded(mesh, torch.zeros(dim_p, dtype=f64), batch_of(idx, vals, y, off, wt, dim_p))
        fit = train_fixed_effect_feature_sharded(mesh, obj, cfg, dim_p)
        res = fit(w0, b)
        out[name] = dict(w=whole(res.w), local=int(res.w.shape[0]), grad_norm=float(res.grad_norm),
                         iterations=int(res.iterations), again=whole(fit(w0, b).w))

    idx, vals, X, y, wt, off = sparse_problem(n=64, d=30, seed=11)
    dim_p = padded_dim(30, F)
    factors = np.linspace(0.5, 1.5, dim_p)
    rng = np.random.default_rng(3)
    w = rng.normal(size=dim_p) * 0.3
    v = rng.normal(size=dim_p)
    hvps = []
    for obj in (GLMObjective(loss=LogisticLoss, l2_weight=0.7, intercept_index=0),
                GLMObjective(loss=LogisticLoss, l2_weight=0.3, intercept_index=0,
                             normalization=NormalizationContext(factors=torch.from_numpy(factors), intercept_index=0))):
        w_loc, b = place_feature_sharded(mesh, torch.from_numpy(w), batch_of(idx, vals, y, off, wt, dim_p))
        v_loc, _ = place_feature_sharded(mesh, torch.from_numpy(v), b)
        hvps.append(whole(sparse_linearized_hvp_feature_sharded(obj, mesh, dim_p)(w_loc, b)(v_loc)))
    out["hvp"] = hvps

    idx, vals, X, y, wt, off = sparse_problem(n=64, d=30, seed=13)
    dim_p = padded_dim(30, F)
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    cfg = OptimizerConfig(max_iter=30, tol=1e-8, track_history=False)
    w0, b = place_feature_sharded(mesh, torch.zeros(dim_p, dtype=f64), batch_of(idx, vals, y, off, wt, dim_p))
    fit = train_fixed_effect_feature_sharded(mesh, obj, cfg, dim_p, solver="tron")
    res = fit(w0, b)
    out["tron"] = dict(w=whole(res.w), grad_norm=float(res.grad_norm), iterations=int(res.iterations),
                       again=whole(fit(w0, b).w))
    return out


def _multislice_cases(world):
    """tests/test_multislice.py's cases on a (2, world/4, 2) and a
    (2, world/2, 1) slice mesh."""
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
    from photon_tpu_torch.evaluation import evaluators as ev
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.common import OptimizerConfig
    from photon_tpu_torch.parallel.distributed import shard_batch
    from photon_tpu_torch.parallel.feature_sharded import place_feature_sharded, train_fixed_effect_feature_sharded
    from photon_tpu_torch.parallel.mesh import FEATURE_AXIS, dp_axes, make_mesh, make_multislice_mesh

    out = {}
    mesh = make_multislice_mesh(n_slices=2, n_feature=2)
    out["axes"] = (mesh.axis_names, dict(mesh.shape), dp_axes(mesh), dp_axes(make_mesh()))
    out["devices"] = (str(mesh.device), str(make_mesh().device))
    indices, values, y, Xd = multislice_sparse()
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    cfg = OptimizerConfig(max_iter=40, tol=1e-8, track_history=False)
    w0, b = place_feature_sharded(mesh, torch.zeros(32, dtype=torch.float64),
                                  LabeledBatch(_t(y, np.float64, "cpu"), SparseFeatures(
                                      torch.from_numpy(indices), _t(values, np.float64, "cpu"), 32)))
    res = train_fixed_effect_feature_sharded(mesh, obj, cfg, 32)(w0, b)
    out["feature_sharded"] = torch.cat(mesh.all_gather(res.w.contiguous(), FEATURE_AXIS)).numpy()

    slices = make_multislice_mesh(n_slices=2, n_feature=1)
    out["glmix"] = _glmix_run(slices, np.float64, OptimizerConfig(max_iter=3, track_history=False))
    sb = shard_batch(LabeledBatch(torch.ones(13, dtype=torch.float64), torch.ones((13, 3), dtype=torch.float64)),
                     slices)
    total = sb.rows.gather(sb.weight)
    out["padding"] = (sb.rows.n_shards * sb.rows.shard_rows, float(sb.rows._reduce(torch.sum(sb.weight)[None])[0]),
                      int(total.shape[0]))

    rng = np.random.default_rng(77)
    n = 8 * 250
    scores = rng.normal(size=n).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.4).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    scores[::7] = 0.5
    gids = rng.integers(0, 16, size=n).astype(np.int32)
    rows = shard_batch(LabeledBatch(torch.from_numpy(labels), torch.from_numpy(scores)[:, None],
                                    None, torch.from_numpy(weight)), make_mesh()).rows
    local = lambda a: torch.from_numpy(a)[rows.lo:rows.lo + rows.local_rows]  # noqa: E731
    got = {}
    for name, fn in (("auc_roc", ev.auc_roc), ("auc_pr", ev.auc_pr), ("rmse", ev.rmse),
                     ("logistic_loss", ev.logistic_loss_metric), ("squared_loss", ev.squared_loss_metric)):
        # Each rank holds its rows; the metric reads the gathered rows.
        got[name] = float(fn(rows.gather(local(scores)), rows.gather(local(labels)), rows.gather(local(weight))))
    got["grouped_auc"] = float(ev.grouped_auc(rows.gather(local(scores)), rows.gather(local(labels)),
                                              rows.gather(local(gids)), num_groups=16,
                                              weight=rows.gather(local(weight))))
    out["evaluators"] = got
    return out


def multidevice_program(rank, world, device):
    """Every case of tests/test_torch_multidevice.py at this world size."""
    from photon_tpu_torch.optim.common import OptimizerConfig
    from photon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=device)
    cfg = OptimizerConfig(max_iter=3, track_history=False)
    tight = OptimizerConfig(max_iter=40, tol=1e-8, track_history=False)
    out = dict(
        glmix=_glmix_run(mesh, np.float64, cfg, steps=2),
        glmix_again=_glmix_run(mesh, np.float64, cfg, steps=2),
        glmix_f32=_glmix_run(mesh, np.float32, cfg, steps=2),
        glmix_lbfgs=_glmix_run(mesh, np.float64, cfg, steps=2, re_solver="lbfgs"),
        glmix_sparse=_glmix_run(mesh, np.float64, cfg, steps=2, sparse=True),
        glmix_converged=_glmix_run(mesh, np.float64, tight),
        tron=_tron_rows(mesh, np.float64),
        tron_again=_tron_rows(mesh, np.float64),
    )
    if world == 8:
        out["feature"] = _feature_cases(make_mesh(n_data=2, n_feature=4, device=device), world)
        out["multislice"] = _multislice_cases(world)
    return out


# ---------------------------------------------------------------------------
# The launcher's own cases (tests/test_torch_multidevice.py)
# ---------------------------------------------------------------------------


def fail_on_rank_one(rank, world, device):
    """Rank 1 raises; the others wait in a collective for it."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return rank


def hang_in_collective(rank, world, device):
    """Rank 0 waits in an all-reduce that rank 1 never joins: the group's
    timeout ends it."""
    import time

    import torch.distributed as dist

    if rank == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(60)
    return rank


def report_rank(rank, world, device):
    import torch.distributed as dist

    t = torch.full((1,), float(rank + 1))
    dist.all_reduce(t)
    return rank, world, str(device), dist.get_backend(), float(t[0])


# ---------------------------------------------------------------------------
# Card-only cases (tests/test_torch_gpu.py): ranks on one card
# ---------------------------------------------------------------------------


def card_rows_program(rank, world, device):
    """A rows-sharded fixed-effect margin L-BFGS and TRON solve on the card
    (K1, K2 on each rank's rows): coefficients, the solve routes and the
    launches that ran."""
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.batch import LabeledBatch
    from photon_tpu_torch.ops import kernels
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.parallel.distributed import shard_batch
    from photon_tpu_torch.parallel.mesh import make_mesh
    from photon_tpu_torch.types import OptimizerType

    mesh = make_mesh(device=device)
    Xf, _Xr, _u, y = tiny_glmix(1 << 14, 64, 4, 16, seed=9)
    lb = shard_batch(LabeledBatch(_t(y, np.float32, device), _t(Xf, np.float32, device).to(torch.bfloat16)), mesh)
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0, use_fused=True)
    cache = SolveCache()
    kernels.reset_launches()
    out = {}
    for name, opt in (("lbfgs", OptimizerType.LBFGS), ("tron", OptimizerType.TRON)):
        spec = OptimizerSpec(opt, max_iter=10, tol=1e-9, track_history=False)
        res = cache.fe_solver(obj, spec)(torch.zeros(64, device=device), lb)
        out[name] = res.w.cpu().numpy()
    torch.cuda.synchronize()
    out["routes"] = [i["route"] for i in cache.entry_info()]
    out["ran"] = kernels.ran()
    return out


def card_entity_program(rank, world, device):
    """The entity-sharded coordinate of tests/test_torch_entity_sharded.py
    on the card in float32 (K3 on this rank's shards)."""
    from photon_tpu_torch.ops import kernels
    from photon_tpu_torch.parallel.mesh import make_mesh

    kernels.reset_launches()
    _coord, coefs, marks, _iters = _run_sharded(make_mesh(device=device), device, np.float32)
    torch.cuda.synchronize()
    return dict(coefs=coefs, marks=marks, ran=kernels.ran())


def card_default_mesh_program(rank, world, device):
    """``make_mesh()`` with no device on a rank that joined on the card: the
    mesh's device, and where the sharded GLMix step places its host inputs
    and leaves its outputs."""
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.common import OptimizerConfig
    from photon_tpu_torch.parallel.mesh import make_mesh
    from photon_tpu_torch.parallel.train_step import glmix_sharded_train_step

    mesh = make_mesh()
    fe, block, Xr, users = _glmix_inputs(np.float32)
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    cfg = OptimizerConfig(max_iter=3, track_history=False)
    step, place = glmix_sharded_train_step(mesh, obj, obj, cfg, cfg, solve_cache=SolveCache())
    args = place(np.zeros(GLMIX_D_FIX, np.float32), np.zeros((GLMIX_E, GLMIX_D_RE), np.float32), fe, block, Xr,
                 users)
    outs = step(*args)
    torch.cuda.synchronize()
    return dict(mesh=str(mesh.device), placed=[str(args[0].device), str(args[2].label.device),
                                               str(args[3][0].features.device)],
                outs=[str(t.device) for t in outs])
