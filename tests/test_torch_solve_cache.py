"""The port's solve cache (photon_tpu_torch/algorithm/solve_cache.py) on the
CPU, on the fixtures of the reference's tests/test_solve_cache.py: one build
per key across CD passes, one per exact block shape, bucketed against exact
parity, warm starts copied and never aliased, the LRU bound and its
environment variable, ``expect_cached`` and the active-set passes; the
cache's counters held against the reference's on the same runs; the host
reads of a solve; and margin L-BFGS and batched Newton through both caches
in float64 (jax's scoped x64) at rtol 1e-5 with equal iteration counts and
reasons. On the CPU an entry is the solver's state machine run eagerly, with
the read pattern of the captured graphs.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.algorithm.random_effect import RandomEffectCoordinate as JCoord
from photon_tpu.algorithm.solve_cache import SolveCache as JSolveCache
from photon_tpu.data import random_effect as jre
from photon_tpu.data.batch import LabeledBatch as JBatch
from photon_tpu.data.game_data import GameBatch as JGameBatch
from photon_tpu.ops.losses import LogisticLoss as JLogistic
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.optim.factory import OptimizerSpec as JSpec
from photon_tpu.types import OptimizerType as JOptimizerType
from photon_tpu.types import TaskType as JTaskType

from photon_tpu_torch.algorithm import solve_cache as sc
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate, _solve_block
from photon_tpu_torch.algorithm.solve_cache import SolveCache
from photon_tpu_torch.data import random_effect as tre
from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.ops.losses import LogisticLoss
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.common import HOST_READS, OptimizerConfig
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.types import OptimizerType, TaskType

E, D = 48, 5
RTOL64 = 1e-5


def _clustered_problem(dtype=np.float32):
    """The reference's fixture: three 12-entity blocks whose exact (E, n_max)
    differ, (12, 40), (12, 43), (12, 46), but whose bucketed shapes coincide
    at (12, 48); the last 12 entities carry no data."""
    rng = np.random.default_rng(11)
    counts = np.concatenate([np.repeat([37, 40], 6), np.repeat([43, 46], 12), np.zeros(12, int)])
    eids = np.repeat(np.arange(E, dtype=np.int32), counts)
    n = eids.size
    X = rng.normal(size=(n, D)).astype(dtype)
    X[:, 0] = 1.0
    y = (rng.uniform(size=n) < 0.5).astype(dtype)
    return eids, X, y, np.ones(n, dtype)


def _config(pkg, bucketed, n_buckets):
    return pkg.RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=n_buckets,
                                      shape_bucketing=bucketed, subspace_projection=False)


def _datasets(eids, X, y, w, bucketed=True, n_buckets=4):
    ds = tre.build_random_effect_dataset(eids, X, y, w, E, _config(tre, bucketed, n_buckets), device="cpu")
    with jax.enable_x64(X.dtype == np.float64):
        jds = jre.build_random_effect_dataset(eids, X, y, w, E, _config(jre, bucketed, n_buckets))
    return ds, jds


def _batches(eids, X, y, w):
    n = y.shape[0]
    tb = GameBatch(label=torch.from_numpy(y), offset=torch.zeros(n, dtype=torch.from_numpy(y).dtype),
                   weight=torch.from_numpy(w), features={"re": torch.from_numpy(X)},
                   entity_ids={"userId": torch.from_numpy(eids)})
    with jax.enable_x64(X.dtype == np.float64):
        jb = JGameBatch(label=jnp.asarray(y), offset=jnp.zeros(n, jnp.asarray(y).dtype), weight=jnp.asarray(w),
                        features={"re": jnp.asarray(X)}, entity_ids={"userId": jnp.asarray(eids)})
    return tb, jb


SPEC = dict(max_iter=25, tol=1e-9)


def _coordinates(ds, jds, cache, jcache, **kw):
    coord = RandomEffectCoordinate(
        "per_user", ds, TaskType.LOGISTIC_REGRESSION,
        GLMObjective(loss=LogisticLoss, l2_weight=0.5, intercept_index=0),
        OptimizerSpec(OptimizerType.NEWTON, **SPEC), solve_cache=cache, **kw)
    with jax.enable_x64(ds.blocks[0].features.dtype == torch.float64):
        jcoord = JCoord("per_user", jds, JTaskType.LOGISTIC_REGRESSION,
                        JObjective(loss=JLogistic, l2_weight=0.5, intercept_index=0),
                        JSpec(optimizer=JOptimizerType.NEWTON, **SPEC), solve_cache=jcache, **kw)
    return coord, jcoord


def _train_both(coord, jcoord, tb, jb, passes, x64=False):
    """``passes`` CD passes of one coordinate in both packages; the port's
    and the reference's last models."""
    model = jmodel = None
    for it in range(passes):
        coord.begin_cd_pass(it)
        model, _ = coord.train(tb, None, model)
        with jax.enable_x64(x64):
            jcoord.begin_cd_pass(it)
            jmodel, _ = jcoord.train(jb, None, jmodel)
    return model, jmodel


def _counters(stats):
    return (stats.calls, stats.traces, stats.hits, [tuple(k) for k in stats.trace_keys])


@pytest.mark.parametrize("bucketed", [True, False], ids=["bucketed", "exact_shapes"])
def test_one_build_per_key_across_passes_matches_reference(bucketed):
    """Bucketed: three same-shape blocks over three CD passes build one entry
    and every other dispatch is a hit (the reference's :96). Exact shapes:
    one entry per distinct block shape (:122). The port's calls, builds,
    hits and trace keys equal the reference's traces on the same run."""
    eids, X, y, w = _clustered_problem()
    ds, jds = _datasets(eids, X, y, w, bucketed=bucketed)
    shapes = {tuple(b.features.shape) for b in ds.blocks}
    cache, jcache = SolveCache(), JSolveCache(donate=True)
    coord, jcoord = _coordinates(ds, jds, cache, jcache)
    passes = 3 if bucketed else 2
    _train_both(coord, jcoord, *_batches(eids, X, y, w), passes)
    if bucketed:
        assert len(ds.blocks) >= 3 and len(shapes) == 1
    assert cache.stats.calls == passes * len(ds.blocks)
    assert cache.stats.traces == len(shapes) == cache.num_entries
    assert cache.stats.hits == cache.stats.calls - len(shapes)
    assert _counters(cache.stats) == _counters(jcache.stats)


def test_bucketed_vs_exact_parity_f64_and_reference():
    """Bucketed solves match exact-shape solves at rtol 1e-6 in float64 (the
    reference's :138), and each matches the reference's at rtol 1e-5."""
    eids, X, y, w = _clustered_problem(np.float64)
    tb, jb = _batches(eids, X, y, w)
    models = {}
    for bucketed in (True, False):
        ds, jds = _datasets(eids, X, y, w, bucketed=bucketed)
        coord, jcoord = _coordinates(ds, jds, SolveCache(), JSolveCache(donate=True))
        model, jmodel = _train_both(coord, jcoord, tb, jb, 2, x64=True)
        models[bucketed] = model.coefficients.numpy()[:E, :D]
        np.testing.assert_allclose(models[bucketed], np.asarray(jmodel.coefficients)[:E, :D], rtol=RTOL64,
                                   atol=1e-10)
    np.testing.assert_allclose(models[True], models[False], rtol=1e-6, atol=1e-12)


def _block_setup(n_buckets=2):
    eids, X, y, w = _clustered_problem()
    ds, _ = _datasets(eids, X, y, w, bucketed=True, n_buckets=n_buckets)
    block = ds.blocks[0]
    spec = OptimizerSpec(OptimizerType.NEWTON, **SPEC)
    cfg = dataclasses.replace(spec.config(), track_history=False)
    offs = block.gather_offsets(torch.zeros(y.shape[0]))
    return block, spec, cfg, offs


def test_warm_start_is_copied_never_aliased():
    """The reference donates the warm start (:161); the port copies it into
    the entry's own buffer. The caller's w0 is untouched and unaliased, the
    result matches the eager solve, and a later dispatch through the same
    entry does not disturb the first result (outputs are cloned)."""
    block, spec, cfg, offs = _block_setup()
    obj = GLMObjective(loss=LogisticLoss, l2_weight=0.5, intercept_index=0)
    solve = SolveCache().block_solver(obj, spec, cfg, has_mask=False)
    w0 = torch.zeros((block.num_entities, block.dim))
    w_cached, _it, _rs, _ps = solve(block, offs, w0)
    assert torch.equal(w0, torch.zeros_like(w0)) and w0.data_ptr() != w_cached.data_ptr()
    w_eager, *_ = _solve_block(block, offs, torch.zeros_like(w0), obj, spec, cfg)
    np.testing.assert_allclose(w_cached.numpy(), w_eager.numpy(), rtol=1e-5, atol=1e-6)
    before = w_cached.clone()
    solve(block, offs, torch.ones_like(w0))
    assert torch.equal(before, w_cached)


def test_warm_start_model_survives_training_end_to_end():
    """Training again from a warm-start model leaves that model's
    coefficients as they were (the reference's :199)."""
    eids, X, y, w = _clustered_problem()
    ds, jds = _datasets(eids, X, y, w)
    coord, _ = _coordinates(ds, jds, SolveCache(), JSolveCache())
    tb, _ = _batches(eids, X, y, w)
    m1, _ = coord.train(tb)
    keep = m1.coefficients.clone()
    coord.train(tb, None, m1)
    assert torch.equal(keep, m1.coefficients)


def test_lru_eviction_bounded_cache():
    """A λ sweep (one entry per l2 weight) under max_entries=2 (the
    reference's :311): the cap holds, evictions count, the live entries hit,
    a handle whose entry was evicted keeps working without a rebuild, and a
    new handle for the evicted λ rebuilds. Every λ runs the one program
    built for the sweep (λ is its input)."""
    block, spec, cfg, offs = _block_setup()
    w0 = lambda: torch.zeros((block.num_entities, block.dim))  # noqa: E731
    cache = SolveCache(max_entries=2)
    lams = [0.1, 0.5, 1.0, 2.0]
    solvers, results = {}, {}
    for lam in lams:
        obj = GLMObjective(loss=LogisticLoss, l2_weight=lam, intercept_index=0)
        solvers[lam] = cache.block_solver(obj, spec, cfg, has_mask=False)
        results[lam] = solvers[lam](block, offs, w0())[0]
        assert cache.num_entries <= 2
    assert (cache.stats.traces, cache.stats.evictions) == (len(lams), len(lams) - 2)
    hits0 = cache.stats.hits
    for lam in lams[-2:]:
        np.testing.assert_allclose(solvers[lam](block, offs, w0())[0].numpy(), results[lam].numpy(), rtol=1e-5)
    assert cache.stats.hits == hits0 + 2 and cache.stats.traces == len(lams)
    np.testing.assert_allclose(solvers[lams[0]](block, offs, w0())[0].numpy(), results[lams[0]].numpy(),
                               rtol=1e-5)
    assert cache.stats.traces == len(lams)
    fresh = cache.block_solver(GLMObjective(loss=LogisticLoss, l2_weight=lams[0], intercept_index=0), spec, cfg,
                               has_mask=False)
    np.testing.assert_allclose(fresh(block, offs, w0())[0].numpy(), results[lams[0]].numpy(), rtol=1e-5)
    assert cache.stats.traces == len(lams) + 1 and cache.num_entries <= 2
    assert cache.stats.captures == 1


def test_max_entries_env_and_validation(monkeypatch):
    monkeypatch.setenv(sc.MAX_ENTRIES_ENV, "3")
    assert SolveCache().max_entries == 3
    monkeypatch.delenv(sc.MAX_ENTRIES_ENV)
    assert SolveCache().max_entries is None
    with pytest.raises(ValueError):
        SolveCache(max_entries=0)
    assert sc.MAX_ENTRIES_ENV != "PHOTON_TPU_SOLVE_CACHE_MAX_ENTRIES"  # the port's own copy


def test_expect_cached_raises_on_a_new_key_and_marks_count_builds():
    block, spec, cfg, offs = _block_setup()
    cache = SolveCache()
    solve = cache.block_solver(GLMObjective(loss=LogisticLoss, l2_weight=0.5), spec, cfg, has_mask=False)
    mark = cache.trace_mark()
    with pytest.raises(AssertionError, match="expected a cache hit"):
        with cache.expect_cached("first dispatch"):
            solve(block, offs, torch.zeros((block.num_entities, block.dim)))
    assert cache.traces_since(mark) == 1
    with cache.expect_cached("second dispatch"):
        solve(block, offs, torch.zeros((block.num_entities, block.dim)))
    assert cache.traces_since(mark) == 1
    cache.reset_stats()
    assert (cache.stats.traces, cache.stats.calls, cache.num_entries) == (0, 0, 1)
    cache.clear()
    assert cache.num_entries == 0


def _cold_cohort_problem(seed=7):
    """Entities whose id is not a multiple of 3 have all-zero features: their
    solve is exactly 0 every pass and they retire at the first gated pass,
    so the gated passes repack the live rows onto the full pass's sizes."""
    rng = np.random.default_rng(seed)
    n_ent = 96
    counts = rng.integers(37, 47, size=n_ent)
    eids = np.repeat(np.arange(n_ent, dtype=np.int32), counts)
    X = rng.normal(size=(eids.size, 6))
    X[eids % 3 != 0] = 0.0
    y = (rng.uniform(size=eids.size) < 0.5).astype(np.float64)
    return eids, X, y, np.ones(eids.size), n_ent


def test_active_set_passes_capture_nothing_new_and_match_reference():
    """Gated passes (repacked onto the first pass's block sizes, inside
    ``expect_cached``) build no entry, skip the retired entities, and give
    the reference's coefficients and counters."""
    eids, X, y, w, n_ent = _cold_cohort_problem()
    cfg = dict(re_type="userId", feature_shard="re", n_buckets=4)
    ds = tre.build_random_effect_dataset(eids, X, y, w, n_ent, tre.RandomEffectDataConfig(**cfg), device="cpu")
    with jax.enable_x64(True):
        jds = jre.build_random_effect_dataset(eids, X, y, w, n_ent, jre.RandomEffectDataConfig(**cfg))
    cache, jcache = SolveCache(), JSolveCache(donate=False)
    obj = dict(loss=LogisticLoss, l2_weight=0.5)
    coord = RandomEffectCoordinate("per_user", ds, TaskType.LOGISTIC_REGRESSION, GLMObjective(**obj),
                                   OptimizerSpec(OptimizerType.NEWTON, **SPEC), active_set=True,
                                   solve_cache=cache)
    with jax.enable_x64(True):
        jcoord = JCoord("per_user", jds, JTaskType.LOGISTIC_REGRESSION, JObjective(loss=JLogistic, l2_weight=0.5),
                        JSpec(optimizer=JOptimizerType.NEWTON, **SPEC), solve_cache=jcache, active_set=True)
    n = y.shape[0]
    tb = GameBatch(torch.from_numpy(y), torch.zeros(n, dtype=torch.float64), torch.from_numpy(w),
                   {"re": torch.from_numpy(X)}, {"userId": torch.from_numpy(eids)})
    with jax.enable_x64(True):
        jb = JGameBatch(jnp.asarray(y), jnp.zeros(n), jnp.asarray(w), {"re": jnp.asarray(X)},
                        {"userId": jnp.asarray(eids)})
    model = jmodel = None
    for it in range(3):
        coord.begin_cd_pass(it)
        mark = cache.trace_mark()
        model, _ = coord.train(tb, None, model)
        with jax.enable_x64(True):
            jcoord.begin_cd_pass(it)
            jmodel, _ = jcoord.train(jb, None, jmodel)
        if it > 0:
            assert cache.traces_since(mark) == 0
            assert coord.last_active_set_stats["entities_skipped"] > 0
        np.testing.assert_allclose(model.coefficients.numpy(), np.asarray(jmodel.coefficients), rtol=RTOL64,
                                   atol=1e-8)
    assert _counters(cache.stats) == _counters(jcache.stats)


def _planted_glm(n=4000, d=12, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[:, 0] = 1.0
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(X @ rng.normal(size=d) * 0.7)))).astype(np.float64)
    return X, y


@pytest.mark.parametrize("max_iter", [5, 40])
def test_fixed_effect_solve_matches_reference_f64_and_reads_per_chunk(max_iter):
    """Margin L-BFGS through both caches' fe_solver in float64: coefficients
    at rtol 1e-5, equal iterations and reason, and the solve makes at most
    ceil(iterations / K) + 2 host reads."""
    X, y = _planted_glm()
    spec = OptimizerSpec(max_iter=max_iter)
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    cache = SolveCache()
    reads0 = HOST_READS.count
    got = cache.fe_solver(obj, spec)(torch.zeros(X.shape[1], dtype=torch.float64),
                                     LabeledBatch(torch.from_numpy(y), torch.from_numpy(X)))
    reads = HOST_READS.count - reads0
    with jax.enable_x64(True):
        want = JSolveCache().fe_solver(JObjective(loss=JLogistic, l2_weight=1.0, intercept_index=0),
                                       JSpec(max_iter=max_iter))(jnp.zeros(X.shape[1]),
                                                                 JBatch(jnp.asarray(y), jnp.asarray(X)))
        want_w, want_it, want_reason = (np.asarray(x) for x in (want.w, want.iterations, want.reason_code))
    np.testing.assert_allclose(got.w.numpy(), want_w, rtol=RTOL64, atol=1e-10)
    assert (int(got.iterations), int(got.reason_code)) == (int(want_it), int(want_reason))
    assert reads <= math.ceil(int(got.iterations) / sc.FE_CHUNK) + 2
    assert cache.stats.traces == 1 and cache.stats.trace_keys == [("fe", X.shape[1])]


def test_block_newton_matches_reference_f64_and_reads_per_chunk():
    """Batched Newton through both caches' block_solver in float64:
    coefficients at rtol 1e-5, equal per-entity iterations and reasons, and
    the solve makes at most ceil(max iterations / K) + 2 host reads."""
    eids, X, y, w = _clustered_problem(np.float64)
    ds, jds = _datasets(eids, X, y, w)
    spec, cfg = OptimizerSpec(OptimizerType.NEWTON, **SPEC), OptimizerConfig(max_iter=25, tol=1e-9,
                                                                               track_history=False)
    block, jblock = ds.blocks[0], jds.blocks[0]
    offs = block.gather_offsets(torch.zeros(y.shape[0], dtype=torch.float64))
    cache = SolveCache()
    reads0 = HOST_READS.count
    got = cache.block_solver(GLMObjective(loss=LogisticLoss, l2_weight=0.5, intercept_index=0), spec, cfg,
                             has_mask=False)(block, offs, torch.zeros((block.num_entities, block.dim),
                                                                      dtype=torch.float64))
    reads = HOST_READS.count - reads0
    from photon_tpu.optim.common import OptimizerConfig as JConfig

    with jax.enable_x64(True):
        want = JSolveCache(donate=False).block_solver(
            JObjective(loss=JLogistic, l2_weight=0.5, intercept_index=0), JSpec(optimizer=JOptimizerType.NEWTON,
                                                                               **SPEC),
            JConfig(max_iter=25, tol=1e-9, track_history=False), has_mask=False)(
            jblock, jblock.gather_offsets(jnp.zeros(y.shape[0])), jnp.zeros((jblock.num_entities, jblock.dim)))
        want = [np.asarray(x) for x in want]
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL64, atol=1e-10)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert reads <= math.ceil(int(got[1].max()) / sc.BLOCK_CHUNK) + 2


def test_glmix_step_and_lambda_sweep_dispatch_through_the_cache():
    """The GLMix step builds one fixed-effect and one block entry and hits
    them on the next pass; the train_glm λ sweep builds one entry per λ in
    the shared cache, all on one program, and releases them."""
    from photon_tpu_torch.cli.train_glm import train_lambda_sweep
    from photon_tpu_torch.parallel.train_step import glmix_train_step

    eids, X, y, w = _clustered_problem()
    ds, _ = _datasets(eids, X, y, w, bucketed=False, n_buckets=1)
    (block,) = ds.blocks
    cache = SolveCache()
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0)
    step = glmix_train_step(obj, obj, OptimizerConfig(max_iter=10, track_history=False),
                            OptimizerConfig(max_iter=5, tol=1e-6, track_history=False), solve_cache=cache)
    fe = LabeledBatch(torch.from_numpy(y), torch.from_numpy(X))
    wf, coefs = torch.zeros(D), torch.zeros(E, D)
    for _ in range(2):
        wf, coefs, *_ = step(wf, coefs, fe, block, torch.from_numpy(X), torch.from_numpy(eids))
    assert (cache.stats.traces, cache.stats.calls, cache.stats.hits) == (2, 4, 2)
    assert sorted(k[0] for k in cache.stats.trace_keys) == ["block", "fe"]

    shared = sc.reset_default_cache()
    try:
        sweep = train_lambda_sweep(fe, [10.0, 1.0, 0.1], TaskType.LOGISTIC_REGRESSION, OptimizerSpec(),
                                   intercept_index=0)
        assert (shared.stats.traces, shared.stats.captures, shared.stats.calls) == (3, 1, 3)
        assert [r.cache["captures"] for r in sweep] == [1, 0, 0]
        assert shared.num_entries == 0  # released when the sweep returns
    finally:
        sc.reset_default_cache()


def test_fixed_effect_zero_model_is_on_the_batch_device():
    """The fixed-effect coordinate's zero model lives on the batch's device
    (as the random effect's does), here the meta device."""
    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.estimators.game_estimator import GameEstimator

    meta = torch.device("meta")
    n, d = 16, 3
    batch = GameBatch(torch.empty(n, device=meta), torch.empty(n, device=meta), torch.empty(n, device=meta),
                      {"global": torch.empty(n, d, device=meta)}, {})
    cfg = config.FixedEffectCoordinateConfig("global", "global")
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, [cfg])
    reg = config.GameOptimizationConfig({"global": config.RegularizationConfig(1.0)})
    coord = est._build_coordinates(batch, reg)["global"]
    means = coord.zero_model().model.coefficients.means
    assert means.device == meta and tuple(means.shape) == (d,)


def test_lambda_is_an_input_of_the_program():
    """Keys that differ only in the L2 weight share one program, which reads
    the weight per solve: each λ's result equals that of a cache built for
    that λ alone, bit for bit, for margin L-BFGS and batched Newton. A zero
    weight (no L2 term) is a program of its own."""
    block, spec, cfg, offs = _block_setup()
    X, y = _planted_glm(n=800, d=6)
    lb = LabeledBatch(torch.from_numpy(y), torch.from_numpy(X))
    shared = SolveCache()
    for lam in (2.0, 0.25, 0.0, 1.0):
        obj = GLMObjective(loss=LogisticLoss, l2_weight=lam, intercept_index=0)
        w0 = torch.zeros((block.num_entities, block.dim))
        for cache in (shared, SolveCache()):
            got = cache.block_solver(obj, spec, cfg, has_mask=False)(block, offs, w0)
            fe = cache.fe_solver(obj, OptimizerSpec(max_iter=30))(torch.zeros(X.shape[1], dtype=torch.float64), lb)
            if cache is shared:
                want, want_fe = got, fe
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(fe.w, want_fe.w) and int(fe.iterations) == int(want_fe.iterations)
    assert (shared.stats.traces, shared.stats.captures) == (8, 4)


def test_static_buffers_are_shared_by_signature():
    """Programs whose inputs have one name and signature load them into one
    buffer: two gates (tol None and 1e-4) over one block shape build two
    programs on one set of buffers, and a reload of the same unchanged
    tensor copies nothing."""
    block, spec, cfg, offs = _block_setup()
    obj = GLMObjective(loss=LogisticLoss, l2_weight=0.5, intercept_index=0)
    cache = SolveCache()
    w0 = torch.zeros((block.num_entities, block.dim))
    plain = cache.block_solver(obj, spec, cfg, has_mask=False)(block, offs, w0)
    gated = cache.block_solver(obj, spec, cfg, has_mask=False, convergence_tol=1e-4)(block, offs, w0)
    assert cache.stats.captures == 2 and len(cache._slots) == 7
    assert torch.equal(plain[0], gated[0])
    copied = cache.stats.copied_bytes
    cache.block_solver(obj, spec, cfg, has_mask=False, convergence_tol=1e-4)(block, offs, w0)
    assert cache.stats.copied_bytes == copied


def test_fit_releases_the_shared_cache():
    """A GameEstimator fit through the shared cache leaves no entry, program
    or buffer behind, keeps the counters, and a fit given its own cache
    keeps that cache's entries."""
    import gc

    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.estimators.game_estimator import GameEstimator

    eids, X, y, w = _clustered_problem()
    tb, _ = _batches(eids, X, y, w)
    tb = dataclasses.replace(tb, features={"re": tb.features["re"], "global": tb.features["re"]})
    cfgs = [config.FixedEffectCoordinateConfig("global", "global"),
            config.RandomEffectCoordinateConfig("per_user", "userId", "re")]
    reg = config.GameOptimizationConfig({"global": config.RegularizationConfig(1.0),
                                         "per_user": config.RegularizationConfig(1.0)})
    shared = sc.reset_default_cache()
    try:
        GameEstimator(TaskType.LOGISTIC_REGRESSION, cfgs, num_iterations=2).fit(tb, optimization_configs=[reg])
        gc.collect()
        assert shared.stats.traces >= 2 and shared.stats.hits >= 2
        assert (shared.num_entries, len(shared._programs), len(shared._slots)) == (0, 0, 0)
        own = SolveCache()
        GameEstimator(TaskType.LOGISTIC_REGRESSION, cfgs, num_iterations=2, solve_cache=own).fit(
            tb, optimization_configs=[reg])
        assert own.num_entries == own.stats.traces >= 2 and shared.stats.calls == shared.stats.traces + \
            shared.stats.hits
    finally:
        sc.reset_default_cache()


def test_x_passes_run_counts_masked_steps():
    """``x_passes_run`` counts the X passes the program ran: init's and two
    a step, masked steps included, so at least the result's logical count
    (two an iteration and init's)."""
    X, y = _planted_glm()
    cache = SolveCache()
    reads0 = HOST_READS.count
    got = cache.fe_solver(GLMObjective(loss=LogisticLoss, l2_weight=1.0, intercept_index=0),
                          OptimizerSpec(max_iter=40))(torch.zeros(X.shape[1], dtype=torch.float64),
                                                      LabeledBatch(torch.from_numpy(y), torch.from_numpy(X)))
    chunks = HOST_READS.count - reads0
    # unfused on the CPU: init is two passes (margins, gradient)
    assert cache.stats.x_passes_run == 2 + 2 * sc.FE_CHUNK * chunks >= int(got.evals)


def test_a_dropped_cache_frees_its_programs_at_once():
    """An entry refers to its cache weakly, so a cache that goes out of use
    frees its programs and buffers by reference counting, without waiting
    for the cycle collector."""
    import gc
    import weakref

    block, spec, cfg, offs = _block_setup()
    cache = SolveCache()
    cache.block_solver(GLMObjective(loss=LogisticLoss, l2_weight=0.5), spec, cfg, has_mask=False)(
        block, offs, torch.zeros((block.num_entities, block.dim)))
    program, slot = (weakref.ref(next(iter(d.values()))) for d in (cache._programs, cache._slots))
    gc.disable()
    try:
        del cache
        assert program() is None and slot() is None
    finally:
        gc.enable()
