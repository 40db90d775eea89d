"""The entity-sharded random effects of the port on gloo ranks against the
reference on its 8 virtual devices (tests/test_entity_sharded.py's cases
but the serving ones).

The port runs SPMD: ``run_ranks`` spawns 1, 2, 4 and 8 CPU ranks joined by
a gloo group (a ``file://`` rendezvous), each running
tests/torch_ranks.py::entity_sharded_program once for every case of this
module. The shard layout is FIXED at S = 8 whatever the world size, so the
coefficients must be bit-identical across world sizes (``np.array_equal``),
with no new solve-cache entry after the first pass. The reference's
sharded coordinate runs here on 8 virtual devices, in float64 under the
scoped x64 context, and the port must match it at rtol 1e-5 with equal
iteration counts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_ranks
from torch_ranks import D_RE, E, make_workload

from photon_tpu_torch.utils.virtual_devices import run_ranks

WORLDS = (1, 2, 4, 8)
CASES = ("plain", "plain_f32", "gated", "ooc", "spill")


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every world size's results, per rank (one spawn a world size)."""
    spill = str(tmp_path_factory.mktemp("spill"))
    return {n: run_ranks(torch_ranks.entity_sharded_program, n, backend="gloo", device="cpu", args=(spill,),
                         threads=1, timeout_s=60.0)
            for n in WORLDS}


def _reference_sharded(dtype, **kw):
    """The reference's sharded coordinate on the 8 virtual devices, 3 passes."""
    from photon_tpu.algorithm.sharded_random_effect import ShardedRandomEffectCoordinate
    from photon_tpu.algorithm.solve_cache import SolveCache
    from photon_tpu.data.game_data import GameBatch
    from photon_tpu.data.random_effect import RandomEffectDataConfig
    from photon_tpu.ops.losses import LogisticLoss
    from photon_tpu.ops.objective import GLMObjective
    from photon_tpu.optim.factory import OptimizerSpec
    from photon_tpu.types import OptimizerType, TaskType

    eids, Xr, y, w, offsets = make_workload()
    Xr, y, w, offsets = (a.astype(dtype) for a in (Xr, y, w, offsets))
    n = eids.size
    batch = GameBatch(label=jnp.asarray(y), offset=jnp.zeros(n, dtype), weight=jnp.asarray(w),
                      features={"re": jnp.asarray(Xr)}, entity_ids={"userId": jnp.asarray(eids)})
    cache = SolveCache(donate=True)
    coord = ShardedRandomEffectCoordinate.build(
        coordinate_id="per_user", entity_ids=eids, features=Xr, label=y, weight=w, num_entities=E,
        config=RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=3, shape_bucketing=True,
                                      subspace_projection=False),
        task=TaskType.LOGISTIC_REGRESSION, objective=GLMObjective(loss=LogisticLoss, l2_weight=0.5),
        optimizer_spec=OptimizerSpec(optimizer=OptimizerType.NEWTON, max_iter=3, tol=1e-9),
        devices=jax.devices()[:8], solve_cache=cache, **kw)
    # No warm start: the reference casts a foreign one to float32 (its
    # ``_shard_initials``), and its merged table is float32 too (ROADMAP
    # queue 3); from pass 1 its shards warm-start from their own models.
    model, iters = None, []
    for it in range(3):
        coord.begin_cd_pass(it)
        model, stats = coord.train(batch, jnp.asarray(offsets), model)
        iters.append(np.asarray(stats.iterations)[np.asarray(stats.valid)])
    return np.asarray(model.coefficients), iters


@pytest.fixture(scope="module")
def reference_runs():
    with jax.enable_x64(True):
        out = {name: _reference_sharded(np.float64, **kw)
               for name, kw in (("plain", {}), ("gated", dict(active_set=True, convergence_tol=1e-7)))}
    # The reference's budgeted run refuses float64 data (ROADMAP queue 3:
    # its host master is float32), so its budget runs in float32.
    out["ooc_f32"] = _reference_sharded(np.float32, device_budget_bytes=1)
    return out


@pytest.mark.parametrize("case", CASES)
def test_bit_parity_across_world_sizes(port_runs, case):
    base = port_runs[1][0][case]
    assert base["marks"][0] > 0 and base["marks"][1:] == [0, 0], base["marks"]
    for n in WORLDS[1:]:
        for rank, res in enumerate(port_runs[n]):
            got = res[case]
            np.testing.assert_array_equal(got["coefs"], base["coefs"], err_msg=f"{case} world {n} rank {rank}")
            for a, b in zip(got["iters"], base["iters"]):
                np.testing.assert_array_equal(a, b)
            # No capture after pass 0 at any world size.
            assert got["marks"][1:] == [0, 0], (n, rank, got["marks"])


@pytest.mark.parametrize("case", ["plain", "gated", "ooc"])
def test_matches_reference_sharded_coordinate_f64(port_runs, reference_runs, case):
    """float64, rtol 1e-5, equal iteration counts; the port's budgeted run
    against the reference's resident one (a budget changes no value)."""
    ref_coefs, ref_iters = reference_runs["plain" if case == "ooc" else case]
    got = port_runs[1][0][case]
    np.testing.assert_allclose(got["coefs"], ref_coefs, rtol=1e-5, atol=1e-10)
    for a, b in zip(got["iters"], ref_iters):
        np.testing.assert_array_equal(a, b)


def test_budgeted_f32_matches_reference_budgeted(port_runs, reference_runs):
    """float32, budget 1 B (every pass churns each shard's store), the port's
    with a memory-mapped spill, against the reference's: within the
    reference's own float32 bar for solves summed in another order, 1e-3
    (three Newton steps from zero leave the solves short of convergence,
    where float32 order differences show at ~4e-4)."""
    ref_coefs, _ref_iters = reference_runs["ooc_f32"]
    got = port_runs[1][0]["spill"]
    np.testing.assert_allclose(got["coefs"], ref_coefs, rtol=1e-3, atol=1e-3)


def test_sharded_matches_unsharded_coordinate(port_runs):
    """The sharded coordinate solves the same per-entity problems as the
    plain coordinate; per-shard bucketing pads to other n_max, so within
    the reference's own 1e-3."""
    from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
    from photon_tpu_torch.algorithm.solve_cache import SolveCache
    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.optim.factory import OptimizerSpec
    from photon_tpu_torch.types import OptimizerType, TaskType

    eids, Xr, y, w, offsets = make_workload()
    cfg = RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=3, shape_bucketing=True,
                                 subspace_projection=False)
    plain = RandomEffectCoordinate(
        coordinate_id="per_user", dataset=build_random_effect_dataset(eids, Xr, y, w, E, cfg, device="cpu"),
        task=TaskType.LOGISTIC_REGRESSION, objective=GLMObjective(loss=LogisticLoss, l2_weight=0.5),
        optimizer_spec=OptimizerSpec(optimizer=OptimizerType.NEWTON, max_iter=3, tol=1e-9),
        solve_cache=SolveCache())
    batch = GameBatch(label=torch.from_numpy(y), offset=torch.zeros(eids.size), weight=torch.from_numpy(w),
                      features={"re": torch.from_numpy(Xr)}, entity_ids={"userId": torch.from_numpy(eids)})
    model = None
    for it in range(3):
        plain.begin_cd_pass(it)
        model, _ = plain.train(batch, torch.from_numpy(offsets), model)
    np.testing.assert_allclose(model.coefficients.numpy(), port_runs[8][0]["plain_f32"]["coefs"], atol=1e-3,
                               rtol=1e-3)


def test_shards_trained_on_their_ranks(port_runs):
    eids = make_workload()[0]
    for n in WORLDS:
        owned = [res["owned"] for res in port_runs[n]]
        assert sorted(s for o in owned for s in o) == list(range(8))
        assert all(o == [s for s in range(8) if (s * n) // 8 == r] for r, o in enumerate(owned))
        assert all(res["shard_devices"] == ["cpu"] for res in port_runs[n])
        # Busy seconds folded through the shard -> rank map, on every rank.
        busy = port_runs[n][0]["busy"]
        assert len(busy) == n and all(b > 0 for b in busy)
        assert all(res["busy"] == busy for res in port_runs[n])
        assert sum(res["samples"] for res in port_runs[n]) == eids.size


@pytest.mark.parametrize("case", ["ooc", "spill"])
def test_one_store_per_shard(port_runs, case):
    """Budgeted shards each run a store of their own (gathered from every
    rank); the budget floors at each shard's largest block, so every pass
    evicts, the same way at every world size."""
    base = port_runs[1][0][case]["residency"]
    assert len(base) == 8 and all(st is not None and st["evictions"] > 0 for st in base)
    for n in WORLDS[1:]:
        for res in port_runs[n]:
            assert res[case]["residency"] == base


def test_warm_cache_builds_nothing_new(port_runs):
    """A second coordinate over the same shard geometry, in the warm cache of
    the first, builds no entry: keys do not depend on the coordinate."""
    for n in WORLDS:
        for res in port_runs[n]:
            assert res["warm_marks"] == [0, 0, 0]


# ---------------------------------------------------------------------------
# Shard plan
# ---------------------------------------------------------------------------


def test_plan_matches_reference_and_explicit_ring():
    from photon_tpu.data.index_map import EntityIndex
    from photon_tpu.parallel.entity_shard import build_shard_plan as ref_plan

    from photon_tpu_torch.parallel.entity_shard import build_shard_plan, shard_members
    from photon_tpu_torch.serve.routing import HashRing

    class Names:
        def entity_id(self, i):
            return f"user{i}"

    eidx = EntityIndex()
    for e in range(E):
        eidx.intern(f"user{e}")
    ring = HashRing(shard_members(8), vnodes=64, seed=0)
    p_default = build_shard_plan(E, 8, entity_index=Names())
    assert p_default.snapshot() == build_shard_plan(E, 8, entity_index=Names(), ring=ring).snapshot()
    assert p_default.snapshot() == ref_plan(E, 8, entity_index=eidx).snapshot()
    assert build_shard_plan(E).snapshot() == ref_plan(E).snapshot()
    seen = set()
    for s in range(8):
        ents = p_default.entities_of(s)
        assert np.array_equal(p_default.local_of[ents], np.arange(ents.size))
        seen.update(ents.tolist())
    assert seen == set(range(E))


def test_merge_shard_coefficients_is_exact():
    from photon_tpu_torch.parallel.entity_shard import DEFAULT_N_SHARDS, build_shard_plan, merge_shard_coefficients

    plan = build_shard_plan(E, DEFAULT_N_SHARDS)
    table = np.random.default_rng(3).normal(size=(E, D_RE)).astype(np.float32)
    merged = merge_shard_coefficients(plan, [table[plan.entities_of(s)] for s in range(plan.n_shards)], D_RE)
    np.testing.assert_array_equal(merged, table)


def test_device_of_is_contiguous_and_total():
    from photon_tpu_torch.parallel.entity_shard import build_shard_plan

    plan = build_shard_plan(E, 8)
    for n_dev in WORLDS:
        devs = [plan.device_of(s, n_dev) for s in range(8)]
        assert devs == sorted(devs)
        assert set(devs) == set(range(n_dev))


# ---------------------------------------------------------------------------
# The entity-sharded GAME step
# ---------------------------------------------------------------------------


def _reference_fused(n_dev):
    """tests/test_entity_sharded.py::_fused_run in float64."""
    from photon_tpu.data.batch import LabeledBatch
    from photon_tpu.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
    from photon_tpu.ops.losses import LogisticLoss
    from photon_tpu.ops.objective import GLMObjective
    from photon_tpu.optim.common import OptimizerConfig
    from photon_tpu.parallel.entity_shard import build_shard_plan
    from photon_tpu.parallel.mesh import make_mesh
    from photon_tpu.parallel.train_step import game_entity_sharded_train_step, stack_shard_blocks

    S = 8
    E_f, eids, Xf, Xr, y, w = torch_ranks.fused_workload()
    Xf, Xr, y, w = (a.astype(np.float64) for a in (Xf, Xr, y, w))
    n = eids.size
    plan = build_shard_plan(E_f, n_shards=S, seed=0)
    cfg = RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=1, shape_bucketing=True,
                                 subspace_projection=False)
    blocks = [build_random_effect_dataset(se, Xr, y, w, int(plan.counts[s]), cfg).blocks[0]
              for s, se in enumerate(plan.shard_sample_entities(eids))]
    stacked = stack_shard_blocks(blocks)
    E_s = stacked.entity_idx.shape[1]
    obj = GLMObjective(loss=LogisticLoss, l2_weight=1.0)
    mesh = make_mesh(n_data=n_dev, devices=jax.devices()[:n_dev])
    step, place = game_entity_sharded_train_step(mesh, obj, obj, OptimizerConfig(max_iter=6, tol=1e-8),
                                                 OptimizerConfig(max_iter=3, tol=1e-9))
    fe = LabeledBatch(label=jnp.asarray(y), features=jnp.asarray(Xf), offset=jnp.zeros(n), weight=jnp.asarray(w))
    args = place(np.zeros(Xf.shape[1]), np.zeros((S, E_s, Xr.shape[1])), fe, stacked, Xr,
                 plan.shard_of[eids].astype(np.int32), plan.local_of[eids].astype(np.int32))
    wf, rc = args[0], args[1]
    for _ in range(2):
        wf, rc, scores, fe_evals, visits = step(wf, rc, *args[2:])
    return np.asarray(wf), np.asarray(rc), np.asarray(scores), int(np.asarray(visits)), int(np.asarray(fe_evals))


@pytest.mark.parametrize("n", WORLDS)
def test_entity_sharded_step_matches_reference(port_runs, n):
    """The whole-pass entity-sharded step on n ranks against the reference's
    on an n-device mesh, float64 rtol 1e-5; bitwise across world sizes (the
    rows-sharded fixed effect sums fixed row shards in a fixed order) and
    run to run."""
    with jax.enable_x64(True):
        w, rc, scores, visits, fe_evals = _reference_fused(n)
    for res in port_runs[n]:
        got = res["fused"]
        np.testing.assert_allclose(got["w"], w, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(got["rc"], rc, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(got["scores"], scores, rtol=1e-5, atol=1e-9)
        assert (got["visits"], got["fe_evals"]) == (visits, fe_evals)
        base = port_runs[1][0]["fused"]
        for k in ("w", "rc", "scores"):
            np.testing.assert_array_equal(got[k], base[k])
            np.testing.assert_array_equal(res["fused_again"][k], got[k])


def test_game_estimator_on_a_mesh(port_runs):
    """``GameEstimator(mesh=)``: the fixed effect on each rank's rows, the
    per-user effect entity-sharded; bitwise the same at every world size,
    and within the reference's 1e-3 bar of the unsharded fit (per-shard
    bucketing)."""
    plain = torch_ranks.estimator_fit(None, "cpu")
    base = port_runs[1][0]["estimator"]
    for k in ("fe", "re"):
        np.testing.assert_allclose(base[k], plain[k], rtol=1e-3, atol=1e-3)
    for n in WORLDS:
        for res in port_runs[n]:
            for k in ("fe", "re"):
                np.testing.assert_array_equal(res["estimator"][k], base[k])


def test_stack_shard_blocks_rejects_mismatched_geometry():
    from photon_tpu_torch.data.random_effect import RandomEffectDataConfig, build_random_effect_dataset
    from photon_tpu_torch.parallel.train_step import stack_shard_blocks

    rng = np.random.default_rng(1)
    cfg = RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=1, shape_bucketing=True,
                                 subspace_projection=False)
    a = build_random_effect_dataset(np.repeat(np.arange(8, dtype=np.int32), 4), rng.normal(size=(32, D_RE)),
                                    np.zeros(32), np.ones(32), 8, cfg, device="cpu").blocks[0]
    # 6 rows an entity: another n_max than a's 4.
    b = build_random_effect_dataset(np.repeat(np.arange(4, dtype=np.int32), 6), rng.normal(size=(24, D_RE)),
                                    np.zeros(24), np.ones(24), 4, cfg, device="cpu").blocks[0]
    with pytest.raises(ValueError):
        stack_shard_blocks([a, b])


# ---------------------------------------------------------------------------
# Sharded serving: the store's device_shards and the engine on them
# ---------------------------------------------------------------------------

S_FIX = 6


def _serving_model(seed=41):
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
    from photon_tpu_torch.models.glm import GeneralizedLinearModel
    from photon_tpu_torch.types import TaskType

    rng = np.random.default_rng(seed)
    w_fix = np.linspace(-1, 1, S_FIX).astype(np.float32)
    w_re = rng.normal(size=(E, D_RE)).astype(np.float32)
    return GameModel({
        "global": FixedEffectModel(GeneralizedLinearModel(Coefficients(torch.as_tensor(w_fix)),
                                                          TaskType.LOGISTIC_REGRESSION), "shardA"),
        "per_user": RandomEffectModel(torch.as_tensor(w_re), "userId", "shardB", TaskType.LOGISTIC_REGRESSION),
    }), w_re


def _serving_index():
    from photon_tpu_torch.data.index_map import EntityIndex

    eidx = EntityIndex()
    for e in range(E):
        eidx.intern(f"user{e}")
    return eidx


def _serving_inputs(seed=5, n=48):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, E, size=n), rng.normal(size=(n, S_FIX)).astype(np.float32),
            rng.normal(size=(n, D_RE)).astype(np.float32))


def _score_via(store, users, xa, xb):
    from photon_tpu_torch.data.game_data import GameBatch
    from photon_tpu_torch.estimators.game_transformer import GameTransformer

    n = len(users)
    slots = store.resolve("userId", [f"user{u}" for u in users])
    b = GameBatch(label=torch.zeros(n), offset=torch.zeros(n), weight=torch.ones(n),
                  features={"shardA": torch.as_tensor(xa), "shardB": torch.as_tensor(xb)},
                  entity_ids={"userId": torch.as_tensor(slots, dtype=torch.int32)})
    return GameTransformer(store.scoring_model()).transform(b).numpy()


def test_store_sharded_pinned_parity_and_layout():
    from photon_tpu_torch.serve import HotColdEntityStore

    model, _ = _serving_model()
    eidx = _serving_index()
    users, xa, xb = _serving_inputs()
    ref = HotColdEntityStore(model, {"userId": eidx}, hot_bytes=1 << 30, device="cpu")
    sh = HotColdEntityStore(model, {"userId": eidx}, hot_bytes=1 << 30, device_shards=8, device="cpu")
    assert ref.group("userId").pinned and sh.group("userId").pinned
    np.testing.assert_array_equal(_score_via(ref, users, xa, xb), _score_via(sh, users, xa, xb))
    # Eight equal entity segments of one table on the store's one device.
    tab = sh.group("userId").tables["per_user"]
    assert tab.device == torch.device("cpu") and tab.shape[0] % 8 == 0
    st = sh.stats()["userId"]
    assert st["device_shards"] == 8 and st["shard_rows"] * 8 == tab.shape[0]


def test_store_sharded_unpinned_parity_and_demotion():
    from photon_tpu_torch.serve import HotColdEntityStore

    model, w_re = _serving_model()
    eidx = _serving_index()
    users, xa, xb = _serving_inputs()
    ref = HotColdEntityStore(model, {"userId": eidx}, hot_bytes=1, min_hot_rows=64, device="cpu")
    sh = HotColdEntityStore(model, {"userId": eidx}, hot_bytes=1, min_hot_rows=64, device_shards=8, device="cpu")
    assert not sh.group("userId").pinned
    sh.warm_uploads(64)
    np.testing.assert_array_equal(_score_via(ref, users, xa, xb), _score_via(sh, users, xa, xb))
    users2 = np.random.default_rng(9).integers(0, E, size=48)
    slots = sh.resolve("userId", [f"user{u}" for u in users2])
    tab = sh.group("userId").tables["per_user"].numpy()
    for u, s in zip(users2, slots):
        np.testing.assert_array_equal(tab[s], w_re[u])


def test_store_shard_snapshot_matches_training_plan_and_reference():
    from photon_tpu.data.index_map import EntityIndex as JEntityIndex
    from photon_tpu.parallel.entity_shard import build_shard_plan as j_build_shard_plan

    from photon_tpu_torch.parallel.entity_shard import build_shard_plan
    from photon_tpu_torch.serve import HotColdEntityStore

    model, _ = _serving_model()
    eidx = _serving_index()
    sh = HotColdEntityStore(model, {"userId": eidx}, hot_bytes=1 << 30, device_shards=8, device="cpu")
    jidx = JEntityIndex()
    for e in range(E):
        jidx.intern(f"user{e}")
    snap = sh.shard_snapshot("userId")
    assert snap == build_shard_plan(E, 8, entity_index=eidx).snapshot()
    assert snap == j_build_shard_plan(E, 8, entity_index=jidx).snapshot()


def test_store_sharded_clone_with_delta():
    from photon_tpu_torch.serve import HotColdEntityStore

    model, _ = _serving_model()
    eidx = _serving_index()
    idx = np.array([3, 17], np.int64)
    rows = np.random.default_rng(13).normal(size=(2, D_RE)).astype(np.float32)
    sh = HotColdEntityStore(model, {"userId": eidx}, hot_bytes=1 << 30, device_shards=8, device="cpu")
    c1 = sh.clone_with_delta({"per_user": (idx, rows)})
    tab, perm = c1.group("userId").tables["per_user"].numpy(), c1.group("userId").perm
    np.testing.assert_array_equal(tab[perm[3]], rows[0])
    np.testing.assert_array_equal(tab[perm[17]], rows[1])
    # The base's table is not written.
    assert not np.array_equal(sh.group("userId").tables["per_user"].numpy()[perm[3]], rows[0])
    sh2 = HotColdEntityStore(model, {"userId": eidx}, hot_bytes=1, min_hot_rows=64, device_shards=8, device="cpu")
    c2 = sh2.clone_with_delta({"per_user": (idx, rows)})
    slots = c2.resolve("userId", ["user3", "user17"])
    tab2 = c2.group("userId").tables["per_user"].numpy()
    np.testing.assert_array_equal(tab2[slots[0]], rows[0])
    np.testing.assert_array_equal(tab2[slots[1]], rows[1])


@pytest.mark.parametrize("hot_bytes", [1 << 30, 1])
def test_engine_device_shards_end_to_end(hot_bytes):
    """The counterpart of the reference's test of the same name: the
    8-segment engine scores exactly as the plain engine, with no row bucket
    first scored after warm-up (the reference's sharded engine compiles once
    on live traffic there: ROADMAP queue 3)."""
    from photon_tpu_torch.serve import ScoreRequest, ServeConfig, ServingEngine

    model, _ = _serving_model()
    users, xa, xb = _serving_inputs(n=32)
    reqs = [ScoreRequest({"shardA": xa[i], "shardB": xb[i]}, {"userId": f"user{users[i]}"}) for i in range(len(users))]
    out = {}
    for shards in (8, None):
        eng = ServingEngine(model, entity_indexes={"userId": _serving_index()},
                            config=ServeConfig(max_batch_size=8, max_delay_ms=1.0, hot_bytes=hot_bytes,
                                               device_shards=shards, device="cpu"))
        try:
            out[shards] = np.asarray([np.float32(eng.submit(r).result(timeout=30)) for r in reqs], np.float32)
            assert eng.retraces_since_warmup == 0, eng.stats()
            assert eng._state.store.device_shards == shards
        finally:
            eng.close()
    np.testing.assert_array_equal(out[8], out[None])
