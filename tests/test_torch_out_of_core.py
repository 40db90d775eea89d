"""The port's out-of-core random effects (algorithm/re_store.py, the
residency core data/residency.py, ``_train_dense_ooc``) on the CPU, against
its own fully resident run and against the JAX reference.

The headline contract is bit parity: a budgeted run uploads blocks through
the staged pipeline, evicts under LRU pressure, and still gives the fully
resident run's coefficients bit for bit, in float32 and in float64. Against
the reference: its budgeted run in float32 within RTOL32/ATOL32 (the two
packages' Newton solves sum in different orders), and its fully resident run
in float64 at rtol 1e-5 with equal iterations and reasons (the reference's
budgeted run cannot take float64 data: its float32 host master meets the
float64 blocks in its Newton loop, ROADMAP queue 3). Then the operational
envelope: deterministic eviction logs, no capture after pass 0, the peak of
the admitted bytes under the effective budget, memory-mapped spill, ENOSPC
and OOM containment, checkpoint and resume, and the configurations the
store refuses.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.algorithm import re_store as jstore
from photon_tpu.algorithm.random_effect import RandomEffectCoordinate as JCoord
from photon_tpu.algorithm.solve_cache import SolveCache as JSolveCache
from photon_tpu.data import random_effect as jre
from photon_tpu.data import residency as jresidency
from photon_tpu.data.game_data import GameBatch as JGameBatch
from photon_tpu.ops.losses import LogisticLoss as JLogistic
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.optim.factory import OptimizerSpec as JSpec
from photon_tpu.serve.routing import HashRing
from photon_tpu.types import OptimizerType as JOptimizerType
from photon_tpu.types import TaskType as JTaskType

from photon_tpu_torch.algorithm import re_store
from photon_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_tpu_torch.algorithm.re_store import ReDeviceStore, block_device_cost, host_entity_block
from photon_tpu_torch.algorithm.solve_cache import SolveCache, block_input_bytes
from photon_tpu_torch.data import random_effect as tre
from photon_tpu_torch.data import residency
from photon_tpu_torch.data.game_data import GameBatch
from photon_tpu_torch.data.residency import ByteBudgetLru, SlotLru
from photon_tpu_torch.ops.losses import LogisticLoss
from photon_tpu_torch.ops.objective import GLMObjective
from photon_tpu_torch.optim.factory import OptimizerSpec
from photon_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType
from photon_tpu_torch.utils import faults, resources
from photon_tpu_torch.utils.faults import FaultPlan, FaultRule

E, D = 96, 6
PASSES = 4
# The port's budgeted float32 run against the reference's.
RTOL32, ATOL32 = 2e-4, 2e-5
RTOL64, ATOL64 = 1e-5, 1e-8

_rng = np.random.default_rng(7)
_counts = _rng.integers(37, 47, size=E)
EIDS = np.repeat(np.arange(E, dtype=np.int32), _counts)
N = EIDS.size
X64 = _rng.normal(size=(N, D))
# A cold cohort (two thirds of the entities see all-zero features) converges
# in one pass: the active-set variant then retires those blocks early.
X64[EIDS % 3 != 0] = 0.0
Y64 = (_rng.uniform(size=N) < 0.5).astype(np.float64)
W64 = np.ones(N)
SPEC = dict(optimizer="NEWTON", max_iter=25, tol=1e-9)


def _arrays(dtype):
    return X64.astype(dtype), Y64.astype(dtype), W64.astype(dtype)


def _cfg(pkg, **kw):
    return pkg.RandomEffectDataConfig(re_type="userId", feature_shard="re", n_buckets=4, shape_bucketing=True, **kw)


def _dataset(dtype=np.float32, **kw):
    X, Y, W = _arrays(dtype)
    return tre.build_random_effect_dataset(EIDS, X, Y, W, E, _cfg(tre, **kw), device="cpu")


def _batch(dtype=np.float32):
    X, Y, W = _arrays(dtype)
    return GameBatch(label=torch.from_numpy(Y), offset=torch.zeros(N, dtype=torch.from_numpy(Y).dtype),
                     weight=torch.from_numpy(W), features={"re": torch.from_numpy(X)},
                     entity_ids={"userId": torch.from_numpy(EIDS)})


def _footprint(dtype=np.float32):
    return sum(block_device_cost(b) for b in _dataset(dtype).blocks)


def _coordinate(budget, dtype=np.float32, active_set=False, spill_dir=None, **kw):
    return RandomEffectCoordinate(
        coordinate_id=kw.pop("coordinate_id", "per_user"), dataset=kw.pop("dataset", None) or _dataset(dtype),
        task=TaskType.LOGISTIC_REGRESSION, objective=GLMObjective(loss=LogisticLoss, l2_weight=0.5),
        optimizer_spec=OptimizerSpec(**dict(SPEC, optimizer=OptimizerType.NEWTON)),
        solve_cache=kw.pop("solve_cache", None) or SolveCache(), active_set=active_set, convergence_tol=1e-4,
        device_budget_bytes=budget, device_spill_dir=spill_dir, **kw)


def _run(budget, dtype=np.float32, active_set=False, spill_dir=None, passes=PASSES):
    """``passes`` CD passes of one coordinate; (model, coordinate, builds
    after pass 0, per-pass tracker stats)."""
    coord = _coordinate(budget, dtype, active_set, spill_dir)
    cache = coord.solve_cache
    batch = _batch(dtype)
    model, stats, warm = None, [], None
    for it in range(passes):
        coord.begin_cd_pass(it)
        model, s = coord.train(batch, None, model)
        stats.append(s)
        if it == 0:
            warm = cache.trace_mark()
    return model, coord, cache.traces_since(warm), stats


def _jrun(budget, dtype=np.float32, passes=PASSES):
    """The reference's run of the same coordinate (float64 under the scoped
    x64 context)."""
    X, Y, W = _arrays(dtype)
    with jax.enable_x64(dtype == np.float64):
        batch = JGameBatch(label=jnp.asarray(Y), offset=jnp.zeros(N, Y.dtype), weight=jnp.asarray(W),
                           features={"re": jnp.asarray(X)}, entity_ids={"userId": jnp.asarray(EIDS)})
        coord = JCoord(
            coordinate_id="per_user", dataset=jre.build_random_effect_dataset(EIDS, X, Y, W, E, _cfg(jre)),
            task=JTaskType.LOGISTIC_REGRESSION, objective=JObjective(loss=JLogistic, l2_weight=0.5),
            optimizer_spec=JSpec(**dict(SPEC, optimizer=JOptimizerType.NEWTON)),
            solve_cache=JSolveCache(donate=False), device_budget_bytes=budget)
        model, stats = None, []
        for it in range(passes):
            coord.begin_cd_pass(it)
            model, s = coord.train(batch, None, model)
            stats.append(s)
        return np.asarray(model.coefficients), stats, coord


@pytest.fixture(scope="module")
def ref_run():
    return _run(None)


@pytest.fixture(scope="module")
def ooc_run():
    return _run(_footprint() // 4)


# ---------------------------------------------------------------------------
# Residency core (a copy of the reference's)
# ---------------------------------------------------------------------------


def test_residency_module_is_the_reference_copy():
    """data/residency.py is the reference's module below its header."""
    ours = open(residency.__file__).read()
    theirs = open(jresidency.__file__).read()
    assert ours.startswith('"""Copy of photon_tpu/data/residency.py')
    assert ours.endswith(theirs.split("\n", 1)[1])


def test_byte_budget_lru_semantics():
    evicted = []
    lru = ByteBudgetLru(100, on_evict=evicted.append)
    assert lru.admit("a", 40) == [] and lru.admit("b", 40) == []
    assert lru.resident_bytes == 80 and lru.peak_bytes == 80
    # LRU order decides the victim; touch refreshes recency.
    assert lru.touch("a")
    assert lru.admit("c", 40) == ["b"]
    assert evicted == ["b"] and lru.eviction_log == ["b"]
    assert lru.resident == ["a", "c"] and lru.evictions == 1
    # Protected keys are skipped over for eviction.
    assert lru.admit("d", 40, protected={"a", "c"}) == []
    assert lru.resident_bytes == 120  # floor admission ran over budget
    # would_fit: only protected bytes in the way → wait; nothing protected
    # resident → floor admission applies and it always "fits".
    assert not lru.would_fit(50, protected={"a", "c", "d"})
    assert lru.would_fit(50, protected=())
    # discard is an uncounted release; evict counts and logs.
    assert lru.discard("d") and lru.evictions == 1
    assert lru.evict("c") and lru.eviction_log == ["b", "c"]
    assert not lru.evict("c") and not lru.discard("zzz")
    # Re-admitting a resident key refreshes recency, evicts nothing.
    assert lru.admit("a", 40) == [] and lru.resident == ["a"]


def test_slot_lru_matches_reference():
    """The same claim/get sequence gives the same slots and demotions in
    both packages (the serving store's pool reuses it)."""
    out = []
    for pkg in (residency, jresidency):
        demoted = []
        lru = pkg.SlotLru(3, on_demote=lambda k, s: demoted.append((k, s)), base=10)
        slots = [lru.claim(k) for k in "abc"]
        lru.get("a")
        slots.append(lru.claim("d", protected={"b"}))
        with pytest.raises(RuntimeError, match="exhausted"):
            lru.claim("e", protected={"a", "b", "d"})
        out.append((slots, demoted, lru.resident, lru.peek("d")))
    assert out[0] == out[1]
    assert out[0][0] == [10, 11, 12, 12] and out[0][1] == [("c", 12)]
    assert isinstance(SlotLru(1), SlotLru)


# ---------------------------------------------------------------------------
# The host master
# ---------------------------------------------------------------------------


def test_host_entity_block_memmaps_under_spill_dir(tmp_path):
    block = _dataset().blocks[0]
    hb = host_entity_block(block, str(tmp_path), 0)
    assert isinstance(hb.features, np.memmap) and not hb.features.flags.writeable
    np.testing.assert_array_equal(np.asarray(hb.features), block.features.numpy())
    assert any(tmp_path.iterdir())  # the .npy spill files exist
    # A block already mapped from its own files is left as it is.
    again = host_entity_block(hb, str(tmp_path), 0)
    assert again.features.filename == hb.features.filename


def test_block_costs_match_reference():
    """The budget counts what the reference counts: data plus w0 and the
    result, (E, dim) f32, for blocks of equal contents."""
    X, Y, W = _arrays(np.float32)
    jds = jre.build_random_effect_dataset(EIDS, X, Y, W, E, _cfg(jre))
    for b, jb in zip(_dataset().blocks, jds.blocks):
        for f in re_store._BLOCK_FIELDS:
            assert getattr(b, f).numpy().dtype.itemsize == np.asarray(getattr(jb, f)).dtype.itemsize, f
        assert block_device_cost(b) == jstore.block_device_cost(jb)
        assert re_store.block_data_bytes(b) == jstore.block_data_bytes(jb)


@pytest.mark.parametrize("member", [3, "updater:3", "replica-a", "node:x"])
def test_spill_partition_tag_matches_reference(member):
    assert re_store.spill_partition_tag(member) == jstore.spill_partition_tag(member)


def test_rebalance_spill_layout_moves_same_files_as_reference(tmp_path):
    """Both packages move the same files to the same successors, with the
    same collision renames; the moves are renames (same inodes)."""
    results = []
    for pkg, root in ((re_store, tmp_path / "port"), (jstore, tmp_path / "ref")):
        inodes = {}
        for k in range(4):
            d = pkg.partition_spill_dir(str(root), f"updater:{k}")
            for name in (f"block00000_features_{k}.npy", "shared.npy"):
                np.save(os.path.join(d, name), np.full((3, 2), float(k), np.float32))
            inodes[k] = os.stat(os.path.join(d, f"block00000_features_{k}.npy")).st_ino
        before = HashRing([f"updater:{k}" for k in range(4)])
        after = HashRing(["updater:0", "updater:1"])
        moves = pkg.rebalance_spill_layout(str(root), before, after)
        layout = sorted(os.path.relpath(os.path.join(dp, f), root) for dp, _, fs in os.walk(root) for f in fs)
        for k in (2, 3):
            succ = moves[f"updater:{k}"]["successor"].rsplit(":", 1)[1]
            assert os.stat(root / f"host-{succ}" / f"block00000_features_{k}.npy").st_ino == inodes[k]
        assert pkg.rebalance_spill_layout(str(root), after, before) == {}
        results.append((moves, layout))
    assert results[0] == results[1]
    assert set(results[0][0]) == {"updater:2", "updater:3"}
    assert any("from-" in p for p in results[0][1])


# ---------------------------------------------------------------------------
# Bit parity and the operational envelope
# ---------------------------------------------------------------------------


def test_ooc_bit_parity_with_fully_resident(ref_run, ooc_run):
    ref_model, _, ref_post, ref_stats = ref_run
    ooc_model, coord, ooc_post, ooc_stats = ooc_run
    st = coord.last_residency_stats
    # Not "close": equal, bit for bit; the model's table is the host master.
    assert ooc_model.coefficients.device.type == "cpu"
    assert torch.equal(ref_model.coefficients, ooc_model.coefficients)
    assert torch.equal(ref_model.score(_batch()), ooc_model.score(_batch()))
    for a, b in zip(ref_stats, ooc_stats):
        assert torch.equal(a.iterations, b.iterations) and torch.equal(a.reasons, b.reasons)
        assert int(a.sample_visits) == int(b.sample_visits)
    # The budget constrained the run (a quarter of the footprint, floored at
    # the largest block: waves of evictions), and the admitted bytes never
    # exceeded the effective budget.
    assert st["evictions"] > 0
    assert st["footprint_bytes"] >= 4 * st["budget_bytes"]
    assert st["peak_bytes"] <= st["effective_budget_bytes"]
    # No build after pass 0, upload churn notwithstanding.
    assert ref_post == 0 and ooc_post == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_ooc_bitwise_resident_keeps_the_data_dtype(dtype):
    """The host master keeps the batch's dtype: the budgeted run is the
    resident run bit for bit in float32 and in float64."""
    ref, _, _, _ = _run(None, dtype, active_set=True, passes=3)
    got, coord, post, _ = _run(_footprint(dtype) // 4, dtype, active_set=True, passes=3)
    assert got.coefficients.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert torch.equal(ref.coefficients, got.coefficients)
    assert post == 0 and coord.last_residency_stats["evictions"] > 0


def test_ooc_stats_published(ooc_run):
    """The numbers of the reference's gauges, read from ``stats()``."""
    _, coord, _, _ = ooc_run
    st = coord.last_residency_stats
    assert st["coordinate"] == "per_user"
    assert 0 < st["peak_bytes"] <= st["effective_budget_bytes"]
    assert st["effective_budget_bytes"] == coord._store.effective_budget
    assert st["resident_blocks"] == len(coord._store.lru)
    assert st["uploads"] + st["upload_hits"] == PASSES * len(coord.dataset.blocks)
    assert len(st["pass_evictions"]) == PASSES and sum(st["pass_evictions"]) == st["evictions"]
    # The pipeline's stages rode along: uploads and downloads were timed.
    assert {"h2d", "d2h", "solve"} <= set(st["pipeline"]["stages"])
    assert st["pipeline"]["stages"]["d2h"]["items"] == len(coord.dataset.blocks)


def test_ooc_eviction_sequence_deterministic(ooc_run):
    _, coord_a, _, _ = ooc_run
    _, coord_b, _, _ = _run(_footprint() // 4)
    a, b = coord_a.last_residency_stats, coord_b.last_residency_stats
    assert a["eviction_log"] == b["eviction_log"] and a["evictions"] > 0
    assert a["uploads"] == b["uploads"]
    assert a["pass_evictions"] == b["pass_evictions"]


def test_ooc_active_set_retires_converged_blocks():
    ref_gated, _, _, _ = _run(None, active_set=True)
    ooc_gated, coord, post, _ = _run(_footprint() // 4, active_set=True)
    st = coord.last_residency_stats
    assert torch.equal(ref_gated.coefficients, ooc_gated.coefficients)
    assert post == 0
    # The cold cohort converges in pass 1; retiring those blocks shrinks the
    # later passes' working set, so eviction pressure collapses after the
    # first gated pass.
    assert st["evictions"] > 0
    assert sum(st["pass_evictions"][2:]) <= st["pass_evictions"][0]
    # Gating also cuts upload traffic.
    ungated = _run(_footprint() // 4)[1].last_residency_stats
    assert st["uploads"] < ungated["uploads"]


def test_ooc_store_retire_evicts_unprotected_resident_blocks():
    blocks = _dataset().blocks
    store = ReDeviceStore(blocks, sum(block_device_cost(b) for b in blocks), "retire_test")
    w0 = np.zeros((blocks[0].num_entities, blocks[0].dim), np.float32)
    store.begin_pass(0)
    store.acquire(0, store.blocks[0], w0, cacheable=True)
    store.release(0, cacheable=True)
    # Not resident → no-op; resident-but-protected → kept; resident → drop.
    assert store.retire([99]) == 0
    store.acquire(0, store.blocks[0], w0, cacheable=True)  # re-protects key 0
    assert store.retire([0]) == 0
    store.release(0, cacheable=True)
    assert store.retire([0]) == 1
    assert store.stats()["retired"] == 1
    assert store.lru.eviction_log == [0]
    store.end_pass()


@pytest.mark.parametrize("transient_released_first", [True, False])
def test_ooc_eviction_log_independent_of_download_timing(transient_released_first):
    """A gated pass's compacted (transient) block leaves the store at its
    release, whenever the download thread gets there. The next admission
    evicts the same blocks either way: with the transient block still in
    flight it waits for its release instead of evicting a resident block."""
    import threading

    block = _dataset().blocks[0]
    # Room for two blocks beside the static buffers of their geometry.
    store = ReDeviceStore([block] * 3, 2 * block_device_cost(block) + block_input_bytes([block]), "timing_test")
    w0 = _w0(store.blocks[0])
    store.begin_pass(0)
    for k in (0, 1):
        store.acquire(k, store.blocks[k], w0, cacheable=True)
        store.release(k, cacheable=True)
    transient = ("compact", 1, 0)
    store.acquire(transient, store.blocks[2], w0, cacheable=False)
    assert store.lru.eviction_log == [0]
    if transient_released_first:
        store.release(transient, cacheable=False)
        store.acquire(2, store.blocks[2], w0, cacheable=True)
    else:
        admit = threading.Thread(target=store.acquire, args=(2, store.blocks[2], w0, True))
        admit.start()
        admit.join(0.3)
        assert admit.is_alive()  # waits for the transient block's release
        store.release(transient, cacheable=False)
        admit.join(10)
        assert not admit.is_alive()
    store.release(2, cacheable=True)
    store.end_pass()
    assert store.lru.eviction_log == [0]
    assert store.lru.resident == [1, 2] and store.stats()["peak_bytes"] <= store.effective_budget


def test_ooc_memmap_spill_parity(ref_run, tmp_path):
    ref_model, _, _, _ = ref_run
    ooc_model, coord, post, _ = _run(_footprint() // 4, spill_dir=str(tmp_path))
    assert torch.equal(ref_model.coefficients, ooc_model.coefficients)
    assert post == 0 and coord.last_residency_stats["evictions"] > 0
    assert isinstance(coord.dataset.blocks[0].features, np.memmap)
    assert len(list(tmp_path.glob("per_user.block*_features.npy"))) == len(coord.dataset.blocks)


def test_two_coordinates_share_a_spill_dir(ref_run, tmp_path):
    """Each coordinate's spill files carry its id: a second coordinate in
    the same directory leaves the first's mapped files alone (the
    reference's unprefixed names would overwrite them, ROADMAP queue 3)."""
    first = _coordinate(_footprint() // 4, spill_dir=str(tmp_path))
    second = _coordinate(_footprint() // 4, spill_dir=str(tmp_path), coordinate_id="per_item")
    assert len(list(tmp_path.glob("per_user.*.npy"))) == len(list(tmp_path.glob("per_item.*.npy"))) > 0
    for coord in (first, second):
        model = None
        for it in range(PASSES):
            coord.begin_cd_pass(it)
            model, _ = coord.train(_batch(), None, model)
        assert torch.equal(model.coefficients, ref_run[0].coefficients)


def test_ooc_spill_member_layout(tmp_path):
    coord = _coordinate(_footprint() // 4, spill_dir=str(tmp_path), device_spill_member="updater:3")
    assert coord._store.spill_dir == str(tmp_path / "host-3")
    assert len(list((tmp_path / "host-3").glob("*.npy"))) == 6 * len(coord.dataset.blocks)


def test_ooc_budget_floors_at_largest_block():
    """The floor is the largest block plus the solve cache's static buffers
    (one flat buffer per input, sized for the largest block), which the
    budget holds too."""
    blocks = _dataset().blocks
    store = ReDeviceStore(blocks, 1, "floor_test")
    assert store.static_bytes == block_input_bytes(blocks) > 0
    assert store.effective_budget == max(block_device_cost(b) for b in blocks) + store.static_bytes
    assert store.budget == 1


def test_ooc_upload_failure_other_than_oom_propagates(monkeypatch):
    """An upload that fails for any reason but a device OOM raises: nothing
    carries on fully resident."""
    coord = _coordinate(_footprint() // 4)

    def broken(*_a, **_k):
        raise RuntimeError("copy engine fault")

    monkeypatch.setattr(coord._store, "_upload_block", broken)
    coord.begin_cd_pass(0)
    with pytest.raises(RuntimeError, match="copy engine fault"):
        coord.train(_batch(), None, None)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def test_ooc_matches_reference_budgeted_and_resident():
    """float32: the port's budgeted coefficients against the reference's
    budgeted run (RTOL32/ATOL32), with the same eviction log (same block
    costs, same plan order). float64: against the reference's fully
    resident run at rtol 1e-5, iterations and reasons equal."""
    budget = _footprint() // 4
    got32, coord, _, _ = _run(budget)
    want32, _, jcoord = _jrun(budget)
    np.testing.assert_allclose(got32.coefficients.numpy(), want32, rtol=RTOL32, atol=ATOL32)
    assert coord.last_residency_stats["eviction_log"] == jcoord.last_residency_stats["eviction_log"]

    got64, _, _, stats64 = _run(_footprint(np.float64) // 4, np.float64)
    want64, jstats64, _ = _jrun(None, np.float64)
    np.testing.assert_allclose(got64.coefficients.numpy(), want64, rtol=RTOL64, atol=ATOL64)
    for s, js in zip(stats64, jstats64):
        v = np.asarray(js.valid)
        np.testing.assert_array_equal(s.valid.numpy(), v)
        np.testing.assert_array_equal(s.iterations.numpy()[v], np.asarray(js.iterations)[v])
        np.testing.assert_array_equal(s.reasons.numpy()[v], np.asarray(js.reasons)[v])


def test_reference_budget_refuses_float64_data():
    """The difference ROADMAP queue 3 records: the reference's host master
    is float32 whatever the data's dtype, and its Newton loop refuses the
    float32 warm start beside float64 blocks; the port trains (above)."""
    with pytest.raises(TypeError, match="float32"):
        _jrun(1, np.float64, passes=1)


# ---------------------------------------------------------------------------
# Config guards
# ---------------------------------------------------------------------------


def test_ooc_projected_dataset_falls_back_fully_resident(caplog):
    ds = _dataset(subspace_projection=True)
    assert ds.projected
    with caplog.at_level(logging.WARNING, logger="photon_tpu_torch"):
        coord = _coordinate(1 << 20, dataset=ds)
    assert coord._store is None  # fully resident: the budget was ignored
    assert any("fully resident" in r.message for r in caplog.records)


def test_ooc_rejects_pearson_ratio():
    with pytest.raises(ValueError, match="features_to_samples_ratio"):
        _coordinate(1 << 20, dataset=_dataset(features_to_samples_ratio=0.5))


def test_ooc_rejects_variance_computation():
    with pytest.raises(ValueError, match="variance"):
        _coordinate(1 << 20, compute_variance=VarianceComputationType.SIMPLE)


def test_host_master_dataset_needs_a_budget():
    coord = _coordinate(1 << 20)
    with pytest.raises(ValueError, match="host master"):
        _coordinate(None, dataset=coord.dataset)


# ---------------------------------------------------------------------------
# Resource containment (reference tests/test_resources.py)
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.reset()
    yield
    faults.reset()


def _plan(*rules):
    return faults.configure(FaultPlan(rules=tuple(rules)))


def _w0(b):
    return np.zeros((b.num_entities, b.dim), np.float32)


def test_re_spill_enospc_falls_back_to_host_memory(tmp_path):
    spill = str(tmp_path / "re-spill")
    os.makedirs(spill)
    block = _dataset().blocks[0]
    # Field 1 ("features") hits a full disk: it stays in host RAM with
    # identical values while the other fields spill.
    _plan(FaultRule("re_store.spill", kind="enospc", at=(1,)))
    out = host_entity_block(block, spill_dir=spill, index=0)
    for name in ("entity_idx", "features", "label", "weight"):
        np.testing.assert_array_equal(np.asarray(getattr(out, name)), getattr(block, name).numpy())
    assert not isinstance(out.features, np.memmap)
    assert isinstance(out.label, np.memmap)
    saved = sorted(os.path.basename(p) for p in os.listdir(spill))
    assert "block00000_features.npy" not in saved and len(saved) == 5


def test_re_store_oom_shrinks_budget_and_retries():
    store = ReDeviceStore(_dataset().blocks, budget_bytes=1 << 30, coordinate_id="per-x")
    assert len(store.blocks) >= 2
    for k in range(len(store.blocks) - 1):
        store.acquire(k, store.blocks[k], _w0(store.blocks[k]), cacheable=True)
        store.release(k, cacheable=True)
    _plan(FaultRule("re_store.upload", kind="oom", at=(0,), max_count=1))
    last = len(store.blocks) - 1
    blk = store.blocks[last]
    dev_block, dev_w0 = store.acquire(last, blk, _w0(blk), cacheable=True)
    # Contained: the unprotected working set evicted, the budget halved, the
    # upload retried; the caller never saw the OOM and the data is equal.
    np.testing.assert_array_equal(dev_block.features.numpy(), np.asarray(blk.features))
    np.testing.assert_array_equal(dev_w0.numpy(), _w0(blk))
    assert store.effective_budget == max(store._max_cost, (1 << 30) // 2)
    assert store.lru.resident == [last]
    assert store.stats()["budget_shrinks"] == 1
    store.release(last, cacheable=True)


def test_re_store_oom_at_floor_raises_device_memory_error():
    store = ReDeviceStore(_dataset().blocks, budget_bytes=1, coordinate_id="per-y")
    _plan(FaultRule("re_store.upload", kind="oom", p=1.0))
    with pytest.raises(resources.DeviceMemoryError) as ei:
        store.acquire(0, store.blocks[0], _w0(store.blocks[0]), cacheable=True)
    assert "largest single" in str(ei.value)


def _train_re_ooc(plan, passes=2):
    faults.reset()
    if plan is not None:
        faults.configure(plan)
    coord = _coordinate(1)  # the floor: one block resident at a time
    model = None
    for it in range(passes):
        coord.begin_cd_pass(it)
        model, _ = coord.train(_batch(), None, model)
    return model.coefficients


def test_re_store_oom_training_bit_parity():
    """An out-of-core run with device OOMs injected at the upload edge gives
    the fault-free run's coefficients bit for bit: containment changes
    residency, never values."""
    clean = _train_re_ooc(None)
    faulted = _train_re_ooc(FaultPlan(rules=(FaultRule("re_store.upload", kind="oom", at=(0, 5), max_count=2),)))
    assert torch.equal(clean, faulted)


# ---------------------------------------------------------------------------
# GameEstimator: budget, checkpoint and resume
# ---------------------------------------------------------------------------


def _estimator(passes, budget_mb, spill_dir=None):
    from photon_tpu_torch.estimators import config
    from photon_tpu_torch.estimators.game_estimator import GameEstimator

    cfgs = [config.FixedEffectCoordinateConfig("global", "global"),
            config.RandomEffectCoordinateConfig("per_user", "userId", "re")]
    reg = config.GameOptimizationConfig({"global": config.RegularizationConfig(1.0, 0.0),
                                         "per_user": config.RegularizationConfig(0.5, 0.0)})
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, cfgs, num_iterations=passes,
                        intercept_indices={"global": 0}, num_entities={"userId": E}, re_active_set=True,
                        re_device_budget_mb=budget_mb, re_spill_dir=spill_dir, solve_cache=SolveCache())
    return est, reg


def _glmix_batch():
    X, Y, W = _arrays(np.float32)
    Xg = np.concatenate([np.ones((N, 1), np.float32), X[:, :3] + 0.5], axis=1)
    b = _batch()
    return GameBatch(label=b.label, offset=b.offset, weight=b.weight, features={"global": torch.from_numpy(Xg),
                                                                              "re": b.features["re"]},
                     entity_ids=b.entity_ids)


def test_estimator_budgeted_resume_equals_unbroken(tmp_path, monkeypatch):
    """A budgeted GameEstimator fit stopped by a signal at its first pass
    boundary (a checkpoint, then GracefulShutdown) and resumed from the
    checkpoint equals the unbroken budgeted fit, and both equal the resident
    fit bit for bit."""
    from photon_tpu_torch.algorithm import coordinate_descent as cd_mod
    from photon_tpu_torch.utils.checkpoint import latest_step
    from photon_tpu_torch.utils.shutdown import GracefulShutdown

    batch = _glmix_batch()
    budget_mb = _footprint() / 4 / (1 << 20)
    resident = _estimator(3, None)[0].fit(batch, optimization_configs=[_estimator(3, None)[1]])[0].model
    est, reg = _estimator(3, budget_mb, str(tmp_path / "spill"))
    unbroken = est.fit(batch, optimization_configs=[reg])[0].model
    ck = str(tmp_path / "ck")
    est, reg = _estimator(3, budget_mb, str(tmp_path / "spill2"))
    with monkeypatch.context() as m:
        m.setattr(cd_mod, "shutdown_requested", lambda: 15)
        with pytest.raises(GracefulShutdown):
            est.fit(batch, optimization_configs=[reg], checkpoint_dir=ck)
    assert latest_step(f"{ck}/cfg_0") == 0  # stopped at the first pass boundary
    est, reg = _estimator(3, budget_mb, str(tmp_path / "spill3"))
    resumed = est.fit(batch, optimization_configs=[reg], checkpoint_dir=ck)[0].model
    for got in (unbroken, resumed):
        assert torch.equal(got.models["per_user"].coefficients.cpu(), resident.models["per_user"].coefficients)
        assert torch.equal(got.models["global"].model.coefficients.means,
                           resident.models["global"].model.coefficients.means)
    assert unbroken.models["per_user"].coefficients.device.type == "cpu"


def test_ooc_static_buffers_count_inside_the_budget(ooc_run):
    """The solve cache's static buffers of a budgeted coordinate are in its
    budget: resident blocks plus the buffers peak at or under the effective
    budget, and the buffers the cache really holds for the coordinate's
    blocks are the ones counted (one flat buffer per input, sized for the
    largest block)."""
    _, coord, _, _ = ooc_run
    st = coord.last_residency_stats
    blocks = coord.dataset.blocks
    assert st["static_bytes"] == block_input_bytes(blocks)
    assert coord.solve_cache.static_bytes() == st["static_bytes"]
    assert st["peak_bytes"] + st["static_bytes"] == st["peak_total_bytes"] <= st["effective_budget_bytes"]
    assert st["evictions"] > 0


def test_block_buffers_are_shared_across_geometries():
    """Blocks of different geometries solve through one flat buffer per
    input (each program reads a view of its block's shape), sized for the
    largest block up front: one cache holds 7 buffers for all of them, the
    bytes of the largest block's inputs, and each solve equals a solve in a
    cache of its own bit for bit."""
    from photon_tpu_torch.optim.common import OptimizerConfig

    blocks = _dataset().blocks
    assert len({tuple(b.features.shape) for b in blocks}) > 1
    obj = GLMObjective(loss=LogisticLoss, l2_weight=0.5)
    spec = OptimizerSpec(**dict(SPEC, optimizer=OptimizerType.NEWTON))
    cfg = OptimizerConfig(max_iter=25, tol=1e-9)
    shared = SolveCache()
    shared.reserve_block_inputs(blocks, "cpu")
    for b in blocks:
        offs = torch.zeros((b.num_entities, b.n_max))
        w0 = torch.zeros((b.num_entities, b.dim))
        got = shared.block_solver(obj, spec, cfg, has_mask=False)(b, offs, w0)
        alone = SolveCache().block_solver(obj, spec, cfg, has_mask=False)(b, offs, w0)
        for x, y in zip(got, alone):
            assert torch.equal(x, y)
    assert len(shared._slots) == 7
    assert shared.static_bytes() == block_input_bytes(blocks)
    assert shared.stats.captures == len({tuple(b.features.shape) for b in blocks})
